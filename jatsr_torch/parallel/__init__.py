"""Data-parallel training and serving over processes: the mesh, the process
group, ZeRO-1's plan, and the tensor-parallel rule table."""

from .distributed import (DataGroup, init_distributed, is_primary,
                          process_batch_slice, put_global_batch,
                          shared_run_name)
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_rows, make_mesh,
                   opt_state_plan, param_specs)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DataGroup", "batch_rows",
           "init_distributed", "is_primary", "make_mesh", "opt_state_plan",
           "param_specs", "process_batch_slice", "put_global_batch",
           "shared_run_name"]
