"""Training and serving over processes: the mesh, the process group,
ZeRO-1's plan, data parallelism, and tensor-parallel serving by the rule
table."""

from .distributed import (DataGroup, ModelGroup, init_distributed,
                          is_primary, process_batch_slice, put_global_batch,
                          shared_run_name)
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_rows, local_params,
                   make_mesh, model_rank, model_size, opt_state_plan,
                   param_specs)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DataGroup", "ModelGroup",
           "batch_rows", "init_distributed", "is_primary", "local_params",
           "make_mesh", "model_rank", "model_size", "opt_state_plan",
           "param_specs", "process_batch_slice", "put_global_batch",
           "shared_run_name"]
