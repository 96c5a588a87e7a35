"""Training and serving over processes: the mesh, the process group,
ZeRO-1's plan, data parallelism, and tensor-parallel training and serving
by the rule table."""

from .distributed import (DataGroup, ModelGroup, broadcast_tree,
                          init_distributed,
                          is_primary, process_batch_slice, put_global_batch,
                          shared_run_name)
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_rows, head_offset,
                   local_params, make_mesh, model_rank, model_size,
                   opt_state_plan, param_specs, param_split_dim)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DataGroup", "ModelGroup",
           "batch_rows", "broadcast_tree", "head_offset", "init_distributed",
           "is_primary", "local_params", "make_mesh", "model_rank",
           "model_size", "opt_state_plan", "param_specs", "param_split_dim",
           "process_batch_slice", "put_global_batch", "shared_run_name"]
