from riptrm_torch.parallel.distributed import host_shard, initialize
from riptrm_torch.parallel.sweep import (
    batched_protocol_sweep,
    batched_riptrm_solve,
    batched_solver_sweep,
    init_state_from,
    make_mesh,
    protocol_single,
    run_sweep,
    sharded_riptrm_solve,
)

__all__ = ["host_shard", "initialize", "batched_protocol_sweep", "batched_riptrm_solve",
           "batched_solver_sweep", "init_state_from", "make_mesh", "protocol_single",
           "run_sweep", "sharded_riptrm_solve"]
