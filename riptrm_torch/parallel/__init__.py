from riptrm_torch.parallel.sweep import (
    batched_protocol_sweep,
    batched_riptrm_solve,
    batched_solver_sweep,
    init_state_from,
    protocol_single,
)

__all__ = ["batched_protocol_sweep", "batched_riptrm_solve", "batched_solver_sweep",
           "init_state_from", "protocol_single"]
