from riptrm_torch.parallel.sweep import batched_riptrm_solve, init_state_from

__all__ = ["batched_riptrm_solve", "init_state_from"]
