"""Device time of the activities launched inside ``aten::linalg_*``
operators (the dense solves: LU, Cholesky, eigendecompositions) over the
traced window."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_s_under(lambda name: name.startswith("aten::linalg_"))
    return None if seconds == 0.0 else 100.0 * seconds / run.window_s
