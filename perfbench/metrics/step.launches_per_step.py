"""Device kernels launched in the traced window over its lockstep steps
(copies and memsets are not kernels and are not counted)."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.kernels()) / max(1, sum(run.steps))
