"""Device time of the family's fused tCG operator (``riptrm::sphere_tcg``)
over the traced window: the device activities launched inside the
operator, so that a renamed CUDA kernel keeps the metric."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_s_under(lambda name: name == run.cell.program.TCG_OP)
    return None if seconds == 0.0 else 100.0 * seconds / run.window_s
