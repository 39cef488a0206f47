"""Share of the traced window's wall time in which no kernel, copy or
memset ran on the device (the union of the device intervals)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
