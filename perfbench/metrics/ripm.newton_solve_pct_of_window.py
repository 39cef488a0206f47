"""Device time launched inside the program's ``riptrm.ripm.newton_solve``
spans (RIPM's dense Newton solve, whatever implements it, and the rest of
the span: the direction back from coordinates, dz, ds, their norms) over
the traced window.  None where the program opens no such span."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_s_under(lambda name: name == "riptrm.ripm.newton_solve")
    return None if seconds == 0.0 else 100.0 * seconds / run.window_s
