"""Device time launched inside the program's ``riptrm.ripm.line_search``
spans (RIPM's merit line search: every trial's retraction and KKT field)
over the traced window.  None where the program opens no such span."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_s_under(lambda name: name == "riptrm.ripm.line_search")
    return None if seconds == 0.0 else 100.0 * seconds / run.window_s
