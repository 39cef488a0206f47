"""Device time launched inside the program's ``riptrm.ripm.materialize``
spans (RIPM's tangent basis, its dense materialisation of the condensed
operator, the right-hand side's coordinates) over the traced window.
None where the program opens no such span."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_s_under(lambda name: name == "riptrm.ripm.materialize")
    return None if seconds == 0.0 else 100.0 * seconds / run.window_s
