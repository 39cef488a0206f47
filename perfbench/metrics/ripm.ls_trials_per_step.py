"""RIPM's merit line-search trials a lockstep step: the program's
``riptrm.ripm.ls_trial`` spans in the traced window (one a call of the
line search's trial, on every lane at once) over the window's lockstep
steps.  None where the program opens no such span."""


def read(run):
    if run.trace is None:
        return None
    trials = sum(op.name == "riptrm.ripm.ls_trial" for op in run.trace.ops.values())
    return None if trials == 0 else trials / max(1, sum(run.steps))
