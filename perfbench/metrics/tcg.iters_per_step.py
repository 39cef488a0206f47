"""Lockstep iterations of the generic tCG a lockstep step: the program's
``riptrm.tcg.iteration`` spans in the traced window (one a body of the
tCG's lane loop, on every lane at once) over the window's lockstep steps.
None where the program opens no such span."""


def read(run):
    if run.trace is None:
        return None
    iters = sum(op.name == "riptrm.tcg.iteration" for op in run.trace.ops.values())
    return None if iters == 0 else iters / max(1, sum(run.steps))
