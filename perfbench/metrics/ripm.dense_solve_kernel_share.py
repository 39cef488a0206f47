"""The share of RIPM's dense Newton solves that go through the program's
hand-written solve: ``riptrm::dense_solve`` operator calls inside the
``riptrm.ripm.newton_solve`` spans of the traced window, over those
spans.  None where no such operator runs there (the library's solve) or
the program opens no such span."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    spans = sum(op.name == "riptrm.ripm.newton_solve" for op in trace.ops.values())
    calls = sum(1 for i, op in trace.ops.items()
                if op.name == "riptrm::dense_solve"
                and "riptrm.ripm.newton_solve" in trace.ancestors(i))
    return None if spans == 0 or calls == 0 else calls / spans
