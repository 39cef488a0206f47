"""The share of the SPD metric's solves that go through the program's
hand-written Cholesky solve: ``riptrm::spd_cho_solve`` operator calls in
the traced window over those calls plus half the
``aten::linalg_solve_triangular`` calls (the library takes two triangular
solves a Cholesky solve, and two a congruence L^-1 u L^-T, which ``dist``
takes), each counted where it runs inside no operator of its own name.
None where no such operator runs (the library's solves) or nothing is
traced."""

KERNEL, LIBRARY = "riptrm::spd_cho_solve", "aten::linalg_solve_triangular"


def read(run):
    trace = run.trace
    if trace is None:
        return None
    calls = {KERNEL: 0, LIBRARY: 0}
    for i, op in trace.ops.items():
        if op.name in calls and op.name not in list(trace.ancestors(op.parent)):
            calls[op.name] += 1
    return None if calls[KERNEL] == 0 else calls[KERNEL] / (calls[KERNEL] + calls[LIBRARY] / 2)
