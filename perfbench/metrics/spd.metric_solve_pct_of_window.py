"""Device time launched inside the SPD metric's solves over the traced
window: ``aten::linalg_solve_triangular`` operators (the library's
triangular solves, two a Cholesky solve) and ``riptrm::spd_cho_solve``
operators (the program's hand-written solve), whichever implements them.
None where neither runs."""

NAMES = ("aten::linalg_solve_triangular", "riptrm::spd_cho_solve")


def read(run):
    if run.trace is None:
        return None
    under = _under(run.trace, NAMES)
    seconds = sum(ev.end - ev.start for ev in run.trace.device if under(ev.op))
    return None if seconds == 0.0 else 100.0 * seconds / run.window_s


def _under(trace, names):
    """op id -> whether the operator or one it ran inside is named in
    ``names``: each operator's chain of parents walked once (a traced sweep
    holds millions of operators)."""
    memo = {0: False}

    def under(op):
        path = []
        while op not in memo:
            node = trace.ops.get(op)
            if node is None or node.name in names:
                memo[op] = node is not None
                break
            path.append(op)
            op = node.parent
        for i in path:
            memo[i] = memo[op]
        return memo[op]

    return under
