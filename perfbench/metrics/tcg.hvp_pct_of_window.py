"""Device time launched inside the program's ``riptrm.tcg.hvp`` spans
(the Hessian-vector products the generic tCG calls: the Lagrangian's
Hessian image, by torch.func's pullback or the family's closed form, and
the barrier term) over the traced window.  None where the program opens
no such span."""


def read(run):
    if run.trace is None:
        return None
    under = _under(run.trace, "riptrm.tcg.hvp")
    seconds = sum(ev.end - ev.start for ev in run.trace.device if under(ev.op))
    return None if seconds == 0.0 else 100.0 * seconds / run.window_s


def _under(trace, name):
    """op id -> whether the operator or one it ran inside is ``name``:
    each operator's chain of parents walked once (a traced sweep holds
    millions of operators)."""
    memo = {0: False}

    def under(op):
        path = []
        while op not in memo:
            node = trace.ops.get(op)
            if node is None or node.name == name:
                memo[op] = node is not None
                break
            path.append(op)
            op = node.parent
        for i in path:
            memo[i] = memo[op]
        return memo[op]

    return under
