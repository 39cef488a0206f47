"""The host's reads of device values inside the generic tCG a lockstep
step: the ``aten::_local_scalar_dense`` operators inside the program's
``riptrm.tcg`` spans in the traced window (the lane loop's check of "any
lane alive", one an iteration and one to end), over the window's lockstep
steps.  None where the program opens no such span."""


def read(run):
    trace = run.trace
    if trace is None or not any(op.name == "riptrm.tcg" for op in trace.ops.values()):
        return None
    under = _under(trace, "riptrm.tcg")
    syncs = sum(1 for i, op in trace.ops.items()
                if op.name == "aten::_local_scalar_dense" and under(i))
    return syncs / max(1, sum(run.steps))


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
