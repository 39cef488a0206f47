"""The host's reads of device values a lockstep step: the
``aten::_local_scalar_dense`` operators (``bool(t)``, ``t.item()``) inside
the program's ``riptrm.sweep`` spans in the traced window, over the
window's lockstep steps.  Each read waits for the device's queue to drain.
The harness's own reads lie outside the spans and are not counted, nor are
the syncs inside a library call that reads no value through an operator.
None where the program opens no such span."""


def read(run):
    trace = run.trace
    if trace is None or not any(op.name == "riptrm.sweep" for op in trace.ops.values()):
        return None
    syncs = sum(1 for i, op in trace.ops.items()
                if op.name == "aten::_local_scalar_dense" and "riptrm.sweep" in trace.ancestors(i))
    return syncs / max(1, sum(run.steps))
