"""The share of the generic tCG's Hessian-vector products that go through
the program's hand-written StableIdentification operator:
``riptrm::stableid_hvp`` operator calls inside the ``riptrm.tcg.hvp``
spans of the traced window, over those spans.  None where no such
operator runs there (the composed operator) or the program opens no such
span."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    spans = sum(op.name == "riptrm.tcg.hvp" for op in trace.ops.values())
    calls = sum(1 for i, op in trace.ops.items()
                if op.name == "riptrm::stableid_hvp" and "riptrm.tcg.hvp" in trace.ancestors(i))
    return None if spans == 0 or calls == 0 else calls / spans
