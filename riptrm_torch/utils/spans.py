"""Named ranges on torch.profiler's own timeline around the port's layers.

``span(name)`` is a context manager that opens a profiler range while
torch.profiler records, and does nothing otherwise: no option, no
environment variable.  A range sits on the profiler's host timeline beside
the operators it encloses, so in any trace (``export_chrome_trace``,
TensorBoard) a kernel belongs to the innermost span around its launch, and
a gap in the device's work to the span the host was in.  Under export
tracing (``utils/lanes.py::tracing``) it does nothing, so an exported
program holds no profiler node.  No span opens inside a ``vmap``ped
function.

The ranges take the profiler's function scope, not the user-annotation
scope of ``torch.profiler.record_function``: kineto mirrors a user
annotation onto the device timeline as an event of its own, which a reader
of the trace would count as device work.

Each sweep call's spans nest under its ``riptrm.sweep``:

* ``riptrm.sweep``, with ``riptrm.sweep.init`` (the lanes' start state) and
  ``riptrm.sweep.residual`` (the closing KKT residual);
* ``riptrm.step``: one body of the lane-batched loop
  (``solvers/base.py::compiled_best_while``), whose host check of the loop
  condition stays outside it; ``riptrm.residual``: a step's residual;
* RIPM: ``riptrm.ripm.kkt``, ``riptrm.ripm.materialize``,
  ``riptrm.ripm.newton_solve`` (or ``riptrm.ripm.krylov``),
  ``riptrm.ripm.line_search`` with one ``riptrm.ripm.ls_trial`` a trial;
* RIPTRM: ``riptrm.riptrm.barrier``, ``riptrm.riptrm.direction`` (tCG) or, in
  exact mode, ``riptrm.riptrm.materialize`` and ``riptrm.riptrm.trs``, then
  ``riptrm.riptrm.trial`` (with ``riptrm.riptrm.retract`` around the trial
  point's retraction) and ``riptrm.riptrm.evaluation``;
* the generic tCG (``ops/tcg.py::truncated_cg``): ``riptrm.tcg`` around
  RIPTRM's call of it, where no fused kernel takes the step, one
  ``riptrm.tcg.iteration`` a lockstep body of its loop (the host check of
  "any lane alive" stays outside it), and ``riptrm.tcg.hvp`` around each
  Hessian-vector product;
* RSQO: ``riptrm.rsqo.regularize``, ``riptrm.rsqo.qp``,
  ``riptrm.rsqo.line_search``; RALM: ``riptrm.ralm.line_search``;
* ``riptrm.callback``: a problem's callback metrics.
"""

from __future__ import annotations

import contextlib

import torch

from riptrm_torch.utils.lanes import tracing

_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while torch.profiler records (and no
    program is being traced for export); else a context that does
    nothing."""
    if not torch.autograd._profiler_enabled() or tracing():
        return _OFF
    return _range(name)
