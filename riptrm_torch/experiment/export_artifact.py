"""Deployable solver artifacts: export -> reload -> run without re-tracing.

Counterpart of ``riptrm_tpu/experiment/export_artifact.py`` on
``torch.export``.  A serving process should not re-trace the solver on
startup.  ``export_sweep`` traces the batched fixed-budget solve of any of
the four solvers (``parallel/sweep.py::batched_solver_sweep``), the
problem's data baked in as constants, and saves the program with
``torch.export.save``; ``load_sweep`` loads it and runs it with no tracing
of the solver.

How the program is traced: ``make_fx`` in fake mode lowers the solve to
aten operators (``torch.export.export`` cannot trace ``torch.func``'s
``vmap(grad)`` of the problems directly), every lane loop becomes one
``while_loop`` operator (``utils/lanes.py::lane_loop``), the hand-written
kernels stay the ``riptrm::`` operators of ``ops/kernels.py``, and
``torch.export.export`` of that graph gives the program.  The tensors a
loop body reads from its closures (the step's point and pullbacks, the
problem's data) are passed to the loop as inputs (``_Captures``): the
tracer would bake the first as constants, and the serializer keeps
constants of the top graph only.

Artifact layout: ``<path>`` is the ``torch.export`` archive, ``<path>.json``
a manifest (solver, batch, step budget, shapes, dtypes, device, torch
version, kernel-library hash) checked on load.

Notes:
* the problem instance (e.g. the Z matrix) is a constant inside the
  artifact: one artifact serves one instance at a fixed batch size;
* an artifact runs on the device it was exported on (``device``, CUDA
  device 0 by default; ``'cpu'`` for a CPU artifact); the JAX function's
  cross-platform ``platforms`` has no counterpart;
* loading imports ``riptrm_torch.ops.kernels`` first, which defines the
  ``riptrm::`` operators the program calls.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings

import torch

from riptrm_torch.config import resolve


def _attr(module, target: str):
    for part in target.split("."):
        module = getattr(module, part)
    return module


class _Captures:
    """What ``make_fx`` loses when it traces a loop body: a tensor that the
    body reads from its closure but that an enclosing graph computes (a
    point, a pullback's saved tensors) is met by the body's tracer as a
    fake constant.  While the program is traced, the tracers are patched to
    record, for each such constant, the node of the enclosing graph that
    produced it (``producers``, by the tensor's id; ``values`` keeps the
    tensors alive), and to give a constant that an inner loop's subgraph
    already holds a flat name (the tracer finds it among the body's buffers
    under a dotted name, ``while_loop_body_graph_0._tensor_constant3``,
    which it cannot read back)."""

    def __init__(self):
        self.tracers = []
        self.producers = {}
        self.values = []

    @contextlib.contextmanager
    def recording(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.fx.experimental.proxy_tensor import PythonKeyTracer, get_proxy_slot

        create_node = PythonKeyTracer.create_node
        captures = self

        def create(tracer, kind, target, *args, **kwargs):
            if not any(t is tracer for t in captures.tracers):
                captures.tracers.append(tracer)
            if kind == "get_attr" and isinstance(target, str):
                value = _attr(tracer.root, target)
                if "." in target:
                    alias = "_nested_" + target.replace(".", "_")
                    if not hasattr(tracer.root, alias):
                        setattr(tracer.root, alias, value)
                    target = alias
                if isinstance(value, FakeTensor) and id(value) not in captures.producers:
                    for outer in reversed(captures.tracers):
                        slot = None if outer is tracer else get_proxy_slot(value, outer, None)
                        if slot is not None:
                            captures.producers[id(value)] = slot.proxy.node
                            captures.values.append(value)
                            break
            return create_node(tracer, kind, target, *args, **kwargs)

        PythonKeyTracer.create_node = create
        try:
            yield self
        finally:
            PythonKeyTracer.create_node = create_node

    def lift(self, gm):
        """Pass the tensors every ``while_loop`` body and condition read from
        outside to the loop as its additional inputs, innermost loops first:
        a captured tensor as its producer's node where this graph computes
        it (else as a constant, wired in turn by the enclosing loop), a true
        constant (the problem's data) as a constant of this graph.  Only the
        top graph then holds constants: ``torch.export`` lifts those and
        cannot serialize one inside a loop's subgraph.  In place."""
        for node in list(gm.graph.nodes):
            if (node.op != "call_function"
                    or node.target is not torch.ops.higher_order.while_loop):
                continue
            cond_node, body_node, carried, extra = node.args
            subs = [_attr(gm, cond_node.target), _attr(gm, body_node.target)]
            consts = []
            for sub in subs:
                self.lift(sub)
                for n in sub.graph.nodes:
                    t = _attr(sub, n.target) if n.op == "get_attr" else None
                    if isinstance(t, torch.Tensor) and not any(t is u for u in consts):
                        consts.append(t)
            if not consts:
                continue
            new_extra = list(extra)
            with gm.graph.inserting_before(node):
                for t in consts:
                    producer = self.producers.get(id(t))
                    if producer is not None and producer.graph is gm.graph:
                        new_extra.append(producer)
                        continue
                    name = f"_loop_constant{len(self.values)}"
                    self.values.append(t)
                    gm.register_buffer(name, t, persistent=False)
                    new_extra.append(gm.graph.get_attr(name))
            for sub in subs:
                last = [n for n in sub.graph.nodes if n.op == "placeholder"][-1]
                for i, t in enumerate(consts):
                    with sub.graph.inserting_after(last):
                        last = sub.graph.placeholder(f"loop_input_{i}")
                        last.meta["val"] = t
                    stale = set()
                    for n in list(sub.graph.nodes):
                        if n.op == "get_attr" and _attr(sub, n.target) is t:
                            n.replace_all_uses_with(last)
                            sub.graph.erase_node(n)
                            stale.add(n.target)
                    for target in stale:  # export would keep it as a constant
                        owner, _, leaf = target.rpartition(".")
                        delattr(_attr(sub, owner) if owner else sub, leaf)
                sub.recompile()
            node.args = (cond_node, body_node, carried, tuple(new_extra))
        gm.recompile()
        return gm


def trace_program(fn, args):
    """``fn(*args)`` as a ``torch.export.ExportedProgram``: ``make_fx`` in
    fake mode (no solve runs, no kernel launches), the loops' captured
    tensors and constants passed to them (``_Captures``), then
    ``torch.export.export``."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.fx.experimental.proxy_tensor import make_fx

    captures = _Captures()
    with captures.recording():
        gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    captures.lift(gm)
    for node in gm.graph.nodes:
        value = _attr(gm, node.target) if node.op == "get_attr" else None
        if isinstance(value, FakeTensor):
            raise RuntimeError(f"export: the traced program reads a value of the trace as a "
                               f"constant ({node.target}); a loop's capture was not wired")
        if isinstance(value, torch.Tensor):
            # the archive stores a constant's storage as the tensor's own
            # elements: a view of a larger storage must be a copy
            setattr(gm, node.target, value.detach().clone(memory_format=torch.contiguous_format))
    return torch.export.export(gm, tuple(args))


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _example_args(problem, batch: int):
    x0 = problem.x0
    y0 = torch.as_tensor(problem.y0)
    xs = torch.zeros((batch,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    ys = torch.zeros((batch,) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
    return xs, ys


def export_sweep(problem, solver_name: str, option: dict, path: str, *, batch: int,
                 max_steps: int = 2000, device=None) -> None:
    """Save the batched fixed-budget solve of ``solver_name`` (RIPTRM,
    RIPM, RSQO or RALM) on ``problem`` to ``path`` and its manifest to
    ``path + '.json'``.

    The artifact's signature is (xs0, ys0) -> (x, y, steps, residuals), with
    a leading batch axis of exactly ``batch``; a tuple point (Product,
    fixed rank) is the port's packed tensor.  ``device`` (CUDA device 0 by
    default) is where the artifact runs; the problem's tensors must lie
    there."""
    from riptrm_torch.ops import _build
    from riptrm_torch.parallel.sweep import batched_solver_sweep

    _, device = resolve(None, device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    xs, ys = _example_args(problem, batch)
    if xs.device != device:
        raise ValueError(f"export_sweep: the problem lies on {xs.device}, the artifact is "
                         f"for {device}; build the problem on {device}")
    fn = batched_solver_sweep(problem, solver_name, option, max_steps)
    program = trace_program(fn, (xs, ys))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    manifest = {
        "solver": solver_name,
        "batch": batch,
        "max_steps": max_steps,
        "num_ineq": int(problem.num_ineq),
        "device": str(device),
        "x_shapes": [list(xs.shape)],
        "x_dtypes": [_dtype_name(xs.dtype)],
        "y_shape": list(ys.shape),
        "y_dtype": _dtype_name(ys.dtype),
        "torch_version": torch.__version__,
        "kernel_library": os.path.basename(_build.library_path()),
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_sweep(path: str):
    """Load an exported sweep: returns (run, manifest).

    ``run(xs0, ys0)`` calls the saved program with no tracing of the
    solver; inputs are checked against the manifest first, so a wrong
    batch size, dtype or device fails with a clear message instead of an
    error from inside the program."""
    import riptrm_torch.ops.kernels  # noqa: F401  (defines the riptrm:: operators)

    program = torch.export.load(path).module()
    manifest = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            manifest = json.load(f)
        if manifest.get("torch_version") not in (None, torch.__version__):
            warnings.warn(f"artifact {path} was exported under torch "
                          f"{manifest['torch_version']}; running under {torch.__version__}")

    def run(xs0, ys0):
        if manifest:
            got = [list(xs0.shape), list(ys0.shape)]
            want = manifest["x_shapes"] + [manifest["y_shape"]]
            if got != want:
                raise ValueError(f"artifact {path} expects input shapes {want} "
                                 f"(batch={manifest['batch']}), got {got}")
            got_dt = [_dtype_name(xs0.dtype), _dtype_name(ys0.dtype)]
            want_dt = manifest["x_dtypes"] + [manifest["y_dtype"]]
            if got_dt != want_dt:
                raise ValueError(f"artifact {path} expects input dtypes {want_dt}, "
                                 f"got {got_dt}")
            got_dev = {str(xs0.device), str(ys0.device)}
            if got_dev != {manifest["device"]}:
                raise ValueError(f"artifact {path} runs on {manifest['device']}, "
                                 f"got inputs on {sorted(got_dev)}")
        return tuple(program(xs0, ys0))

    return run, manifest
