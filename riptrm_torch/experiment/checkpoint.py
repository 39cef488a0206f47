"""Checkpoint / resume.

Counterpart of ``riptrm_tpu/experiment/checkpoint.py``:

* solver level: a solver state (one of the port's state dataclasses, or a
  dict of arrays and states) is saved as an .npz keyed by field name under
  the JAX package's key names (``leaf.x``, ``leaf.h_lam``; ``leaf['a']``
  for a dict, ``leaf['state'].x`` for a state inside one, as a
  checkpointed sweep's carry holds it), with JSON metadata (elapsed time,
  log so far) inside the archive, so a host-driven run resumes mid-budget
  (``RIPTRM.run`` with ``checkpoint_path`` and ``resume``) and a
  checkpointed sweep resumes at its last segment
  (``parallel/sweep.py::run_sweep_checkpointed``);
* sweep level: the simulator skips (instance, initial point, solver) jobs
  whose log already exists (``skip_existing``), so multirun sweeps restart
  shard by shard.

The port's states carry a lane axis, the JAX host runner's do not: a
one-lane checkpoint written by the JAX package loads into a one-lane port
state (the lane axis added, a tuple point packed by ``manifold.pack``),
through ``solvers/base.py::state_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _fields(state, prefix="leaf"):
    """[(archive key, value)] of a state dataclass, or of a dict of arrays
    and state dataclasses (the keys of ``jax.tree_util.keystr``)."""
    if dataclasses.is_dataclass(state):
        return [(f"{prefix}.{f.name}", getattr(state, f.name))
                for f in dataclasses.fields(state)]
    if isinstance(state, dict):
        out = []
        for k, v in state.items():
            key = f"{prefix}[{k!r}]"
            out += _fields(v, key) if dataclasses.is_dataclass(v) else [(key, v)]
        return out
    raise TypeError(f"cannot checkpoint a {type(state).__name__}: a state dataclass "
                    "or a dict of arrays and states")


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _atomic_write(path: str, write_fn) -> None:
    dir_ = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".tmp")
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_state(path: str, state: Any, meta: Optional[dict] = None) -> None:
    """Atomically persist a solver state + metadata.

    The metadata sits INSIDE the npz (key ``__meta__``), so state and meta
    are one atomic ``os.replace``: a kill cannot leave a new state with
    stale or torn meta (resume accounting depends on it).  A ``.meta.json``
    sidecar is also written (atomically) for human inspection only.
    """
    arrays = {k: _numpy(v) for k, v in _fields(state)}
    arrays["__meta__"] = np.asarray(json.dumps(meta or {}))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    _atomic_write(path, write_npz)

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta or {}, f)

    _atomic_write(path + ".meta.json", write_meta)


def _stored(data, key, manifold):
    """The archive's value of field ``key``: one array, or the components
    ``key[0]``, ``key[1]``, ... of a JAX tuple point as a tuple."""
    if key in data:
        return data[key]
    parts = []
    while f"{key}[{len(parts)}]" in data:
        parts.append(data[f"{key}[{len(parts)}]"])
    if parts and manifold is None:
        raise ValueError(f"{key} is a tuple point: pass the manifold that packs it")
    return tuple(parts) if parts else None


def _legacy_keys(data, template_values):
    """Positional ``leaf_<i>`` keys of a pre-name-keying checkpoint, when its
    leaf count AND every leaf's shape match the template (a count alone is
    not identity: another layout with as many leaves would be silently
    misassigned); else None."""
    old = [f"leaf_{i}" for i in range(len(template_values))]
    n_old = sum(1 for k in data.files if k.startswith("leaf_") and k[5:].isdigit())
    if n_old == len(old) and all(
        k in data and data[k].shape == tuple(_numpy(v).shape)
        for k, v in zip(old, template_values)
    ):
        return old
    return None


def load_state(path: str, template: Any, manifold=None) -> Tuple[Any, dict]:
    """Restore a solver state with ``template``'s structure, dtypes and
    device -> (state, meta).

    A dataclass template gets torch tensors; a field stored without the
    template's lane axis (a JAX one-lane checkpoint) gets it back, and a
    tuple point is packed by ``manifold.pack``.  A dict template gets each
    entry in the kind of its template entry: a state, a tensor (the
    template's dtype and device) or a numpy array.  A checkpoint of another
    state layout raises ``ValueError``."""
    entries = _fields(template)
    keys = [k for k, _ in entries]
    with np.load(path) as data:
        stored = {k: _stored(data, k, manifold) for k in keys}
        missing = [k for k in keys if stored[k] is None]
        if missing:
            old = _legacy_keys(data, [v for _, v in entries])
            if old is None:
                raise ValueError(
                    f"checkpoint {path} lacks field(s) {missing}: it was saved by a "
                    "different solver-state layout and cannot be resumed"
                )
            stored = {k: data[o] for k, o in zip(keys, old)}
        meta = json.loads(str(data["__meta__"])) if "__meta__" in data else None
    if meta is None:  # legacy checkpoint: meta only in the sidecar
        meta = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
    if isinstance(template, dict):
        out = {}
        for k, v in template.items():
            key = f"leaf[{k!r}]"
            if dataclasses.is_dataclass(v):
                out[k] = _to_state(v, stored, manifold, key)
            elif isinstance(v, torch.Tensor):
                out[k] = torch.as_tensor(np.asarray(stored[key]), dtype=v.dtype,
                                         device=v.device)
            else:
                out[k] = np.asarray(stored[key], dtype=_numpy(v).dtype)
        return out, meta
    return _to_state(template, stored, manifold), meta


def _to_state(template, stored, manifold, prefix="leaf"):
    """A state of ``template``'s class from its stored fields, through
    ``base.state_from_numpy``: unbatched fields (a JAX host run's) become
    one lane; each field keeps the template's dtype and device."""
    from riptrm_torch.solvers.base import state_from_numpy

    d, unbatched = {}, []
    for f in dataclasses.fields(template):
        t = getattr(template, f.name)
        v = stored[f"{prefix}.{f.name}"]
        if isinstance(v, tuple):
            shape = tuple(manifold.pack(tuple(torch.as_tensor(np.asarray(a)) for a in v)).shape)
        else:
            shape = tuple(np.shape(v))
        unbatched.append(shape == tuple(t.shape[1:]) and tuple(t.shape[:1]) == (1,))
        shape = (1,) + shape if unbatched[-1] else shape
        if shape != tuple(t.shape):
            raise ValueError(f"checkpoint field {f.name} has shape {shape}, the state "
                             f"{tuple(t.shape)}: another problem or lane count")
        d[f.name] = v
    if any(unbatched) and not all(unbatched):
        raise ValueError("checkpoint mixes fields with and without a lane axis")
    scalar = next(f.name for f in dataclasses.fields(template)
                  if getattr(template, f.name).ndim == 1
                  and getattr(template, f.name).dtype.is_floating_point)
    ints = tuple(f.name for f in dataclasses.fields(template)
                 if not getattr(template, f.name).dtype.is_floating_point
                 and getattr(template, f.name).dtype != torch.bool)
    state = state_from_numpy(type(template), d, scalar_field=scalar, int_fields=ints,
                             device=template.x.device, dtype=template.x.dtype,
                             manifold=manifold)
    return type(template)(**{
        f.name: getattr(state, f.name).to(getattr(template, f.name).dtype)
        for f in dataclasses.fields(template)
    })


def job_done_marker(output_path: str, solver_display_name: str) -> str:
    return f"{output_path}/{solver_display_name}_log.csv"


def job_is_done(output_path: str, solver_display_name: str) -> bool:
    return os.path.exists(job_done_marker(output_path, solver_display_name))
