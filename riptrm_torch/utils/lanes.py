"""Per-lane helpers over a leading lane axis: values [B, ...], per-lane
scalars and masks [B]; and ``lane_loop``, the lane-masked loop every
solver runs, which an exported program keeps as a ``while_loop``
operator."""

from __future__ import annotations

import dataclasses

import torch


def dot(u, v):
    """Inner product over the last axis, per lane: [B, n] x [B, n] -> [B]."""
    return torch.sum(u * v, dim=-1)


def mv(a, v):
    """Matrix-vector product per lane: [B, m, n] x [B, n] -> [B, m]."""
    return torch.einsum("bij,bj->bi", a, v)


def sym_mv(a, v):
    """A v per lane for a symmetric ``a`` shared by the lanes [n, n] or
    given per lane [B, n, n] (a structure's Zs under instance batching);
    ``v`` [B, n]."""
    return mv(a, v) if a.ndim == 3 else v @ a


def bcast(a, like):
    """A per-lane scalar or mask [B] shaped to broadcast against ``like``
    [B, ...]."""
    return a.reshape(a.shape + (1,) * (like.ndim - 1))


def where_lanes(mask, a, b):
    """``torch.where`` with a [B] mask over [B, ...] values."""
    return torch.where(bcast(mask, a), a, b)


def tracing() -> bool:
    """True while a program is being traced for export: under ``make_fx``
    (a proxy dispatch mode is set) or under dynamo.  Eagerly False."""
    if torch.compiler.is_compiling():
        return True
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    return get_proxy_mode() is not None


def _flatten(tree):
    """The tensors of a carry (tensors, tuples, lists, dicts and
    dataclasses of them) in order, and a function that rebuilds the carry
    from such a list."""
    leaves = []

    def spec(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return None
        if dataclasses.is_dataclass(t):
            return type(t), [(f.name, spec(getattr(t, f.name))) for f in dataclasses.fields(t)]
        if isinstance(t, dict):
            return dict, [(k, spec(v)) for k, v in t.items()]
        if isinstance(t, (tuple, list)):
            return type(t), [spec(a) for a in t]
        raise TypeError(f"a loop carry holds tensors, tuples, dicts and dataclasses, not "
                        f"{type(t)}")

    tree_spec = spec(tree)

    def rebuild(flat):
        it = iter(flat)

        def build(s):
            if s is None:
                return next(it)
            kind, parts = s
            if kind is dict:
                return {name: build(p) for name, p in parts}
            if dataclasses.is_dataclass(kind):
                return kind(**{name: build(p) for name, p in parts})
            return kind(build(p) for p in parts)

        return build(tree_spec)

    return leaves, rebuild


def _like(t, layout):
    """``t`` in the strides of ``layout``: the loop operator holds each
    carried tensor to one layout, and an iteration must compute on the
    layouts the eager loop sees (a reduction over a transposed operand sums
    in another order)."""
    if t.stride() == layout.stride():
        return t
    return torch.empty_strided(t.shape, layout.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def lane_loop(cond, body, carry, max_iters=None):
    """``while i < max_iters and cond(*carry): carry = body(i, *carry)``.

    ``carry`` is a tuple of tensors, tuples, dicts and dataclasses of
    tensors with fixed shapes and dtypes; ``cond(*carry)`` gives a 0-d bool
    tensor (in a lane-batched loop: some lane still runs), ``body(i,
    *carry)`` the next carry, ``i`` the iteration from 0.  Eagerly this is a Python loop with
    one host check of ``cond`` an iteration, ``i`` a Python int.  Under
    tracing (``tracing()``) it is one ``while_loop`` operator whose ``i`` is
    a 0-d int64 tensor, so an exported program keeps the loop and its
    data-dependent end."""
    if not tracing():
        i = 0
        while max_iters is None or i < max_iters:
            if not bool(cond(*carry)):
                break
            carry = body(i, *carry)
            i += 1
        return carry
    from torch._higher_order_ops.while_loop import while_loop_op

    flat, rebuild = _flatten(tuple(carry))
    # an empty tensor's strides are arbitrary (an expanded empty cache has
    # (0, 1), the one an iteration makes (1, 1)): give it a new tensor's
    flat = [t.new_empty(t.shape) if t.numel() == 0 else t for t in flat]
    i0 = torch.zeros((), dtype=torch.int64, device=flat[0].device)

    def cond_flat(i, *leaves):
        go = cond(*rebuild(leaves))
        return go if max_iters is None else go & (i < max_iters)

    def body_flat(i, *leaves):
        out, _ = _flatten(tuple(body(i, *rebuild(leaves))))
        out = [_like(o, a) for o, a in zip(out, leaves)]
        # the operator refuses an output that aliases an input
        out = [o.clone() if any(o is a for a in leaves) else o for o in out]
        return (i + 1, *out)

    return rebuild(while_loop_op(cond_flat, body_flat, (i0, *flat), ())[1:])
