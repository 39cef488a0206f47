"""Inputs of a StableIdentification deployment, in NumPy on the host.

The instance is the upstream's shipped one (``dataset/StableIdentification/1``
of this repository: its ``config_dataset.yaml`` at seed 0), read from its
files and not drawn again: the noisy trajectories ``noisyX_<i>.csv`` and
the constraint set ``constset.csv``.  The random generator the harness
hands to ``instance`` is not used.

A point is (J, R, Q) on Product(Skew(d), SPD(d), SPD(d)), one start
[3, d, d].  The pool of starts: lane i is the shipped interior start
number i mod 20 (``initJ_a`` ... ``initQ_t``), unchanged for i < 20 and
perturbed for i >= 20.  A perturbation moves each block by a random
direction of its own kind (skew for J, symmetric for R and Q), scaled to
``perturbation`` (5 %) of that block's Frobenius norm, and a lane's draw
is repeated until the perturbed start is strictly inside all constraints
at their original parameters with R and Q positive definite.  Why so:

* the upstream's starts are interior points found by its generator, and
  the paper runs each of them; a sweep of many lanes repeats that
  experiment, so its starts stay interior points near the shipped ones
  rather than points of another distribution;
* 5 % moves every lane off its shipped start (no two lanes share a
  trajectory) while about half of the draws stay inside the constraints,
  the tightest of which leave little room around some starts;
* redrawing a lane, never clipping it, keeps each accepted start a plain
  sample of the perturbation conditioned on being interior.

(J - R) Q is Hurwitz for every R, Q > 0, so no stability test is needed.
"""

from __future__ import annotations

import numpy as np

STARTS = "abcdefghijklmnopqrst"
KIND_LS, KIND_RS, KIND_TWO = 0, 1, 2
MAX_ROUNDS = 200


def _dataset(cfg):
    from perfbench.harness import ROOT

    return ROOT / cfg["instance"]


def _csv(path):
    return np.loadtxt(path, ndmin=2)


def instance(rng: np.random.Generator, cfg: dict) -> dict:
    """{"trajectories": [len(x_set), d, N] noisy states, "constset": [rows,
    6] the upstream's constraint rows} from the shipped files."""
    del rng  # the instance is the shipped one
    path = _dataset(cfg)
    trajs = np.stack([_csv(path / f"noisyX_{i}.csv") for i in cfg["x_set"]])
    if trajs.shape[1:] != (cfg["dim"], cfg["N"]):
        raise ValueError(f"trajectories {trajs.shape}: expected d = {cfg['dim']}, "
                         f"N = {cfg['N']}")
    return {"trajectories": trajs, "constset": _csv(path / "constset.csv")}


def constraints(constset):
    """The constraint rows in the upstream's order (``coordinator.py``):
    (kinds, rows, cols, p1, p2).  A box row (type 0 or 1) gives
    -a + lo <= 0 and a - hi <= 0, an annulus row (type 2) -(a - c)^2 + k^2
    <= 0, with a = A[row, col]."""
    kinds, rows, cols, p1, p2 = [], [], [], [], []
    for t, r, c, a, b, *_ in np.atleast_2d(constset):
        r, c = int(r), int(c)
        if int(t) in (0, 1):
            kinds += [KIND_LS, KIND_RS]
            rows += [r, r]
            cols += [c, c]
            p1 += [a, 0.0]
            p2 += [0.0, b]
        elif int(t) == 2:
            kinds.append(KIND_TWO)
            rows.append(r)
            cols.append(c)
            p1.append(a)
            p2.append(b)
        else:
            raise ValueError(f"constraint type {t}")
    return (np.asarray(kinds), np.asarray(rows), np.asarray(cols), np.asarray(p1),
            np.asarray(p2))


def constraint_values(constset, points):
    """g [L, m] of points [L, 3, d, d]: feasible where <= 0."""
    kinds, rows, cols, p1, p2 = constraints(constset)
    a = ((points[:, 0] - points[:, 1]) @ points[:, 2])[:, rows, cols]
    return np.where(kinds == KIND_LS, -a + p1,
                    np.where(kinds == KIND_RS, a - p2, -(a - p1) ** 2 + p2 ** 2))


def shipped_starts(cfg) -> np.ndarray:
    """The upstream's 20 interior starts a-t, [20, 3, d, d]."""
    path = _dataset(cfg)
    return np.stack([np.stack([_csv(path / f"init{b}_{s}.csv") for b in "JRQ"])
                     for s in STARTS])


def _interior(constset, points):
    pd = np.all(np.linalg.eigvalsh(points[:, 1:]) > 0, axis=(1, 2))
    return pd & np.all(constraint_values(constset, points) < 0, axis=1)


def starts(rng: np.random.Generator, cfg: dict, count: int) -> np.ndarray:
    """``count`` strictly interior starts [count, 3, d, d] float64: the
    shipped starts in turn, perturbed from lane 20 on (the module's
    docstring)."""
    shipped = shipped_starts(cfg)
    constset = instance(None, cfg)["constset"]
    base = shipped[np.arange(count) % len(shipped)]
    out = base.copy()
    size = cfg["perturbation"] * np.linalg.norm(base, axis=(2, 3), keepdims=True)
    todo = np.arange(len(shipped), count)
    for _ in range(MAX_ROUNDS):
        if todo.size == 0:
            return out
        m = rng.standard_normal((todo.size, 3) + shipped.shape[2:])
        d = np.concatenate([m[:, :1] - m[:, :1].swapaxes(-1, -2),
                            m[:, 1:] + m[:, 1:].swapaxes(-1, -2)], axis=1)
        d *= size[todo] / np.linalg.norm(d, axis=(2, 3), keepdims=True)
        cand = base[todo] + d
        ok = _interior(constset, cand)
        out[todo[ok]] = cand[ok]
        todo = todo[~ok]
    raise ValueError(f"{todo.size} lanes found no interior start in {MAX_ROUNDS} rounds")
