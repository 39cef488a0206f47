"""The port's single-card sweep and solve API against ``riptrm_tpu``.

``RIPTRM.solve_compiled(return_done=True)``, ``batched_riptrm_continue``,
``run_sweep``, ``make_segment_solver``, ``_sweep_identity`` and
``run_sweep_checkpointed``, on the CPU in float64: a spiked NonnegPCA
instance (n = 16) and four feasible starts made with numpy from a seed go
through both packages.  Steps must be equal and final points within
atol 1e-7; the final residuals (~9e-6, the lanes stop at tolresid 1e-5)
within rtol 1e-2, because there the residual itself moves by ~3e-3
(relative) under a 1e-13 change of the state (measured: the port resumed
from the JAX package's segment against its own uninterrupted sweep).  The
port's segmented sweeps must equal its unsegmented sweep bit for bit.  Also the
checkpointed sweep on StableIdentification's packed (J, R, Q) points (d =
3, the JAX package's own payload), and a sweep checkpoint written by the
JAX package resumed in the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.parallel import sweep as ts
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.parallel import sweep as js
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import riptrm as jrm

torch.set_num_threads(1)

N, B = 16, 4
OPT = {"maxiter": 30, "tolresid": 1e-5, "TRS_solver": "tCG",
       "second_order_stationarity": False}
MAX_STEPS = 300


def spiked(rng, n):
    """NonnegPCA's spiked Z (the generators' distribution), from numpy."""
    v = (rng.permutation(n) < int(0.7 * n)) / np.sqrt(int(0.7 * n))
    return np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((n, n)) / np.sqrt(n)


def starts(rng, b, n):
    xs = np.abs(rng.standard_normal((b, n))) + 0.01
    return xs / np.linalg.norm(xs, axis=1, keepdims=True), np.ones((b, n))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    z = spiked(rng, N)
    xs, ys = starts(rng, B, N)
    return tn.make_problem(z, xs[0], device="cpu"), jn.make_problem(z, xs[0]), xs, ys


def _state(problem, option, xs, ys):
    return ts.init_state_from(problem, trm.RIPTRM(option).option, torch.tensor(xs),
                              torch.tensor(ys))


def test_solve_compiled_return_done_matches_jax(setup):
    """The stop flag tells lanes that met their criterion from lanes that
    ran out of steps, as the JAX flag does."""
    tp, jp, xs, ys = setup
    steps = 40  # some lanes stop within it, others run out
    st, k, done = trm.RIPTRM(OPT).solve_compiled(tp, steps, return_done=True)(
        _state(tp, OPT, xs, ys))
    solver = jrm.RIPTRM(OPT)
    solve = solver.solve_compiled(jp, steps, return_done=True)
    jst, jk, jdone = js.jax.jit(js.jax.vmap(
        lambda x, y: solve(js.init_state_from(jp, solver.option, x, y))))(
        jnp.asarray(xs), jnp.asarray(ys))
    assert k.tolist() == np.asarray(jk).tolist()
    assert done.tolist() == np.asarray(jdone).tolist()
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=1e-8, atol=1e-9)
    st2, k2 = trm.RIPTRM(OPT).solve_compiled(tp, steps)(_state(tp, OPT, xs, ys))
    assert torch.equal(st2.x, st.x) and torch.equal(k2, k)


def test_continue_matches_jax(setup):
    """Phase 2 from the JAX package's phase-1 states: re-seeded counters and
    anchors, best point kept, in both packages."""
    tp, jp, xs, ys = setup
    opt1 = OPT | {"tolresid": 1e-3}
    opt2 = OPT | {"tolresid": 1e-5}
    jst1, _, _ = js.batched_riptrm_solve(jp, opt1, MAX_STEPS)(jnp.asarray(xs), jnp.asarray(ys))
    jst2, jk2, jres2 = js.batched_riptrm_continue(jp, opt2, MAX_STEPS)(jst1)
    st1 = trm.state_from_numpy(js.jax.device_get(jst1)._asdict(), device="cpu")
    st2, k2, res2 = ts.batched_riptrm_continue(tp, opt2, MAX_STEPS)(st1)
    assert k2.tolist() == np.asarray(jk2).tolist()
    np.testing.assert_allclose(res2.numpy(), np.asarray(jres2), rtol=1e-2)
    np.testing.assert_allclose(st2.x.numpy(), np.asarray(jst2.x), atol=1e-7)
    assert torch.all(st2.outer_iter <= opt2["maxiter"])


class _TpOnlyMesh:
    """A mesh with a tp axis only: the sweeps' dp axis is missing (the
    sharded paths themselves are tests/test_torch_distributed.py's)."""

    mesh_dim_names, shape = ("tp",), (1,)


def test_run_sweep_matches_jax_and_takes_lists(setup):
    tp, jp, xs, ys = setup
    x, y, k, res = ts.run_sweep(tp, OPT, xs, ys, max_steps=MAX_STEPS)
    jx, jy, jk, jres = js.run_sweep(jp, OPT, jnp.asarray(xs), jnp.asarray(ys),
                                    max_steps=MAX_STEPS)
    assert k.tolist() == np.asarray(jk).tolist()
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-2)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-7)
    x2, _, k2, _ = ts.run_sweep(tp, OPT, list(xs), ys, max_steps=MAX_STEPS)
    assert torch.equal(x2, x) and torch.equal(k2, k)
    with pytest.raises(ValueError, match="no axis 'dp'"):
        ts.run_sweep(tp, OPT, xs, ys, max_steps=MAX_STEPS, mesh=_TpOnlyMesh())


def test_segment_solver_freezes_done_lanes(setup):
    """A lane flagged done passes through bit for bit with 0 steps; the
    others stop on the solve's own flag."""
    tp, _, xs, ys = setup
    st0 = _state(tp, OPT, xs, ys)
    done = torch.tensor([True, False, True, False])
    st, k, res, new_done = ts.make_segment_solver(tp, OPT, 25)(st0, done)
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(st0, f.name)
        assert torch.equal(a[done], b[done]), f.name
    assert k[done].tolist() == [0, 0] and bool(new_done[done].all())
    ref, rk, rdone = trm.RIPTRM(OPT).solve_compiled(tp, 25, return_done=True)(st0)
    assert torch.equal(st.x[~done], ref.x[~done]) and torch.equal(k[~done], rk[~done])
    assert torch.equal(new_done[~done], rdone[~done])


@pytest.mark.parametrize("fused", [False, True])
def test_sweep_identity_matches_jax(setup, fused):
    """The same starts, options and dimensions hash to the same id in both
    packages; use_fused_tcg is hashed under its JAX name use_pallas_tcg."""
    tp, jp, xs, ys = setup
    opt = OPT | {"sweep_stall_window": 25}
    tid = ts._sweep_identity(tp, trm.RIPTRM(opt | {"use_fused_tcg": fused}).option,
                             torch.tensor(xs), torch.tensor(ys))
    jid = js._sweep_identity(jp, jrm.RIPTRM(opt | {"use_pallas_tcg": fused}).option,
                             jnp.asarray(xs), jnp.asarray(ys))
    assert tid == jid
    other = ts._sweep_identity(tp, trm.RIPTRM(opt).option, torch.tensor(xs[::-1].copy()),
                               torch.tensor(ys))
    assert other != tid or fused  # another sweep, another id


def test_identity_option_lists_cover_the_defaults():
    """Renamed, port-only and JAX-only keys: after the rename the port's
    default options and the JAX package's have one key set."""
    port = {ts._JAX_OPTION_NAMES.get(k, k) for k in trm.default_option()
            if k not in ts._PORT_ONLY_OPTIONS}
    jax_keys = set(jrm.default_option())
    assert port | set(ts._JAX_ONLY_DEFAULTS) == jax_keys
    for k, v in ts._JAX_ONLY_DEFAULTS.items():
        assert repr(jrm.default_option()[k]) == repr(v)


def test_checkpointed_sweep_resume(setup, tmp_path):
    """Killed after its first segment and rerun from the file, the sweep
    equals the uninterrupted one bit for bit; a finished sweep's resume is
    a no-op."""
    tp, _, xs, ys = setup
    ckpt = str(tmp_path / "sweep.npz")
    x_ref, _, ks_ref, res_ref = ts.run_sweep_checkpointed(
        tp, OPT, xs, ys, max_steps=MAX_STEPS, segment_steps=20)
    assert torch.all(res_ref <= OPT["tolresid"])

    class Kill(Exception):
        pass

    def killer(n_seg, steps, res, done):
        if n_seg == 1:
            raise Kill

    with pytest.raises(Kill):
        ts.run_sweep_checkpointed(tp, OPT, xs, ys, max_steps=MAX_STEPS, segment_steps=20,
                                  checkpoint_path=ckpt, on_segment=killer)
    segs = []
    x2, _, ks2, res2 = ts.run_sweep_checkpointed(
        tp, OPT, xs, ys, max_steps=MAX_STEPS, segment_steps=20, checkpoint_path=ckpt,
        on_segment=lambda n, s, r, d: segs.append(n))
    assert segs[0] == 2  # resumed, not restarted
    assert torch.equal(x2, x_ref) and torch.equal(ks2, ks_ref) and torch.equal(res2, res_ref)
    x3, _, ks3, res3 = ts.run_sweep_checkpointed(
        tp, OPT, xs, ys, max_steps=MAX_STEPS, segment_steps=20, checkpoint_path=ckpt)
    assert torch.equal(x3, x_ref) and torch.equal(ks3, ks_ref)
    np.testing.assert_allclose(res3.numpy(), res_ref.numpy(), rtol=1e-12)


def test_checkpointed_sweep_exact_budget_and_segment_boundary(setup):
    """The budget is exact (the last segment truncated) and any segment
    size gives the unsegmented sweep, also where lanes stop on a segment's
    last step (segment 1)."""
    tp, jp, xs, ys = setup
    tight = OPT | {"tolresid": 1e-7}  # no lane stops within 50 steps
    _, _, ks, _ = ts.run_sweep_checkpointed(tp, tight, xs, ys, max_steps=50, segment_steps=20)
    assert int(ks.max()) == 50  # not rounded up to 60
    _, _, jks, _ = js.run_sweep_checkpointed(jp, tight, jnp.asarray(xs), jnp.asarray(ys),
                                             max_steps=50, segment_steps=20)
    assert ks.tolist() == np.asarray(jks).tolist()
    x_ref, _, ks_ref, _ = ts.run_sweep_checkpointed(tp, OPT, xs, ys, max_steps=MAX_STEPS,
                                                    segment_steps=MAX_STEPS)
    for seg in (1, 20, 23):
        x2, _, ks2, _ = ts.run_sweep_checkpointed(tp, OPT, xs, ys, max_steps=MAX_STEPS,
                                                  segment_steps=seg)
        assert torch.equal(ks2, ks_ref), seg
        assert torch.equal(x2, x_ref), seg


def test_checkpoint_identity_mismatch_refuses_resume(setup, tmp_path):
    tp, _, xs, ys = setup
    ckpt = str(tmp_path / "sweep.npz")
    kw = dict(max_steps=40, segment_steps=20, checkpoint_path=ckpt)
    ts.run_sweep_checkpointed(tp, OPT, xs, ys, **kw)
    with pytest.raises(ValueError, match="sweep_id"):
        ts.run_sweep_checkpointed(tp, OPT, np.roll(xs, 1, axis=0), ys, **kw)
    with pytest.raises(ValueError, match="sweep_id"):
        ts.run_sweep_checkpointed(tp, OPT | {"tolresid": 1e-8}, xs, ys, **kw)
    ts.run_sweep_checkpointed(tp, OPT, xs, ys, **kw)  # the same sweep resumes
    with pytest.raises(ValueError, match="no axis 'dp'"):
        ts.run_sweep_checkpointed(tp, OPT, xs, ys, max_steps=40, mesh=_TpOnlyMesh())


def test_jax_sweep_checkpoint_resumes_in_port(setup, tmp_path):
    """A checkpoint that ``riptrm_tpu``'s sweep wrote after its first
    segment (keys ``leaf['state'].x``, ``leaf['done']``, ``leaf['ks']``)
    resumes in the port, which finishes as its uninterrupted sweep does."""
    tp, jp, xs, ys = setup
    ckpt = str(tmp_path / "jax.npz")

    class Kill(Exception):
        pass

    def killer(n_seg, steps, res, done):
        raise Kill

    with pytest.raises(Kill):
        js.run_sweep_checkpointed(jp, OPT, jnp.asarray(xs), jnp.asarray(ys),
                                  max_steps=MAX_STEPS, segment_steps=20,
                                  checkpoint_path=ckpt, on_segment=killer)
    with np.load(ckpt) as data:
        assert {"leaf['state'].x", "leaf['done']", "leaf['ks']"} <= set(data.files)
    segs = []
    x, _, ks, res = ts.run_sweep_checkpointed(
        tp, OPT, xs, ys, max_steps=MAX_STEPS, segment_steps=20, checkpoint_path=ckpt,
        on_segment=lambda n, s, r, d: segs.append(n))
    x_ref, _, ks_ref, res_ref = ts.run_sweep_checkpointed(tp, OPT, xs, ys,
                                                          max_steps=MAX_STEPS,
                                                          segment_steps=20)
    assert segs[0] == 2  # resumed from the JAX package's segment 1
    assert ks.tolist() == ks_ref.tolist()
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), atol=1e-7)
    np.testing.assert_allclose(res.numpy(), res_ref.numpy(), rtol=1e-2)


def test_checkpointed_sweep_packed_points(tmp_path):
    """StableIdentification's (J, R, Q) starts, given as the JAX package's
    tuple of stacked components, are packed into the port's [B, 3, d, d]
    and map lane by lane; the sweep agrees with the JAX one and both stamp
    the same identity."""
    from riptrm_torch.problems import stable_identification as tsi
    from riptrm_tpu.experiment.chip_sweep import _cache_load, _generate_payload
    from riptrm_tpu.problems import stable_identification as jsi

    payload = (_cache_load("StableIdentification", 3, 2, 1)
               or _generate_payload("StableIdentification", 3, 2, 1))
    comps = (payload["b_J"], payload["b_R"], payload["b_Q"])
    x0 = tuple(a[0] for a in comps)
    args = (3, list(payload["trajs"]), payload["constset"], x0)
    jprob, tprob = jsi.make_problem(*args), tsi.make_problem(*args, device="cpu")
    jxs = tuple(jnp.asarray(a) for a in comps)
    jys = jnp.ones((2, jprob.num_ineq))
    opt = {"maxiter": 10, "tolresid": 1e-4, "TRS_solver": "tCG",
           "second_order_stationarity": False}
    tuple_xs = tuple(np.asarray(a) for a in jxs)
    x, y, ks, res = ts.run_sweep_checkpointed(tprob, opt, tuple_xs, np.asarray(jys),
                                              max_steps=60, segment_steps=25,
                                              checkpoint_path=str(tmp_path / "si.npz"))
    assert x.shape == (2, 3, 3, 3) and torch.all(torch.isfinite(res))
    jx, _, jks, jres = js.run_sweep_checkpointed(jprob, opt, jxs, jys, max_steps=60,
                                                 segment_steps=25)
    # StableIdentification's tCG boundary test flips between the packages
    # after ~10 steps (ROADMAP queue 3's known behaviours), and (J, R, Q)
    # is determined only through A = (J - R) Q: steps within the JAX
    # package's own cross-compilation rule, residuals within rtol 1e-3, and
    # A on lanes that took the same steps
    for i in range(2):
        assert abs(int(ks[i]) - int(jks[i])) <= 0.05 * int(jks[i]) + 3
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-3)
    tj, tr, tq = (a.numpy() for a in tprob.manifold.unpack(x))
    jj, jr, jq = (np.asarray(a) for a in jx)
    same = [i for i in range(2) if int(ks[i]) == int(jks[i])]
    assert same
    for i in same:
        np.testing.assert_allclose((tj[i] - tr[i]) @ tq[i], (jj[i] - jr[i]) @ jq[i], atol=1e-6)
    tid = ts._sweep_identity(tprob, trm.RIPTRM(opt).option,
                             ts._as_stacked_points(tprob, tuple_xs), torch.tensor(np.asarray(jys)))
    assert tid == js._sweep_identity(jprob, jrm.RIPTRM(opt).option, jxs, jys)


def test_legacy_checkpoint_resumes_with_a_warning(setup, tmp_path):
    """A checkpoint with no sweep identity and no ``steps_done`` (an older
    writer's) resumes with a warning, its budget counted as its segments
    times its own segment size; the result is the uninterrupted sweep's."""
    from riptrm_torch.experiment.checkpoint import load_state, save_state

    tp, _, xs, ys = setup
    ckpt = str(tmp_path / "legacy.npz")
    kw = dict(max_steps=MAX_STEPS, segment_steps=20)

    class Kill(Exception):
        pass

    def killer(n_seg, steps, res, done):
        raise Kill

    with pytest.raises(Kill):
        ts.run_sweep_checkpointed(tp, OPT, xs, ys, checkpoint_path=ckpt, on_segment=killer,
                                  **kw)
    carry0 = {"state": _state(tp, OPT, xs, ys), "done": torch.zeros(B, dtype=torch.bool),
              "ks": torch.zeros(B, dtype=torch.int64)}
    carry, meta = load_state(ckpt, carry0)
    assert meta["steps_done"] == 20 and meta["sweep_id"]
    save_state(ckpt, carry, {"segments_done": 1, "segment_steps": 20})
    segs = []
    with pytest.warns(UserWarning, match="legacy checkpoint"):
        x, _, ks, _ = ts.run_sweep_checkpointed(
            tp, OPT, xs, ys, checkpoint_path=ckpt,
            on_segment=lambda n, s, r, d: segs.append((n, s)), **kw)
    assert segs[0] == (2, 40)
    x_ref, _, ks_ref, _ = ts.run_sweep_checkpointed(tp, OPT, xs, ys, **kw)
    assert torch.equal(x, x_ref) and torch.equal(ks, ks_ref)
