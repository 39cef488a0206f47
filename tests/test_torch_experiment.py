"""The port's experiment layer against ``riptrm_tpu``'s, on the CPU.

(a) ``cfg``: the JAX ``tests/test_experiment.py`` config cases; the
    port's YAML reader equal to ``yaml.safe_load`` on every file under
    ``configs/``; ``load_config`` and ``sweep_configs`` equal to the JAX
    package's on every shipped config, with and without overrides;
(b) ``simulate`` of NonnegPCA (maxiter 3, float64) in both packages: the
    same CSV files, the same log columns in the same order, the same empty
    cells, residuals to rtol 1e-6; the Rosenbrock log (callback columns);
(c) the block-file round trip of a StableIdentification point, and the
    strict-complementarity post-check on it in both packages;
(d) the analyzers' numbers on the same CSVs, equal; the figures render;
(e) ``generate``: its instances load, it refuses an existing instance
    without ``--overwrite``; the CLIs refuse to run without CUDA unless
    given ``--device cpu``;
(f) ``benchmark`` at a tiny budget (restartable, host-sharded);
(g) the wandb hooks' fallback (wandb is not installed).
"""

import csv
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from riptrm_torch.experiment import analyzer as ta
from riptrm_torch.experiment import cfg as tcfg
from riptrm_torch.experiment import simulator as tsim
from riptrm_tpu.experiment import analyzer as ja
from riptrm_tpu.experiment import cfg as jcfg
from riptrm_tpu.experiment import simulator as jsim

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))


# -- (a) cfg ---------------------------------------------------------------
def test_config_interpolation(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text(
        "problem_name: Foo\nproblem_instance: 3\n"
        "output_path: intermediate/${problem_name}/${problem_instance}\n"
        "tol: 1e-8\n"
    )
    cfg = tcfg.load_config(str(p))
    assert cfg.output_path == "intermediate/Foo/3"
    assert cfg.tol == 1e-8  # YAML-1.1 '1e-8' string coerced to float


def test_config_overrides(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a: 1\nnested:\n  b: 2\n")
    cfg = tcfg.load_config(str(p), ["a=5", "nested.b=7", "new.key=hello"])
    assert cfg.a == 5 and cfg.get_path("nested.b") == 7
    assert cfg.get_path("new.key") == "hello"


def test_sweep_cross_product(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("problem_name: X\nsweeper:\n  params:\n    inst: 1,2,3\n    pt: a,b\n")
    cfgs = tcfg.sweep_configs(str(p))
    assert len(cfgs) == 6
    assert {(c.inst, c.pt) for c in cfgs} == {(i, p_) for i in (1, 2, 3) for p_ in ("a", "b")}


def test_sweep_interpolation_after_sweep_values(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("problem_name: X\npt: a\nout: inter/${pt}\nsweeper:\n  params:\n    pt: a,b,c\n")
    assert sorted(c.out for c in tcfg.sweep_configs(str(p))) == ["inter/a", "inter/b", "inter/c"]


def test_sweep_cli_override_axis(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("problem_name: X\n")
    assert len(tcfg.sweep_configs(str(p), ["pt=a,b,c"])) == 3


def test_sweep_single_value_pins_axis(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("problem_name: X\nsweeper:\n  params:\n    pt: a,b,c\n    inst: 1,2\n")
    cfgs = tcfg.sweep_configs(str(p), ["pt=b"])
    assert len(cfgs) == 2
    assert all(c.pt == "b" for c in cfgs)
    assert sorted(c.inst for c in cfgs) == [1, 2]


def test_solver_option_merge():
    cfg = tcfg.load_config(os.path.join(REPO, "configs/NonnegPCA/config_simulation.yaml"))
    opt = tcfg.solver_options_from_cfg(cfg, "RIPTRM")
    assert opt["maxtime"] == 240
    assert opt["TRS_solver"] == "tCG"
    assert opt["second_order_stationarity"] is False
    assert tcfg.solver_options_from_cfg(cfg, "RSQO")["quadoptim_eigvalcorr"] == 1e-2


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert tcfg.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "1", "1e-2", "1.0e-2", ".5", "0x1F", "010", "-3", "1_000", "+.inf", "true", "on", "No",
    "~", "null", "[a, 1, 2.5]", '["a","b"]', "'x y'", "'it''s'", '"a\\"b"', "[RIPTRM]",
    "[]", "[[1, 2], [3]]", "/tmp/x", "a,b", "1e+20", "-1.5e+3",
])
def test_yaml_scalars_match_pyyaml(text):
    a, b = tcfg._value(text), yaml.safe_load(text)
    assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))
    assert type(a) is type(b)


@pytest.mark.parametrize("text", ["- a\n- b\n", "a: &x 1\n", "a: {b: 1}\n", "a: |\n  x\n"])
def test_yaml_reader_refuses_other_constructs(text):
    with pytest.raises(ValueError, match="subset|mapping"):
        tcfg.safe_load(text)


OVERRIDES = [
    [],
    ["solver_option.common.maxiter=3", "output_path=/tmp/x/${problem_name}"],
    ["problem_initialpoint=a,b", "solver_name=[RIPTRM,RIPM]"],
]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_load_and_sweep_match_jax(path):
    for ov in OVERRIDES:
        single = [o for o in ov if "," not in o.split("=", 1)[1] or "[" in o]
        assert tcfg.load_config(path, single) == jcfg.load_config(path, single)
        assert tcfg.sweep_configs(path, ov) == jcfg.sweep_configs(path, ov)


# -- (b) simulate ------------------------------------------------------------
def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _simulate_both(tmp_path, monkeypatch, problem, solvers, maxiter):
    monkeypatch.chdir(REPO)
    args = ["--problem", problem, f"solver_name=[{','.join(solvers)}]",
            f"solver_option.common.maxiter={maxiter}"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsim.main(args + [f"output_path={jdir}"])
    tsim.main(args + [f"output_path={tdir}", "--device", "cpu"])
    return jdir, tdir


def _same_logs(jdir, tdir, rtol):
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for f in sorted(os.listdir(jdir)):
        if not f.endswith("_log.csv"):
            continue
        j, t = _rows(f"{jdir}/{f}"), _rows(f"{tdir}/{f}")
        assert j[0] == t[0], f  # columns, name for name, in order
        assert len(j) == len(t), f
        for rj, rt in zip(j[1:], t[1:]):
            # the same empty cells and the same booleans
            assert [c == "" for c in rj] == [c == "" for c in rt], f
            assert ([c in ("True", "False") for c in rj]
                    == [c in ("True", "False") for c in rt]), f
        i = j[0].index("residual")
        np.testing.assert_allclose([float(r[i]) for r in t[1:]], [float(r[i]) for r in j[1:]],
                                   rtol=rtol, err_msg=f)


def test_simulate_matches_jax(tmp_path, monkeypatch):
    """The parity case (RIPTRM, maxiter 3) plus the three baseline
    solvers: every output file, every log column."""
    jdir, tdir = _simulate_both(tmp_path, monkeypatch, "NonnegPCA",
                                ["RIPTRM", "RIPM", "RSQO", "RALM"], 3)
    _same_logs(jdir, tdir, rtol=1e-6)
    for name in ("RIPTRM_tCG", "RSQO_reghess_corr1e-02"):
        xj = np.loadtxt(f"{jdir}/{name}_x.csv")
        xt = np.loadtxt(f"{tdir}/{name}_x.csv")
        np.testing.assert_allclose(xt, xj, rtol=1e-6, atol=1e-12)
        assert abs(np.linalg.norm(xt) - 1) < 1e-10
    # the option table: the same columns, but for the renamed fused-tCG key
    j, t = (_rows(f"{d}/RIPTRM_tCG_option.csv")[0] for d in (jdir, tdir))
    assert [c.replace("use_pallas_tcg", "use_fused_tcg") for c in j] == t


def test_simulate_rosenbrock_callback_columns(tmp_path, monkeypatch):
    """Rosenbrock's callback adds second_order_residual and
    condition_number to every evaluation: they sit among the sorted
    evaluation columns, as in the JAX log."""
    jdir, tdir = _simulate_both(tmp_path, monkeypatch, "Rosenbrock", ["RSQO"], 2)
    _same_logs(jdir, tdir, rtol=1e-6)
    assert "second_order_residual" in _rows(f"{tdir}/RSQO_reghess_corr1e-02_log.csv")[0]


def test_simulate_skip_existing(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    out = str(tmp_path / "o")
    args = ["--problem", "NonnegPCA", "solver_name=[RSQO]", "solver_option.common.maxiter=1",
            f"output_path={out}", "--device", "cpu"]
    tsim.main(args)
    log = f"{out}/RSQO_reghess_corr1e-02_log.csv"
    os.utime(log, (0, 0))
    tsim.main(args + ["skip_existing=true"])
    assert os.path.getmtime(log) == 0


# -- (c) block files ------------------------------------------------------------
@pytest.fixture(scope="module")
def sid():
    from riptrm_torch.problems import stable_identification as tsi
    from riptrm_tpu.problems import stable_identification as jsi

    path = os.path.join(REPO, "dataset/StableIdentification/1")
    return path, jsi.load_problem(path, "a"), tsi.load_problem(path, "a", device="cpu")


def test_block_file_roundtrip_of_a_product_point(tmp_path, sid):
    """The port's packed [3, d, d] point is written in the JAX layout: one
    ``# block d d`` per component, read back by either package."""
    from riptrm_torch.solvers.base import Output as TOutput
    from riptrm_tpu.solvers.base import Output as JOutput

    _, jp, tp = sid
    y = np.ones(tp.num_ineq)
    tout = TOutput(name="S", x=tp.x0, ineqLagmult=torch.as_tensor(y), eqLagmult=np.zeros(0),
                   option={"a": 1, "b": None, "c": [2]}, log={"r": [1.0, 0.5]})
    jout = JOutput(name="S", x=tuple(np.asarray(a) for a in jp.x0), ineqLagmult=y,
                   eqLagmult=np.zeros(0), option={"a": 1, "b": None, "c": [2]},
                   log={"r": [1.0, 0.5]})
    tsim.save_output(str(tmp_path / "t"), "S", tout, manifold=tp.manifold)
    jsim.save_output(str(tmp_path / "j"), "S", jout)
    for f in ("S_x.csv", "S_ineqLagmult.csv", "S_option.csv", "S_log.csv"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text(), f
    blocks = tsim.load_block_file(str(tmp_path / "t" / "S_x.csv"))
    for b, a in zip(blocks, tp.manifold.unpack(tp.x0)):
        np.testing.assert_array_equal(b, a.numpy())
    assert [b.shape for b in jsim.load_block_file(str(tmp_path / "t" / "S_x.csv"))] == [
        (5, 5)] * 3


def test_strict_complementarity_matches_jax(tmp_path, sid):
    path, jp, tp = sid
    g = np.asarray(jp.ineq_val(jp.x0))
    y = np.ones(tp.num_ineq)
    near = int(np.argmin(np.abs(g)))
    y[near] = 0.0
    tol = abs(g[near]) + 1e-12
    jx = tuple(np.asarray(a) for a in jp.x0)
    assert list(ta.strict_complementarity(tp, jx, y, tol)) == list(
        ja.strict_complementarity(jp, jp.x0, y, tol)) == [near]
    out_dir = tmp_path / "1" / "a"
    from riptrm_torch.solvers.base import Output

    tsim.save_output(str(out_dir), "S", Output(name="S", x=tp.x0, ineqLagmult=torch.as_tensor(y),
                                               eqLagmult=np.zeros(0), option={}, log={}),
                     manifold=tp.manifold)
    t = ta.check_strict_complementarity_outputs(path, str(tmp_path), 1, ["a"], ["S"],
                                                tol=tol, device="cpu")
    j = ja.check_strict_complementarity_outputs(path, str(tmp_path), 1, ["a"], ["S"], tol=tol)
    assert list(t[("S", "a")]) == list(j[("S", "a")]) == [near]


# -- (d) analyzers --------------------------------------------------------------
def _synthetic_logs(root):
    rng = np.random.default_rng(0)
    for pt in ("a", "b", "c"):
        d = root / "P" / "1" / pt
        d.mkdir(parents=True)
        n = 40
        with open(d / "RIPTRM_tCG_log.csv", "w") as f:
            f.write("iteration,time,residual,second_order_residual,inner_status\n")
            for i in range(n):
                status = "" if i == 0 else rng.choice(["converged", "successful", "unsuccessful"])
                res = "" if i == 7 else repr(10.0 * 0.7 ** i * rng.uniform(0.5, 2))
                f.write(f"{i},{12.0 * i},{res},{(-1) ** i * 0.5 ** i},{status}\n")
        with open(d / "RSQO_reghess_corr1e-02_log.csv", "w") as f:
            f.write("iteration,time,residual,second_order_residual\n")
            for i in range(n):
                f.write(f"{i},{10.0 * i},{0.5 ** i},{-(0.5 ** i)}\n")
    return root / "P"


def test_analyzers_agree(tmp_path):
    root = _synthetic_logs(tmp_path)
    names = ["RIPTRM_tCG", "RSQO_reghess_corr1e-02"]
    for pt in ("a", "b", "c"):
        for name in names:
            tl, jl = ta.load_log(f"{root}/1/{pt}", name), ja.load_log(f"{root}/1/{pt}", name)
            assert list(tl) == list(jl.columns)
            tf, jf = ta.filter_riptrm_rows(tl), ja.filter_riptrm_rows(jl)
            np.testing.assert_array_equal(tf["time"], jf["time"].to_numpy())
            for budget in (0.0, 100.0, 240.0, 1e9):
                # pandas' default CSV float parser is not round-trip exact
                # (one ulp off), Python's float() is: rtol 1e-15
                a, b = ta.best_residual_within(tf, budget), ja.best_residual_within(jf, budget)
                assert a == pytest.approx(b, rel=1e-15, nan_ok=True)
    # the box plot's numbers (the JAX function returns them beside its figure)
    _, jdata = ja.box_plot_best_residuals(str(root), 1, ["a", "b", "c"], names)
    tdata = ta.best_residuals(str(root), 1, ["a", "b", "c"], names)
    assert tdata.keys() == jdata.keys()
    for k in tdata:
        np.testing.assert_allclose(tdata[k], jdata[k], rtol=1e-15)


def test_analyzer_plots_and_cli(tmp_path, monkeypatch):
    from riptrm_torch.experiment import analyze

    root = _synthetic_logs(tmp_path)
    out_dir = f"{root}/1/a"
    f1, f2 = str(tmp_path / "res.png"), str(tmp_path / "so.png")
    ta.plot_residual_curves(out_dir, ["RIPTRM_tCG"], save_path=f1)
    ta.plot_second_order_curves(out_dir, ["RIPTRM_tCG"], save_path=f2)
    assert all(os.path.getsize(f) > 1000 for f in (f1, f2))
    os.makedirs(tmp_path / "intermediate")
    os.rename(root, tmp_path / "intermediate" / "Rosenbrock")
    monkeypatch.chdir(tmp_path)
    analyze.main(["--problem", "Rosenbrock", "--initialpoints", "a,b,c"])
    assert sorted(os.listdir(tmp_path / "result" / "torch" / "Rosenbrock")) == [
        "box_1.png", "residual_1_a.png", "second_order_1_a.png"]


# -- (e) generate, devices -------------------------------------------------------
def test_generate_and_load(tmp_path, monkeypatch):
    from riptrm_torch.experiment import generate
    from riptrm_torch.problems import low_rank, nonneg_pca

    monkeypatch.chdir(REPO)
    out = str(tmp_path / "pca")
    generate.main(["--problem", "NonnegPCA", "dim=12", f"output_path={out}", "--device", "cpu"])
    p = nonneg_pca.load_problem(out, "a", device="cpu")
    assert p.num_ineq == 12 and bool((p.ineq_val(p.x0[None]) <= 0).all())
    first = np.loadtxt(f"{out}/Z.csv")
    with pytest.raises(FileExistsError, match="pca already holds an instance"):
        generate.main(["--problem", "NonnegPCA", "dim=12", f"output_path={out}",
                       "--device", "cpu"])
    generate.main(["--problem", "NonnegPCA", "dim=12", f"output_path={out}", "--device", "cpu",
                   "--overwrite", "seed=1"])
    assert not np.array_equal(np.loadtxt(f"{out}/Z.csv"), first)
    out = str(tmp_path / "lr")
    generate.main(["--problem", "LowRank", "m=7", "n=5", "rank=2", f"output_path={out}",
                   "--device", "cpu"])
    p = low_rank.load_problem(out, "a", device="cpu")
    assert p.num_ineq == 35 and bool((p.slack(p.x0[None]) > 0).all())


def test_generate_refuses_the_shipped_instances(monkeypatch):
    from riptrm_torch.experiment import generate

    monkeypatch.chdir(REPO)
    with pytest.raises(FileExistsError, match="dataset/NonnegPCA/1 already holds"):
        generate.main(["--problem", "NonnegPCA", "--device", "cpu"])


@pytest.mark.parametrize("module,args", [
    ("simulator", ["--problem", "NonnegPCA"]),
    ("generate", ["--problem", "NonnegPCA"]),
    ("benchmark", []),
    ("protocol_speedrun", []),
    ("chip_sweep", []),
])
def test_clis_need_cuda_or_device_cpu(module, args, monkeypatch):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.chdir(REPO)
    mod = importlib.import_module(f"riptrm_torch.experiment.{module}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)


# -- (f) benchmark ---------------------------------------------------------------
def test_benchmark_tiny_budget(tmp_path, monkeypatch):
    from riptrm_torch.experiment import benchmark

    monkeypatch.chdir(REPO)
    summary = str(tmp_path / "summary.json")
    args = ["--problems", "NonnegPCA", "--solvers", "RSQO,RIPM", "--budget", "30",
            "--summary", summary, f"output_path={tmp_path}/${{problem_name}}",
            "solver_option.common.maxiter=5", "--device", "cpu"]
    out = benchmark.main(args)
    with open(summary) as f:
        assert json.load(f) == out
    assert sorted(out) == ["NonnegPCA/1/a/RIPM_RepMat_gamma0.9_beta0.0001_theta0.5",
                           "NonnegPCA/1/a/RSQO_reghess_corr1e-02"]
    assert out["NonnegPCA/1/a/RSQO_reghess_corr1e-02"] < 1e-8
    # restartable: the finished jobs are skipped, the summary rebuilt from
    # their logs
    log = tmp_path / "NonnegPCA" / "RSQO_reghess_corr1e-02_log.csv"
    os.utime(log, (0, 0))
    assert benchmark.main(args) == out and os.path.getmtime(log) == 0


def test_host_shard():
    from riptrm_torch.parallel.distributed import host_shard
    from riptrm_tpu.parallel.distributed import host_shard as jshard

    items = list(range(10))
    for n in (1, 3, 4):
        shards = [host_shard(items, i, n) for i in range(n)]
        assert shards == [jshard(items, i, n) for i in range(n)]
        assert sorted(sum(shards, [])) == items
    assert host_shard(items) == items  # no process group: one process


# -- (g) wandb -------------------------------------------------------------------
def test_wandb_fallback_warns_and_disables():
    from riptrm_torch.solvers import base

    option = {"wandb_logging": True}
    with pytest.warns(UserWarning, match="wandb is not installed"):
        assert base.maybe_wandb_init(option, "X") is None
    assert option["wandb_logging"] is False
    base.maybe_wandb_log(option, {"a": 1.0})  # off now: no warning, no call
    base.maybe_wandb_finish(option)
    option = {"wandb_logging": True}
    with pytest.warns(UserWarning, match="wandb is not installed"):
        base.maybe_wandb_log(option, {"a": 1.0})
    assert option["wandb_logging"] is False
