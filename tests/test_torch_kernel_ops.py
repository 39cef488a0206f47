"""The kernels as ``riptrm::`` operators (``riptrm_torch/ops/kernels.py``)
on CPU tensors: ``torch.library.opcheck`` of each operator (schema, fake
implementation, tracing), and each wrapper reaching its operator."""

import pytest
import torch

from riptrm_torch.manifolds import Sphere, Stiefel
from riptrm_torch.ops import kernels as tk

torch.set_num_threads(1)
N, B, P = 24, 3, 4


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _sphere_case():
    g = _gen(0)
    a = torch.randn(N, N, generator=g)
    zs = (a @ a.T / N).contiguous()
    xs = torch.nn.functional.normalize(torch.rand(B, N, generator=g), dim=-1)
    ws = torch.rand(B, N, generator=g) + 0.1
    grads = Sphere(N).proj(xs, torch.randn(B, N, generator=g))
    radii = torch.tensor([0.01, 0.5, 5.0])
    return zs, xs, ws, grads, radii


def _stiefel_case():
    g = _gen(1)
    a = torch.randn(N, N, generator=g)
    zs = (a @ a.T / N).contiguous()
    d = torch.arange(P, 0, -1, dtype=torch.float32)
    xs = torch.linalg.qr(torch.randn(B, N, P, generator=g))[0].contiguous()
    ws = torch.rand(B, N, P, generator=g) + 0.1
    ss = torch.randn(B, P, P, generator=g)
    ss = (ss + ss.mT).contiguous()
    grads = Stiefel(N, P).proj(xs, torch.randn(B, N, P, generator=g)).contiguous()
    radii = torch.tensor([0.01, 0.5, 5.0])
    return zs, d, xs, ws, ss, grads, radii


def _cases():
    zs, xs, ws, grads, radii = _sphere_case()
    v0 = torch.nn.functional.normalize(torch.randn(N, generator=_gen(2)), dim=0)
    chain = (zs, xs[0].contiguous(), ws[0].contiguous(), v0, 5)
    return {
        "chain_resident": chain + (1, 1),
        "sphere_tcg": (zs, xs, ws, grads, radii, N, 1, 1.0, 0.1) + (0,) * 7 + (False,),
        "stiefel_tcg": _stiefel_case() + (N * P, 1, 1.0, 0.1, 0, 0, 0, False),
        "matvec_chain_left": (zs, torch.randn(B, N, generator=_gen(3)), 4, 0) + (0,) * 5,
        "matvec_chain_right": (zs, torch.randn(N, B, generator=_gen(4)), 4, 2) + (0,) * 3
        + (False,),
        "chain_hbm": chain + (1, 1, 4, 8, True),
        "dense_solve": _dense_case() + (1, 1),
        "stableid_hvp": _stableid_case(),
        "spd_cho_solve": _spd_case(),
    }


def _dense_case():
    g = _gen(5)
    return torch.randn(B, N, N, generator=g), torch.randn(B, N, generator=g)


def _stableid_case():
    """StableIdentification's barrier operator at d = 3 with 4 constraints:
    (x, g, y, c, dx, gram, idx, lin, two, p1, scale)."""
    g, d, m = _gen(6), 3, 4
    a = torch.randn(B, 2, d, d, generator=g)
    x = torch.stack((a[:, 0] - a[:, 0].mT, torch.eye(d) + 0.1 * (a[:, 1] + a[:, 1].mT),
                     torch.eye(d).expand(B, d, d)), dim=1)
    gram = torch.randn(d, d, generator=g)
    return (x, torch.randn(B, d, d, generator=g), torch.rand(B, m, generator=g) + 0.5,
            torch.rand(B, m, generator=g) + 0.5, torch.randn(B, 3, d, d, generator=g),
            gram @ gram.T, torch.tensor([0, 4, 4, 7]), torch.tensor([-1.0, 1.0, 0.0, 0.0]),
            torch.tensor([0.0, 0.0, 1.0, 1.0]), torch.randn(m, generator=g), 0.01)


def _spd_case():
    """The SPD metric's solve at d = 3 as a Product reads it: a factor of
    the stacked blocks (column-major, as the Cholesky writes it) and the
    narrowed blocks of a packed [B, 3, d, d] tangent."""
    g, d = _gen(7), 3
    a = torch.randn(B, 2, d, d, generator=g)
    l = torch.linalg.cholesky(a @ a.mT + torch.eye(d))
    return l, torch.randn(B, 3, d, d, generator=g).narrow(1, 1, 2)


@pytest.mark.parametrize("name", sorted(tk._OPS))
def test_opcheck(name):
    torch.library.opcheck(getattr(torch.ops.riptrm, name).default, _cases()[name])


@pytest.mark.parametrize("name", sorted(tk._OPS))
def test_operator_has_every_implementation(name):
    """Each operator is registered for CUDA, the CPU and fake tensors."""
    op = getattr(torch.ops.riptrm, name).default
    for key in ("CUDA", "CPU", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)


@pytest.mark.parametrize("wrapper,args", [
    ("chained_barrier_matvec", "chain"),
    ("fused_tcg_sphere_quadratic", "one"),
    ("fused_tcg_sphere_quadratic_batched", "lanes"),
    ("fused_tcg_stiefel_bound_batched", "frames"),
    ("bare_matvec_chain", "left"),
    ("chained_barrier_matvec_hbm", "chain"),
    ("dense_solve_nan", "dense"),
    ("stableid_barrier_hvp", "stableid"),
    ("spd_cho_solve", "spd"),
])
def test_wrapper_calls_one_operator(wrapper, args):
    """Each of the nine launch counters' wrappers reaches exactly one
    riptrm:: operator a call, and counts nothing on the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    zs, xs, ws, grads, radii = _sphere_case()
    v0 = torch.nn.functional.normalize(torch.randn(N, generator=_gen(2)), dim=0)
    kw = {"maxinner": N}
    calls = {
        "chain": ((zs, xs[0], ws[0], v0, 5), {}),
        "one": ((zs, xs[0], ws[0], grads[0], radii[0]), kw),
        "lanes": ((zs, xs, ws, grads, radii), kw),
        "frames": (_stiefel_case(), {"maxinner": N * P}),
        "left": ((zs, torch.randn(B, N, generator=_gen(3)), 4, "highest"), {}),
        "dense": (_dense_case(), {}),
        "stableid": (_stableid_case()[:5], dict(zip(("gram", "idx", "lin", "two", "p1", "scale"),
                                                    _stableid_case()[5:]))),
        "spd": (_spd_case(), {}),
    }
    seen = []

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), k=None):
            if func.namespace == "riptrm":
                seen.append(func)
            return func(*a, **(k or {}))

    tk.reset_launch_counts()
    a, k = calls[args]
    with Capture():
        getattr(tk, wrapper)(*a, **k)
    assert len(seen) == 1
    assert not any(tk.launch_counts().values())


def test_traced_wrapper_holds_operator():
    """make_fx of a wrapper records its operator as one node, not the plain
    version's loop, and the CPU call counts no launch."""
    from torch.fx.experimental.proxy_tensor import make_fx

    zs, xs, ws, grads, radii = _sphere_case()
    fn = lambda *a: tk.fused_tcg_sphere_quadratic_batched(*a, maxinner=N)  # noqa: E731
    gm = make_fx(fn, tracing_mode="fake")(zs, xs, ws, grads, radii)
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert "riptrm.sphere_tcg.default" in targets
    assert not any("while_loop" in t for t in targets)
    tk.reset_launch_counts()
    eta, _, iters, codes = gm(zs, xs, ws, grads, radii)
    ref = tk.fused_tcg_plain(zs, xs, ws, grads, radii, maxinner=N)
    assert torch.equal(eta, ref[0]) and torch.equal(iters, ref[2]) and torch.equal(codes, ref[3])
    assert not any(tk.launch_counts().values())
