"""RALM: Riemannian Augmented Lagrangian Method (Liu-Boumal baseline).

Counterpart of ``riptrm_tpu/solvers/ralm.py``, over lanes: the state
carries ``x`` [B, ...], the clipped multipliers ``y`` [B, m] and ``z``
[B, l], their unbounded (AKKT) versions, and per-lane scalars [B].  An
outer step minimises the augmented Lagrangian with a Riemannian subsolver
(``solvers/subsolvers.py``: steepest descent or conjugate gradient, each a
lane-masked loop with a nested lane-masked line search), its gradient by
``torch.func.grad`` of the per-lane AL cost (in the ambient space on an
embedded problem, ``problems/embedded.py``), then updates the multipliers
and the penalty.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch.func import grad, vmap

from riptrm_torch.ops.kkt import compute_residual, evaluation
from riptrm_torch.solvers import base
from riptrm_torch.solvers.base import (
    Output,
    compiled_best_while,
    host_run,
    max_abs_multiplier,
    maybe_wandb_finish,
    maybe_wandb_init,
    merge_options,
)
from riptrm_torch.solvers.subsolvers import conjugate_gradient, steepest_descent

SUBSOLVERS = {"SteepestDescent": steepest_descent, "ConjugateGradient": conjugate_gradient}


def default_option():
    """The JAX package's defaults (``riptrm_tpu/solvers/ralm.py``)."""
    return {
        "maxtime": 100,
        "maxiter": 100,
        "tolresid": 1e-6,
        "rho": 1.0,
        "bound": 20.0,
        "tau": 0.8,
        "thetarho": 0.3,
        "numOuterItertgn": 30,
        "LagmultUnbdUpdate": False,
        "innersubsolver": "SteepestDescent",  # or "ConjugateGradient"
        "maxInnerIter": 200,
        "startingtolgradnorm": 1e-3,
        "endingtolgradnorm": 1e-6,
        "innerminstepsize": 1e-10,
        # the reference computes the geometric inner-tolerance decay but
        # never uses it; True applies it
        "tolgradnorm_decay_fix": False,
        # fixed-budget loops return the best iterate
        "keep_best_point": True,
        "verbosity": 0,
        "wandb_logging": False,
        "do_exit_on_error": True,
    }


@dataclasses.dataclass
class RalmState:
    x: torch.Tensor
    y: torch.Tensor  # clipped inequality multipliers [B, m]
    z: torch.Tensor  # clipped equality multipliers [B, l]
    y_unbd: torch.Tensor
    z_unbd: torch.Tensor
    rho: torch.Tensor
    oldacc: torch.Tensor
    tolgradnorm: torch.Tensor
    outer_iter: torch.Tensor  # int64


def state_from_numpy(d, device=None, dtype=None, manifold=None) -> RalmState:
    """Port's state from a dict of arrays (e.g. a JAX ``RalmState``'s
    ``_asdict()``), one lane or [B] lanes."""
    return base.state_from_numpy(RalmState, d, scalar_field="rho",
                                 int_fields=("outer_iter",), device=device, dtype=dtype,
                                 manifold=manifold)


state_to_numpy = base.state_to_numpy


def _check_slice(option):
    if option["innersubsolver"] not in SUBSOLVERS:
        raise ValueError(f"innersubsolver {option['innersubsolver']!r}: one of "
                         f"{tuple(SUBSOLVERS)}")


def make_step(problem, option):
    """Build ``step(state) -> (state, info)`` (info: the subsolver's
    iterations and final gradient norm per lane)."""
    _check_slice(option)
    man = problem.manifold
    bound = option["bound"]
    tau = option["tau"]
    thetarho = option["thetarho"]
    ending = option["endingtolgradnorm"]
    theta_tol = (option["endingtolgradnorm"] / option["startingtolgradnorm"]) ** (
        1.0 / option["numOuterItertgn"]
    )
    subsolver = SUBSOLVERS[option["innersubsolver"]]
    decay_fix = option["tolgradnorm_decay_fix"]

    def al_terms(val, g, h, y, z, rho):
        """The augmented Lagrangian of one lane from its values."""
        if g is not None:
            val = val + 0.5 * rho * torch.sum(torch.clamp(y / rho + g, min=0.0) ** 2)
        if h is not None:
            val = val + 0.5 * rho * torch.sum((z / rho + h) ** 2)
        return val

    def al_lane(x, y, z, rho):
        return al_terms(problem.cost_fn(x),
                        problem.ineq_fn(x) if problem.has_ineq else None,
                        problem.eq_fn(x) if problem.has_eq else None, y, z, rho)

    # Embedded problems (fixed rank): the AL's gradient is taken in the
    # AMBIENT space, so egrad2rgrad receives an ambient matrix and not a
    # gradient with respect to the packed factors.
    embedded = getattr(problem, "a_cost", None) is not None

    def al_ambient(xa, y, z, rho):
        return al_terms(problem.a_cost(xa),
                        problem.a_ineq(xa) if problem.has_ineq else None,
                        problem.a_eq(xa) if problem.has_eq else None, y, z, rho)

    def step(state: RalmState):
        y, z, rho = state.y, state.z, state.rho
        cost = lambda x: vmap(al_lane)(x, y, z, rho)
        if embedded:
            rgrad = lambda x: man.egrad2rgrad(
                x, vmap(grad(al_ambient))(man.embed_point(x), y, z, rho))
        else:
            rgrad = lambda x: man.egrad2rgrad(x, vmap(grad(al_lane))(x, y, z, rho))
        inner_tol = (state.tolgradnorm if decay_fix
                     else torch.full_like(rho, option["startingtolgradnorm"]))
        result = subsolver(
            man, cost, rgrad, state.x,
            max_iterations=option["maxInnerIter"],
            min_step_size=option["innerminstepsize"],
            min_gradient_norm=inner_tol,
        )
        x = result.point
        g = problem.ineq_val(x)
        h = problem.eq_val(x)
        r = rho[:, None]

        # unbounded AKKT multipliers
        y_unbd = torch.clamp(y + r * g, min=0.0) if problem.has_ineq else state.y_unbd
        z_unbd = z + r * h if problem.has_eq else state.z_unbd

        # clipped multiplier updates and the accuracy
        newacc = torch.zeros_like(rho)
        if problem.has_ineq:
            newacc = torch.maximum(newacc, torch.amax(torch.abs(torch.maximum(-y / r, g)), dim=-1))
            y = torch.clamp(torch.clamp(y + r * g, min=0.0), max=bound)
        if problem.has_eq:
            newacc = torch.maximum(newacc, torch.amax(torch.abs(h), dim=-1))
            z = torch.clamp(torch.clamp(z + r * h, min=-bound), max=bound)

        # rho grows where the accuracy did not improve by tau
        rho = torch.where(newacc > tau * state.oldacc, rho / thetarho, rho)
        tolgradnorm = torch.clamp(state.tolgradnorm * theta_tol, min=ending)
        new_state = RalmState(
            x=x, y=y, z=z, y_unbd=y_unbd, z_unbd=z_unbd, rho=rho, oldacc=newacc,
            tolgradnorm=tolgradnorm, outer_iter=state.outer_iter + 1,
        )
        return new_state, {"inner_iterations": result.iterations,
                           "inner_gradnorm": result.gradient_norm}

    return step


def eval_multipliers(problem, state, option):
    """The multipliers the residual is evaluated at: unbounded under
    ``LagmultUnbdUpdate``, else the clipped ones."""
    if option["LagmultUnbdUpdate"]:
        return state.y_unbd, state.z_unbd
    return state.y, state.z


def init_state(problem, option):
    """One-lane initial state."""
    y0 = problem.y0[None]
    z0 = problem.z0[None]
    dt = y0.dtype if y0.numel() else problem.x0.dtype
    dev = problem.x0.device
    full = lambda v: torch.full((1,), v, dtype=dt, device=dev)
    return RalmState(
        x=problem.x0[None], y=y0, z=z0, y_unbd=y0, z_unbd=z0,
        rho=full(option["rho"]), oldacc=full(float("inf")),
        tolgradnorm=full(option["startingtolgradnorm"]),
        outer_iter=torch.zeros(1, dtype=torch.int64, device=dev),
    )


def solve_compiled_best(problem, option, max_steps: int):
    """Fixed-budget solve over the lanes of a state, tracking the best KKT
    residual (seeded with the initial residual); a lane stops once its
    best <= target or at the residual tolerance, the budget being
    min(max_steps, maxiter).  ``keep_best_point`` (default True) returns
    each lane's best iterate: RALM's residual is not monotone.  Returns
    solve(state, target) -> (state, steps [B], best [B])."""
    option = merge_options(default_option(), option or {})
    step = make_step(problem, option)
    tolresid = option["tolresid"]

    def residual(st):
        y_eval, z_eval = eval_multipliers(problem, st, option)
        return compute_residual(problem, st.x, y_eval, z_eval)[0]

    def step1(st):
        new_st, _ = step(st)
        res = residual(new_st)
        stop = res <= tolresid
        return new_st, res, torch.ones_like(stop), stop

    def solve(state, target):
        st, k, _, best = compiled_best_while(
            step1, state, target, min(max_steps, option["maxiter"]), residual(state),
            stall_window=option.get("sweep_stall_window"),
            track_best_state=option.get("keep_best_point", True),
        )
        return st, k, best

    return solve


def solve_compiled(problem, option, max_steps: int):
    """Fixed-budget solve: solve(state) -> (state, steps)."""
    inner = solve_compiled_best(problem, option, max_steps)

    def solve(state):
        st, k, _ = inner(state, -float("inf"))
        return st, k

    return solve


class RALM:
    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        self.name = f"RALM_{self.option['innersubsolver']}"

    def run(self, problem) -> Output:
        """Host loop on one lane with the reference's run protocol."""
        option = self.option
        maybe_wandb_init(option, self.name)
        state = init_state(problem, option)
        step = make_step(problem, option)

        def evaluate(x_prev, st):
            y_eval, z_eval = eval_multipliers(problem, st, option)
            return evaluation(problem, x_prev, st.x, y_eval, z_eval)

        def status_row(st, info):
            return {"rho": st.rho,
                    "maxabsLagmult": max_abs_multiplier(*eval_multipliers(problem, st, option))}

        state, log, stop_reason = host_run(
            option=option,
            state=state,
            step=step,
            evaluate=evaluate,
            status_row=status_row,
            get_x=lambda st: st.x,
            verbosity_line=lambda i, ev: (
                f"Iter: {i}, Cost: {ev['cost']}, KKT residual: {ev['residual']}"
            ),
        )
        self.option["stoppingcriterion"] = stop_reason
        maybe_wandb_finish(option)
        y_eval, z_eval = eval_multipliers(problem, state, option)
        opt_out = {k: v for k, v in self.option.items() if not callable(v)}
        return Output(
            name=self.name,
            x=state.x[0],
            ineqLagmult=y_eval[0],
            eqLagmult=z_eval[0],
            option=copy.deepcopy(opt_out),
            log=log,
        )
