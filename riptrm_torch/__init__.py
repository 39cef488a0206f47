"""riptrm_torch — the PyTorch/CUDA port of ``riptrm_tpu``.

The JAX package ``riptrm_tpu`` is the reference; this package mirrors its
layout and names (``manifolds``, ``problems``, ``ops``, ``solvers``,
``parallel``, ``experiment``, ``utils``) so each module's counterpart sits
under the same path.  Ported so far: RIPTRM in tCG and exact mode, with
first- or second-order stopping, on every problem family of the JAX
package (NonnegPCA on the sphere, BoundedPCA on Stiefel, Rosenbrock on
Grassmann, StableIdentification on Product(Skew, SPD, SPD), LowRank on the
fixed-rank manifold), with the compensated reductions; the three baseline solvers RIPM (``solvers/ripm.py``, with the
conjugate residual of ``ops/conjres.py``), RSQO (``solvers/rsqo.py``, with
the QP IPM of ``ops/qp.py``) and RALM (``solvers/ralm.py``, with the
subsolvers of ``solvers/subsolvers.py``); the batched sweeps of all four
solvers with RIPTRM's second-order certificate; the experiment layer
(``experiment/``: the ``simulate``, ``generate``, ``analyze``,
``benchmark``, ``protocol_speedrun``, ``chip_sweep`` and ``roofline``
CLIs, configs, registries and checkpoint/resume); with a hand-written
Hopper kernel for every Pallas kernel of the JAX package
(``ops/kernels.py``, ``csrc/``).

Conventions:

* Solver states and manifold points carry a leading lane axis: ``x`` and
  ``y`` are ``[B, n]``, per-lane scalars are ``[B]``.  The host runner uses
  B = 1, the batched sweep B > 1; one step function serves both.  A point
  the JAX package keeps as a tuple (a product's, a fixed-rank one's) is
  one packed tensor a lane (``Manifold.pack``/``unpack``).
* Every constructor takes ``device`` and ``dtype``: by default CUDA device
  0 and float64 (``config.resolve``), which raises where CUDA is absent,
  never falling back to the CPU; pass ``device="cpu"`` for the CPU.  Random
  draws take an explicit ``torch.Generator``.  The package never imports
  JAX.
* Nothing is compiled at import time: the CUDA kernels are built with
  ``nvcc`` at their first launch on a CUDA tensor (``ops/_build.py``).
"""

from riptrm_torch import config, manifolds, ops, parallel, problems, solvers  # noqa: F401
from riptrm_torch.problems import Problem  # noqa: F401
from riptrm_torch.solvers import RALM, RIPM, RIPTRM, RSQO  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "config",
    "manifolds",
    "ops",
    "parallel",
    "problems",
    "solvers",
    "Problem",
    "RALM",
    "RIPM",
    "RIPTRM",
    "RSQO",
]
