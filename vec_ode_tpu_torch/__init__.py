"""vec_ode_tpu_torch: the PyTorch / CUDA port of vec_ode_tpu.

Grows beside the JAX package, which stays the reference. Its front door
is the JAX package's: ``solve_ivp`` (dx/dt = f(t, y) over any pytree
state with ``RungeKutta``, default RKF45) and ``solve_linear`` (an
exponential stepper over ``op_fn(t)``, with the split solvers and the
composite splits of ``exp.splits``) solve one problem on the driver's
scalar carry, and ``parallel.ensemble_solve(f, y0_batch, ...)`` a batch
of them on the vmapped tier (``torch.func.vmap`` of the per-trajectory
step); the models of ``models`` (linear, nonlinear, chains, quantum) come
with them. Beside that it runs three natively batched ensemble paths
through ``parallel.ensemble_solve``: the adaptive
embedded-RK stepper ``ops.fused_rk.FusedModulatedLinearRK`` (dx/dt =
(M0 + u(t) M1) x with shared matrices and a declared drive u), the modulated exponential
steppers ``exp.MidpointModulated`` / ``MagnusModulated4`` /
``MagnusModulated6`` / ``CFMModulated`` (A(t) = sum_k c_k(t) M_k; the
models ``DrivenDense``, ``LandauZener`` and the open-system
``Lindblad``; ``exp.auto_modulated`` recovers such an operator, with a
Chebyshev ``ChebForm``, from a black-box callback), and the generic
exponential steppers
(``exp.ExpMidpoint``, ``Magnus4``, ``Magnus6``, ``CFM4``,
``CFM4_BLANES17``, ``SplitMidpoint``, ``SplitCFM``) with a black-box
operator callback over ``exp.DenseSplit`` / ``exp.DenseCplxSplit``. On
CUDA tensors they run hand-written kernels (``csrc/``): a step kernel per
driver iteration, or the whole loop in one launch; on CPU tensors the
plain torch twins run. ``diff`` holds the O(1)-memory reversible adjoint
(``adjoint_solve``, ``adjoint_solve_adaptive``, ``basis_grad=True``)
over the adjoint kernels, whose workload is ``models.PulseControl``, the
dense-operator adjoint (``adjoint_solve_dense``), ``fit_loop``, and
gradients through the driver (``solve_for_grad``, ``grad_terminal``,
``value_and_grad_terminal``: autograd through ``method="scan"``, with
``remat_levels`` and ``grad_safe``). ``events`` (declared
observables, run in the loop kernel, or callables, run by the host
driver) and ``dense`` (free-running interpolated saves) are taken by
``ensemble_solve(events=..., dense=True)``; ``solve_ivp_dense`` and
``solve_linear_dense`` are the dense front doors. ``quad`` holds the
Gauss-Legendre and trapezoid quadratures. ``compensated=True`` on
``RungeKutta`` and the generic exponential steppers carries the state as
a double-word pair (``comp``); ``parallel.ensemble_solve_compact``
re-batches the running lanes between chunks; ``utils.save_state`` /
``load_state`` checkpoint the driver's carry; ``config.warn_on_fallback``
names the rule wherever a batched solve declines a kernel path. This package imports neither
jax nor vec_ode_tpu.
"""

from . import (api, comp, config, controller, convert, dense, diff, driver,
               events, exp, lc, models, ops, parallel, quad, rk, tableaus,
               utils)
from .api import solve_ivp, solve_linear
from .dense import solve_ivp_dense, solve_linear_dense
from .controller import StepControl
from .driver import (
    DONE,
    DONE_EVENT,
    ERR_BAD_GRID,
    ERR_MAX_STEPS,
    ERR_STALLED,
    EVT_CHKPT,
    EVT_END,
    EVT_NONE,
    EVT_REJECT,
    EVT_STEP,
    RUNNING,
    IntState,
    Solution,
    init_state,
    integrate,
    make_grid,
    resume,
    step_once,
)
from .events import (Event, EventConfig, LinearObservable,
                     QuadraticObservable)
from .exp import ChebForm, auto_modulated
from .models import PulseControl
from .rk import RungeKutta, rk_step
from .tableaus import (
    BOSH32,
    CASH_KARP,
    DOPRI5,
    EULER,
    HEUN_RK2,
    MIDPOINT_RK2,
    RK4,
    RKF45,
    RKF45_REFERENCE,
    TABLEAUS,
    ButcherTableau,
)

__version__ = "0.1.0"

__all__ = [
    "api",
    "comp",
    "config",
    "utils",
    "rk",
    "solve_ivp",
    "solve_linear",
    "solve_ivp_dense",
    "solve_linear_dense",
    "RungeKutta",
    "rk_step",
    "controller",
    "convert",
    "dense",
    "diff",
    "driver",
    "events",
    "exp",
    "lc",
    "models",
    "ops",
    "parallel",
    "quad",
    "tableaus",
    "auto_modulated",
    "ChebForm",
    "StepControl",
    "Event",
    "EventConfig",
    "LinearObservable",
    "QuadraticObservable",
    "PulseControl",
    "Solution",
    "IntState",
    "integrate",
    "resume",
    "init_state",
    "step_once",
    "make_grid",
    "ButcherTableau",
    "RKF45",
    "RKF45_REFERENCE",
    "RK4",
    "DOPRI5",
    "BOSH32",
    "CASH_KARP",
    "EULER",
    "MIDPOINT_RK2",
    "HEUN_RK2",
    "TABLEAUS",
    "RUNNING",
    "DONE",
    "DONE_EVENT",
    "ERR_BAD_GRID",
    "ERR_MAX_STEPS",
    "ERR_STALLED",
    "EVT_NONE",
    "EVT_STEP",
    "EVT_CHKPT",
    "EVT_REJECT",
    "EVT_END",
]
