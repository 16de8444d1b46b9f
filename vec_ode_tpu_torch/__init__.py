"""vec_ode_tpu_torch: the PyTorch / CUDA port of vec_ode_tpu.

Grows beside the JAX package, which stays the reference. So far it runs
three ensemble paths through ``parallel.ensemble_solve``: the adaptive
embedded-RK stepper ``ops.fused_rk.FusedModulatedLinearRK`` (dx/dt =
(M0 + cos(wt) M1) x with shared matrices), the modulated exponential
steppers ``exp.MidpointModulated`` / ``exp.MagnusModulated4`` (A(t) =
sum_k c_k(t) M_k), and the generic exponential steppers
(``exp.ExpMidpoint``, ``Magnus4``, ``Magnus6``, ``CFM4``,
``CFM4_BLANES17``, ``SplitMidpoint``, ``SplitCFM``) with a black-box
operator callback over ``exp.DenseSplit`` / ``exp.DenseCplxSplit``. On
CUDA tensors they run hand-written kernels (``csrc/``): a step kernel per
driver iteration, or the whole loop in one launch; on CPU tensors the
plain torch twins run. ``diff`` holds the O(1)-memory reversible adjoint
(``adjoint_solve``, ``adjoint_solve_adaptive``) over the adjoint kernels,
whose workload is ``models.PulseControl``. This package imports neither
jax nor vec_ode_tpu.
"""

from . import (controller, convert, diff, driver, exp, lc, models, ops,
               parallel, tableaus)
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
from .models import PulseControl
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
    "controller",
    "convert",
    "diff",
    "driver",
    "exp",
    "lc",
    "models",
    "ops",
    "parallel",
    "tableaus",
    "StepControl",
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
