"""The order-6 and commutator-free modulated steppers of the port
(``MagnusModulated6``, ``CFMModulated``, ``CFM4Modulated``: R > 1
exponentials per chain in the chain step) on the CPU, against the JAX
package on the same numpy inputs: the step twins against the JAX step in
its XLA tier and in its Pallas kernel in interpret mode; ``ensemble_solve``
through the per-step twin (an operator without a declared form) and the
loop twin (the declared form) against the JAX XLA driver; the loop twin
against the JAX loop kernel in interpret mode, unpacked (the widened width
is 128, so d = 64). The gate in f64: status, n_accept, n_reject and
n_iters equal per trajectory, states to 1e-13 of their scale (1e-10 after
a whole solve). The kernels K4 and K5 against these twins on a card:
tests/test_torch_cuda.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu import tableaus as jtb
from vec_ode_tpu.exp import magnus as jmagnus
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch import lc
from vec_ode_tpu_torch import tableaus as ttb
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.ops import expmv, fused_loop
from vec_ode_tpu_torch.parallel import ensemble_solve

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

B, D, TF = 8, 64, 0.3
WEIGHTS = tuple(np.linspace(0.5, 2.0, D))
# an order-2 comparison row over the three Gauss-Legendre nodes (the
# exponential midpoint): zero alphas and three zero pad rows under
# BLANES17's four
BLANES_ERR = ((0.0, 1.0, 0.0),)


def _jstepper(kind, jop, **kw):
    if kind == "mm6":
        return vexp.MagnusModulated6(jop, **kw)
    if kind == "mm6_fixed":
        return vexp.MagnusModulated6(jop, adaptive=False, **kw)
    if kind == "cfm4":
        return vexp.CFM4Modulated(jop, **kw)
    if kind == "cfm4_fixed":
        return vexp.CFM4Modulated(jop, adaptive=False, **kw)
    return vexp.CFMModulated(
        jop, alpha=tuple(map(tuple, jtb.BLANES17_R4_J4)),
        c=tuple(jtb.C_GAUSS_LEGENDRE_6),
        alpha_err=BLANES_ERR if kind == "blanes" else None, **kw)


def _tstepper(kind, top, **kw):
    if kind == "mm6":
        return texp.MagnusModulated6(top, **kw)
    if kind == "mm6_fixed":
        return texp.MagnusModulated6(top, adaptive=False, **kw)
    if kind == "cfm4":
        return texp.CFM4Modulated(top, **kw)
    if kind == "cfm4_fixed":
        return texp.CFM4Modulated(top, adaptive=False, **kw)
    return texp.CFMModulated(
        top, alpha=ttb.BLANES17_R4_J4, c=ttb.C_GAUSS_LEGENDRE_6,
        alpha_err=BLANES_ERR if kind == "blanes" else None, **kw)


def _models(dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (JDrivenDense.make(d=D, seed=0).modulated(jdt),
            DrivenDense.make(d=D, seed=0).modulated(dtype, device="cpu"))


def _np(c):
    return np.concatenate([np.asarray(c.re), np.asarray(c.im)], axis=-1)


def test_constants_and_tables_are_the_jax_packages():
    assert expmv._SUB_OFF == jmagnus._SUB_OFF
    assert expmv._SUB_LEN == jmagnus._SUB_LEN
    for name in ("CFM_R2_J1_GL", "CFM_R4_J2_GL", "BLANES17_R4_J4",
                 "C_GAUSS_LEGENDRE_4", "C_GAUSS_LEGENDRE_6"):
        assert np.array_equal(getattr(ttb, name), getattr(jtb, name)), name
    _, top = _models(torch.float64)
    assert texp.MagnusModulated6(top).nfev_per_step == 8
    assert texp.MagnusModulated6(top, adaptive=False).nfev_per_step == 6
    assert texp.CFM4Modulated(top).nfev_per_step == 2
    st = _tstepper("blanes", top)
    assert st.nfev_per_step == 3 and st.alpha_err == BLANES_ERR
    assert (st._recipe, st._chains, st._adaptive) == ("cfm", 2, True)
    assert expmv.n_nodes("magnus6", 2) == 8
    assert expmv.n_nodes("cfm", 2, st._table) == 3
    assert expmv.identity_rows("magnus6", 2) == {(1, 1), (1, 2)}


def test_cfm_table_validation():
    """An error chain longer than the main chain raises, as the JAX
    package's make_step_fn does (exp/modulated.py:1200-1204); so do
    shapes that do not match the nodes and recipes given a table they do
    not take."""
    _, top = _models(torch.float64)
    with pytest.raises(ValueError, match="longer than the main chain"):
        texp.CFMModulated(top, alpha=((0.5, 0.5),), c=(0.2, 0.8),
                          alpha_err=((1.0, 0.0), (0.0, 1.0)))
    with pytest.raises(ValueError, match="alpha"):
        expmv.CfmTable(alpha=((0.5, 0.5, 0.0),), c=(0.2, 0.8))
    with pytest.raises(ValueError, match="CfmTable"):
        expmv.check_recipe("magnus6", 1, expmv.CfmTable(((1.0,),), (0.5,)))
    with pytest.raises(ValueError, match="C = 2"):
        expmv.check_recipe("cfm", 1, expmv.CfmTable(((1.0,),), (0.5,),
                                                     ((1.0,),)))
    with pytest.raises(ValueError, match="C = 1"):
        expmv.check_recipe("magnus6", 3)


def _step_inputs(dtype, dt_range, seed=5):
    """States, t in [0, 1) and dt in ``dt_range``: steps long enough that
    each row's error (a difference of two chains of the state's size) is
    above 1e-6 of the state, so that its f64 rounding stays within 1e-9 of
    it (ROADMAP queue 3), and long enough to take squarings."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    t = rng.uniform(0.0, 1.0, B)
    dt = rng.uniform(*dt_range, B)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return ((jcp.from_complex(z, jdt), jnp.asarray(t, jdt),
             jnp.asarray(dt, jdt)),
            (tcp.from_complex(z, dtype, device="cpu"),
             torch.as_tensor(t, dtype=dtype), torch.as_tensor(dt, dtype=dtype)))


def _jax_step(stepper, jin, backend=None):
    """The JAX stepper's step on (y, t, dt); ``backend="tpu"`` builds its
    Pallas branch (interpret mode) by stubbing the backend while the step
    is made, as the JAX package's own tests do."""
    orig = jax.default_backend
    try:
        if backend is not None:
            jax.default_backend = lambda: backend
        step = stepper.make_step_fn()
    finally:
        jax.default_backend = orig
    y, t, dt = jin
    return step(t, y, dt)


STEP_DT = {"mm6": (0.3, 0.6), "mm6_fixed": (0.3, 0.6), "cfm4": (0.1, 0.3),
           "blanes": (0.1, 0.3)}


def _check_step(kind, dtype, tier, y_rtol, e_rtol, e_atol=0.0, norm=None,
                dt_range=None):
    jop, top = _models(dtype)
    jin, tin = _step_inputs(dtype, dt_range or STEP_DT[kind])
    jnorm = tnorm = None
    if norm is not None:
        jnorm, tnorm = jlc.WeightedNorm(*norm), lc.WeightedNorm(*norm)
    if tier == "xla":
        jy, je = _jax_step(_jstepper(kind, jop, use_pallas=False,
                                     norm=jnorm), jin)
    else:
        jy, je = _jax_step(_jstepper(kind, jop, interpret=True, norm=jnorm),
                           jin, backend="tpu")
    y, e = _tstepper(kind, top, norm=tnorm).make_step_fn()(tin[1], tin[0],
                                                           tin[2])
    want = _np(jy)
    np.testing.assert_allclose(_np(y), want, rtol=y_rtol,
                               atol=y_rtol * np.abs(want).max())
    assert (e is None) == (je is None)
    if je is not None:
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=e_rtol,
                                   atol=e_atol)


NORMS = {"l2": None, "weighted_l2": ("l2", WEIGHTS),
         "weighted_max": ("max", None)}
# a fixed-step stepper has no error to weigh
XLA_STEPS = [(k, n) for k in STEP_DT for n in NORMS
             if k != "mm6_fixed" or n == "l2"]


@pytest.mark.parametrize("kind,norm", XLA_STEPS)
def test_step_matches_jax_xla_step_f64(kind, norm):
    """States to 1e-13 of their scale (measured ~2e-15); the error, a
    cancelling sum, to rtol 1e-9 (measured <= 7e-10 on these steps; ROADMAP
    queue 3). The CFM rows are summed in the kernels' skip-zero order, the
    JAX XLA tier forms them with one einsum: the same to rounding."""
    _check_step(kind, torch.float64, "xla", 1e-13, 1e-9, 1e-18, NORMS[norm])


@pytest.mark.parametrize("kind", ["mm6", "cfm4", "blanes"])
def test_step_matches_pallas_interpret_f64(kind):
    """The JAX Pallas step kernel in interpret mode (one squaring count per
    tile and row; the port's is per trajectory and row): states to 1e-13
    of their scale (measured ~2e-15), the error to rtol 1e-9 (measured
    6.6e-12 for Magnus-6, 5e-14 for CFM)."""
    _check_step(kind, torch.float64, "pallas", 1e-13, 1e-9)


@pytest.mark.parametrize("kind,e_rtol", [("mm6", 1e-2), ("cfm4", 1e-4),
                                         ("blanes", 5e-4)])
def test_step_matches_pallas_interpret_f32(kind, e_rtol):
    """f32 against the Pallas kernel in interpret mode, on steps of 0.3 to
    0.6 (errors of 1e-3 to 3e-2 of the state): states to 1e-5 of their
    scale (measured 3.4e-6 for Magnus-6, whose four exponentials take more
    squarings, 1e-7 to 1e-6 for CFM); the error, a difference of two f32
    chains, to the stated rtol (measured 3.1e-3, 2.2e-6 and 4.8e-5)."""
    _check_step(kind, torch.float32, "pallas", 1e-5, e_rtol,
                dt_range=(0.3, 0.6))


def test_step_edges():
    """A row whose dt is 0 returns x exactly; a NaN state gives a NaN
    error (Magnus-6: through its comparison chain's full row; CFM: through
    the zero pad rows, which are run); the wrapper on CPU tensors counts
    no launch; the identity rows of Magnus-6 cost nothing in the twin."""
    _, top = _models(torch.float64)
    _, tin = _step_inputs(torch.float64, (0.1, 0.3))
    x, t, dt = tin
    dt = dt.clone()
    dt[3] = 0.0
    x = tcp.Cplx(x.re.clone(), x.im.clone())
    x.re[5, 0] = float("nan")
    before = expmv.fused_chain_apply.launches
    for kind in ("mm6", "blanes"):
        y, e = _tstepper(kind, top).make_step_fn()(t, x, dt)
        assert torch.equal(y.re[3], x.re[3]) and torch.equal(y.im[3], x.im[3])
        assert bool(torch.isnan(e[5])) and bool(torch.isfinite(e[:5]).all())
    assert expmv.fused_chain_apply.launches == before
    # a comparison chain of zero rows only, each run for one pass: x
    # exactly
    table = expmv.CfmTable(((0.5, 0.5),), (0.2, 0.8), ((0.0, 0.0),))
    mt, norms = texp.CFM4Modulated(top)._operands(torch.device("cpu"),
                                                  torch.float64)
    xw = torch.cat([tin[0].re, tin[0].im], 1)
    samples = [top.coeff_fn(tn) for tn in expmv.node_times(
        "cfm", tin[1], tin[2], 2, table)]
    rows = expmv.chain_rows("cfm", samples, tin[2], 2, table)
    cs, n_pass = expmv.scale_rows(rows, norms, 0.25, 16)
    assert not bool(rows[:, 1].any()) and bool((n_pass[:, 1] == 1).all())
    outs = expmv.torch_chain_expmv(cs, n_pass, xw, mt, m=12)
    assert torch.equal(outs[1], xw)
    # Magnus-6's comparison chain: rows 1 and 2 skipped, the same as the
    # full interval's Magnus-4 row alone
    rows = expmv.chain_rows("magnus6", [top.coeff_fn(tn) for tn in
                                        expmv.node_times("magnus6", tin[1],
                                                         tin[2], 2)],
                            tin[2], 2)
    assert not bool(rows[:, 1, 1:].any())
    m4 = texp.MagnusModulated4(top)
    mt4, norms4 = m4._operands(torch.device("cpu"), torch.float64)
    cs, n_pass = expmv.scale_rows(rows[:, 1:, :1], norms4, 0.25, 16)
    full = expmv.torch_chain_expmv(cs, n_pass, xw, mt4, m=12)[0]
    cs6, n6 = expmv.scale_rows(rows, norms4, 0.25, 16)
    got = expmv.torch_chain_expmv(cs6, n6, xw, mt4, m=12,
                                  identity=expmv.identity_rows("magnus6", 2))
    assert torch.equal(got[1], full)


# -- ensembles: the per-step twin and the loop twin against the JAX package

BASE = dict(rtol=1e-6, min_dt=1e-5, max_dt=0.2, max_steps=2000)


@dataclasses.dataclass(frozen=True)
class Case:
    kind: str
    ctl: dict = dataclasses.field(default_factory=dict)
    save_at: tuple = None
    norm: tuple = None          # (kind, weights) of a WeightedNorm
    h0: float = 1e-3


CASES = {
    "mm6": Case("mm6"),
    "mm6_save_grid": Case("mm6", save_at=(0.075, 0.15, 0.225)),
    "mm6_weighted_l2": Case("mm6", norm=("l2", WEIGHTS)),
    "mm6_pi": Case("mm6", ctl=dict(pi=True)),
    "mm6_fixed": Case("mm6_fixed", h0=0.05),
    "cfm4": Case("cfm4"),
    "cfm4_weighted_max": Case("cfm4", norm=("max", None)),
    "cfm4_fixed": Case("cfm4_fixed", save_at=(0.1,), h0=0.03),
    "blanes": Case("blanes"),
    "mm6_scaled_error": Case("mm6", ctl=dict(scaled_error=True, rtol=1e-6,
                                             atol=1e-9)),
    "cfm4_save_grid_scaled": Case("cfm4", save_at=(0.1, 0.2),
                                  ctl=dict(scaled_error=True, rtol=1e-6,
                                           atol=1e-9)),
}
# scaled_error runs in the loop only, as in the JAX package
XLA_CASES = [k for k, c in CASES.items()
             if not c.ctl.get("scaled_error")]
PALLAS_CASES = ["mm6", "mm6_fixed", "mm6_scaled_error", "cfm4_weighted_max",
                "cfm4_save_grid_scaled"]


@functools.cache
def _psi():
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


def _adaptive(case):
    return not case.kind.endswith("_fixed")


def _np_sol(sol):
    out = {k: np.asarray(getattr(sol, k)) for k in
           ("status", "n_accept", "n_reject", "n_iters")}
    out["y"] = _np(sol.y_final)
    out["ys"] = _np(sol.ys)
    return out


@functools.cache
def _jax_xla(name):
    case = CASES[name]
    jop, _ = _models(torch.float64)
    kw = {}
    if case.norm is not None:
        kw["error_norm"] = jlc.WeightedNorm(*case.norm)
    sol = jensemble_solve(
        None, jcp.from_complex(_psi(), jnp.float64), 0.0, TF,
        stepper=_jstepper(case.kind, jop, use_pallas=False),
        ctl=vo.StepControl(**{**BASE, **case.ctl}), h0=case.h0,
        save_at=case.save_at, adaptive=_adaptive(case),
        time_dtype=jnp.float64, **kw)
    return _np_sol(sol)


@functools.cache
def _jax_pallas_loop(name):
    """The JAX package's whole-loop kernel in interpret mode, unpacked:
    its ``fused_loop_solve`` with the backend stubbed, as
    tests/test_modulated.py runs it."""
    case = CASES[name]
    jop, _ = _models(torch.float64)
    st = _jstepper(case.kind, jop, interpret=True,
                   norm=None if case.norm is None
                   else jlc.WeightedNorm(*case.norm))
    grid = vo.make_grid(0.0, TF, case.save_at, dtype=jnp.float64)
    orig = jax.default_backend
    try:
        jax.default_backend = lambda: "tpu"
        sol = st.fused_loop_solve(jcp.from_complex(_psi(), jnp.float64),
                                  grid, case.h0,
                                  ctl=vo.StepControl(**{**BASE, **case.ctl}),
                                  adaptive=_adaptive(case))
    finally:
        jax.default_backend = orig
    assert sol.path == "pallas-loop-persistent", sol.path
    return _np_sol(sol)


def _port(name, path):
    case = CASES[name]
    _, top = _models(torch.float64)
    op = top if path == "loop" else dataclasses.replace(top, form=None)
    kw = {}
    if case.norm is not None:
        kw["error_norm"] = lc.WeightedNorm(*case.norm)
    sol = ensemble_solve(
        None, tcp.from_complex(_psi(), torch.float64, device="cpu"), 0.0,
        TF, stepper=_tstepper(case.kind, op),
        ctl=vt.StepControl(**{**BASE, **case.ctl}), h0=case.h0,
        save_at=case.save_at, adaptive=_adaptive(case),
        time_dtype=torch.float64, **kw)
    assert sol.path == ("torch-loop" if path == "loop" else "torch-driver")
    return sol


def _gate(sol, want):
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(), want[k],
                                      err_msg=k)
    assert (sol.status.numpy() == vt.DONE).all()
    np.testing.assert_allclose(_np(sol.y_final), want["y"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(_np(sol.ys), want["ys"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("path", ["per_step", "loop"])
@pytest.mark.parametrize("name", XLA_CASES)
def test_ensemble_matches_jax_xla(name, path):
    _gate(_port(name, path), _jax_xla(name))


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_loop_twin_matches_jax_pallas_loop(name):
    _gate(_port(name, "loop"), _jax_pallas_loop(name))


def test_mm6_below_f32_error_floor_surfaces_max_steps():
    """The Magnus-6 embedded estimate has an f32 noise floor near 1e-7, so
    an rtol far below it rejects every step; the solve must end in
    ERR_MAX_STEPS with a finite state, never a livelock at min_dt
    (tests/test_modulated.py:815), on the loop twin and on the per-step
    twin."""
    _, top = _models(torch.float32)
    rng = np.random.default_rng(11)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    ctl = vt.StepControl(rtol=1e-12, min_dt=1e-6, max_dt=0.25, max_steps=64)
    for op, path in ((top, "torch-loop"),
                     (dataclasses.replace(top, form=None), "torch-driver")):
        sol = ensemble_solve(
            None, tcp.from_complex(psi, torch.float32, device="cpu"), 0.0,
            1.0, stepper=texp.MagnusModulated6(op), ctl=ctl, h0=1e-2,
            time_dtype=torch.float32)
        assert sol.path == path
        assert (sol.status == vt.ERR_MAX_STEPS).all(), sol.status
        assert bool(torch.isfinite(sol.y_final.re).all()
                    & torch.isfinite(sol.y_final.im).all())
        assert (sol.n_accept == 0).all()


def test_loop_solve_declines_and_routes():
    """Another adaptivity than the stepper's declines the loop (None); the
    persistent and chunked loop twins take the same steps; the twins
    launch nothing on CPU tensors."""
    _, top = _models(torch.float64)
    y0 = tcp.from_complex(_psi(), torch.float64, device="cpu")
    grid = vt.make_grid(0.0, TF, dtype=torch.float64, device="cpu")
    ctl = vt.StepControl(**BASE)
    for kind, adaptive in (("mm6", False), ("mm6_fixed", True),
                           ("cfm4", False), ("cfm4_fixed", True)):
        assert _tstepper(kind, top).fused_loop_solve(
            y0, grid, 1e-3, ctl=ctl, adaptive=adaptive) is None
    before = (expmv.fused_chain_apply.launches,
              fused_loop.fused_loop_chunk.launches)
    for kind in ("mm6", "blanes"):
        st = _tstepper(kind, top)
        p = st.fused_loop_solve(y0, grid, 1e-3, ctl=ctl, adaptive=True)
        c = st.fused_loop_solve(y0, grid, 1e-3, ctl=ctl, adaptive=True,
                                persistent=False, chunk=3)
        for k in ("status", "n_accept", "n_reject", "n_iters", "h_final"):
            assert torch.equal(getattr(p, k), getattr(c, k)), k
        assert torch.equal(p.y_final.re, c.y_final.re)
    assert (expmv.fused_chain_apply.launches,
            fused_loop.fused_loop_chunk.launches) == before
