"""The generic exponential steppers of the port on the CPU against the
JAX package's, in f64 on the same numpy inputs: the scalar step functions
(``midpoint_step``, ``magnus4_step``, ``magnus6_step``, ``cfm_step``,
``split_midpoint_step``, ``split_cfm_step``) step by step, and the slice
as a whole, ``parallel.ensemble_solve`` with every ported stepper over a
dense leaf against ``vec_ode_tpu.parallel.ensemble_solve``: as the port
runs them (on the CPU the twin of K9) and with the step's chains computed
by ``dense_fast.run_stacked_chains`` instead, the stacked batched ``expm``
that is the JAX package's default executor.

The gate for a solve: status, n_accept, n_reject and n_iters equal per
trajectory, y_final to 1e-10 (the executors differ from the JAX package's
batched expm by rounding per step: per-trajectory scaling and the
Paterson-Stockmeyer polynomial where JAX takes Padé-13 in f64). A scalar
step agrees to 1e-13.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu import tableaus as jtab
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert, lc
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch import tableaus as ttab
from vec_ode_tpu_torch.exp import dense_fast
from vec_ode_tpu_torch.exp.dense_fast import run_batched_chains
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.ops.dense_chains import fused_dense_chain_apply
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

D, B, TF = 8, 6, 0.4
CTL = dict(rtol=1e-6, min_dt=1e-6, max_dt=0.25)
WEIGHTS = tuple(np.linspace(0.5, 2.0, D))
SPLIT_CFM = dict(rho=((0.5, 0.5),), sigma=((0.5, 0.0), (0.0, 0.5)),
                 c=(0.2113248654051871, 0.7886751345948129))


@functools.cache
def _model():
    return JDrivenDense.make(d=D, seed=0)


def _jop(t):
    return _model().op_pair(t, jnp.float64)


@functools.cache
def _top():
    m = _model()
    return convert.driven_op_from_numpy(m.H0, m.V, m.w, dtype=torch.float64,
                                        device="cpu")


@functools.cache
def _split_parts():
    rng = np.random.default_rng(11)

    def herm():
        M = rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D))
        return (M + M.conj().T) / (2 * np.sqrt(D))

    HA, HB = herm(), herm()
    return [HA.imag, -HA.real, HB.imag, -HB.real]


def _jops(t):
    p = [jnp.asarray(a) for a in _split_parts()]
    c = jnp.cos(1.3 * jnp.asarray(t))
    return (jcp.Cplx(p[0] * c, p[1] * c), jcp.Cplx(p[2], p[3]))


def _tops(t):
    p = [torch.as_tensor(a.copy()) for a in _split_parts()]
    c = torch.cos(1.3 * t)
    # B is constant: + 0 c gives it the batch axis under vmap
    return (tcp.Cplx(p[0] * c, p[1] * c),
            tcp.Cplx(p[2] + 0 * c, p[3] + 0 * c))


def _psi(batch=()):
    rng = np.random.default_rng(42)
    psi = (rng.standard_normal(batch + (D,))
           + 1j * rng.standard_normal(batch + (D,)))
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


def _pair_close(got, want, tol):
    if want is None:
        assert got is None
        return
    assert got.re.dtype == torch.float64
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), rtol=0,
                               atol=tol)


# -- the scalar step functions, step by step ---------------------------------

SCALAR_STEPS = {
    "midpoint": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.midpoint_step(op, sp, t, x, dt)),
    "magnus4": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.magnus4_step(op, sp, t, x, dt)),
    "magnus4_fast": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.magnus4_step(op, sp, t, x, dt, fast_error=True)),
    "magnus4_fixed": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.magnus4_step(op, sp, t, x, dt, adaptive=False)),
    "magnus6": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.magnus6_step(op, sp, t, x, dt)),
    "magnus6_fixed": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.magnus6_step(op, sp, t, x, dt, adaptive=False)),
    "cfm4": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.cfm_step(op, sp, t, x, dt, tab.CFM_R4_J2_GL,
                                    tab.C_GAUSS_LEGENDRE_4,
                                    tab.CFM_R2_J1_GL)),
    "cfm4_fixed": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.cfm_step(op, sp, t, x, dt, tab.CFM_R4_J2_GL,
                                    tab.C_GAUSS_LEGENDRE_4, None)),
    "cfm4_blanes17": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.cfm_step(
            op, sp, t, x, dt, tab.BLANES17_R4_J4, tab.C_GAUSS_LEGENDRE_6,
            np.array([[5 / 18, 4 / 9, 5 / 18]]))),
    "split_midpoint": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.split_midpoint_step(ops, sp, sp, t, x, dt)),
    "split_midpoint_strict": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.split_midpoint_step(
            ops, sp, sp, t, x, dt, strict_reference_compat=True)),
    "split_cfm": lambda m, sp, op, ops, tab: (
        lambda t, x, dt: m.split_cfm_step(
            ops, sp, sp, t, x, dt, SPLIT_CFM["rho"], SPLIT_CFM["sigma"],
            SPLIT_CFM["c"])),
}


class _JFns:
    """The JAX package's step functions under the port's names."""
    midpoint_step = staticmethod(vexp.magnus.midpoint_step)
    magnus4_step = staticmethod(vexp.magnus4_step)
    magnus6_step = staticmethod(vexp.magnus6_step)
    cfm_step = staticmethod(vexp.cfm_step)
    split_midpoint_step = staticmethod(vexp.split_midpoint_step)
    split_cfm_step = staticmethod(vexp.split_cfm_step)


@pytest.mark.parametrize("name", sorted(SCALAR_STEPS))
def test_scalar_step_matches_jax(name):
    """Three steps of one trajectory from the same state, each fed the
    JAX package's state so that the steps compare one by one."""
    jstep = SCALAR_STEPS[name](_JFns, vexp.DenseCplxSplit(), _jop, _jops,
                               jtab)
    tstep = SCALAR_STEPS[name](texp, texp.DenseCplxSplit(), _top(), _tops,
                               ttab)
    psi = _psi()
    jx = jcp.from_complex(psi, jnp.float64)
    t = 0.1
    for dt in (0.05, 0.2, 0.013):
        tx = tcp.Cplx(torch.as_tensor(np.asarray(jx.re).copy()),
                      torch.as_tensor(np.asarray(jx.im).copy()))
        jy, jerr = jstep(t, jx, dt)
        ty, terr = tstep(t, tx, dt)
        _pair_close(ty, jy, 1e-13)
        _pair_close(terr, jerr, 1e-13)
        jx, t = jy, t + dt


def test_scalar_steps_take_tensor_times_and_real_splits():
    """A real DenseSplit with 0-dim tensor times, against the JAX step."""
    rng = np.random.default_rng(5)
    A0, A1 = rng.standard_normal((2, D, D)) / np.sqrt(D)
    x = rng.standard_normal(D)
    jy, jerr = vexp.magnus4_step(
        lambda t: jnp.asarray(A0) + jnp.sin(t) * jnp.asarray(A1),
        vexp.DenseSplit(), 0.3, jnp.asarray(x), 0.1)
    tA0, tA1 = torch.as_tensor(A0), torch.as_tensor(A1)
    ty, terr = texp.magnus4_step(
        lambda t: tA0 + torch.sin(t) * tA1, texp.DenseSplit(),
        torch.tensor(0.3, dtype=torch.float64), torch.as_tensor(x),
        torch.tensor(0.1, dtype=torch.float64))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-13)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-13)


def test_split_cfm_step_validates_shapes():
    sp, x = texp.DenseCplxSplit(), tcp.from_complex(_psi(), device="cpu")
    with pytest.raises(ValueError):
        texp.split_cfm_step(_tops, sp, sp, 0.0, x, 0.1, (0.5, 0.5),
                            SPLIT_CFM["sigma"], SPLIT_CFM["c"])
    with pytest.raises(ValueError):
        texp.split_cfm_step(_tops, sp, sp, 0.0, x, 0.1, SPLIT_CFM["rho"],
                            SPLIT_CFM["sigma"][:1], SPLIT_CFM["c"])
    with pytest.raises(ValueError):
        texp.SplitCFM(sp, sp, rho=((0.5,),), sigma=SPLIT_CFM["sigma"],
                      c=SPLIT_CFM["c"]).make_step_fn(_tops)


# -- the slice as a whole: ensemble_solve ------------------------------------

def _dense(m):
    return m.DenseCplxSplit()


# name -> (make(m, **kw), adaptive, uses the split operator pair)
ENSEMBLES = {
    "midpoint": (lambda m, **kw: m.ExpMidpoint(_dense(m), **kw), False,
                 False),
    "magnus4": (lambda m, **kw: m.Magnus4(_dense(m), **kw), True, False),
    "magnus4_fast": (lambda m, **kw: m.Magnus4(
        _dense(m), fast_error=True, **kw), True, False),
    "magnus4_fixed": (lambda m, **kw: m.Magnus4(
        _dense(m), adaptive=False, **kw), False, False),
    "magnus4_weighted_l2": (lambda m, **kw: m.Magnus4(_dense(m), **kw), True,
                            False),
    "magnus4_weighted_max": (lambda m, **kw: m.Magnus4(_dense(m), **kw),
                             True, False),
    "magnus4_fast_weighted": (lambda m, **kw: m.Magnus4(
        _dense(m), fast_error=True, **kw), True, False),
    "magnus6": (lambda m, **kw: m.Magnus6(_dense(m), **kw), True, False),
    "cfm4": (lambda m, **kw: m.CFM4(_dense(m), **kw), True, False),
    "cfm4_blanes17": (lambda m, **kw: m.CFM4_BLANES17(_dense(m), **kw), True,
                      False),
    "split_midpoint": (lambda m, **kw: m.SplitMidpoint(
        _dense(m), _dense(m), **kw), False, True),
    "split_midpoint_strict": (lambda m, **kw: m.SplitMidpoint(
        _dense(m), _dense(m), strict_reference_compat=True, **kw), False,
        True),
    "split_cfm": (lambda m, **kw: m.SplitCFM(
        _dense(m), _dense(m), **SPLIT_CFM, **kw), False, True),
}
NORMS = {"magnus4_weighted_l2": ("l2", WEIGHTS),
         "magnus4_weighted_max": ("max", None),
         "magnus4_fast_weighted": ("rms", WEIGHTS)}


def _np_sol(sol):
    return {"status": np.asarray(sol.status),
            "n_accept": np.asarray(sol.n_accept),
            "n_reject": np.asarray(sol.n_reject),
            "n_iters": np.asarray(sol.n_iters),
            "re": np.asarray(sol.y_final.re), "im": np.asarray(sol.y_final.im),
            "ts": np.asarray(sol.ts)}


@functools.cache
def _jax_solution(name):
    make, adaptive, is_split = ENSEMBLES[name]
    kw = {}
    if name in NORMS:
        kw["error_norm"] = jlc.WeightedNorm(*NORMS[name])
    sol = jensemble_solve(
        _jops if is_split else _jop, jcp.from_complex(_psi((B,)), jnp.float64),
        0.0, TF, stepper=make(vexp), adaptive=adaptive,
        ctl=vo.StepControl(**CTL), h0=0.02, time_dtype=jnp.float64, **kw)
    return _np_sol(sol)


EXECUTORS = pytest.mark.parametrize("executor",
                                    ["kernel_twin", "stacked_expm"])


def _use_executor(monkeypatch, executor):
    """"stacked_expm": the steppers' chains go through
    ``run_stacked_chains``, the reference computation, instead of the
    kernel's wrapper."""
    if executor == "stacked_expm":
        monkeypatch.setattr(
            dense_fast, "run_batched_chains",
            lambda *a, lo=None, **kw: dense_fast.run_stacked_chains(*a, **kw))


def _torch_solve(name, **extra):
    make, adaptive, is_split = ENSEMBLES[name]
    kw = dict(extra)
    if name in NORMS:
        kw["error_norm"] = lc.WeightedNorm(*NORMS[name])
    return ensemble_solve(
        _tops if is_split else _top(),
        tcp.from_complex(_psi((B,)), torch.float64, device="cpu"), 0.0, TF,
        stepper=make(texp), adaptive=adaptive,
        ctl=vt.StepControl(**CTL), h0=0.02, **kw)


@EXECUTORS
@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_ensemble_solve_matches_jax(name, executor, monkeypatch):
    _use_executor(monkeypatch, executor)
    want = _jax_solution(name)
    sol = _torch_solve(name)
    assert sol.path == "torch-driver"
    got = _np_sol(sol)
    assert (want["status"] == vo.DONE).all()
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["n_accept"].min() >= 2
    np.testing.assert_allclose(got["re"], want["re"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["im"], want["im"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got["ts"], want["ts"])
    norm = np.sqrt((got["re"] ** 2 + got["im"] ** 2).sum(-1))
    if "strict" not in name:
        assert np.abs(norm - 1).max() < 1e-9


def test_adaptive_solves_reject_some_steps():
    """The comparison above covers both branches of the controller."""
    assert _jax_solution("magnus4")["n_reject"].max() >= 1


@EXECUTORS
def test_ensemble_solve_with_params_matches_jax(executor, monkeypatch):
    """``params``: one drive frequency per trajectory, op_fn(t, p)."""
    _use_executor(monkeypatch, executor)
    m = _model()
    w = np.linspace(0.5, 2.0, B)
    jparts = m.pair_parts(jnp.float64)

    def jop(t, p):
        c = jnp.cos(p * jnp.asarray(t))
        return jcp.Cplx(jparts[0].im + c * jparts[1].im,
                        -(jparts[0].re + c * jparts[1].re))

    H0, V = DrivenDense(m.H0, m.V, m.w).pair_parts(torch.float64, "cpu")

    def top(t, p):
        c = torch.cos(p * t)
        return tcp.Cplx(H0.im + c * V.im, -(H0.re + c * V.re))

    want = _np_sol(jensemble_solve(
        jop, jcp.from_complex(_psi((B,)), jnp.float64), 0.0, TF,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()), ctl=vo.StepControl(**CTL),
        h0=0.02, time_dtype=jnp.float64, params=jnp.asarray(w)))
    sol = ensemble_solve(
        top, tcp.from_complex(_psi((B,)), torch.float64, device="cpu"), 0.0,
        TF, stepper=texp.Magnus4(texp.DenseCplxSplit()),
        ctl=vt.StepControl(**CTL), h0=0.02, params=torch.as_tensor(w))
    got = _np_sol(sol)
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the frequencies do differ per trajectory
    assert len(set(want["n_accept"].tolist())) > 1 or \
        np.abs(want["re"][0] - want["re"][-1]).max() > 1e-3
    np.testing.assert_allclose(got["re"], want["re"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["im"], want["im"], rtol=0, atol=1e-10)


@EXECUTORS
def test_real_dense_split_and_save_grid_match_jax(executor, monkeypatch):
    """A real DenseSplit (no embedding) on a save grid, through CFM4."""
    _use_executor(monkeypatch, executor)
    rng = np.random.default_rng(6)
    A0, A1 = rng.standard_normal((2, D, D)) / np.sqrt(D)
    A0, A1 = A0 - A0.T, A1 - A1.T
    x0 = rng.standard_normal((B, D))
    save_at = (0.1, 0.25)
    want = jensemble_solve(
        lambda t: jnp.asarray(A0) + jnp.sin(t) * jnp.asarray(A1),
        jnp.asarray(x0), 0.0, TF, stepper=vexp.CFM4(vexp.DenseSplit()),
        ctl=vo.StepControl(**CTL), h0=0.02, save_at=save_at,
        time_dtype=jnp.float64)
    tA0, tA1 = torch.as_tensor(A0), torch.as_tensor(A1)
    sol = ensemble_solve(
        lambda t: tA0 + torch.sin(t) * tA1, torch.as_tensor(x0), 0.0, TF,
        stepper=texp.CFM4(texp.DenseSplit()), ctl=vt.StepControl(**CTL),
        h0=0.02, save_at=save_at)
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(),
                                      np.asarray(getattr(want, k)))
    assert sol.ys.shape == (B, 4, D)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(want.ys), rtol=0,
                               atol=1e-10)


# -- routing, refusals and the executors' contract ---------------------------

@pytest.mark.parametrize("name", ["magnus4", "magnus4_weighted_l2",
                                  "magnus4_weighted_max",
                                  "magnus4_fast_weighted", "magnus6",
                                  "split_cfm"])
def test_every_iteration_reaches_the_kernel_wrapper(name, monkeypatch):
    """Each driver iteration calls the K9 wrapper (its twin on CPU
    tensors) once, under a declared norm too, which it receives."""
    calls = []
    real = dense_fast.fused_dense_chain_apply
    monkeypatch.setattr(
        dense_fast, "fused_dense_chain_apply",
        lambda *a, **k: calls.append(k.get("wnorm")) or real(*a, **k))
    sol = _torch_solve(name)
    assert len(calls) == int(sol.n_iters.max())
    # fast_error measures w2 xf outside the chains, with the norm there
    declared = name in NORMS and "fast" not in name
    assert all((c is not None) == declared for c in calls)
    assert fused_dense_chain_apply.launches == 0    # no card here


def test_steppers_have_no_executor_option():
    """One executor on the card: the kernel. The stacked expm is a
    function beside it, not a stepper's field."""
    sp = texp.DenseCplxSplit()
    for st in (texp.ExpMidpoint(sp), texp.Magnus4(sp), texp.Magnus6(sp),
               texp.CFM4(sp), texp.CFM4_BLANES17(sp),
               texp.SplitMidpoint(sp, sp),
               texp.SplitCFM(sp, sp, **SPLIT_CFM)):
        assert not hasattr(st, "use_kernel"), st
        assert not hasattr(st, "use_pallas"), st
    with pytest.raises(TypeError):
        texp.Magnus4(sp, use_kernel=False)


class _OnCard:
    is_cuda = True


@pytest.mark.parametrize("make", [
    lambda sp, wn: texp.Magnus4(sp),
    lambda sp, wn: texp.Magnus4(sp, norm=wn),
    lambda sp, wn: texp.Magnus4(sp, norm=wn, fast_error=True),
    lambda sp, wn: texp.Magnus6(sp, norm=wn),
    lambda sp, wn: texp.CFM4(sp),
    lambda sp, wn: texp.CFM4(sp, norm=wn),
    lambda sp, wn: texp.ExpMidpoint(sp),
    lambda sp, wn: texp.SplitMidpoint(sp, sp),
    lambda sp, wn: texp.SplitCFM(sp, sp, **SPLIT_CFM),
], ids=["magnus4", "magnus4_norm", "magnus4_fast_norm", "magnus6_norm",
        "cfm4", "cfm4_norm", "midpoint", "split_midpoint", "split_cfm"])
def test_step_path_names_the_kernel_on_the_card(make):
    """On the card every generic stepper runs K9, whatever norm is
    declared; CPU tensors run its twin."""
    st = make(texp.DenseCplxSplit(), lc.WeightedNorm("l2"))
    assert st.step_path(tcp.Cplx(_OnCard(), _OnCard())) \
        == "torch-driver+cuda-step"
    assert st.step_path(tcp.from_complex(_psi((B,)), device="cpu")) \
        == "torch-driver"


def test_refusals_name_what_is_missing():
    sp = texp.DenseCplxSplit()
    y0 = tcp.from_complex(_psi((B,)), device="cpu")
    # items 25 and 26 are ported (tests/test_torch_compensated.py,
    # test_torch_traced_norm.py): the compensated tier carries lo, and
    # norm= takes a declared or a traced norm, nothing else
    assert texp.Magnus4(sp, compensated=True).has_carry
    with pytest.raises(TypeError, match="TracedNorm"):
        texp.Magnus4(sp, norm=lambda e: e)
    # the vmapped tier (batched=False, a split that cannot batch, and
    # scaled_error on an auto-batched stepper) runs: see
    # test_vmapped_tier_steppers_match_jax
    with pytest.raises(ValueError, match="dense split"):
        ensemble_solve(_top(), y0, 0.0, TF, h0=0.02, stepper=texp.Magnus4(
            texp.DiagonalCplxSplit(), batched=True))
    # scaled_error needs the error vector: the JAX package refuses it for
    # batched=True
    ctl = vt.StepControl(scaled_error=True, **CTL)
    with pytest.raises(ValueError, match="scaled_error"):
        ensemble_solve(_top(), y0, 0.0, TF, ctl=ctl, h0=0.02,
                       stepper=texp.Magnus4(sp, batched=True))
    # params only where the stepper maps them
    from vec_ode_tpu_torch.models import LandauZener
    mod = texp.MidpointModulated(LandauZener().modulated(torch.float64,
                                                         "cpu"))
    with pytest.raises(ValueError, match="params"):
        ensemble_solve(None, tcp.from_complex(_psi((B,))[:, :2],
                                              device="cpu"),
                       0.0, TF, stepper=mod, adaptive=False, h0=0.02,
                       params=torch.ones(B))
    # a fixed-step stepper has no error estimate for the controller
    with pytest.raises(ValueError, match="error estimate"):
        ensemble_solve(_top(), y0, 0.0, TF, stepper=texp.ExpMidpoint(sp),
                       adaptive=True, h0=0.02)
    with pytest.raises(ValueError, match="weights"):
        ensemble_solve(_top(), y0, 0.0, TF, stepper=texp.Magnus4(sp),
                       error_norm=lc.WeightedNorm("l2", (1.0, 2.0)), h0=0.02)


def _diag(op):
    """The diagonal of a dense Cplx operator callback."""
    def fn(t):
        L = op(t)
        return type(L)(L.re.diagonal(0, -2, -1), L.im.diagonal(0, -2, -1))
    return fn


# the steppers the vmapped tier runs, which raised before it was ported:
# (stepper, operator callback kind, controller)
VMAPPED = {
    "magnus4_unbatched": (lambda ex: ex.Magnus4(ex.DenseCplxSplit(),
                                                batched=False), "dense", {}),
    "magnus4_diagonal": (lambda ex: ex.Magnus4(ex.DiagonalCplxSplit()),
                         "diag", {}),
    "split_midpoint_diagonal": (lambda ex: ex.SplitMidpoint(
        ex.DenseCplxSplit(), ex.DiagonalCplxSplit()), "pair", None),
    "magnus4_scaled_error": (lambda ex: ex.Magnus4(ex.DenseCplxSplit()),
                             "dense", dict(scaled_error=True)),
}


def _vmapped_fn(kind, side):
    """The dense operator, its diagonal, or the (dense, diagonal) pair."""
    op = _jop if side == "jax" else _top()
    if side == "jax":
        diag = (lambda t: jcp.Cplx(jnp.diagonal(op(t).re),
                                   jnp.diagonal(op(t).im)))
    else:
        diag = _diag(op)
    return {"dense": op, "diag": diag,
            "pair": lambda t: (op(t), diag(t))}[kind]


@functools.cache
def _vmapped_want(name):
    make, kind, ctl = VMAPPED[name]
    kw = (dict(adaptive=False) if ctl is None else
          dict(ctl=vo.StepControl(**dict(CTL, **ctl))))
    return jensemble_solve(_vmapped_fn(kind, "jax"),
                           jcp.from_complex(_psi((B,)), jnp.float64), 0.0,
                           TF, stepper=make(vexp), h0=0.02, **kw)


@pytest.mark.parametrize("name", sorted(VMAPPED))
def test_vmapped_tier_steppers_match_jax(name):
    make, kind, ctl = VMAPPED[name]
    kw = (dict(adaptive=False) if ctl is None else
          dict(ctl=vt.StepControl(**dict(CTL, **ctl))))
    got = ensemble_solve(_vmapped_fn(kind, "torch"),
                         tcp.from_complex(_psi((B,)), device="cpu"), 0.0,
                         TF, stepper=make(texp), h0=0.02, **kw)
    want = _vmapped_want(name)
    assert got.path == "torch-driver"
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    _pair_close(got.y_final, want.y_final, 1e-12)
    np.testing.assert_allclose(got.h_final.numpy(), np.asarray(want.h_final),
                               rtol=1e-9)


def test_state_layout_helpers_round_trip():
    from vec_ode_tpu_torch.exp import dense_fast as df

    x = tcp.from_complex(_psi((B,)), device="cpu")
    for split, state in ((texp.DenseCplxSplit(), x), (texp.DenseSplit(),
                                                      x.re)):
        parts = df.split_parts(split, state)
        xw = df.widen(parts)
        assert xw.shape == (B, D * len(parts))
        for back in (df.unwiden(split, xw), df.split_unparts(split, parts)):
            assert type(back) is type(state)
            assert all(torch.equal(a, b) for a, b in zip(
                df.split_parts(split, back), parts))
    assert df.ps_params(torch.float32) == (12, 1.0)
    assert df.ps_params(torch.float64) == (12, 0.25)


def test_driven_dense_operators_match_jax():
    m = _model()
    tm = DrivenDense.make(d=D, seed=0)
    t = np.array([0.0, 0.37, 1.9])
    np.testing.assert_allclose(
        tm.hamiltonian(torch.as_tensor(t)[:, None, None],
                       device="cpu").numpy(),
        np.asarray(m.hamiltonian(jnp.asarray(t)[:, None, None])), rtol=0,
        atol=1e-15)
    for t037 in (0.37, torch.tensor(0.37, dtype=torch.float64)):
        np.testing.assert_allclose(tm.op(t037, device="cpu").numpy(),
                                   np.asarray(m.op(0.37)), rtol=0, atol=1e-15)
    for tt, jt in ((torch.float64, jnp.float64), (torch.float32,
                                                  jnp.float32)):
        got = torch.func.vmap(lambda s: tm.op_pair(s, tt, "cpu"))(
            torch.as_tensor(t))
        for k, ti in enumerate(t):
            want = m.op_pair(ti, jt)
            assert got.re.dtype == tt
            np.testing.assert_allclose(got.re[k].numpy(), np.asarray(want.re),
                                       rtol=0, atol=1e-6 if tt ==
                                       torch.float32 else 1e-15)
            np.testing.assert_allclose(got.im[k].numpy(), np.asarray(want.im),
                                       rtol=0, atol=1e-6 if tt ==
                                       torch.float32 else 1e-15)
    # the operators go to the device once per (dtype, device)
    assert len(tm._op_fns) == 2


def test_driven_dense_operators_default_to_the_card():
    """Like the package's other constructors: the card unless the caller
    names another device, and a tensor time must already lie there."""
    tm = DrivenDense.make(d=D, seed=0)
    t = torch.tensor(0.37, dtype=torch.float64)
    for call in (tm.hamiltonian, tm.op, tm.op_pair):
        with pytest.raises(ValueError, match="lies on cpu"):
            call(t)
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call(0.37)
    assert tm.op_pair(0.37, torch.float64, "cpu").re.device.type == "cpu"
