"""Ensemble propagation: many independent trajectories in one solve (the
counterpart of ``vec_ode_tpu/parallel/ensemble.py``):

* natively batched steppers: the whole loop in one kernel launch where
  the stepper's ``fused_loop_solve`` takes the configuration, else one
  driver loop over per-step launches;
* the vmapped tier (the generic ``rk.RungeKutta``, ``stepper=None``, and
  exponential steppers with ``batched=False`` or over a split that cannot
  batch): one batched driver loop whose step is ``torch.func.vmap`` of
  the per-trajectory step over (t, x, dt) (and ``params`` and the
  stepper's carry); the driver's lane masking gives each trajectory the
  branch sequence that the JAX package's vmapped ``while_loop`` gives it.
  ``dense=True`` there is one batched ``dense.integrate_interp`` over the
  vmapped per-trajectory dense step.

``method="scan"`` runs the host driver on every tier (exactly
``ctl.max_steps`` iterations, no read of the device), so a natively
batched stepper skips its whole-loop kernel and launches its step kernel
once an iteration, as the JAX package skips ``fused_loop_solve``.

``mesh=`` shards the batch over a ``torch.distributed`` DeviceMesh
(:func:`ensemble_mesh`; :func:`shard_batch` places a batch): every rank
runs the unsharded solve above on its own contiguous rows, so the route
(loop kernel or step kernel, ``fused_loop.LOOP_MAX_BATCH`` included)
follows the rank's own batch, as the JAX package's ``shard_map`` of the
same body does, and the outputs come back as DTensors sharded on the
batch dim (no gather).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import lc
from ..controller import StepControl, check_h0
from ..driver import Solution, integrate, make_grid
from ..events import as_event_config
from ..rk import RungeKutta
from . import _mesh


def _declares_norm(stepper) -> bool:
    return dataclasses.is_dataclass(stepper) and any(
        f.name == "norm" for f in dataclasses.fields(stepper))


def _batched_norm_dispatch(stepper, error_norm, y0_batch, ctl):
    """How a natively batched stepper takes ``error_norm`` (the JAX
    package's ``ensemble_solve``, ``ensemble.py:104-181``): a declared
    ``lc.WeightedNorm`` is installed in the stepper's ``norm`` (its
    kernels execute it); an opaque callable is probed
    (``lc.try_trace_norm`` on one trajectory's state) and, where it maps
    to a scalar, installed as an ``lc.TracedNorm`` (the stepper then runs
    its twin step on the tensors' device). An auto-batched stepper takes
    the vmapped tier for what its batched conventions cannot express
    (``scaled_error`` without a loop kernel, a norm it cannot hold); an
    explicitly batched one raises. Returns (stepper, error_norm,
    use_batched)."""
    auto = bool(getattr(stepper, "auto_batched", False))
    declares = _declares_norm(stepper)
    custom = error_norm is not lc.norm_l2
    if custom and isinstance(error_norm, lc.WeightedNorm):
        if ctl.scaled_error:
            raise ValueError(
                "scaled_error and a WeightedNorm are mutually exclusive "
                "(both redefine the error measure)")
        if declares:
            existing = stepper.norm
            if existing is None:
                stepper = dataclasses.replace(stepper, norm=error_norm)
            elif not error_norm.same_as(existing):
                raise ValueError(
                    "stepper already declares a different norm= than the "
                    "error_norm= passed to ensemble_solve")
            custom = False
    elif custom and not ctl.scaled_error:
        traced = lc.try_trace_norm(
            error_norm, pytree.tree_map(lambda a: a[0], y0_batch))
        if traced is not None and declares and stepper.norm is None:
            stepper = dataclasses.replace(stepper, norm=traced)
            custom = False
    scaled_conflict = (ctl.scaled_error
                       and getattr(stepper, "fused_loop_solve", None) is None)
    if (custom or scaled_conflict) and auto:
        # the JAX package keeps the vmapped tier for calls that an
        # auto-batched stepper's batched conventions cannot express
        return stepper, error_norm, False
    if custom:
        raise ValueError(
            "this stepper computes its own per-trajectory error norms; an "
            "OPAQUE error_norm callable that does not map to one scalar "
            "per trajectory cannot be applied (declare an lc.WeightedNorm, "
            "or use batched=False dense-split steppers for the vmapped "
            "path)")
    return stepper, lc.norm_l2, True


def ensemble_solve(
    rhs_or_op: Optional[Callable],
    y0_batch,
    t0,
    tf,
    *,
    stepper=None,
    h0: Optional[float] = None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    error_norm: Callable = lc.norm_l2,
    time_dtype: Optional[torch.dtype] = None,
    mesh=None,
    axis_name: str = "traj",
    method: str = "while",
    params=None,
    events=None,
    dense: bool = False,
    remat_levels: int = 0,
    grad_safe: bool = False,
) -> Solution:
    """Integrate a batch of independent trajectories (leading axis of every
    leaf of ``y0_batch``) on ``y0_batch``'s device.

    ``rhs_or_op`` is the per-trajectory RHS ``f(t, y)`` (RK steppers) or
    operator assembly ``op_fn(t)`` (exponential steppers), unbatched: the
    steppers map it over the batch. With ``params`` (a pytree with the
    same leading batch axis) the signature becomes ``f(t, y, p)`` /
    ``op_fn(t, p)``, so an ensemble can sweep model parameters. None for a
    stepper that embeds its operator.

    Natively batched steppers (``ops.fused_rk.FusedModulatedLinearRK``,
    the modulated ``exp.MidpointModulated`` / ``MagnusModulated4`` /
    ``MagnusModulated6`` / ``CFMModulated``, and the generic exponential
    steppers over ``DenseSplit`` / ``DenseCplxSplit``) run the whole loop
    in one launch of the CUDA loop kernel where their ``fused_loop_solve``
    takes the configuration, else one driver loop over the whole batch
    with a kernel launch per step on the card, or the plain torch step on
    the CPU. Every other stepper (``stepper=None``, i.e. ``RungeKutta()``;
    ``batched=False``; a split that cannot batch) runs the vmapped tier:
    one driver loop over ``torch.func.vmap`` of the per-trajectory step,
    with ``error_norm`` applied per trajectory (``lc.norm_l2``, a declared
    ``lc.WeightedNorm`` or an opaque callable), ``scaled_error``, opaque
    event callables and per-trajectory ``h0``; an auto-batched generic
    stepper takes it too where its batched conventions cannot express the
    call (``scaled_error``, which needs the error vector).
    ``Solution.path`` names the path taken (``"torch-driver"`` on the
    vmapped tier, on either device).

    ``events`` (an ``events.EventConfig``, an ``Event``, a callable or a
    sequence of them) locates event crossings: declared observables run
    in the loop kernel, opaque callables in the host driver (the
    ``Solution.event_*`` fields). ``dense=True`` makes the interior
    ``save_at`` times free-running interpolated saves on the batched
    steppers: the loop kernel records the crossing steps' endpoints, else
    the host driver's ``dense.integrate_interp`` runs; the path name gains
    ``-dense``. On the vmapped tier ``dense=True`` interpolates from the
    RK stage slopes (``p_dense``) or cubic Hermite, as
    ``dense.solve_ivp_dense`` / ``solve_linear_dense`` do per trajectory.
    ``dense=True`` with events needs the loop kernel.

    ``method="scan"`` runs exactly ``ctl.max_steps`` driver iterations
    with no read of the device, on every tier (never the whole-loop
    kernel); autograd differentiates it. ``remat_levels`` and
    ``grad_safe`` are ``driver.integrate``'s, passed to every driver loop
    but the dense one (the JAX package's ``ensemble_solve`` has neither:
    its callers differentiate a jitted solve).

    The signature is the JAX package's, with those two added.
    ``time_dtype`` defaults to float64 (the JAX package's default under
    x64); ``h0`` may be per-trajectory (B,).

    ``mesh`` (a ``torch.distributed`` DeviceMesh, :func:`ensemble_mesh`)
    shards the batch over the mesh's first dimension; every rank of the
    mesh calls ``ensemble_solve`` alike. ``y0_batch``, ``params`` and a
    per-trajectory ``h0`` are global tensors (every rank holds the same;
    each takes its contiguous rows) or DTensors sharded on dim 0
    (:func:`shard_batch`), on the mesh's device type. The batch size must
    divide the mesh size. Each rank runs the unsharded solve on its rows
    (its route, and ``Solution.path``, are its own); every batched field
    of the Solution comes back as a DTensor sharded on dim 0
    (``.full_tensor()`` gathers it).

    ``error_norm`` on a natively batched stepper: a declared
    ``WeightedNorm`` goes into the stepper's ``norm`` (its kernels run
    it); an opaque callable that maps one trajectory's error to a scalar
    goes in as an ``lc.TracedNorm`` (the stepper runs its twin step on
    the tensors' device, path ``torch-driver+twin-step``); anything else
    takes the vmapped tier on an auto-batched stepper and raises on an
    explicitly batched one.
    """
    kw = dict(stepper=stepper, h0=h0, adaptive=adaptive, ctl=ctl,
              save_at=save_at, error_norm=error_norm, time_dtype=time_dtype,
              method=method, params=params, events=events, dense=dense,
              remat_levels=remat_levels, grad_safe=grad_safe)
    if mesh is not None:
        return _sharded_solve(rhs_or_op, y0_batch, t0, tf, mesh, kw)
    return _solve(rhs_or_op, y0_batch, t0, tf, **kw)


def _sharded_solve(rhs_or_op, y0_batch, t0, tf, mesh, kw) -> Solution:
    """``shard_map`` of the unsharded body (``ensemble.py:404-432``): the
    rank's rows of the batched inputs through :func:`_solve`, every
    batched output a DTensor sharded on dim 0 over the mesh's first
    dimension."""
    _mesh.check_mesh(mesh)
    lead = pytree.tree_leaves(y0_batch)[0].shape[0]
    n_shards = mesh.size()
    if lead % n_shards != 0:
        raise ValueError(
            f"ensemble size {lead} must divide the mesh size {n_shards}")
    rows = {0: 0}

    def local(tree):
        return pytree.tree_map(lambda a: _mesh.take(a, mesh, rows), tree)

    h0 = kw["h0"]
    if isinstance(h0, torch.Tensor) and h0.ndim:
        kw = dict(kw, h0=local(h0))
    sol = _solve(rhs_or_op, local(y0_batch), t0, tf,
                 **dict(kw, params=local(kw["params"])))
    b = lead // mesh.size(0)

    def out(a):
        if isinstance(a, torch.Tensor) and a.ndim and a.shape[0] == b:
            return _mesh.shard(a, mesh, rows)
        return a

    return dataclasses.replace(sol, **{
        f.name: pytree.tree_map(out, getattr(sol, f.name))
        for f in dataclasses.fields(sol) if f.name != "path"})


def _solve(rhs_or_op, y0_batch, t0, tf, *, stepper, h0, adaptive, ctl,
           save_at, error_norm, time_dtype, method, params, events, dense,
           remat_levels, grad_safe) -> Solution:
    """The unsharded ensemble solve on ``y0_batch``'s device."""
    if dense and (remat_levels or grad_safe):
        raise ValueError("dense=True: the dense driver takes neither "
                         "remat_levels nor grad_safe")
    if stepper is None:
        stepper = RungeKutta()
    event_cfg = as_event_config(events)
    use_batched = bool(getattr(stepper, "is_batched", False))
    if use_batched:
        stepper, error_norm, use_batched = _batched_norm_dispatch(
            stepper, error_norm, y0_batch, ctl)

    leaves = pytree.tree_leaves(y0_batch)
    b = leaves[0].shape[0]
    device = leaves[0].device
    if time_dtype is None:
        time_dtype = torch.float64
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype, device=device)
    h0 = check_h0(h0, ctl, adaptive)
    loop = dict(method=method, remat_levels=remat_levels,
                grad_safe=grad_safe)
    if not use_batched:
        sol = _vmapped_solve(rhs_or_op, y0_batch, t_grid, h0,
                             stepper=stepper, adaptive=adaptive, ctl=ctl,
                             error_norm=error_norm, params=params,
                             event_cfg=event_cfg, dense=dense, loop=loop)
        sol.ts = t_grid.expand(b, t_grid.shape[0])
        return sol

    if params is not None and not getattr(stepper, "supports_batched_params",
                                          False):
        raise ValueError(
            "params is unsupported for this natively batched stepper (it "
            "embeds its own operator)")
    fused = getattr(stepper, "fused_loop_solve", None)
    if fused is not None and method == "while" and not grad_safe:
        kw = {}
        if event_cfg is not None:
            kw["events"] = event_cfg
        if dense:
            kw["dense"] = True
        sol = fused(y0_batch, t_grid, h0, ctl=ctl, adaptive=adaptive, **kw)
        if sol is not None:
            return sol
    if ctl.scaled_error:
        raise ValueError(
            "scaled_error with a norm-returning stepper requires the fused "
            "loop kernel, which did not engage for this configuration (see "
            "the stepper's fused_loop_solve: e.g. the time dtype must be "
            "the state's; generic exponential steppers take batched=False "
            "for the vmapped tier)")
    if params is None:
        step_fn = stepper.make_step_fn(rhs_or_op)
    else:
        step_fn = stepper.make_step_fn(rhs_or_op, params=params)
    # a batched stepper's carry seed is shape-polymorphic over the batch
    init_cf = (stepper.make_init_carry(rhs_or_op)
               if getattr(stepper, "has_carry", False) else None)
    if dense:
        if event_cfg is not None:
            raise ValueError(
                "dense=True with events= needs the fused loop kernel, which "
                "did not engage for this configuration (the dense driver "
                "carries no event state; see fused_loop_solve eligibility)")
        sol = _batched_dense_fallback(
            stepper, step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
            ctl=ctl, method=method, batch_shape=(b,), init_carry_fn=init_cf)
    else:
        sol = integrate(step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
                        ctl=ctl, error_norm=stepper.error_norm,
                        batch_shape=(b,), init_carry_fn=init_cf,
                        event_cfg=event_cfg, **loop)
        sol.path = stepper.step_path(y0_batch)
    # the shared save grid, per trajectory (as the JAX package returns it)
    sol.ts = t_grid.expand(b, t_grid.shape[0])
    return sol


def _check_arity(fn: Callable, takes_state: bool) -> None:
    """With ``params`` the callable takes (t, y, p) (RK) or (t, p)
    (exponential steppers), as the JAX package checks it."""
    want = 3 if takes_state else 2
    try:
        n_args = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_args = want
    if n_args != want:
        sig = "(t, y, p)" if takes_state else "(t, p)"
        raise ValueError(
            f"with params, this stepper expects rhs_or_op{sig}; got a "
            f"{n_args}-parameter callable")


def _batched_norm(error_norm: Callable) -> Callable:
    """A per-trajectory error norm over the batch: ``lc.norm_l2`` as
    ``lc.norm_l2_batched``, a declared ``WeightedNorm`` by its ``.batched``
    form, any other callable through ``torch.func.vmap``."""
    if error_norm is lc.norm_l2:
        return lc.norm_l2_batched
    if isinstance(error_norm, lc.WeightedNorm):
        return error_norm.batched
    return torch.func.vmap(error_norm)


def _vmapped_solve(rhs_or_op, y0_batch, t_grid, h0, *, stepper, adaptive,
                   ctl, error_norm, params, event_cfg, dense,
                   loop) -> Solution:
    """The vmapped tier: one batched driver loop over ``torch.func.vmap``
    of the per-trajectory step, its carry seeded by the vmapped
    ``make_init_carry`` (FSAL); with ``dense`` one batched
    ``dense.integrate_interp`` over the vmapped per-trajectory dense step.
    A missing error estimate crosses the vmap as an empty tuple."""
    from ..dense import integrate_interp, linear_slope, rk_dense_step

    takes_state = bool(getattr(stepper, "takes_state", False))
    if params is not None:
        _check_arity(rhs_or_op, takes_state)

    def fn_of(p):
        if p is None:
            return rhs_or_op
        return ((lambda tt, y: rhs_or_op(tt, y, p)) if takes_state
                else (lambda tt: rhs_or_op(tt, p)))

    interp = {}
    if dense:
        if event_cfg is not None:
            raise ValueError(
                "dense=True with events= needs the fused loop kernel "
                "(batched modulated steppers); the vmapped dense driver "
                "carries no event state")
        if takes_state and not isinstance(stepper, RungeKutta):
            raise ValueError("dense=True supports RungeKutta and exp "
                             "steppers on the vmapped tier")
        if getattr(stepper, "compensated", False):
            raise ValueError(
                "dense=True has no compensated variant (the dense driver "
                "carries no lo word); use compensated=False")
        if takes_state:
            # the JAX package's solve_ivp_dense per trajectory
            def make(p):
                return rk_dense_step(fn_of(p), stepper.tableau,
                                     stepper.advance_lower)[:2]

            _, init, kind = rk_dense_step(rhs_or_op, stepper.tableau,
                                          stepper.advance_lower)
            has_init = init is not None
            interp = dict(interp_kind=kind, tab=stepper.tableau)
        else:
            # solve_linear_dense per trajectory: Hermite over A(t) x
            def make(p):
                op_fn = fn_of(p)
                slope = linear_slope(stepper, op_fn)
                inner = stepper.make_step_fn(op_fn)

                def step_dense(t, x, dt):
                    x_next, err = inner(t, x, dt)
                    return x_next, err, (slope(t, x), slope(t + dt, x_next))

                return step_dense, None

            has_init = False
    else:
        has_init = bool(getattr(stepper, "has_carry", False))

        def make(p):
            fn = fn_of(p)
            return (stepper.make_step_fn(fn),
                    stepper.make_init_carry(fn) if has_init else None)

    step_fn, init_carry_fn = _vmap_step(make, params, has_init)
    b = pytree.tree_leaves(y0_batch)[0].shape[0]
    enorm = _batched_norm(error_norm)
    if dense:
        sol = integrate_interp(step_fn, y0_batch, t_grid, h0,
                               adaptive=adaptive, ctl=ctl, error_norm=enorm,
                               method=loop["method"], batch_shape=(b,),
                               init_carry_fn=init_carry_fn, **interp)
    else:
        sol = integrate(step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
                        ctl=ctl, error_norm=enorm, batch_shape=(b,),
                        init_carry_fn=init_carry_fn, event_cfg=event_cfg,
                        **loop)
    sol.path = "torch-driver"
    return sol


def _vmap_step(make: Callable, params, has_init: bool):
    """The batched (step_fn, init_carry_fn or None) of the vmapped tier:
    ``torch.func.vmap`` of the per-trajectory step and carry seed that
    ``make(p)`` builds for one trajectory's params ``p`` (None without
    params). A missing error estimate crosses the vmap as an empty
    tuple."""

    def single(p, t, x, dt, *carry):
        out = make(p)[0](t, x, dt, *carry)
        return (out[0], () if out[1] is None else out[1]) + tuple(out[2:])

    def single_init(p, t, x):
        return make(p)[1](t, x)

    if params is None:
        mapped = torch.func.vmap(functools.partial(single, None))
        mapped_init = torch.func.vmap(functools.partial(single_init, None))
        args = ()
    else:
        mapped = torch.func.vmap(single)
        mapped_init = torch.func.vmap(single_init)
        args = (params,)

    def step_fn(t, x, dt, *carry):
        out = mapped(*args, t, x, dt, *carry)
        err = out[1] if pytree.tree_leaves(out[1]) else None
        return (out[0], err) + tuple(out[2:])

    init_carry_fn = None
    if has_init:
        def init_carry_fn(t0, x0):
            b = pytree.tree_leaves(x0)[0].shape[0]
            return mapped_init(*args, t0.expand(b), x0)

    return step_fn, init_carry_fn


def _batched_dense_fallback(stepper, fn, y0, t_grid, h0, *, adaptive, ctl,
                            batch_shape, method="while",
                            init_carry_fn=None) -> Solution:
    """The host driver's dense tier for a natively batched stepper:
    free-running ``dense.integrate_interp`` with cubic-Hermite saves whose
    endpoint slopes are the stepper's ``hermite_slope``, or the operator
    action A(t) x of its ``ModulatedOperator``; a stepper with a carry
    threads it (``init_carry_fn``)."""
    from ..dense import integrate_interp

    slope = getattr(stepper, "hermite_slope", None)
    if slope is None:
        op = getattr(stepper, "op", None)
        if op is None or not hasattr(op, "coeff_fn"):
            raise ValueError(
                "dense=True on a natively-batched stepper needs its "
                "ModulatedOperator (or a hermite_slope method) for the "
                "Hermite endpoint slopes; for generic exp steppers pass "
                "batched=False (the vmapped dense driver computes slopes "
                "from the split)")
        from ..exp.modulated import operator_slope

        def slope(t, x):
            return operator_slope(op, t, x)

    if init_carry_fn is not None:
        def sfd(t, x, dt, carry):
            xn, err, c2 = fn(t, x, dt, carry)
            return xn, err, (slope(t, x), slope(t + dt, xn)), c2
    else:
        def sfd(t, x, dt):
            xn, err = fn(t, x, dt)
            return xn, err, (slope(t, x), slope(t + dt, xn))

    sol = integrate_interp(sfd, y0, t_grid, h0, adaptive=adaptive, ctl=ctl,
                           error_norm=stepper.error_norm, method=method,
                           batch_shape=batch_shape,
                           init_carry_fn=init_carry_fn)
    sol.path = stepper.step_path(y0) + "-dense"
    return sol


def step_efficiency(sol: Solution, n_shards: int = 1,
                    per_shard: bool = False):
    """Straggler accounting of a batched Solution: the batched loop runs
    every lane until the slowest trajectory of its shard finishes, so it
    executes max(n_iters) * B lane iterations a shard where sum(n_iters)
    are useful. Returns useful / executed in [0, 1] (1: no waste);
    ``n_shards`` splits the leading batch axis as a mesh would (each
    shard its own loop), ``per_shard=True`` returns the (n_shards,)
    efficiencies instead of the aggregate. A sharded Solution (DTensor
    fields) is read through its full view: every rank of its mesh calls
    this alike."""
    ni = _mesh.full(sol.n_iters).reshape(n_shards, -1).to(torch.float64)
    per = ni.sum(dim=1) / (ni.amax(dim=1) * ni.shape[1])
    if per_shard:
        return per
    return ni.sum() / (ni.amax(dim=1) * ni.shape[1]).sum()


def cost_sorted_permutation(cost_hint) -> np.ndarray:
    """Straggler mitigation by placement: a permutation that sorts the
    trajectories by an expected cost (a sweep rate, a stiffness estimate,
    ``h_final`` or ``n_iters`` of an earlier solve), so that contiguous
    shards hold work of one size. Apply it to ``y0_batch`` (and params,
    h0) with ``a[perm]``, and undo it on the outputs with
    :func:`inverse_permutation`. A stable sort."""
    if isinstance(cost_hint, torch.Tensor):
        cost_hint = cost_hint.detach().cpu().numpy()
    return np.argsort(np.asarray(cost_hint), kind="stable")


def inverse_permutation(perm) -> np.ndarray:
    """The permutation that undoes ``perm``: inv[perm] = arange."""
    if isinstance(perm, torch.Tensor):
        perm = perm.detach().cpu().numpy()
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def _run_chunk(state, step_fn, *, adaptive, ctl, error_norm, chunk):
    """Advance a batched carry by at most ``chunk`` driver iterations,
    stopping early where no lane is RUNNING (the one read of the device
    an iteration)."""
    from ..driver import RUNNING, step_once

    for _ in range(chunk):
        if not bool((state.status == RUNNING).any()):
            break
        state = step_once(state, step_fn, adaptive=adaptive, ctl=ctl,
                          error_norm=error_norm, batched=True)
    return state


def ensemble_solve_compact(
    rhs_or_op: Optional[Callable],
    y0_batch,
    t0,
    tf,
    *,
    stepper=None,
    h0: Optional[float] = None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    error_norm: Callable = lc.norm_l2,
    time_dtype: Optional[torch.dtype] = None,
    chunk_iters: int = 64,
    min_batch: int = 8,
    bucket_multiple: Optional[int] = None,
):
    """Straggler-mitigated ensemble integration: the host driver runs
    chunks of at most ``chunk_iters`` iterations and, between chunks,
    COMPACTS the batch to the lanes still RUNNING (an ``index_select`` on
    the tensors' device), padded up to a multiple of ``bucket_multiple``
    (default max(min_batch, B // 16)) and never below ``min_batch``; the
    padding lanes repeat a running lane, frozen DONE. Finished lanes are
    written back to their place in the full batch (``index_copy``).

    A natively batched stepper takes one step (a K1 launch for
    ``FusedModulatedLinearRK`` on the card) an iteration on the
    compacted batch, never the loop kernel; any other stepper runs the
    vmapped tier. The rules are the JAX package's
    (``parallel/ensemble.py:ensemble_solve_compact``). Returns
    ``(Solution, {"executed_lane_iters", "useful_lane_iters",
    "efficiency"})``, efficiency = useful / executed, the number
    :func:`step_efficiency` gives the plain path afterwards."""
    from ..driver import DONE, RUNNING, init_state

    if stepper is None:
        stepper = RungeKutta()
    has_carry = bool(getattr(stepper, "has_carry", False))
    use_batched = bool(getattr(stepper, "is_batched", False))
    if use_batched:
        stepper, error_norm, use_batched = _batched_norm_dispatch(
            stepper, error_norm, y0_batch, ctl)
    if use_batched:
        step_fn = stepper.make_step_fn(rhs_or_op)
        enorm = stepper.error_norm
        init_cf = stepper.make_init_carry(rhs_or_op) if has_carry else None
        path = stepper.step_path(y0_batch)
    else:
        step_fn, init_cf = _vmap_step(
            lambda p: (stepper.make_step_fn(rhs_or_op),
                       stepper.make_init_carry(rhs_or_op) if has_carry
                       else None), None, has_carry)
        enorm = _batched_norm(error_norm)
        path = "torch-driver"

    leaves = pytree.tree_leaves(y0_batch)
    B, device = leaves[0].shape[0], leaves[0].device
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype or torch.float64,
                       device=device)
    h0 = check_h0(h0, ctl, adaptive)
    carry0 = () if init_cf is None else init_cf(t_grid[0], y0_batch)
    state = init_state(y0_batch, t_grid, h0, batch_shape=(B,),
                       stepper_carry=carry0)

    def lanes(st):
        return st._replace(ts_grid=())

    # the whole batch's result, lanes written back in their places
    out = lanes(state)
    active = torch.arange(B, device=device)
    executed = 0
    m = bucket_multiple or max(min_batch, B // 16, 1)

    def bucket(n):
        return max(min_batch, -(-n // m) * m, 1)

    while True:
        n_act = active.shape[0]
        before = state.n_iters[:n_act].clone()
        state = _run_chunk(state, step_fn, adaptive=adaptive, ctl=ctl,
                           error_norm=enorm, chunk=chunk_iters)
        executed += int((state.n_iters[:n_act] - before).max()) * n_act
        running = state.status[:n_act] == RUNNING
        n_run = int(running.sum())
        if n_run == 0:
            done = torch.arange(n_act, device=device)
            out = pytree.tree_map(
                lambda o, a: o.index_copy(0, active, a.index_select(0, done)),
                out, lanes(state))
            break
        new_b = bucket(n_run)
        if new_b >= n_act:
            continue
        # write the finished lanes back, compact to the running ones
        fin = torch.nonzero(~running).reshape(-1)
        out = pytree.tree_map(
            lambda o, a: o.index_copy(0, active.index_select(0, fin),
                                      a.index_select(0, fin)),
            out, lanes(state))
        keep = torch.nonzero(running).reshape(-1)
        pad = torch.cat([keep, keep[:1].expand(new_b - n_run)])
        state = pytree.tree_map(lambda a: a.index_select(0, pad),
                                lanes(state))._replace(ts_grid=t_grid)
        if new_b > n_run:
            # padding lanes: frozen DONE, so that they step no more
            status = state.status.clone()
            status[n_run:] = DONE
            state = state._replace(status=status)
        active = active.index_select(0, keep)

    sol = Solution(ts=t_grid.expand(B, t_grid.shape[0]), ys=out.ys,
                   t_final=out.t, y_final=out.x, status=out.status,
                   n_accept=out.n_accept, n_reject=out.n_reject,
                   n_iters=out.n_iters, h_final=out.h, path=path)
    useful = int(sol.n_iters.sum())
    return sol, {"executed_lane_iters": executed,
                 "useful_lane_iters": useful,
                 "efficiency": useful / max(executed, 1)}


def ensemble_mesh(n_devices: Optional[int] = None, axis: str = "traj",
                  device: str = "cuda"):
    """A 1-D ``torch.distributed`` DeviceMesh named ``axis`` over the
    world's first ``n_devices`` ranks (default: all), one rank a device:
    NCCL on ``"cuda"`` (each rank on its own card), gloo on ``"cpu"``.
    A process group not yet initialised is set up from the environment,
    as ``torchrun`` sets it; every rank of the world calls this alike.
    More devices than the world holds raise ``ValueError``."""
    world = _mesh.world_size(device)
    n = world if n_devices is None else n_devices
    return _mesh.make_mesh(device, (n,), (axis,))


def shard_batch(y0_batch, mesh):
    """Every tensor leaf of the host batch ``y0_batch`` (the same on every
    rank, as a JAX host array is one array) as a DTensor sharded on dim 0
    over the mesh's first dimension: each rank takes its own contiguous
    rows, with no collective, so that ``ensemble_solve(..., mesh=mesh)``
    runs without a gather. The leaves must lie on the mesh's device type
    and their leading size divide the mesh's first dimension."""
    _mesh.check_mesh(mesh)
    return pytree.tree_map(
        lambda a: _mesh.shard(_mesh.take(a, mesh, {0: 0}), mesh, {0: 0})
        if isinstance(a, torch.Tensor) else a, y0_batch)
