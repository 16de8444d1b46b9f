"""State-dimension parallelism: one large linear ODE dx/dt = A(t) x with
its operator row-sharded over a mesh axis (the counterpart of
``vec_ode_tpu/parallel/state_parallel.py``).

* A is row-sharded over the axis: each rank holds its (D/n, D) rows;
* the state is sharded (D/n,) a rank;
* one RHS evaluation is an all-gather of the state over the axis's
  process group and a local (D/n, D) product with the full state (plain
  ``torch.matmul``, IEEE: the JAX package's ``einsum`` at HIGHEST, no
  hand kernel);
* the controller's error norm is a local sum of |e|^2 and an all-reduce
  over the axis, so every rank of the axis reads the same bits and takes
  the same accept / reject decisions: the host driver's loop condition,
  and so the number of collectives, is the same on each (with NCCL a
  collective that one rank skips is a hang, not an error).

:func:`ensemble_solve_state_sharded` adds the trajectory axis of a 2-D
("traj", "state") mesh: the batch is sharded over "traj" with no
communication, and each rank runs the port's batched driver over its
(B/t, D/s) block, one all-gather of the block a RHS evaluation and one
all-reduce of its (B/t,) sums a step; each trajectory keeps its own
controller and counters, as under the JAX package's vmap. (Collectives do
not run under ``torch.func.vmap``, so the batched driver takes its
place.)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..api import _time_dtype
from ..controller import StepControl, check_h0
from ..driver import Solution, integrate, make_grid
from ..rk import RungeKutta
from . import _mesh


def local_rows(assemble: Callable, mesh, axis: Optional[str] = None
               ) -> Callable:
    """Turn a GLOBAL operator assembly ``assemble(t) -> (D, D)`` into the
    per-shard ``assemble_local(t) -> (D/n, D)`` that the state-sharded
    solvers take: each rank assembles the full operator and keeps its row
    block, the rows of its place on ``axis`` (default: the mesh's LAST
    axis, as the solvers default; for large D write ``assemble_local``
    directly so that each rank builds only its rows)."""
    axis = axis or mesh.mesh_dim_names[-1]
    dim = _mesh.mesh_dim(mesh, axis)
    n, i = mesh.size(dim), mesh.get_local_rank(dim)

    def assemble_local(t):
        A = assemble(t)
        rows = A.shape[0] // n
        return A[i * rows:(i + 1) * rows]

    return assemble_local


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None)
    (gather or dist.all_gather_into_tensor)(out, inp, group=group)


def _gather_cols(y_loc: torch.Tensor, group, n: int) -> torch.Tensor:
    """(..., D/n) -> (..., D): the blocks of the axis's ranks in rank order
    along the last dim; one collective (complex blocks travel as their
    real views)."""
    lead, dl = y_loc.shape[:-1], y_loc.shape[-1]
    src = y_loc.reshape(-1, dl)
    m = src.shape[0]
    if src.is_complex():
        src = torch.view_as_real(src)
    src = src.contiguous()
    out = src.new_empty((n * m,) + src.shape[1:])
    _all_gather(out, src, group)
    if y_loc.is_complex():
        out = torch.view_as_complex(out)
    return out.reshape(n, m, dl).transpose(0, 1).reshape(*lead, n * dl)


def _check_ieee(a: torch.Tensor) -> None:
    if (a.is_cuda and a.dtype in (torch.float32, torch.complex64)
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the state-sharded product feeds the error estimate and needs "
            "IEEE float32 products; set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def _sharded_rhs(A, a_fn, group, n: int) -> Callable:
    """f(t, y_loc) = A_loc(t) @ gather(y_loc), for one trajectory's
    (D/n,) block or a batch's (B, D/n) with per-trajectory times (B,),
    where a time-dependent ``a_fn`` is mapped over the times."""
    def rhs(t, y_loc):
        y_full = _gather_cols(y_loc, group, n)
        if a_fn is None:
            _check_ieee(y_full)
            return torch.matmul(y_full, A.mT)
        t = torch.as_tensor(t)
        if t.ndim == 0:
            a = a_fn(t)
            _check_ieee(a)
            return torch.matmul(y_full, a.mT)
        a = torch.func.vmap(a_fn)(t)                    # (B, D/n, D)
        _check_ieee(a)
        return torch.matmul(a, y_full.unsqueeze(-1)).squeeze(-1)

    return rhs


def _sharded_norm(group) -> Callable:
    """sqrt of the axis's all-reduced sum of |e|^2 over the last dim: a
    scalar for one trajectory, (B,) for a batch."""
    import torch.distributed as dist

    def err_norm(e):
        sq = (e * e.conj()).real.sum(-1)
        dist.all_reduce(sq, group=group)
        return torch.sqrt(sq)

    return err_norm


def _run(A, y0, t0, tf, *, mesh, dims, state_dim, batch_shape, stepper, h0,
         adaptive, ctl, save_at, time_dtype) -> tuple:
    """The rank's solve: its rows of A (or ``A`` itself as the callable
    ``assemble_local(t)``) and its block of y0 through the driver, the
    stepper's step (and FSAL carry) over the sharded RHS and norm."""
    _mesh.check_mesh(mesh)
    if stepper is None:
        stepper = RungeKutta()
    a_fn = A if callable(A) else None
    A_loc = None if a_fn else _mesh.take(A, mesh, {state_dim: 0})
    y_loc = _mesh.take(y0, mesh, dims)
    group, n = mesh.get_group(state_dim), mesh.size(state_dim)
    if time_dtype is None:
        time_dtype = _time_dtype(t0, tf)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype,
                       device=y_loc.device)
    h0 = check_h0(h0, ctl, adaptive)
    rhs = _sharded_rhs(A_loc, a_fn, group, n)
    sol = integrate(
        stepper.make_step_fn(rhs), y_loc, t_grid, h0, adaptive=adaptive,
        ctl=ctl, error_norm=_sharded_norm(group), batch_shape=batch_shape,
        init_carry_fn=(stepper.make_init_carry(rhs)
                       if getattr(stepper, "has_carry", False) else None))
    return sol, t_grid


def solve_linear_state_sharded(
    A,
    y0: torch.Tensor,
    t0,
    tf,
    *,
    mesh,
    axis: Optional[str] = None,
    stepper=None,
    h0: Optional[float] = None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    time_dtype: Optional[torch.dtype] = None,
) -> Solution:
    """Integrate dx/dt = A(t) x with the operator row-sharded over
    ``mesh[axis]`` (default: the mesh's LAST axis, as :func:`local_rows`
    defaults; on a multi-axis mesh the two defaulting to different axes
    would mismatch row blocks and state shards). Every rank of the mesh
    calls it alike.

    ``A`` is a constant (D, D) tensor (global, the same on every rank, or
    a DTensor sharded on its rows over ``axis``), or a TIME-DEPENDENT
    callable ``assemble_local(t) -> (D/n, D)`` evaluated by each rank on
    its rows (``mesh.get_local_rank(axis)`` is the row block's index, or
    wrap a global assembly with :func:`local_rows`). ``y0`` is the full
    (D,) state (global, or a DTensor sharded over ``axis``), on the
    mesh's device type. Returns a Solution whose state fields are
    DTensors sharded over ``axis`` (``y_final`` (D,), ``ys`` (n_grid, D)
    on dim 1) and whose scalars are plain tensors, the same on every
    rank."""
    axis = axis or mesh.mesh_dim_names[-1]
    dim = _mesh.mesh_dim(mesh, axis)
    sol, _ = _run(A, y0, t0, tf, mesh=mesh, dims={dim: 0}, state_dim=dim,
                  batch_shape=(), stepper=stepper, h0=h0, adaptive=adaptive,
                  ctl=ctl, save_at=save_at, time_dtype=time_dtype)
    sol.y_final = _mesh.shard(sol.y_final, mesh, {dim: 0})
    sol.ys = _mesh.shard(sol.ys, mesh, {dim: 1})
    return sol


def ensemble_solve_state_sharded(
    A,
    y0_batch: torch.Tensor,
    t0,
    tf,
    *,
    mesh,
    traj_axis: str = "traj",
    state_axis: str = "state",
    stepper=None,
    h0: Optional[float] = None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    time_dtype: Optional[torch.dtype] = None,
) -> Solution:
    """2-D parallelism: a (B, D) ensemble on a (``traj_axis``,
    ``state_axis``) mesh (:func:`mesh_2d`).

    The batch is sharded over ``traj_axis`` (no communication); each
    trajectory's D-dim state over ``state_axis`` (an all-gather a RHS
    evaluation, an all-reduce a step, within the rank's state group).
    ``A`` is a constant (D, D) tensor (row-sharded over ``state_axis``,
    replicated over ``traj_axis``) or a time-dependent
    ``assemble_local(t) -> (D/s, D)`` callable, mapped over the
    trajectories' own times (see :func:`solve_linear_state_sharded` /
    :func:`local_rows`). ``y0_batch`` is global or a DTensor sharded
    (traj, state) on dims (0, 1). Returns a Solution of DTensors: the
    states sharded over both axes (``ys`` (B, n_grid, D) on dims 0 and 2),
    ``ts`` (B, n_grid) and the per-trajectory scalars over ``traj_axis``.
    """
    td = _mesh.mesh_dim(mesh, traj_axis)
    sd = _mesh.mesh_dim(mesh, state_axis)
    b = y0_batch.shape[0] // mesh.size(td)
    sol, t_grid = _run(A, y0_batch, t0, tf, mesh=mesh, dims={td: 0, sd: 1},
                       state_dim=sd, batch_shape=(b,), stepper=stepper,
                       h0=h0, adaptive=adaptive, ctl=ctl, save_at=save_at,
                       time_dtype=time_dtype)
    sol.y_final = _mesh.shard(sol.y_final, mesh, {td: 0, sd: 1})
    sol.ys = _mesh.shard(sol.ys, mesh, {td: 0, sd: 2})
    sol.ts = _mesh.shard(t_grid.expand(b, t_grid.shape[0]), mesh, {td: 0})
    for name in ("t_final", "status", "n_accept", "n_reject", "n_iters",
                 "h_final"):
        setattr(sol, name, _mesh.shard(getattr(sol, name), mesh, {td: 0}))
    return sol


def mesh_2d(n_traj_shards: int, n_state_shards: int,
            traj_axis: str = "traj", state_axis: str = "state",
            device: str = "cuda"):
    """A 2-D DeviceMesh (``traj_axis``, ``state_axis``) over the world's
    first n_traj_shards * n_state_shards ranks, for combined trajectory x
    state sharding: NCCL on ``"cuda"``, gloo on ``"cpu"``; every rank of
    the world calls it alike. More devices than the world holds raise
    ``ValueError``."""
    return _mesh.make_mesh(device, (n_traj_shards, n_state_shards),
                           (traj_axis, state_axis))
