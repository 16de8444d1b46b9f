"""The loop kernel K2 with the chain step K5 (``csrc/fused_loop.cu`` over
``csrc/chain_step.cuh``) on the Magnus-4 pair: ``chip_smoke.chain_flops``,
``work_passes`` and the bound of ``time_k5``, frozen, with the port's
scaling rule (``ops/expmv.node_times``, ``chain_rows``, ``scale_rows``
for the ``magnus4`` recipe, C = 2) copied at the f32 Taylor degree and
threshold.

The least work of a solve: for every step the data needs (accepted and
rejected) and each chain of the pair, the Taylor passes its scaled row
needs, each pass m terms of a (D, K D) product with the K basis terms the
chain's row can hold nonzero (the comparison chain's commutator column is
zero and not counted), the K-term sum, the division and the running sum;
the carries, the state and the basis moved once.

The steps a solve takes come from a replay of the batch through the
port's plain twin of the loop kernel (``ops.fused_loop.torch_fused_loop``
with a ``ChainStep``), which takes the kernel's steps line for line; the
passes of each step are counted here. Only a traced run replays, after
its window.
"""

from __future__ import annotations

import math

import torch

from ..peaks import bound

M_TAYLOR, THETA, MAX_SQUARINGS = 8, 0.35, 16  # f32 (exp/modulated.py)
C_MID = 0.5 / math.sqrt(3.0)                 # Gauss-Legendre nodes
B2 = -math.sqrt(3.0) / 12.0                  # the commutator's weight
K0, KP = 2, 3                                # basis terms; with [M0, M1]


def chain_flops(passes, D: int, m: int = M_TAYLOR) -> float:
    """Operations of passes[c] Taylor passes of chain c of the Magnus-4
    pair: chain 0 over all K' = 3 working terms, chain 1 over its K0 = 2
    nonzero ones."""
    flop = 0
    for c, n in enumerate(passes):
        k = K0 if c == 1 else KP
        flop += n * m * (2 * D * k * D + 2 * k * D + 2 * D)
    return flop


def solve_bytes(B: int, D: int, nbytes: int = 4) -> int:
    """Bytes a loop solve moves at least: carries and state in and out,
    the working basis, the grid ends."""
    return nbytes * (2 * B * (5 + D) + KP * D * D + 2) + 2 * 4 * B * 8


def bound_ms(passes, B: int, D: int) -> tuple:
    return bound(chain_flops(passes, D), solve_bytes(B, D))


def basis_norms(H0: torch.Tensor, V: torch.Tensor,
                dtype=torch.float32) -> list:
    """||M_k||_1 of the real-embedded working terms -i H0, -i V and their
    commutator [M0, M1], in ``dtype``."""
    A0, A1 = -1j * H0, -1j * V
    terms = [A0, A1, A0 @ A1 - A1 @ A0]
    out = []
    for A in terms:
        re, im = A.real.to(dtype), A.imag.to(dtype)
        M = torch.cat([torch.cat([re, -im], 1), torch.cat([im, re], 1)], 0)
        out.append(float(M.abs().sum(0).max()))
    return out


def step_passes(t, dt, w: float, norms, theta: float = THETA,
                max_squarings: int = MAX_SQUARINGS) -> list:
    """Passes per chain, summed over the rows that step (dt != 0), of one
    Magnus-4 pair step from t over dt under the drive [1, cos(w t)]."""
    tm = t + 0.5 * dt
    ga = torch.stack([torch.ones_like(t), torch.cos(w * (tm - C_MID * dt))],
                     -1)
    gb = torch.stack([torch.ones_like(t), torch.cos(w * (tm + C_MID * dt))],
                     -1)
    dts = dt[:, None]
    w1 = 0.5 * dts * (ga + gb)
    w2 = (B2 * dts * dts) * (ga[:, :1] * gb[:, 1:] - ga[:, 1:] * gb[:, :1])
    main = torch.cat([w1, w2], 1)
    lower = torch.cat([w1, torch.zeros_like(w2)], 1)
    stepping = dt != 0
    out = []
    for row in (main, lower):
        acc = None
        for k in range(KP):
            term = row[:, k].abs() * norms[k]
            acc = term if acc is None else acc + term
        ratio = acc / theta
        mant, expo = torch.frexp(ratio)
        s = expo - (mant == 0.5).to(expo.dtype)
        s = torch.where(torch.isfinite(acc) & (ratio > 1.0),
                        torch.clamp(s, 0, max_squarings), 0)
        n_pass = torch.bitwise_left_shift(torch.ones_like(s), s)
        need = (row.abs().sum(-1) > 0) & stepping
        out.append(int((n_pass * need).sum()))
    return out


class _Counting:
    """A ChainStep that also counts the passes its stepping rows need."""

    def __init__(self, step, w: float, norms):
        self.step, self.w, self.norms = step, w, norms
        self.passes = [0, 0]

    def __getattr__(self, name):
        return getattr(self.step, name)

    def plain(self, t, dt, xw):
        got = step_passes(t, dt, self.w, self.norms)
        self.passes = [a + b for a, b in zip(self.passes, got)]
        return self.step.plain(t, dt, xw)


def replay_passes(system, batch) -> list:
    """The passes per chain a solve of ``batch`` (a Cplx (B, d)) needs:
    the batch replayed through the port's plain twin of the loop kernel
    under the system's controller, the operator's declared form."""
    from vec_ode_tpu_torch.driver import make_grid
    from vec_ode_tpu_torch.exp.modulated import CoeffForm
    from vec_ode_tpu_torch.ops.cplx import Cplx, embed
    from vec_ode_tpu_torch.ops.expmv import basis_norms as port_norms
    from vec_ode_tpu_torch.ops.expmv import stacked_transpose
    from vec_ode_tpu_torch.ops.fused_loop import (ChainStep, init_carries,
                                                  torch_fused_loop)

    dtype = batch.re.dtype
    dev = batch.re.device
    A = [(-1j * H).to(torch.complex128) for H in (system.H0, system.V)]
    A.append(A[0] @ A[1] - A[1] @ A[0])
    bw = embed(Cplx(torch.stack([a.real for a in A]).to(dtype),
                    torch.stack([a.imag for a in A]).to(dtype)))
    form = CoeffForm(a=(1.0, 0.0), b=(0.0, 0.0), c=(0.0, 1.0),
                     w=(0.0, system.w))
    step = ChainStep(mt=stacked_transpose(bw), norms=port_norms(bw),
                     form=form, recipe="magnus4", C=2, m=M_TAYLOR,
                     theta=THETA)
    counting = _Counting(step, system.w, basis_norms(system.H0, system.V,
                                                     dtype))
    mix = system.mix
    grid = make_grid(mix["t0"], mix["tf"], dtype=dtype, device=dev)
    carries = init_carries(grid, torch.cat([batch.re, batch.im], 1),
                           system.config["h0"])
    with torch.no_grad():
        torch_fused_loop(*carries, counting, ctl=system.ctl, adaptive=True)
    return counting.passes
