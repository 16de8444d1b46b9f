"""The system under test for the driven dense configurations: ensembles
of the 64-dim complex driven system H(t) = H0 + cos(w t) V through
``vec_ode_tpu_torch.parallel.ensemble_solve``.

The harness makes H0 and V (``DrivenDense.make``'s construction and
scaling, from the configuration's ``operator_seed``) and the pool of
unit-norm initial states (on the device, from the run's seed), and hands
them to the port: ``DrivenDense(H0=, V=, w=)``, then
``FusedModulatedLinearRK.from_driven_dense`` (method ``rkf45``) or
``MagnusModulated4`` over ``.modulated()`` (method ``magnus4``). The
traffic's ``drive`` is ``declared`` (the operator's own coefficient form,
which the loop kernel samples) or ``callable`` (a Python function of t and
no form, which the loop declines). A call solves one batch of the pool
over [t0, tf] with the traffic's saves; call i takes batch i mod P.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import traffic as tr
from ..counts import load as load_count


@dataclasses.dataclass
class DrivenDenseSystem:
    config: dict
    mix: dict
    device: str
    H0: torch.Tensor            # (d, d) complex128, as the reference gets it
    V: torch.Tensor
    w: float
    pool: list                  # P Cplx batches (B, d) in the state type
    stepper: object
    ctl: object
    save_at: tuple
    _passes: dict = dataclasses.field(default_factory=dict)

    # -- the call the window times -----------------------------------------

    def call(self, i: int):
        """The i-th call of the closed loop: one ensemble solve of batch
        i mod P (the port's Solution; nothing waited for)."""
        from vec_ode_tpu_torch.parallel import ensemble_solve

        c = self.config
        return ensemble_solve(
            None, self.pool[self.batch_of(i)], self.mix["t0"], self.mix["tf"],
            stepper=self.stepper, ctl=self.ctl, h0=c["h0"], adaptive=True,
            save_at=self.save_at or None, time_dtype=_dtype(c["time_dtype"]))

    def batch_of(self, i: int) -> int:
        return i % len(self.pool)

    # -- what the output check reads ---------------------------------------

    def check_times(self) -> list:
        """The times at which a call's states are judged: the saves, then
        tf (t0 is the input itself)."""
        return [*self.save_at, float(self.mix["tf"])]

    def initial_states(self, i: int) -> torch.Tensor:
        """Call i's initial states as complex128 (B, d): the rounded values
        the port was given."""
        y = self.pool[self.batch_of(i)]
        return torch.complex(y.re.double(), y.im.double())

    def outputs(self, sol) -> torch.Tensor:
        """The states a call produced at :meth:`check_times`, complex128
        (B, n_times, d): the interior saves and the final state."""
        parts = []
        if self.save_at:
            parts.append(torch.complex(sol.ys.re[:, 1:-1].double(),
                                       sol.ys.im[:, 1:-1].double()))
        parts.append(torch.complex(sol.y_final.re.double(),
                                   sol.y_final.im.double())[:, None])
        return torch.cat(parts, dim=1)

    # -- the least work, for the rooflines and solve_mfu ---------------------

    def chain_passes(self, i: int) -> list:
        """Taylor passes per chain that the solve of call i's batch needs
        (``counts/fused_loop_chain.py``), one replay per pool batch."""
        b = self.batch_of(i)
        if b not in self._passes:
            count = load_count("fused_loop_chain")
            self._passes[b] = count.replay_passes(self, self.pool[b])
        return self._passes[b]

    def solve_flop(self, run) -> float:
        """The least operations of all the calls of the traced window."""
        c, B, D = self.config, self.mix["batch"], 2 * self.config["d"]
        if c["method"] == "rkf45":
            rk = load_count("fused_loop_rk")
            return rk.flop_bytes(run.steps, B, D, c["stages"],
                                 len(self.save_at) + 2, 4)[0]
        chain = load_count("fused_loop_chain")
        return sum(chain.chain_flops(self.chain_passes(i), D)
                   for i in range(run.n_calls))


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def make_operators(seed: int, d: int, device: str) -> tuple:
    """H0 and V of the configuration, made as ``DrivenDense.make(d,
    seed)`` makes them (a copy of its construction: M complex Gaussian
    from ``numpy.random.default_rng(seed)``, H = (M + M^H) / (2 sqrt d)),
    complex128 on ``device``. The configuration fixes the seed: the
    operator sets how many steps a solve takes, so it is the same for
    every run's seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        out.append(torch.as_tensor((M + M.conj().T) / (2 * math.sqrt(d)),
                                   device=device))
    return tuple(out)


def callable_drive(w: float):
    """The drive a user writes as a function: t -> [1, cos(w t)]."""
    def coeff_fn(t):
        return torch.stack([torch.ones_like(t), torch.cos(w * t)], dim=-1)
    return coeff_fn


def build(config: dict, mix: dict, seed: int, device: str):
    from vec_ode_tpu_torch import StepControl
    from vec_ode_tpu_torch.exp import MagnusModulated4
    from vec_ode_tpu_torch.exp.modulated import ModulatedOperator
    from vec_ode_tpu_torch.models import DrivenDense
    from vec_ode_tpu_torch.ops.cplx import Cplx
    from vec_ode_tpu_torch.ops.fused_rk import FusedModulatedLinearRK

    d, w, dtype = config["d"], float(config["w"]), _dtype(config["dtype"])
    H0, V = make_operators(config["operator_seed"], d, device)
    gen = tr.generator(seed, device)
    states = tr.unit_states(gen, mix["pool_batches"] * mix["batch"], d,
                            device)
    pool = [Cplx(s.real.to(dtype).contiguous(), s.imag.to(dtype).contiguous())
            for s in states.split(mix["batch"])]
    model = DrivenDense(H0=H0.cpu().numpy(), V=V.cpu().numpy(), w=w)
    if config["method"] == "rkf45":
        if mix["drive"] != "declared":
            raise ValueError("the rkf45 configuration takes a declared drive")
        stepper = FusedModulatedLinearRK.from_driven_dense(model, dtype,
                                                           device=device)
    elif config["method"] == "magnus4":
        op = model.modulated(dtype, device=device)
        if mix["drive"] == "callable":
            op = ModulatedOperator(basis=op.basis, coeff_fn=callable_drive(w))
        elif mix["drive"] != "declared":
            raise ValueError(f"unknown drive {mix['drive']!r}")
        stepper = MagnusModulated4(op)
    else:
        raise ValueError(f"unknown method {config['method']!r}")
    ctl = StepControl(rtol=config["rtol"], atol=config["atol"],
                      min_dt=config["min_dt"], max_dt=config["max_dt"])
    return DrivenDenseSystem(
        config=config, mix=mix, device=device, H0=H0, V=V, w=w, pool=pool,
        stepper=stepper, ctl=ctl, save_at=tuple(mix["save_at"]))
