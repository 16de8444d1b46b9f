"""The driven tight-binding chain, the counterpart of
``vec_ode_tpu/models/chains.py``: dpsi/dt = -i (H_hop + v(t) H_onsite)
psi, whose hopping part is a dense leaf and whose onsite part a diagonal
one, the use case of the operator splits."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .quantum import _time_on


@dataclasses.dataclass(frozen=True)
class TightBindingChain:
    """n-site chain: H_hop = -J sum |k><k+1| + h.c. (+ the periodic wrap),
    H_onsite(t) = v(t) diag(site energies), v(t) = cos(w t). The numpy
    constructors are the JAX package's, so a seed gives the same
    energies."""

    n: int = 16
    J: float = 1.0
    periodic: bool = False
    seed: int = 0
    w: float = 1.0

    def __post_init__(self):
        # ops_pair's (H_hop, energies) by (dtype, device), made at first use
        object.__setattr__(self, "_parts", {})

    def hop_matrix(self) -> np.ndarray:
        H = np.zeros((self.n, self.n))
        for k in range(self.n - 1):
            H[k, k + 1] = H[k + 1, k] = -self.J
        if self.periodic:
            H[0, -1] = H[-1, 0] = -self.J
        return H

    def onsite_energies(self) -> np.ndarray:
        return np.random.default_rng(self.seed).uniform(-1, 1, self.n)

    def v(self, t):
        return torch.cos(self.w * t)

    def ops_pair(self, t, dtype=torch.float32, device="cuda"):
        """(La, Lb) for the splits over (DenseCplxSplit,
        DiagonalCplxSplit): La = -i H_hop, Lb = -i v(t) diag(e), v taken in
        the time's dtype, on the card unless ``device`` names another.
        The matrices go to the device once per (dtype, device); callable
        under ``torch.func.vmap``."""
        from ..ops.cplx import Cplx

        t = _time_on(t, device, "TightBindingChain")
        key = (dtype, t.device)
        if key not in self._parts:
            self._parts[key] = (
                torch.as_tensor(self.hop_matrix(), dtype=dtype,
                                device=t.device),
                torch.as_tensor(self.onsite_energies(), dtype=dtype,
                                device=t.device))
        Hh, e = self._parts[key]
        vt = self.v(t).to(dtype)
        return (Cplx(torch.zeros_like(Hh), -Hh),
                Cplx(torch.zeros_like(e), -vt * e))

    def op(self, t, dtype=torch.complex128, device="cuda"):
        """The full operator -i (H_hop + v(t) diag(e)) as a complex
        tensor, on the card unless ``device`` names another."""
        t = _time_on(t, device, "TightBindingChain")
        Hh = torch.as_tensor(self.hop_matrix(), dtype=dtype, device=t.device)
        e = torch.as_tensor(np.diag(self.onsite_energies()), dtype=dtype,
                            device=t.device)
        return -1j * (Hh + self.v(t).to(dtype) * e)
