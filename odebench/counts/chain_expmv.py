"""The chain step kernel K4 (``csrc/chain_expmv.cu``) on the Magnus-4
pair: its operations are those of ``fused_loop_chain`` (the same passes,
as ``chip_smoke.time_k4`` counts a launch with ``passes_needed`` and
``chain_flops``), its bytes a launch those of ``time_k4``: the state in
and out, the node samples, dt and the error, the working basis.
"""

from __future__ import annotations

from ..peaks import bound
from .fused_loop_chain import KP, K0, chain_flops


def launch_bytes(B: int, D: int, n_samples: int = 2, nbytes: int = 4) -> int:
    return nbytes * (2 * B * D + n_samples * B * K0 + 2 * B + KP * D * D)


def bound_ms(passes, B: int, D: int, launches: int = 1) -> tuple:
    """The least time of ``launches`` launches over B rows that need
    ``passes`` Taylor passes per chain in all (ms), and what bounds it."""
    return bound(chain_flops(passes, D), launches * launch_bytes(B, D))
