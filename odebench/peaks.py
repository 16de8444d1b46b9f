"""The card's published peaks and the least time of a piece of work.

NVIDIA H100 SXM, dense, at its 700 W power limit: 67 TFLOP/s in FP32
outside the tensor cores (the configurations allow no TF32) and 3.35 TB/s
of HBM. A roofline share is stated against these, with the card's power
limit printed beside it.
"""

from __future__ import annotations

FP32_FLOP_S = 67e12
HBM_BYTE_S = 3.35e12


def bound(flop: float, nbytes: float) -> tuple:
    """The least time the card could take (ms) and what bounds it."""
    ops_ms, bytes_ms = flop / FP32_FLOP_S * 1e3, nbytes / HBM_BYTE_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")
