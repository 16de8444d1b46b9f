"""Each kernel's operation and byte count, one module a kernel
(``counts/<kernel>.py``), found by name (:func:`load`). Frozen copies of
the arithmetic that ``chip_smoke.py`` reads its bounds with, so that a
change to the port cannot move the yardstick."""

from __future__ import annotations


def load(kernel: str):
    """The count module ``counts/<kernel>.py``."""
    from ..manifest import module

    return module("counts", kernel)
