"""The frozen operation and byte counts reproduce the bounds recorded for
the kernels (PERF.md's kernel table) at the recorded shapes and counters
(CPU)."""

from __future__ import annotations

import pytest
import torch

from odebench.counts import load


def test_k2_k3_at_2048_with_nine_saves():
    # 69 447 accepted + rejected steps, as chip_smoke.py recorded them
    ms, by = load("fused_loop_rk").bound_ms(69447, 2048, 128, 6, 11, 4)
    assert by == "operations" and ms == pytest.approx(0.4076, abs=5e-5)


def test_k2_k5_at_16384():
    # Taylor passes per chain of the Magnus-4 loop solve, as recorded
    ms, by = load("fused_loop_chain").bound_ms([1595618, 1595557], 16384,
                                               128)
    assert by == "operations" and ms == pytest.approx(31.556, abs=5e-4)


def test_k4_launch_at_16384():
    count = load("chain_expmv")
    ms, by = count.bound_ms([36016, 36014], 16384, 128)
    assert by == "operations" and ms == pytest.approx(0.7123, abs=5e-5)
    assert count.launch_bytes(16384, 128) / 1e6 == pytest.approx(17.4,
                                                                 abs=0.05)


def test_step_passes_follow_the_scaling_rule():
    count = load("fused_loop_chain")
    norms = [1.0, 1.0, 1.0]
    t = torch.zeros(4)
    # bound ~ dt (|w1_0| + |w1_1|) = 2 dt: passes 0 (no step), 1, 2, 4 at
    # theta 0.35
    dt = torch.tensor([0.0, 0.1, 0.3, 0.5])
    main, lower = count.step_passes(t, dt, 1.0, norms)
    assert (main, lower) == (7, 7)
