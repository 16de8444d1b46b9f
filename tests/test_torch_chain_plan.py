"""The launch plans of the chain step on the CPU: K4's route (tiled or a
thread-block cluster per tile), cluster size, tile and shared memory
(``ops/expmv.chain_plan``, the mirror of ``csrc/chain_expmv.cu:
chain_plan``) and the loop kernel's chain-step tile (``ops/expmv.
loop_plan``, the mirror of ``csrc/fused_loop.cu``'s chain_tile and
loop_smem) against the constants of the CUDA sources, at the batches and
widths the paths and the tests use, on every recipe shape the wrapper
takes: each plan fits an H100's 232 448 bytes of shared memory a block and
256 threads. The kernels themselves run on a card: tests/test_torch_cuda.py.
"""

import pathlib
import re

import numpy as np
import pytest

from vec_ode_tpu_torch.ops import expmv

CSRC = pathlib.Path(expmv.__file__).parents[1] / "csrc"
MAX_SMEM = 232448
_TABLE = expmv.CfmTable(alpha=np.ones((4, 8)), c=np.linspace(0, 1, 8),
                        alpha_err=np.ones((4, 8)))
# every recipe shape the kernels take, at its largest row count
SHAPES = (("midpoint", 1, None), ("magnus4", 1, None), ("magnus4", 2, None),
          ("magnus4_fast", 1, None), ("magnus6", 1, None),
          ("magnus6", 2, None), ("cfm", 2, _TABLE))


def _ints(name: str) -> dict:
    """The constexpr ints of csrc/<name>."""
    out = {}
    for decl in re.findall(r"constexpr int ([A-Z_0-9]+ = [^;]*);",
                           (CSRC / name).read_text()):
        for part in decl.split(","):
            key, value = (v.strip() for v in part.split("="))
            if re.fullmatch(r"-?\d+", value):
                out[key] = int(value)
    return out


def test_plan_constants_match_the_sources():
    k4, loop = _ints("chain_expmv.cu"), _ints("fused_loop.cu")
    assert (k4["CLUSTER_MAX"], k4["CLUSTER_RM"], k4["CLUSTER_CN"],
            k4["CLUSTER_TILE"]) == (expmv.CLUSTER_MAX, expmv.CLUSTER_RM,
                                    expmv.CLUSTER_CN, expmv.CLUSTER_TILE)
    assert (loop["CHAIN_RM"], loop["MAX_THREADS"]) == (expmv.LOOP_RM,
                                                       expmv.LOOP_THREADS)
    # within the portable cluster limit; no option or variable picks a route
    assert expmv.CLUSTER_MAX <= 8
    src = (CSRC / "chain_expmv.cu").read_text()
    assert "getenv" not in src
    assert "chain_products" not in (CSRC / "chain_step.cuh").read_text()


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("B", [1, 33, 256, 1000, 16384])
def test_chain_plan_fits(B, elem):
    """At every width and number of basis terms: the plan's threads cover
    its tile with whole microtiles within 256 threads, its shared memory
    fits, the cluster's blocks cover D with at most 8 of them, and the
    blocks cover the batch."""
    for D in (5, 8, 64, 128, 512):
        for K0 in range(1, expmv.MAX_K0 + 1):
            for recipe, C, table in SHAPES:
                pl = expmv.chain_plan(B, D, elem, recipe, C, K0, table)
                key = (B, elem, D, K0, recipe, C, pl)
                items = (pl["tile"] // pl["rm"]) * -(-pl["dc"] // pl["cn"])
                assert pl["tile"] % pl["rm"] == 0, key
                assert items <= pl["threads"] <= expmv.GEMM_THREADS, key
                assert pl["smem"] <= MAX_SMEM, key
                assert pl["blocks"] == -(-B // pl["tile"]) * pl["n"], key
                if pl["route"] == "cluster":
                    assert 2 <= pl["n"] <= expmv.CLUSTER_MAX, key
                    assert (pl["n"] - 1) * pl["dc"] < D <= pl["n"] * pl[
                        "dc"], key
                    # the tiled plan gave fewer blocks than SMs
                    tile = expmv.gemm_tile(B, D, elem, recipe, C, K0, table)
                    assert -(-B // tile) < 132, key
                else:
                    assert (pl["n"], pl["dc"]) == (1, D), key


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("recipe,C", [("magnus4", 2), ("magnus6", 2),
                                      ("cfm", 2), ("magnus4_fast", 1),
                                      ("midpoint", 1)])
def test_k4_takes_the_cluster_route_at_256x128(recipe, C, elem):
    """The adjoint's and the JAX record's batch: the tiled plan has 16
    blocks for 132 SMs, so K4 runs clusters of 4 blocks, each owning 32
    of the 128 columns, over at least 64 blocks, its basis columns
    resident at K' <= 3 in f32 (K' = 1 in f64); at 16384 it runs
    tiled."""
    table = _TABLE if recipe == "cfm" else None
    for K0 in (1, 2, 3):
        pl = expmv.chain_plan(256, 128, elem, recipe, C, K0, table)
        assert pl["route"] == "cluster" and pl["n"] == 4, pl
        assert pl["dc"] == 32 and pl["blocks"] >= 64, pl
        kp = expmv.n_working_terms(recipe, K0)
        assert pl["resident"] == (kp * elem <= 12), pl
        big = expmv.chain_plan(16384, 128, elem, recipe, C, K0, table)
        assert big["route"] == "tiled" and big["n"] == 1, big
        assert big["tile"] == {4: 64, 8: 32}[elem], big


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("elem", [4, 8])
def test_loop_plan_fits(elem, extra):
    """K5's tile in the loop kernel with the ring (or the resident basis)
    beside the loop's state, with and without the events / dense switch:
    within 227 KB at every width and K'; 32 rows at the paths' 16384 x
    128 and at Landau-Zener's D = 4 (the basis resident there)."""
    for D in (4, 5, 8, 64, 128, 512):
        for K0 in range(1, expmv.MAX_K0 + 1):
            for recipe, C, table in SHAPES:
                for B in (1, 1000, 16384):
                    pl = expmv.loop_plan(B, D, elem, recipe, C, K0, table,
                                         extra)
                    key = (B, D, K0, recipe, C, pl)
                    ncg = expmv.gemm_dp(D) // expmv.GEMM_CN
                    assert pl["tile"] % expmv.LOOP_RM == 0, key
                    assert (pl["tile"] // expmv.LOOP_RM) * ncg <= 256, key
                    assert pl["smem"] <= MAX_SMEM, key
    path = expmv.loop_plan(16384, 128, elem, "magnus4", 2, 2, extra=extra)
    assert path["tile"] == 32 and not path["resident"], path
    lz = expmv.loop_plan(16384, 4, elem, "midpoint", 1, 2, extra=extra)
    assert lz["tile"] == 32 and lz["resident"], lz
