"""The RK step's launch plans on the CPU: K1's (``ops/fused_rk.rk_plan``,
the mirror of ``csrc/fused_rk_step.cu: rk_plan``) and the loop kernel's
RK step (``ops/fused_loop.rk_loop_plan``, the mirror of ``csrc/
fused_loop.cu: rk_loop_plan``) against the constants of the CUDA sources,
at every batch, width, tableau size and type the kernels take: each plan
fits an H100's 232 448 bytes of shared memory a block and 256 threads,
its threads cover the tile with whole microtiles, and the warp shape of
``csrc/rk_step.cuh`` gives every microtile to exactly one thread. The
kernels themselves run on a card: tests/test_torch_cuda.py.
"""

import pathlib
import re

import pytest

from vec_ode_tpu_torch.ops import _build, expmv, fused_loop, fused_rk

CSRC = pathlib.Path(fused_rk.__file__).parents[1] / "csrc"
MAX_SMEM = 232448
BATCHES = (1, 33, 257, 1000, 2048, 16384)
WIDTHS = (2, 6, 10, 128, 256, 512)
# BOSH32, RK4 (no pair), RKF45 / Cash-Karp, DOPRI5
STAGES = (3, 4, 6, 7)


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


def _rk_thread(tid: int, tile: int, D: int, rm: int):
    """csrc/rk_step.cuh: rk_thread, for thread ``tid``: (row group,
    column group) or None past the microtiles."""
    ncl, ngr = expmv.gemm_dp(D) // expmv.GEMM_CN, tile // rm
    wc = fused_rk.rk_wc(ncl)
    ncb, rgs = ncl // wc, min(32 // wc, ngr)
    t1 = tid // rgs
    t2 = t1 // wc
    cg, rg = (t2 % ncb) * wc + t1 % wc, (t2 // ncb) * rgs + tid % rgs
    return (rg, cg) if rg < ngr else None


def test_plan_constants_match_the_sources():
    k1, loop = _ints("fused_rk_step.cu"), _ints("fused_loop.cu")
    num = _ints("numerics.cuh")
    assert (k1["RK_MAX_TILE"], k1["RK_MIN_TILE"]) == (fused_rk.RK_MAX_TILE,
                                                      fused_rk.RK_MIN_TILE)
    assert (k1["RK_RM_REG"], k1["RK_KS_REG"], k1["RK_RM"]) == (
        fused_rk.RK_RM_REG, fused_rk.RK_KS_REG, fused_rk.RK_RM)
    assert (loop["RK_LOOP_RM"], loop["MAX_THREADS"]) == (
        fused_loop.RK_LOOP_RM, expmv.LOOP_THREADS)
    assert (num["MAX_STAGES"], num["MAX_WIDTH"]) == (fused_rk.MAX_STAGES,
                                                     fused_rk.MAX_WIDTH)
    gemm = _ints("gemm_tile.cuh")
    assert (gemm["GEMM_THREADS"], gemm["GEMM_CN"], gemm["GEMM_STAGES"]) == (
        expmv.GEMM_THREADS, expmv.GEMM_CN, expmv.GEMM_STAGES)


@pytest.mark.parametrize("name", ["fused_rk_step.cu", "fused_loop.cu",
                                  "rk_step.cuh", "gemm_tile.cuh",
                                  "numerics.cuh", "chain_step.cuh"])
def test_no_option_or_variable_picks_a_route(name):
    """The plan is a function of the shape and the card: no environment
    variable; and the RK step reads no operator by __ldg and keeps no
    block-wide stage slots."""
    src = (CSRC / name).read_text()
    assert "getenv" not in src
    if name == "rk_step.cuh":
        assert "__ldg" not in src and "ks + i * slot" not in src
        assert "#include \"gemm_tile.cuh\"" in src


def test_headers_share_one_error_measure():
    """The numerics and the error measure live in numerics.cuh, which
    gemm_tile.cuh includes; the RK body includes gemm_tile.cuh; one
    chain_err_measure serves both steps."""
    gemm = (CSRC / "gemm_tile.cuh").read_text()
    assert "#include \"numerics.cuh\"" in gemm
    assert "#include \"rk_step.cuh\"" not in gemm
    defs = [p.name for p in CSRC.glob("*.cu*")
            if re.search(r"void chain_err_measure\(", p.read_text())]
    assert defs == ["numerics.cuh"]
    for name in ("rk_step.cuh", "chain_step.cuh"):
        assert "chain_err_measure(" in (CSRC / name).read_text()


@pytest.mark.parametrize("header", ["numerics.cuh", "rk_step.cuh",
                                    "gemm_tile.cuh"])
def test_library_names_follow_the_step_headers(header, tmp_path,
                                               monkeypatch):
    """Every kernel library's name carries the RK step's headers (on a copy
    of the sources)."""
    for src in CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(tmp_path / header, "a") as f:
        f.write("\n// edited\n")
    for n, path in names.items():
        assert _build.library_path(n) != path, (header, n)


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("s", STAGES)
@pytest.mark.parametrize("B", BATCHES)
def test_k1_plan_fits(B, s, elem):
    """Every width: whole microtiles within 256 threads, shared memory
    within an H100's, the stages in registers only in f32 (4 x 4 up to 6
    stages, 2 x 4 for 7), persistent blocks only with the operator
    resident, the blocks cover the batch."""
    for D in WIDTHS:
        pl = fused_rk.rk_plan(B, D, s, elem)
        key = (B, D, s, elem, pl)
        ncl = expmv.gemm_dp(D) // expmv.GEMM_CN
        assert pl["tile"] % pl["rm"] == 0, key
        assert (pl["tile"] // pl["rm"]) * ncl <= pl["threads"] <= 256, key
        assert pl["threads"] % 32 == 0, key
        assert pl["smem"] <= MAX_SMEM, key
        assert pl["smem"] == fused_rk.rk_smem_bytes(
            pl["tile"], D, s, elem, pl["ks"] == 0, pl["resident"]), key
        assert pl["ks"] == (0 if elem == 8 else (6 if s <= 6 else 7)), key
        assert pl["rm"] == (4 if elem == 4 and s <= 6 else 2), key
        n_tiles = -(-B // pl["tile"])
        assert pl["blocks"] == (min(n_tiles, 132) if pl["resident"]
                                else n_tiles), key


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("s", STAGES)
@pytest.mark.parametrize("B", BATCHES)
def test_loop_rk_plan_fits(B, s, elem, extra):
    """The loop kernel's RK step beside the loop's state, with and without
    the events / dense switch: within 227 KB and 256 threads, a thread per
    row for the controller, the tile sized with the switch on."""
    for D in WIDTHS:
        pl = fused_loop.rk_loop_plan(B, D, s, elem, extra)
        key = (B, D, s, elem, extra, pl)
        ncl = expmv.gemm_dp(D) // expmv.GEMM_CN
        assert pl["tile"] % fused_loop.RK_LOOP_RM == 0, key
        assert max((pl["tile"] // pl["rm"]) * ncl,
                   pl["tile"]) <= pl["threads"] <= 256, key
        assert pl["smem"] <= MAX_SMEM, key
        assert pl["ks"] == (7 if elem == 4 else 0), key
        on = fused_loop.rk_loop_plan(B, D, s, elem, True)
        assert (pl["tile"], pl["resident"]) == (on["tile"], on["resident"])


@pytest.mark.parametrize("elem", [4, 8])
def test_the_paths_plans(elem):
    """At the paths' shapes (RKF45, d = 64): K1 at 16 384 takes 32 rows of
    4 x 4 outputs over 256 threads in f32 with the operator resident in
    one persistent block an SM (16 rows of 2 x 4, streamed, in f64); the
    loop kernel at 2048 and 16 384 takes tiles of 16 rows over 256
    threads, the operator resident in f32."""
    k1 = fused_rk.rk_plan(16384, 128, 6, elem)
    if elem == 4:
        assert (k1["tile"], k1["rm"], k1["threads"], k1["resident"],
                k1["blocks"]) == (32, 4, 256, 1, 132), k1
    else:
        assert (k1["tile"], k1["rm"], k1["threads"], k1["resident"],
                k1["blocks"]) == (16, 2, 256, 0, 1024), k1
    for B in (2048, 16384):
        for extra in (False, True):
            pl = fused_loop.rk_loop_plan(B, 128, 6, elem, extra)
            assert (pl["tile"], pl["threads"]) == (16, 256), pl
            assert pl["resident"] == (elem == 4), pl


@pytest.mark.parametrize("D", WIDTHS + (1, 4, 100, 200))
@pytest.mark.parametrize("rm", [2, 4])
def test_warp_shape_covers_every_microtile_once(D, rm):
    """rk_step.cuh's thread map: the (tile / RM) x DP / 4 microtiles, each
    to one thread, the threads past them idle; a warp spans wc column
    groups (a power of two dividing DP / 4, at most 8)."""
    ncl = expmv.gemm_dp(D) // expmv.GEMM_CN
    wc = fused_rk.rk_wc(ncl)
    assert ncl % wc == 0 and wc in (1, 2, 4, 8)
    for tile in (rm, 2 * rm, 16, 32):
        if tile % rm or (tile // rm) * ncl > 256:
            continue
        items = (tile // rm) * ncl
        threads = -(-items // 32) * 32
        got = [_rk_thread(t, tile, D, rm) for t in range(threads)]
        owned = [g for g in got if g is not None]
        assert len(owned) == items == len(set(owned)), (tile, D, rm)
        assert all(g is None for g in got[items:])
