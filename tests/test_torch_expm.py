"""The port's matrix exponential, complex pairs and split leaves against
the JAX package's on the same numpy inputs (made from a seed), on the
CPU: ``ops.expm`` (expm, expm_m1, expm_frechet, the Fréchet-adjoint
gradient), the ``Cplx`` arithmetic and helpers of ``ops.cplx``, and each
leaf of ``exp.leaves`` (exp, exp_m1, map_exp, commutator, apply_l,
scale_l, lincomb_l, multi_exp, exp_many).

Tolerances: both sides run the same algorithm in the same type, so f64
results agree to a few ulp of the largest entry (1e-13 relative); f32 to
2e-6. The squaring count is found with frexp here and with ceil(log2) in
JAX, which agree except at exact powers of two.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu.exp import leaves as jleaves
from vec_ode_tpu.exp.protocol import index_u as jindex_u
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu_torch.exp import leaves as tleaves
from vec_ode_tpu_torch.exp.protocol import index_u
from vec_ode_tpu_torch.ops import cplx as tcp

# both ops packages export the function ``expm`` over the module's name
jexpm = importlib.import_module("vec_ode_tpu.ops.expm")
texpm = importlib.import_module("vec_ode_tpu_torch.ops.expm")

torch.set_num_threads(1)

D = 6
F64, F32 = (torch.float64, jnp.float64), (torch.float32, jnp.float32)


def _mats(scale, batch=(3,), d=D, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(batch + (d, d)) * scale / np.sqrt(d)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    lim = rtol * max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= lim


def _close_cplx(got, want, rtol):
    _close(got.re, want.re, rtol)
    _close(got.im, want.im, rtol)


@pytest.mark.parametrize("fn", ["expm", "expm_m1"])
@pytest.mark.parametrize("method", ["auto", "pade13", "taylor"])
@pytest.mark.parametrize("scale", [0.05, 0.9, 7.0, 60.0])
@pytest.mark.parametrize("types", [F64, F32], ids=["f64", "f32"])
def test_expm_matches_jax(fn, method, scale, types):
    tt, jt = types
    A = _mats(scale)
    got = getattr(texpm, fn)(torch.as_tensor(A, dtype=tt), method=method)
    want = getattr(jexpm, fn)(jnp.asarray(A, jt), method=method)
    # f32 Padé solves a linear system: its last digits follow the solver
    rtol = 1e-13 if tt == torch.float64 else (
        2e-6 if method != "pade13" else 2e-5)
    _close(got, want, rtol * max(1.0, scale))


def test_expm_complex_on_cpu():
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((2, D, D)) + 1j * rng.standard_normal((2, D, D)))
    got = texpm.expm(torch.as_tensor(A))
    _close(got, jexpm.expm(jnp.asarray(A)), 1e-13)
    _close(got, torch.linalg.matrix_exp(torch.as_tensor(A)).numpy(), 1e-12)


def test_expm_max_squarings_bounds_the_loop():
    # under-scaled on purpose; the products-only method stays comparable
    A = _mats(60.0)
    got = texpm.expm(torch.as_tensor(A), max_squarings=2, method="taylor")
    want = jexpm.expm(jnp.asarray(A), max_squarings=2, method="taylor")
    _close(got, want, 1e-10)
    assert float(np.abs(want - np.asarray(jexpm.expm(jnp.asarray(A),
                                                     method="taylor"))).max()
                 ) > 1.0


def test_expm_leaves_a_nan_matrix_alone():
    """One NaN matrix takes no squarings away from the others."""
    A = _mats(7.0)
    A[1] = np.nan
    got = texpm.expm(torch.as_tensor(A))
    want = texpm.expm(torch.as_tensor(A[[0, 2]]))
    assert torch.isnan(got[1]).all()
    assert torch.equal(got[[0, 2]], want)


def test_expm_rejects_non_square_and_unknown_method():
    with pytest.raises(ValueError):
        texpm.expm(torch.zeros(3, 4))
    with pytest.raises(ValueError):
        texpm.expm(torch.zeros(3, 3), method="series")
    with pytest.raises(ValueError):
        texpm.taylor_ps(torch.zeros(3, 3), m=10)


@pytest.mark.parametrize("theta", [1.0, 0.25, 0.35])
def test_squaring_count_is_the_least_s(theta):
    norms = torch.tensor([0.0, 0.1, theta, theta * (1 + 1e-12), 2 * theta,
                          2 * theta * (1 + 1e-12), 1000.0, 1e30,
                          float("inf"), float("nan")], dtype=torch.float64)
    s = texpm.squaring_count(norms, theta, 16)
    for n, si in zip(norms.tolist(), s.tolist()):
        if not np.isfinite(n):
            assert si == 0
            continue
        want = 0
        while n / theta > 2.0 ** want and want < 16:
            want += 1
        assert si == want, (n, si, want)


@pytest.mark.parametrize("method", ["pade13", "taylor"])
@pytest.mark.parametrize("scale", [0.3, 7.0])
def test_expm_frechet_matches_jax(method, scale):
    A, E = _mats(scale, seed=1), _mats(1.0, seed=2)
    got = texpm.expm_frechet(torch.as_tensor(A), torch.as_tensor(E),
                             method=method)
    want = jexpm.expm_frechet(jnp.asarray(A), jnp.asarray(E), method=method)
    _close(got, want, 1e-12 * max(1.0, scale))


def test_expm_frechet_is_the_directional_derivative():
    A, E = _mats(0.8, batch=()), _mats(1.0, batch=(), seed=4)
    At, Et = torch.as_tensor(A), torch.as_tensor(E)
    h = 1e-6
    fd = (texpm.expm(At + h * Et) - texpm.expm(At - h * Et)) / (2 * h)
    _close(texpm.expm_frechet(At, Et), fd.numpy(), 1e-8)


@pytest.mark.parametrize("fn", ["expm", "expm_m1"])
@pytest.mark.parametrize("method", ["pade13", "taylor"])
def test_expm_gradient_matches_jax(fn, method):
    A, Wt = _mats(2.0, seed=5), _mats(1.0, seed=6)
    At = torch.as_tensor(A).requires_grad_()
    (getattr(texpm, fn)(At, method=method) * torch.as_tensor(Wt)).sum() \
        .backward()
    want = jax.grad(lambda a: jnp.sum(
        getattr(jexpm, fn)(a, method=method) * jnp.asarray(Wt)))(
            jnp.asarray(A))
    _close(At.grad, want, 1e-12)


@pytest.mark.parametrize("fn", ["expm", "expm_m1"])
def test_expm_gradcheck(fn):
    A = torch.as_tensor(_mats(1.5, batch=(2,), d=3, seed=7)).requires_grad_()
    assert torch.autograd.gradcheck(getattr(texpm, fn), (A,), eps=1e-6,
                                    atol=1e-7, rtol=1e-6)


def test_expm_second_order_through_frechet():
    """expm_frechet is plain differentiable torch: a gradient of a
    gradient runs."""
    A = torch.as_tensor(_mats(0.5, batch=(), d=3, seed=8)).requires_grad_()
    g, = torch.autograd.grad(texpm.expm(A).sum(), A, create_graph=True)
    gg, = torch.autograd.grad(g.sum(), A)
    assert torch.isfinite(gg).all() and float(gg.abs().max()) > 0


def test_expm_apply():
    A, x = _mats(1.0), np.random.default_rng(9).standard_normal((3, D))
    got = texpm.expm_apply(torch.as_tensor(A), torch.as_tensor(x))
    _close(got, jexpm.expm_apply(jnp.asarray(A), jnp.asarray(x)), 1e-13)


# -- ops.cplx ----------------------------------------------------------------

def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _both(re, im):
    return (tcp.Cplx(torch.as_tensor(re), torch.as_tensor(im)),
            jcp.Cplx(jnp.asarray(re), jnp.asarray(im)))


CPLX_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "neg": lambda a, b: -a,
    "add_real": lambda a, b: a + 2.5,
    "radd_real": lambda a, b: 2.5 + a,
    "add_complex": lambda a, b: a + (1.5 - 0.5j),
    "sub_complex": lambda a, b: a - (1.5 - 0.5j),
    "rsub_real": lambda a, b: 2.5 - a,
    "rsub_complex": lambda a, b: (1.5 - 0.5j) - a,
    "mul_real": lambda a, b: a * 0.3,
    "rmul_real": lambda a, b: 0.3 * a,
    "mul_complex": lambda a, b: a * (0.3 + 2j),
    "rmul_np_complex": lambda a, b: np.complex128(0.3 + 2j) * a,
    "rmul_np_real": lambda a, b: np.float64(0.3) * a,
}


@pytest.mark.parametrize("name", sorted(CPLX_OPS))
def test_cplx_arithmetic_matches_jax(name):
    (ta, ja), (tb_, jb) = _both(*_pair((4, 3), 0)), _both(*_pair((4, 3), 1))
    got, want = CPLX_OPS[name](ta, tb_), CPLX_OPS[name](ja, jb)
    assert isinstance(got, tcp.Cplx)
    _close_cplx(got, want, 1e-15)


def test_cplx_addition_is_not_concatenation():
    ta, _ = _both(*_pair((4, 3), 0))
    assert len(ta + ta) == 2 and (ta + ta).re.shape == (4, 3)


CPLX_FNS = {
    "cconj": lambda m, a, x: m.cconj(a),
    "cscale_real": lambda m, a, x: m.cscale(a, 0.7),
    "cscale_complex": lambda m, a, x: m.cscale(a, 0.7 - 1.1j),
    "cscale_any_float": lambda m, a, x: m.cscale_any(a, 0.7),
    "cscale_any_int": lambda m, a, x: m.cscale_any(a, 2),
    "cscale_any_np_real": lambda m, a, x: m.cscale_any(a, np.float32(0.5)),
    "cscale_any_complex": lambda m, a, x: m.cscale_any(a, 0.7 - 1.1j),
    "cscale_any_np_complex": lambda m, a, x: m.cscale_any(
        a, np.complex64(0.5 + 2j)),
    "cscale_any_cplx": lambda m, a, x: m.cscale_any(
        a, m.Cplx(*(m_asarray(m, v) for v in (0.25, -1.5)))),
    "cscale_any_tensor": lambda m, a, x: m.cscale_any(a, m_asarray(m, 0.3)),
    "cscale_any_complex_tensor": lambda m, a, x: m.cscale_any(
        a, m_asarray(m, 0.3 - 2j)),
    "cmatmul": lambda m, a, x: m.cmatmul(a, a),
    "cmatvec": lambda m, a, x: m.cmatvec(a, x),
    "apply_embedded": lambda m, a, x: m.apply_embedded(m.embed(a), x),
    "cexp": lambda m, a, x: m.cexp(x),
    "cexpm1": lambda m, a, x: m.cexpm1(x),
    "cexpm": lambda m, a, x: m.cexpm(a),
    "extract_embed": lambda m, a, x: m.extract(m.embed(a)),
}


def m_asarray(m, v):
    if m is not tcp:
        return jnp.asarray(v)
    return torch.tensor(v, dtype=torch.complex128 if isinstance(v, complex)
                        else torch.float64)


@pytest.mark.parametrize("name", sorted(CPLX_FNS))
def test_cplx_functions_match_jax(name):
    re, im = _pair((3, D, D), 2)
    (ta, ja) = _both(re / np.sqrt(D), im / np.sqrt(D))
    (tx, jx) = _both(*_pair((3, D), 3))
    _close_cplx(CPLX_FNS[name](tcp, ta, tx), CPLX_FNS[name](jcp, ja, jx),
                1e-13)


def test_cabs2_and_small_cexpm1():
    (tx, jx) = _both(*_pair((5,), 4))
    _close(tcp.cabs2(tx), jcp.cabs2(jx), 1e-15)
    tiny = tcp.Cplx(torch.tensor([1e-12], dtype=torch.float64),
                    torch.tensor([-3e-12], dtype=torch.float64))
    got = tcp.cexpm1(tiny)
    # e^z - 1 = z + z^2 / 2 + ..., kept to relative accuracy
    assert abs(float(got.re) / 1e-12 - 1) < 1e-9
    assert abs(float(got.im) / -3e-12 - 1) < 1e-9


# -- exp.leaves --------------------------------------------------------------

def _anti_hermitian(seed, batch=(2,), d=D):
    rng = np.random.default_rng(seed)
    M = (rng.standard_normal(batch + (d, d))
         + 1j * rng.standard_normal(batch + (d, d)))
    H = (M + np.conj(np.swapaxes(M, -1, -2))) / (2 * np.sqrt(d))
    return -1j * H


def _leaf_inputs(name):
    """(L, L2, x) as numpy: a leaf's operator samples and state."""
    rng = np.random.default_rng(11)
    if name in ("DenseSplit",):
        return _mats(1.2, (2,), seed=12), _mats(1.2, (2,), seed=13), \
            rng.standard_normal((2, D))
    if name == "DiagonalSplit":
        return rng.standard_normal((2, D)), rng.standard_normal((2, D)), \
            rng.standard_normal((2, D))
    if name == "AntiHermitianSplit":
        return _anti_hermitian(14), _anti_hermitian(15), \
            rng.standard_normal((2, D)) + 1j * rng.standard_normal((2, D))
    x = rng.standard_normal((2, D)) + 1j * rng.standard_normal((2, D))
    if name == "DenseCplxSplit":
        L = _mats(1.2, (2,), seed=12) + 1j * _mats(1.2, (2,), seed=16)
        L2 = _mats(1.2, (2,), seed=13) + 1j * _mats(1.2, (2,), seed=17)
        return L, L2, x
    if name == "DiagonalCplxSplit":
        return (rng.standard_normal((2, D)) + 1j * rng.standard_normal((2, D)),
                rng.standard_normal((2, D)) + 1j * rng.standard_normal((2, D)),
                x)
    assert name == "AntiHermitianCplxSplit"
    return _anti_hermitian(14), _anti_hermitian(15), x


LEAVES = ["DenseSplit", "DiagonalSplit", "AntiHermitianSplit",
          "DenseCplxSplit", "DiagonalCplxSplit", "AntiHermitianCplxSplit"]


def _to(name, a, torch_side):
    if name.endswith("CplxSplit"):
        if torch_side:
            return tcp.Cplx(torch.as_tensor(a.real.copy()),
                            torch.as_tensor(a.imag.copy()))
        return jcp.Cplx(jnp.asarray(a.real), jnp.asarray(a.imag))
    return torch.as_tensor(a) if torch_side else jnp.asarray(a)


def _cmp(name, got, want, rtol):
    if isinstance(got, tcp.Cplx):
        _close_cplx(got, want, rtol)
    else:
        _close(got, want, rtol)


LEAF_OPS = {
    "exp": lambda sp, L, L2, x, iu: sp.exp(L),
    "exp_m1": lambda sp, L, L2, x, iu: sp.exp_m1(L),
    "map_exp": lambda sp, L, L2, x, iu: sp.map_exp(sp.exp(L), x),
    "map_exp_m1": lambda sp, L, L2, x, iu: sp.map_exp(sp.exp_m1(L), x),
    "commutator": lambda sp, L, L2, x, iu: sp.commutator(L, L2),
    "apply_l": lambda sp, L, L2, x, iu: sp.apply_l(L, x),
    "scale_l": lambda sp, L, L2, x, iu: sp.scale_l(L, 0.37),
    "add_l": lambda sp, L, L2, x, iu: sp.add_l(L, L2),
    "lincomb_l": lambda sp, L, L2, x, iu: sp.lincomb_l([L, L2], [0.4, -1.3]),
    "multi_exp": lambda sp, L, L2, x, iu: sp.map_exp(
        iu(sp.multi_exp(L, np.array([0.5, 0.25])), 1), x),
    "exp_many": lambda sp, L, L2, x, iu: sp.map_exp(
        iu(sp.exp_many([L, L2]), 1), x),
    "exp_many_m1": lambda sp, L, L2, x, iu: sp.map_exp(
        iu(sp.exp_many_m1([L, L2]), 0), x),
}


@pytest.mark.parametrize("op", sorted(LEAF_OPS))
@pytest.mark.parametrize("name", LEAVES)
def test_leaf_matches_jax(name, op):
    L, L2, x = _leaf_inputs(name)
    got = LEAF_OPS[op](getattr(tleaves, name)(),
                       *(_to(name, a, True) for a in (L, L2, x)), index_u)
    want = LEAF_OPS[op](getattr(jleaves, name)(),
                        *(_to(name, a, False) for a in (L, L2, x)), jindex_u)
    # the eigh-based leaves may pick other eigenvectors in a degenerate
    # pair: the propagator is the same to the eigensolver's accuracy
    _cmp(name, got, want, 1e-11 if "AntiHermitian" in name else 1e-13)


@pytest.mark.parametrize("name", ["AntiHermitianSplit",
                                  "AntiHermitianCplxSplit"])
def test_anti_hermitian_leaves_are_unitary(name):
    L, _, x = _leaf_inputs(name)
    sp = getattr(tleaves, name)()
    y = sp.map_exp(sp.exp(_to(name, L, True)), _to(name, x, True))
    n0 = np.linalg.norm(x, axis=-1)
    n1 = (np.sqrt((y.re ** 2 + y.im ** 2).sum(-1).numpy())
          if isinstance(y, tcp.Cplx) else np.linalg.norm(y.numpy(), axis=-1))
    assert np.abs(n1 - n0).max() < 1e-13


def test_skew_expm_gradient_matches_jax():
    """eigh's own derivative is ill-posed on the (doubly degenerate)
    embedding; the custom backward is the Fréchet adjoint."""
    L = _anti_hermitian(20, batch=())
    M = np.block([[L.real, -L.imag], [L.imag, L.real]])
    Wt = _mats(1.0, batch=(), d=2 * D, seed=21)
    Mt = torch.as_tensor(M).requires_grad_()
    (tleaves._skew_expm(Mt) * torch.as_tensor(Wt)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jleaves._skew_expm(a)
                                      * jnp.asarray(Wt)))(jnp.asarray(M))
    _close(Mt.grad, want, 1e-11)


def test_anti_hermitian_cplx_rejects_complex_scalings():
    sp = tleaves.AntiHermitianCplxSplit()
    L = _to("AntiHermitianCplxSplit", _anti_hermitian(22), True)
    with pytest.raises(ValueError):
        sp.scale_l(L, 0.5 + 0.1j)
    with pytest.raises(ValueError):
        sp.multi_exp(L, np.array([0.5 + 0.1j, 0.5]))
    with pytest.raises(ValueError):
        sp.scale_l(L, torch.tensor(0.5 + 0.1j))
    sp.scale_l(L, 0.5)


def test_leaves_take_no_operator_argument():
    with pytest.raises(TypeError):
        tleaves.DenseSplit(lambda t: t)
    with pytest.raises(TypeError):
        tleaves.DenseCplxSplit(2.0)
    assert tleaves.DenseSplit(8).max_squarings == 8
    assert tleaves.DenseSplit().supports_batched_dense
    assert tleaves.DenseCplxSplit().is_cplx_split


def test_multi_exp_with_complex_scalings_on_a_real_operator():
    L = _mats(0.8, (2,), seed=23)
    ks = np.array([0.3 + 0.2j, 0.5 - 0.1j])
    got = tleaves.DenseSplit().multi_exp(torch.as_tensor(L), ks)
    want = jleaves.DenseSplit().multi_exp(jnp.asarray(L), ks)
    _close(got, want, 1e-13)
    got32 = tleaves.DenseSplit().multi_exp(
        torch.as_tensor(L, dtype=torch.float32), ks)
    assert got32.dtype == torch.complex64


def test_cplx_builds_the_jax_pair():
    """ops.cplx.cplx (item 4's rest): a pair from its real part, with a
    zero imaginary part unless given, as the JAX package's."""
    re = np.arange(6.0).reshape(2, 3)
    im = -re / 3
    for args in ((re,), (re, im)):
        got = tcp.cplx(*(torch.as_tensor(a) for a in args))
        want = jcp.cplx(*(jnp.asarray(a) for a in args))
        np.testing.assert_array_equal(got.re.numpy(), np.asarray(want.re))
        np.testing.assert_array_equal(got.im.numpy(), np.asarray(want.im))
    assert tcp.cplx([1.0, 2.0]).im.shape == (2,)


def test_cexpm_apply_matches_jax():
    rng = np.random.default_rng(4)
    A = (rng.standard_normal((3, 5, 5))
         + 1j * rng.standard_normal((3, 5, 5))) * 0.4
    x = rng.standard_normal((3, 5)) + 1j * rng.standard_normal((3, 5))
    got = tcp.cexpm_apply(tcp.from_complex(A, device="cpu"),
                          tcp.from_complex(x, device="cpu"))
    want = jcp.cexpm_apply(jcp.from_complex(A, jnp.float64),
                           jcp.from_complex(x, jnp.float64))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               atol=1e-13)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                               atol=1e-13)
    from scipy.linalg import expm as sexpm

    ref = np.stack([sexpm(a) @ v for a, v in zip(A, x)])
    np.testing.assert_allclose(got.re.numpy() + 1j * got.im.numpy(), ref,
                               atol=1e-12)


def test_cp_embed_matches_jax():
    rng = np.random.default_rng(6)
    L = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    got = tleaves.cp_embed(tcp.from_complex(L, device="cpu"))
    want = jleaves.cp_embed(jcp.from_complex(L, jnp.float64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
