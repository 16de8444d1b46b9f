"""The port's Butcher tableaus, quadrature nodes and commutator-free Magnus
coefficient tables equal the JAX package's, entry for entry."""

import dataclasses

import numpy as np
import pytest
import torch

from vec_ode_tpu import tableaus as jt
from vec_ode_tpu_torch import tableaus as tt

torch.set_num_threads(1)

NAMES = sorted(jt.TABLEAUS)


def test_same_tables():
    assert sorted(tt.TABLEAUS) == NAMES
    for name in ("RKF45", "RKF45_REFERENCE", "RK4", "DOPRI5", "BOSH32",
                 "CASH_KARP", "EULER", "MIDPOINT_RK2", "HEUN_RK2"):
        assert getattr(tt, name).name == getattr(jt, name).name


@pytest.mark.parametrize("name", NAMES)
def test_tableau_equal(name):
    want, got = jt.TABLEAUS[name], tt.TABLEAUS[name]
    for field in dataclasses.fields(want):
        a, b = getattr(want, field.name), getattr(got, field.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype, field.name
            np.testing.assert_array_equal(b, a, err_msg=field.name)
        else:
            assert b == a, field.name
    assert got.stages == want.stages
    assert got.is_fsal == want.is_fsal


@pytest.mark.parametrize("name", ["C_GAUSS_LEGENDRE_4", "C_GAUSS_LEGENDRE_6",
                                  "CFM_R2_J1_GL", "CFM_R4_J2_GL",
                                  "BLANES17_R4_J4", "RKN_O4_A", "RKN_O4_B",
                                  "TJ_O4_A", "TJ_O4_B", "SEMI_COMPLEX_O4_A",
                                  "SEMI_COMPLEX_O4_B"])
def test_quadrature_and_cfm_tables_equal(name):
    want, got = getattr(jt, name), getattr(tt, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
