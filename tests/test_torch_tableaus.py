"""The port's Butcher tableaus equal the JAX package's, entry for entry."""

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
