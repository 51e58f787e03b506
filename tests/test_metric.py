"""Smoothness-metric construction golden tests vs the oracle."""

import numpy as np

from or_cdchomp_jax.chomp import metric as mm
from tests.ref import oracle as orc

RNG = np.random.default_rng(4)


def _check(m, n, D, has_init0=True):
    dt = 1.0 / (m + 1)
    init0 = RNG.normal(size=n) if has_init0 else None
    final0 = RNG.normal(size=n)
    ops = mm.build_metric(m, dt, D=D, has_init0=has_init0)
    B, trC = mm.build_B_trC(ops, init0, final0, n)

    inits = [init0] + [np.zeros(n)] * (D - 1)
    finals = [final0] + [np.zeros(n)] * (D - 1)
    A_o, B_o, trC_o, _, _ = orc.build_KEs(m, n, dt, D, inits, finals)
    np.testing.assert_allclose(ops.A, A_o, atol=1e-9)
    np.testing.assert_allclose(B, B_o, atol=1e-9)
    np.testing.assert_allclose(trC, trC_o, atol=1e-9)
    np.testing.assert_allclose(ops.Ainv @ ops.A, np.eye(m), atol=1e-8)

    Kv_o, Ev_o = orc.build_Kvels(m, n, dt, init0, final0)
    np.testing.assert_allclose(ops.Kvels, Kv_o, atol=1e-12)
    Ev = mm.build_Evels(ops, init0, final0, n)
    np.testing.assert_allclose(Ev, Ev_o, atol=1e-12)


def test_metric_D1():
    _check(9, 3, 1)


def test_metric_D2():
    _check(9, 3, 2)


def test_metric_D3():
    _check(12, 2, 3)


def test_metric_no_init0():
    # start_tsr mode: first point moves
    _check(8, 3, 1, has_init0=False)


def test_A_tridiagonal_D1():
    ops = mm.build_metric(10, 0.1, D=1)
    A = ops.A
    for i in range(10):
        for j in range(10):
            if abs(i - j) > 1:
                assert A[i, j] == 0.0
