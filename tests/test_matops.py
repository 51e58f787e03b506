"""cd_mat parity-layer tests (mat.c:30-177)."""

import numpy as np
import jax.numpy as jnp

from or_cdchomp_jax.ops import matops


def test_cross_accumulates():
    """cd_mat_cross ACCUMULATES into res (mat.c:126-132)."""
    a = jnp.asarray([1.0, 0.0, 0.0])
    b = jnp.asarray([0.0, 1.0, 0.0])
    res = jnp.asarray([10.0, 20.0, 30.0])
    np.testing.assert_allclose(np.asarray(matops.cross_accum(a, b, res)),
                               [10.0, 20.0, 31.0])


def test_set_diag_rectangular():
    m = np.asarray(matops.set_diag(2, 4, 3.5))
    expect = np.zeros((2, 4))
    expect[0, 0] = expect[1, 1] = 3.5
    np.testing.assert_allclose(m, expect)


def test_trace_rectangular():
    A = jnp.asarray(np.arange(6.0).reshape(2, 3))
    assert float(matops.trace(A)) == 0.0 + 4.0


def test_vec_to_str():
    s = matops.vec_to_str("v: ", [1.0, -2.5])
    assert s == "v: [   1.0000  -2.5000 ]"
