"""Grid interp/grad golden tests vs the sequential oracle."""

import numpy as np
import jax.numpy as jnp

from or_cdchomp_jax.ops.grid import (
    Grid3D, grid_interp_grad, multigrid_interp_grad, pad_stack_grids)
from tests.ref import oracle as orc

RNG = np.random.default_rng(2)


def test_interp_grad_matches_oracle():
    data = RNG.normal(size=(7, 9, 5))
    lengths = np.array([1.4, 0.9, 2.0])
    pts = RNG.uniform(low=-0.1, high=1.1, size=(200, 3)) * lengths
    val, grad, inb = grid_interp_grad(
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(pts))
    val, grad, inb = np.asarray(val), np.asarray(grad), np.asarray(inb)
    for i in range(len(pts)):
        want = orc.grid_interp(data, lengths, pts[i])
        if want is None:
            assert not inb[i]
            assert np.isinf(val[i])
        else:
            assert inb[i]
            np.testing.assert_allclose(val[i], want, atol=1e-10,
                                       err_msg=f"point {pts[i]}")
            wgrad = orc.grid_grad(data, lengths, pts[i])
            np.testing.assert_allclose(grad[i], wgrad, atol=1e-10)


def test_multigrid_matches_single():
    g1 = Grid3D(data=jnp.asarray(RNG.normal(size=(6, 6, 6))),
                lengths=jnp.asarray([1.0, 1.0, 1.0]))
    g2 = Grid3D(data=jnp.asarray(RNG.normal(size=(4, 8, 5))),
                lengths=jnp.asarray([0.8, 1.6, 1.0]))
    data, sizes, lengths = pad_stack_grids([g1, g2])
    pts = RNG.uniform(size=(50, 2, 3)) * np.asarray(lengths)
    val, grad, inb = multigrid_interp_grad(data, sizes, lengths,
                                           jnp.asarray(pts))
    for fi, g in enumerate([g1, g2]):
        v1, g1g, _ = grid_interp_grad(g.data, g.lengths, jnp.asarray(pts[:, fi]))
        np.testing.assert_allclose(np.asarray(val[:, fi]), np.asarray(v1),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(grad[:, fi]), np.asarray(g1g),
                                   atol=1e-5)


def test_center_of_index():
    g = Grid3D.create((4, 4, 4), (2.0, 2.0, 2.0))
    c = np.asarray(g.center_of_index(jnp.asarray([0, 0, 0])))
    np.testing.assert_allclose(c, [0.25, 0.25, 0.25])
    c = np.asarray(g.center_of_index(jnp.asarray([3, 3, 3])))
    np.testing.assert_allclose(c, [1.75, 1.75, 1.75])
