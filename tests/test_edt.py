"""EDT + signed SDF golden tests vs the Felzenszwalb oracle."""

import numpy as np
import jax.numpy as jnp

from or_cdchomp_jax.ops.edt import edt_sq, signed_edt
from or_cdchomp_jax.ops.flood import exterior_free_mask, flood_reachable
from tests.ref import oracle as orc

RNG = np.random.default_rng(3)


def test_edt_matches_felzenszwalb():
    occ = RNG.uniform(size=(9, 7, 11)) < 0.1
    lengths = np.array([0.9, 0.7, 1.1])
    f = np.where(occ, 0.0, np.inf)
    want = orc.sedt_3d(f, lengths)
    got = np.asarray(edt_sq(jnp.asarray(f), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_edt_empty_grid_stays_inf():
    f = np.full((4, 4, 4), np.inf)
    got = np.asarray(edt_sq(jnp.asarray(f), jnp.asarray([1.0, 1, 1])))
    assert np.all(np.isinf(got))


def test_signed_edt_signs():
    occ = np.zeros((8, 8, 8), dtype=bool)
    occ[3:5, 3:5, 3:5] = True
    lengths = np.array([1.0, 1.0, 1.0])
    sdf = np.asarray(signed_edt(jnp.asarray(occ), jnp.asarray(lengths)))
    want = orc.signed_sdf(occ, lengths)
    np.testing.assert_allclose(sdf, want, rtol=1e-6, atol=1e-9)
    assert np.all(sdf[occ] <= 0)
    assert np.all(sdf[~occ] >= 0)


def test_flood_fill_pocket():
    # hollow box: interior free cells are unreachable from the corner
    occ = np.zeros((10, 10, 10), dtype=bool)
    occ[2:8, 2:8, 2:8] = True
    occ[3:7, 3:7, 3:7] = False  # enclosed pocket
    reach = np.asarray(flood_reachable(jnp.asarray(~occ)))
    assert not reach[5, 5, 5]
    assert reach[0, 0, 0]
    assert reach[1, 5, 5]
    final_obs = np.asarray(exterior_free_mask(jnp.asarray(occ)))
    assert final_obs[5, 5, 5]      # pocket counted as obstacle
    assert final_obs[4, 4, 2]      # wall
    assert not final_obs[0, 0, 0]  # exterior


def test_flood_seed_blocked():
    occ = np.ones((4, 4, 4), dtype=bool)
    reach = np.asarray(flood_reachable(jnp.asarray(~occ)))
    assert not reach.any()
