"""Compacted pair-list self-collision ≡ dense SoA form.

The "pairs" backend (cost_soa._selfcol_soa_pairs) is a work-compaction
rewrite of the dense (m, Sa, So, B) form: each unordered non-same-link
pair is computed once and the two ordered contributions of the
reference loop (orcdchomp_mod.cpp:1249-1317) are scattered back with a
±1 matmul.  Cost and net workspace gradient must match the dense form
to f64 round-off on arbitrary inputs, including inactive spheres and
degenerate (zero-velocity / coincident-sphere) cases.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from or_cdchomp_jax.chomp import cost_soa
from or_cdchomp_jax.chomp.cost import _VEL_EPS
from or_cdchomp_jax.ops import soa


def _rand_setup(m=6, Sa=7, SI=3, B=4, n_links=4, seed=0,
                zero_vel_frac=0.0, coincident=False):
    rng = np.random.default_rng(seed)
    link = rng.integers(0, n_links, size=Sa + SI)
    same = link[:Sa, None] == link[None, :]
    radii_act = rng.uniform(0.03, 0.1, Sa)
    radii_all = np.concatenate([radii_act, rng.uniform(0.03, 0.1, SI)])
    xs = rng.normal(size=(3, m, Sa, B)) * 0.15
    vs = rng.normal(size=(3, m, Sa, B))
    if zero_vel_frac:
        mask = rng.random(size=(m, Sa, B)) < zero_vel_frac
        vs = np.where(mask[None], 0.0, vs)
    if coincident:
        # make sphere 1 coincide with sphere 0 at every waypoint
        xs[:, :, 1, :] = xs[:, :, 0, :]
    x_i = tuple(jnp.asarray(xs[c]) for c in range(3))
    vel = tuple(jnp.asarray(vs[c]) for c in range(3))
    v2 = soa.norm2(vel)
    vnorm = jnp.sqrt(v2)
    safe = vnorm > _VEL_EPS
    probs = SimpleNamespace(
        epsilon_self=jnp.asarray(rng.uniform(0.1, 0.3, B)),
        obs_factor_self=jnp.asarray(rng.uniform(5.0, 20.0, B)),
        inactive_pos=jnp.asarray(rng.normal(size=(B, SI, 3)) * 0.15),
    )
    return same, radii_act, radii_all, probs, x_i, vel, vnorm, v2, safe


def _both(args, method="pairs"):
    same, ra, rall, probs, x_i, vel, vnorm, v2, safe = args
    c_ref, net_ref = cost_soa._selfcol_soa(
        None, jnp.asarray(same), jnp.asarray(ra), jnp.asarray(rall),
        probs, x_i, vel, vnorm, v2, safe, method="xla")
    c_p, net_p = cost_soa._selfcol_soa(
        None, jnp.asarray(same), jnp.asarray(ra), jnp.asarray(rall),
        probs, x_i, vel, vnorm, v2, safe, method=method)
    # the two forms round differently: dense computes the pair distance
    # by the dot-product identity xi²+xo²−2x·o (catastrophic
    # cancellation for near-coincident random spheres), pairs by the
    # direct Σ(xi−xj)².  Agreement on random inputs is therefore to the
    # *conditioning* of the worst pair, not bitwise; the end-to-end
    # test below pins realistic geometry at rtol 1e-10.
    np.testing.assert_allclose(np.asarray(c_p), np.asarray(c_ref),
                               rtol=1e-7, atol=1e-9)
    for a, b in zip(net_p, net_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-7)
    assert float(c_ref[0]) > 0.0  # the scene must actually collide


METHODS = ["pairs", "sym", "symv", "xla2"]


@pytest.mark.parametrize("method", METHODS)
def test_pairs_matches_dense_with_inactive(method):
    _both(_rand_setup(), method)


@pytest.mark.parametrize("method", METHODS)
def test_pairs_matches_dense_no_inactive(method):
    _both(_rand_setup(SI=0, seed=1), method)


@pytest.mark.parametrize("method", METHODS)
def test_pairs_matches_dense_zero_velocity(method):
    """safe=False rows: the velocity projection must be skipped
    identically (reference x_vel_norm > 1e-6 guard)."""
    _both(_rand_setup(seed=2, zero_vel_frac=0.5), method)


def test_pairs_coincident_spheres_finite():
    """Exactly coincident different-link spheres are UB in the
    reference (g_grad = 0/0, orcdchomp_mod.cpp:1273-1276).  The dense
    form returns catastrophic-cancellation garbage for that pair
    (w1≈1e12 times an xi−xj that only cancels in exact arithmetic);
    the pairs form computes diff exactly 0 and yields a clean 0.  So:
    pairs output must be finite, the cost must match dense, and the
    net must match dense away from the coincident spheres 0/1."""
    same, ra, rall, probs, x_i, vel, vnorm, v2, safe = _rand_setup(
        seed=3, coincident=True, n_links=8)
    c_ref, net_ref = cost_soa._selfcol_soa(
        None, jnp.asarray(same), jnp.asarray(ra), jnp.asarray(rall),
        probs, x_i, vel, vnorm, v2, safe, method="xla")
    c_p, net_p = cost_soa._selfcol_soa(
        None, jnp.asarray(same), jnp.asarray(ra), jnp.asarray(rall),
        probs, x_i, vel, vnorm, v2, safe, method="pairs")
    for a in net_p:
        assert np.all(np.isfinite(np.asarray(a)))
    np.testing.assert_allclose(np.asarray(c_p), np.asarray(c_ref),
                               rtol=1e-7, atol=1e-9)
    for a, b in zip(net_p, net_ref):
        np.testing.assert_allclose(np.asarray(a)[:, 2:],
                                   np.asarray(b)[:, 2:],
                                   rtol=2e-5, atol=1e-7)


def test_pairs_all_same_link():
    """Every sphere on one link → P=0 → zero cost and gradient."""
    same, ra, rall, probs, x_i, vel, vnorm, v2, safe = _rand_setup(
        n_links=1, SI=0, seed=4)
    c_p, net_p = cost_soa._selfcol_soa(
        None, jnp.asarray(same), jnp.asarray(ra), jnp.asarray(rall),
        probs, x_i, vel, vnorm, v2, safe, method="pairs")
    assert float(jnp.max(jnp.abs(c_p))) == 0.0
    for a in net_p:
        assert float(jnp.max(jnp.abs(a))) == 0.0


def test_pairs_end_to_end_step(monkeypatch):
    """Full batched solver step with CDX_SELFCOL=pairs matches the
    dense default bitwise-close over several iterations."""
    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot
    from or_cdchomp_jax.parallel.batch import problem_batch_from_grid

    START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=START)
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9)
    run = mod.runs[h]
    engine = run.engine
    rng = np.random.default_rng(7)
    batch = 4
    starts = np.tile(START, (batch, 1)) + 0.02 * rng.normal(size=(batch, 7))
    goals = np.tile(GOAL, (batch, 1)) + 0.02 * rng.normal(size=(batch, 7))
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)

    monkeypatch.setattr(cost_soa, "_SELFCOL", "xla")
    out_ref, costs_ref = engine.iterate_batched_nojit(probs, 4)
    monkeypatch.setattr(cost_soa, "_SELFCOL", "pairs")
    out_p, costs_p = engine.iterate_batched_nojit(probs, 4)
    np.testing.assert_allclose(np.asarray(out_p.traj),
                               np.asarray(out_ref.traj),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(costs_p),
                               np.asarray(costs_ref), rtol=1e-10)
