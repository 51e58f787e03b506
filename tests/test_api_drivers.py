"""Regression tests for the api-layer driver defects found in round 3:

 - engine-cache aliasing on start_cost: the cache key must distinguish
   *which* callable a run captured, not merely whether one exists
   (api.create engine cache; the reference passes the hook per-run as a
   %p pointer, orcdchomp_mod.cpp:1998-2001, so hooks can never alias).
 - iterate_masked chunk buckets: per-iteration callers (max_time /
   trajs_fileformstr) must execute ~1 step of compute per applied
   iteration, not a full 16-step masked chunk per iteration.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot

GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


@pytest.fixture(scope="module")
def world():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    return mod


def test_start_cost_hooks_do_not_alias(world):
    """Two sequential runs with different start_cost hooks but identical
    static structure must each run their OWN hook."""
    mod = world
    calls = {"f": 0, "g": 0}

    def hook_f(T):
        calls["f"] += 1
        return jnp.asarray(0.0, T.dtype), jnp.zeros_like(T)

    def hook_g(T):
        calls["g"] += 1
        return jnp.asarray(0.0, T.dtype), jnp.zeros_like(T)

    h1 = mod.create(robot="wam", adofgoal=GOAL, n_points=9,
                    start_cost=hook_f)
    mod.iterate(run=h1, n_iter=1)
    mod.destroy(run=h1)
    assert calls["f"] > 0

    f_before = calls["f"]
    h2 = mod.create(robot="wam", adofgoal=GOAL, n_points=9,
                    start_cost=hook_g)
    mod.iterate(run=h2, n_iter=1)
    mod.destroy(run=h2)
    # run B must trace hook g, and must NOT have silently reused the
    # engine that captured hook f
    assert calls["g"] > 0
    assert calls["f"] == f_before


def test_same_hook_reuses_engine(world):
    """The same callable on two runs still shares one cached engine."""
    mod = world

    def hook(T):
        return jnp.asarray(0.0, T.dtype), jnp.zeros_like(T)

    h1 = mod.create(robot="wam", adofgoal=GOAL, n_points=9, start_cost=hook)
    e1 = mod.runs[h1].engine
    mod.destroy(run=h1)
    h2 = mod.create(robot="wam", adofgoal=GOAL, n_points=9, start_cost=hook)
    assert mod.runs[h2].engine is e1
    mod.destroy(run=h2)


def test_chunk1_bucket_runs_one_step(world):
    """iterate_masked(…, chunk_size=1) applies exactly one iteration and
    matches the full-chunk driver's per-step results."""
    mod = world
    h1 = mod.create(robot="wam", adofgoal=GOAL, n_points=9, seed=7)
    h2 = mod.create(robot="wam", adofgoal=GOAL, n_points=9, seed=7)
    rn1, rn2 = mod.runs[h1], mod.runs[h2]
    eng = rn1.engine
    assert eng is rn2.engine

    p1, c1 = eng.iterate_masked(rn1.problem, 1, 1)
    assert c1.shape == (1, 3)
    assert int(p1.iteration) == int(rn1.problem.iteration) + 1
    # parity with the masked 16-chunk at valid=1
    p2, c2 = eng.iterate_masked(rn2.problem, 1, eng.ITER_CHUNK)
    np.testing.assert_allclose(np.asarray(c1[0]), np.asarray(c2[0]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(p1.traj), np.asarray(p2.traj),
                               rtol=1e-12)
    mod.destroy(run=h1)
    mod.destroy(run=h2)


def test_max_time_uses_single_step_bucket(world, monkeypatch):
    """api.iterate with max_time must call the chunk=1 bucket (one step
    of compute per applied iteration — the round-3 16x waste)."""
    mod = world
    h = mod.create(robot="wam", adofgoal=GOAL, n_points=9)
    rn = mod.runs[h]
    seen = []
    orig = rn.engine.iterate_masked

    def spy(prob, valid, chunk_size=None):
        seen.append((int(valid), chunk_size))
        return orig(prob, valid, chunk_size)

    monkeypatch.setattr(rn.engine, "iterate_masked", spy)
    mod.iterate(run=h, n_iter=3, max_time=1e9)
    assert seen == [(1, 1)] * 3
    seen.clear()
    mod.iterate(run=h, n_iter=3)  # no budget → full-chunk bucket
    assert seen == [(3, rn.engine.ITER_CHUNK)]
    mod.destroy(run=h)


def test_masked_driver_no_recompile_across_valid(world):
    """Varying the valid count must not retrace either bucket."""
    mod = world
    h = mod.create(robot="wam", adofgoal=GOAL, n_points=9)
    rn = mod.runs[h]
    eng = rn.engine
    p = rn.problem
    p, _ = eng.iterate_masked(p, 3, eng.ITER_CHUNK)
    # the per-engine jit wrapper now exists; its cache must not grow
    # across valid counts (valid is traced, chunk_size static)
    wrapper = eng._jits["iterate_masked"]
    n0 = wrapper._cache_size()
    p, _ = eng.iterate_masked(p, 9, eng.ITER_CHUNK)
    p, _ = eng.iterate_masked(p, 5, eng.ITER_CHUNK)
    assert wrapper._cache_size() == n0  # reused across valid=9, 5
    mod.destroy(run=h)
