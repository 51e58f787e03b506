"""Run-lifecycle semantics: multiple concurrent runs, re-entrant
iterate, resume-from-trajectory, destroy, and bad handles.

The reference supports any number of simultaneous runs per module
(README.md:86-88), each a separable create/iterate/gettraj/destroy
handle; iterate is re-entrant (README.md:106-110) and a run can seed
another via starttraj (orcdchomp_mod.cpp:2375-2416).
"""

import numpy as np
import pytest

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


def test_concurrent_runs_are_independent(world):
    mod = world
    h1 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=9,
                    seed=1)
    h2 = mod.create(robot="wam", adofgoal=-0.5 * GOAL, lambda_=50.0,
                    n_points=9, seed=2)
    assert h1 != h2
    # interleaved, re-entrant iteration
    c1a = mod.iterate(run=h1, n_iter=3)
    c2a = mod.iterate(run=h2, n_iter=3)
    c1b = mod.iterate(run=h1, n_iter=3)
    assert mod.runs[h1].iteration == 6
    assert mod.runs[h2].iteration == 3
    t1 = np.asarray(mod.runs[h1].problem.traj)
    t2 = np.asarray(mod.runs[h2].problem.traj)
    assert not np.allclose(t1[-1], t2[-1])  # different goals
    assert np.isfinite([c1a, c2a, c1b]).all()
    mod.destroy(run=h2)
    # h1 still usable after destroying h2
    mod.iterate(run=h1, n_iter=1)
    traj = mod.gettraj(run=h1, no_collision_check=True)
    assert traj.positions.shape == (9, 7)
    mod.destroy(run=h1)


def test_destroyed_handle_rejected(world):
    mod = world
    h = mod.create(robot="wam", adofgoal=GOAL, n_points=9)
    mod.destroy(run=h)
    for fn in (lambda: mod.iterate(run=h),
               lambda: mod.gettraj(run=h),
               lambda: mod.destroy(run=h)):
        with pytest.raises((KeyError, ValueError)):
            fn()


def test_resume_via_starttraj(world):
    """Seed a new run from a previous run's optimized trajectory — the
    reference's de-facto optimizer resume (SURVEY.md §5)."""
    mod = world
    h1 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=9)
    mod.iterate(run=h1, n_iter=5)
    prev = np.asarray(mod.runs[h1].problem.traj)
    mod.destroy(run=h1)

    h2 = mod.create(robot="wam", starttraj=prev, lambda_=100.0, n_points=9)
    t2 = np.asarray(mod.runs[h2].problem.traj)
    np.testing.assert_allclose(t2, prev, atol=1e-9)  # resampled identity
    c = mod.iterate(run=h2, n_iter=3)
    assert np.isfinite(c)
    mod.destroy(run=h2)


def test_starttraj_resampling(world):
    """A starttraj with a different number of rows is resampled at
    n_points uniform times (orcdchomp_mod.cpp:2375-2416)."""
    mod = world
    rows = np.linspace(np.zeros(7), GOAL, 21)
    h = mod.create(robot="wam", starttraj=rows, n_points=9)
    t = np.asarray(mod.runs[h].problem.traj)
    assert t.shape == (9, 7)
    np.testing.assert_allclose(t[0], rows[0], atol=1e-9)
    np.testing.assert_allclose(t[-1], rows[-1], atol=1e-9)
    # uniform resampling of a straight line stays on the line
    np.testing.assert_allclose(t[4], 0.5 * (rows[0] + rows[-1]), atol=1e-9)
    mod.destroy(run=h)


def test_masked_iterate_matches_static_and_compiles_once(world):
    """api.iterate drives the masked fixed-chunk executable: results
    are bit-identical to the static-length scan, and varying n_iter /
    max_time patterns reuse ONE compiled executable per engine
    (the n_iter-recompile fix)."""
    mod = world
    h1 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=9,
                    seed=3)
    h2 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=9,
                    seed=3)
    rn1, rn2 = mod.runs[h1], mod.runs[h2]
    engine = rn1.engine
    assert engine is rn2.engine   # same static structure → shared engine

    # warm one call so the PER-ENGINE jit wrapper exists (engine-owned
    # caches since round 5: evicted engines must actually free), then
    # count only the entries the mixed patterns add
    mod.iterate(run=h1, n_iter=1)
    wrapper = engine._jits["iterate_masked"]
    cache_before = wrapper._cache_size()

    # drive run 1 through mixed n_iter patterns via the api
    c1 = mod.iterate(run=h1, n_iter=4)
    c1 = mod.iterate(run=h1, n_iter=17)   # crosses a chunk boundary
    c1 = mod.iterate(run=h1, n_iter=2, max_time=1e9)

    # drive run 2 with the static-length scans (the bench path)
    for n in (1, 4, 17, 2):
        rn2.problem, _ = engine.iterate(rn2.problem, n)

    np.testing.assert_allclose(np.asarray(rn1.problem.traj),
                               np.asarray(rn2.problem.traj), atol=1e-12)
    np.testing.assert_allclose(c1, float(jnp.stack(
        engine.costs_only_jit(rn2.problem))[0]), rtol=1e-12)

    # one executable: despite 3 distinct n_iter patterns, this test
    # adds at most ONE iterate_masked cache entry (the valid count is a
    # traced scalar, so n_iter never specializes the executable)
    added = wrapper._cache_size() - cache_before
    assert added <= 1, f"iterate_masked compiled {added} times"
    mod.destroy(run=h1)
    mod.destroy(run=h2)
