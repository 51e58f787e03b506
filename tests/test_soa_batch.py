"""Batch-native SoA step ≡ vmapped AoS step.

The batch-native path (solver.step_batched + cost_soa) is a layout
rewrite, not a math rewrite: for every eligible problem class it must
produce the same trajectories and costs as vmap of the per-problem
step, which is the path the float64 oracle parity suite pins against
libcd's formulas (chomp.c:430-683, orcdchomp_mod.cpp:968-1327).
"""

import numpy as np
import jax
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.parallel.batch import problem_batch_from_grid

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _module(two_fields=False):
    import jax.numpy as jnp
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=START)
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    if two_fields:
        mod.add_kinbody(KinBody("mug", oc.Scene.build(
            spheres=[((0.45, 0.1, 0.7), 0.05)])))
        mod.computedistancefield(kinbody="mug", cube_extent=0.08)
    r.enabled = True
    return mod


def _compare(mod, n_iter=4, batch=5, **create_kw):
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, **create_kw)
    run = mod.runs[h]
    engine = run.engine
    assert engine.batch_native_ok
    rng = np.random.default_rng(3)
    starts = np.tile(START, (batch, 1)) + 0.02 * rng.normal(size=(batch, 7))
    goals = np.tile(GOAL, (batch, 1)) + 0.02 * rng.normal(size=(batch, 7))
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)

    out_soa, costs_soa = engine.iterate_batched_nojit(probs, n_iter)
    out_ref, costs_ref = jax.vmap(
        lambda p: engine.iterate_nojit(p, n_iter))(probs)

    np.testing.assert_allclose(np.asarray(out_soa.traj),
                               np.asarray(out_ref.traj),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(costs_soa),
                               np.asarray(costs_ref), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(out_soa.AG),
                               np.asarray(out_ref.AG),
                               rtol=1e-8, atol=1e-10)
    return out_soa


def test_soa_matches_vmap_plain():
    _compare(_module())


def test_soa_matches_vmap_momentum():
    _compare(_module(), use_momentum=True)


def test_soa_matches_vmap_hmc():
    """HMC: both paths draw momentum noise through the same vmapped
    per-problem resampler, so trajectories must agree bitwise-close."""
    _compare(_module(), n_iter=6, use_hmc=True, seed=11)


def test_soa_matches_vmap_multifield():
    """Two SDFs of different grid sizes exercise the per-field
    min-select in the SoA lookup."""
    _compare(_module(two_fields=True))


def test_soa_limit_repair():
    """A goal far outside the joint limits forces the repair loop."""
    mod = _module()
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9)
    run = mod.runs[h]
    engine = run.engine
    batch = 3
    rng = np.random.default_rng(0)
    starts = np.tile(START, (batch, 1)) + 0.02 * rng.normal(size=(batch, 7))
    # drive towards limits so the repair while-loop actually fires
    hi = np.asarray(run.problem.jlimit_upper)
    goals = np.tile(hi * 0.999, (batch, 1))
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)
    out_soa, _ = engine.iterate_batched_nojit(probs, 5)
    out_ref, _ = jax.vmap(lambda p: engine.iterate_nojit(p, 5))(probs)
    np.testing.assert_allclose(np.asarray(out_soa.traj),
                               np.asarray(out_ref.traj),
                               rtol=1e-9, atol=1e-9)
    lo = np.asarray(run.problem.jlimit_lower)
    assert np.all(np.asarray(out_soa.traj) <= hi + 1e-7)
    assert np.all(np.asarray(out_soa.traj) >= lo - 1e-7)


def _compare_handle(mod, h, n_iter=4, batch=4):
    run = mod.runs[h]
    engine = run.engine
    assert engine.batch_native_ok
    spec = engine.spec
    rng = np.random.default_rng(5)
    start = np.asarray(run.problem.traj)[0]
    goal = np.asarray(run.problem.traj)[-1]
    starts = np.tile(start, (batch, 1)) + \
        0.02 * rng.normal(size=(batch, spec.n))
    goals = np.tile(goal, (batch, 1)) + \
        0.02 * rng.normal(size=(batch, spec.n))
    if spec.floating_base:
        starts[:, 3:7] = start[3:7]
        goals[:, 3:7] = goal[3:7]
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)
    out_soa, costs_soa = engine.iterate_batched_nojit(probs, n_iter)
    out_ref, costs_ref = jax.vmap(
        lambda p: engine.iterate_nojit(p, n_iter))(probs)
    np.testing.assert_allclose(np.asarray(out_soa.traj),
                               np.asarray(out_ref.traj),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(costs_soa),
                               np.asarray(costs_ref), rtol=1e-8)


def test_soa_matches_vmap_floating():
    """Floating base: per-waypoint SE(3) base through the SoA FK, the
    damped base Jacobian block, and the per-iteration quat renorm."""
    mod = _module()
    basegoal = np.array([0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0])
    h = mod.create(robot="wam", adofgoal=GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=200.0, obs_factor=200.0,
                   n_points=7)
    _compare_handle(mod, h)


def test_soa_matches_vmap_floating_everyn_tsr():
    """The config-4 shape: floating base + everyn TSR — constraint
    eval/projection run vmapped-AoS inside the batch-native step."""
    from or_cdchomp_jax.tsr import TSR
    mod = _module()
    tsr = TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))
    basegoal = np.array([0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0])
    h = mod.create(robot="wam", adofgoal=GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=200.0, obs_factor=200.0,
                   n_points=7, everyn_tsr=tsr)
    assert mod.runs[h].engine.cons.k_total > 0
    _compare_handle(mod, h)


def test_soa_matches_vmap_fixed_con_tsr():
    """Fixed base + a single-point con_tsr."""
    from or_cdchomp_jax.tsr import TSR
    mod = _module()
    tsr = TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, con_tsr=("end", tsr))
    assert mod.runs[h].engine.cons.k_total > 0
    _compare_handle(mod, h)


def test_start_tsr_not_eligible():
    """start_tsr shifts the moving-point window; it keeps the vmapped
    AoS path."""
    from or_cdchomp_jax.tsr import TSR
    mod = _module()
    tsr = TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, start_tsr=tsr)
    assert not mod.runs[h].engine.batch_native_ok
