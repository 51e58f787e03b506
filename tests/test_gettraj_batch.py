"""gettraj_batch parity: the batch-native retime + sampled collision
re-check must reproduce the per-run gettraj() exactly, problem by
problem (same linear retimer, same 0.04-rad sampling semantics,
orcdchomp_mod.cpp:2854-3011), for fixed and floating base."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.parallel.batch import BatchSolver, problem_batch_from_grid

GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])


@pytest.fixture(scope="module")
def world():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=START.copy())
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    return mod


def _batch(mod, run, B, seed=7, scale=0.05):
    rn = mod.runs[run]
    rng = np.random.default_rng(seed)
    t = np.asarray(rn.problem.traj)
    start, goal = t[0], t[-1]
    starts = np.tile(start, (B, 1))
    goals = np.tile(goal, (B, 1))
    # perturb arm dofs only (a floating-base problem carries the 7-pose
    # in the leading dims — noise there would denormalize the quat)
    starts[:, -7:] += scale * rng.normal(size=(B, 7))
    goals[:, -7:] += scale * rng.normal(size=(B, 7))
    return problem_batch_from_grid(rn.problem, starts, goals, rn.engine)


def test_gettraj_batch_matches_per_run(world):
    mod = world
    run = mod.create(robot="wam", adofgoal=GOAL, n_points=21,
                     lambda_=100.0, obs_factor=500.0)
    probs = _batch(mod, run, B=4)
    solver = BatchSolver(mod.runs[run].engine)
    probs, _ = solver.iterate(solver.shard(probs), 8)

    trajs, flags = mod.gettraj_batch(run=run, probs=probs,
                                     device_chunk=3)  # force 2 chunks
    assert len(trajs) == 4 and flags.shape == (4,)

    rn = mod.runs[run]
    saved = rn.problem
    try:
        for b in range(4):
            rn.problem = saved._replace(
                traj=jnp.asarray(np.asarray(probs.traj)[b]))
            ref = mod.gettraj(run=run, no_collision_exception=True,
                              no_collision_details=True)
            np.testing.assert_allclose(trajs[b].times, ref.times,
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(trajs[b].positions, ref.positions,
                                       rtol=1e-12, atol=1e-12)
            assert trajs[b].in_collision == ref.in_collision == bool(
                flags[b])
    finally:
        rn.problem = saved
    mod.destroy(run=run)


def test_gettraj_batch_flags_forced_collision(world):
    """A trajectory driven through the table must flag in_collision
    without raising (batch callers filter, not catch)."""
    mod = world
    run = mod.create(robot="wam", adofgoal=GOAL, n_points=21,
                     lambda_=100.0, obs_factor=500.0)
    probs = _batch(mod, run, B=2)
    # overwrite problem 1 with a straight shot through zeros (elbow
    # folded through the table region) — guaranteed env or self hit
    t = np.asarray(probs.traj).copy()
    t[1, 1:-1] = 0.0
    probs = probs._replace(traj=jnp.asarray(t))
    trajs, flags = mod.gettraj_batch(run=run, probs=probs)
    rn = mod.runs[run]
    saved = rn.problem
    try:
        for b in range(2):
            rn.problem = saved._replace(traj=jnp.asarray(t[b]))
            ref = mod.gettraj(run=run, no_collision_exception=True,
                              no_collision_details=True)
            assert bool(flags[b]) == ref.in_collision
    finally:
        rn.problem = saved
    mod.destroy(run=run)


def test_gettraj_batch_degenerate_and_nocheck(world):
    """A zero-length trajectory (start == goal) is not colliding (the
    per-run path early-returns False on total_dist == 0), and
    no_collision_check=True skips the check entirely."""
    mod = world
    run = mod.create(robot="wam", adofgoal=GOAL, n_points=21,
                     lambda_=100.0, obs_factor=500.0)
    probs = _batch(mod, run, B=2)
    t = np.asarray(probs.traj).copy()
    t[0, :] = t[0, 0]                 # problem 0: all waypoints equal
    probs = probs._replace(traj=jnp.asarray(t))

    trajs, flags = mod.gettraj_batch(run=run, probs=probs)
    assert not flags[0] and not trajs[0].in_collision
    # seg floor 1e-6 keeps the retime finite, like the per-run path
    assert np.isfinite(trajs[0].times).all()

    _, flags_nc = mod.gettraj_batch(run=run, probs=probs,
                                    no_collision_check=True)
    assert not flags_nc.any()
    mod.destroy(run=run)


def test_gettraj_batch_floating_base(world):
    mod = world
    basegoal = np.array([0.3, 0.1, 0.0, 0.0, 0.0, 0.38268343, 0.92387953])
    run = mod.create(robot="wam", adofgoal=GOAL, basegoal=basegoal,
                     n_points=15, floating_base=True, lambda_=100.0,
                     obs_factor=500.0)
    probs = _batch(mod, run, B=3, scale=0.02)
    solver = BatchSolver(mod.runs[run].engine)
    probs, _ = solver.iterate(solver.shard(probs), 5)
    trajs, flags = mod.gettraj_batch(run=run, probs=probs)

    rn = mod.runs[run]
    saved = rn.problem
    try:
        for b in range(3):
            rn.problem = saved._replace(
                traj=jnp.asarray(np.asarray(probs.traj)[b]))
            ref = mod.gettraj(run=run, no_collision_exception=True,
                              no_collision_details=True)
            np.testing.assert_allclose(trajs[b].times, ref.times,
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(trajs[b].base_poses,
                                       ref.base_poses,
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(trajs[b].base_velocities,
                                       ref.base_velocities,
                                       rtol=1e-12, atol=1e-12)
            assert trajs[b].in_collision == ref.in_collision
    finally:
        rn.problem = saved
    mod.destroy(run=run)
