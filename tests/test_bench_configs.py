"""Benchmark-workload integrity: the measured configs must be *solvable*.

Round 3's flagship scenario had fixed endpoints 2.5 cm inside the
table (and a self-colliding goal), so every benchmarked "solve" ended
in unavoidable collision.  These tests pin the feasibility invariants
so future scenario edits can't silently regress the benchmark's
meaning: both endpoints of config 1 (shared by configs 3/5 and
bench.py) clear every obstacle and the sphere self-model with margin.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from benchmarks import configs as C
from or_cdchomp_jax.ops.voxelize import scene_distance
from or_cdchomp_jax.utils import np_pose

MARGIN = 0.01  # meters of required clearance at the fixed endpoints


@pytest.fixture(scope="module")
def config1():
    return C.wam7_single_sdf(jnp.float64, n_points=11)


def _clearances(mod, robot, q):
    fk = robot._fk()
    x = np.asarray(fk.sphere_positions_jit(
        jnp.asarray(q, fk.dtype), jnp.asarray(robot.pose, fk.dtype)))
    rad = np.asarray(robot.model.sphere_radius)
    out = {}
    for name, b in mod.bodies.items():
        local = np.stack([np_pose.apply(np_pose.invert(
            np.asarray(b.pose, np.float64)), xi) for xi in x])
        d = np.asarray(scene_distance(b.scene, jnp.asarray(local)))
        out[name] = float((d - rad).min())
    dist = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    excl = robot.check_exclude_mask()
    out["self"] = float(
        (dist - rad[:, None] - rad[None, :] + 1e9 * excl).min())
    return out


def test_config1_endpoints_feasible(config1):
    mod, run, goal = config1
    robot = mod.robots["wam"]
    for label, q in (("start", np.asarray(run.problem.traj)[0]),
                     ("goal", goal)):
        clear = _clearances(mod, robot, np.asarray(q, np.float64))
        for name, c in clear.items():
            assert c >= MARGIN, (label, name, c)


def test_config1_solve_collision_free(config1):
    """A short solve of the benchmark problem passes gettraj's strict
    collision re-check (the property the benchmark's 'solves' claim
    rests on)."""
    mod, run, goal = config1
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=31)
    mod.iterate(run=h, n_iter=60)
    traj = mod.gettraj(run=h, no_collision_exception=True)
    assert not traj.in_collision
    mod.destroy(run=h)


# ---- config 2 (cluttered multi-SDF) --------------------------------------


@pytest.fixture(scope="module")
def config2():
    return C.cluttered_multi_sdf(jnp.float64, n_points=11)


def test_config2_endpoints_feasible(config2):
    mod, run, goal = config2
    robot = mod.robots["wam"]
    for label, q in (("start", np.asarray(run.problem.traj)[0]),
                     ("goal", goal)):
        clear = _clearances(mod, robot, np.asarray(q, np.float64))
        for name, c in clear.items():
            assert c >= MARGIN, (label, name, c)


def test_config2_solve_collision_free(config2):
    mod, run, goal = config2
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, obs_factor_self=10.0,
                   epsilon_self=0.04, n_points=31)
    mod.iterate(run=h, n_iter=60)
    traj = mod.gettraj(run=h, no_collision_exception=True)
    assert not traj.in_collision
    mod.destroy(run=h)


# ---- config 4 (floating base + everyn TSR) -------------------------------


@pytest.fixture(scope="module")
def config4():
    return C.floating_everyn_tsr(jnp.float64, n_points=11)


def _floating_clearances(mod, robot, row):
    """row = [base_pose7, q_adof]: place the base, then reuse the
    fixed-base clearance helper."""
    old = robot.pose
    try:
        robot.pose = np.asarray(row[:7], np.float64)
        return _clearances(mod, robot, np.asarray(row[7:], np.float64))
    finally:
        robot.pose = old


def test_config4_endpoints_feasible(config4):
    mod, run, goal = config4
    robot = mod.robots["wam"]
    traj = np.asarray(run.problem.traj)
    for label, row in (("start", traj[0]), ("goal", traj[-1])):
        clear = _floating_clearances(mod, robot, row)
        for name, c in clear.items():
            assert c >= MARGIN, (label, name, c)


def test_config4_solve_collision_free(config4):
    from or_cdchomp_jax.tsr import TSR
    mod, run, goal = config4
    tsr = TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))
    h = mod.create(robot="wam", adofgoal=goal[7:], basegoal=goal[:7],
                   floating_base=True, lambda_=200.0, obs_factor=200.0,
                   n_points=31, everyn_tsr=tsr)
    mod.iterate(run=h, n_iter=60)
    traj = mod.gettraj(run=h, no_collision_exception=True)
    assert not traj.in_collision
    mod.destroy(run=h)
