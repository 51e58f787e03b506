"""Golden parity: the batched JAX solver vs the sequential oracle.

Runs the WAM7 workload shape (scaled down for oracle speed) in float64
and requires trajectory agreement far below the 1e-3 target
(BASELINE.md correctness bar) — effectively to solver roundoff.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from tests.ref.oracle import OracleChomp


@pytest.fixture(scope="module")
def world():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    table = KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))]))
    mod.add_kinbody(table)
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.05)
    r.enabled = True
    return mod, r


Q_GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _oracle_from_run(mod, rn):
    sdf = mod.sdfs[0]
    body = mod.bodies["table"]
    from or_cdchomp_jax.utils import np_pose
    pose_world_gsdf = np_pose.compose(body.pose, sdf.pose)
    return OracleChomp(
        model=rn.robot.model,
        robot_pose=rn.robot.pose,
        traj=np.asarray(rn.problem.traj, dtype=np.float64),
        lambda_=float(rn.problem.lambda_),
        epsilon=float(rn.problem.epsilon),
        epsilon_self=float(rn.problem.epsilon_self),
        obs_factor=float(rn.problem.obs_factor),
        obs_factor_self=float(rn.problem.obs_factor_self),
        sdfs=[(np.asarray(sdf.grid.data, dtype=np.float64),
               np.asarray(sdf.grid.lengths, dtype=np.float64),
               pose_world_gsdf)],
        jlimit_lower=np.asarray(rn.problem.jlimit_lower),
        jlimit_upper=np.asarray(rn.problem.jlimit_upper),
    )


def test_iterate_matches_oracle(world):
    mod, r = world
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=11)
    rn = mod.runs[h]
    orc = _oracle_from_run(mod, rn)

    # initial trajectories identical
    np.testing.assert_allclose(np.asarray(rn.problem.traj), orc.traj,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(rn.engine.A), orc.A, atol=1e-9)

    for it in range(5):
        rn.problem, costs = rn.engine.iterate(rn.problem, 1)
        total_o, obs_o, smooth_o = orc.iterate(True)
        costs = np.asarray(costs)[0]
        np.testing.assert_allclose(costs[1], obs_o, rtol=1e-6,
                                   err_msg=f"obs cost iter {it}")
        np.testing.assert_allclose(costs[2], smooth_o, rtol=1e-6,
                                   err_msg=f"smooth cost iter {it}")
        np.testing.assert_allclose(
            np.asarray(rn.problem.traj), orc.traj, atol=1e-6,
            err_msg=f"trajectory diverged at iter {it}")
    mod.destroy(run=h)


def test_final_cost_report(world):
    mod, r = world
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=11)
    rn = mod.runs[h]
    orc = _oracle_from_run(mod, rn)
    rn.problem, _ = rn.engine.iterate(rn.problem, 3)
    for _ in range(3):
        orc.iterate(True)
    total, obs, smooth = (float(x) for x in
                          jax.jit(rn.engine.costs_only)(rn.problem))
    t_o, o_o, s_o = orc.iterate(False)
    np.testing.assert_allclose(total, t_o, rtol=1e-6)
    np.testing.assert_allclose(obs, o_o, rtol=1e-6)
    np.testing.assert_allclose(smooth, s_o, rtol=1e-6)
    mod.destroy(run=h)


def test_joint_limit_repair(world):
    """Force a limit violation and check repaired trajectory respects
    limits and matches the oracle's repair."""
    mod, r = world
    # goal at a limit edge to provoke overshoot during optimization
    tight = np.array([2.59, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    h = mod.create(robot="wam", adofgoal=tight, lambda_=20.0,
                   obs_factor=500.0, n_points=11)
    rn = mod.runs[h]
    orc = _oracle_from_run(mod, rn)
    for it in range(5):
        rn.problem, _ = rn.engine.iterate(rn.problem, 1)
        orc.iterate(True)
        np.testing.assert_allclose(np.asarray(rn.problem.traj), orc.traj,
                                   atol=1e-6)
    lo = np.asarray(rn.problem.jlimit_lower)
    hi = np.asarray(rn.problem.jlimit_upper)
    T = np.asarray(rn.problem.traj)[1:-1]
    assert np.all(T >= lo - 1e-9) and np.all(T <= hi + 1e-9)
    mod.destroy(run=h)
