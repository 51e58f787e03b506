"""Floating-base and HMC/momentum solver-path tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot


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
    return mod, r


GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def test_floating_base_runs_and_normalizes(world):
    mod, r = world
    basegoal = np.array([0.3, 0.1, 0.0, 0.0, 0.0, 0.38268343, 0.92387953])
    h = mod.create(robot="wam", adofgoal=GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=100.0, n_points=8)
    rn = mod.runs[h]
    assert rn.spec.n == 14
    rn.problem, costs = rn.engine.iterate(rn.problem, 3)
    traj = np.asarray(rn.problem.traj)
    # per-iteration quaternion renormalization (orcdchomp_mod.cpp:2805)
    qn = np.linalg.norm(traj[:, 3:7], axis=1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-9)
    # endpoints pinned: start = current base+q, goal = basegoal+adofgoal
    np.testing.assert_allclose(traj[-1, :7], basegoal, atol=1e-9)
    np.testing.assert_allclose(traj[-1, 7:], GOAL, atol=1e-9)
    assert np.all(np.isfinite(np.asarray(costs)))
    # base joint limits unlimited (orcdchomp_mod.cpp:2642-2646)
    assert np.all(np.isinf(np.asarray(rn.problem.jlimit_lower[:7])))
    t = mod.gettraj(run=h, no_collision_check=True)
    assert t.base_poses.shape == (8, 7)
    mod.destroy(run=h)


def test_floating_base_gradient_moves_base(world):
    """All spheres are active under floating base; the base columns of
    the update are damped but nonzero when obstacles push."""
    mod, r = world
    basegoal = np.array([0.0, 0.0, 0.0, 0, 0, 0, 1.0])
    h = mod.create(robot="wam", adofgoal=GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=30.0, n_points=8)
    rn = mod.runs[h]
    assert rn.engine.n_spheres_active == 16  # all active
    t0 = np.asarray(rn.problem.traj[:, :3]).copy()
    rn.problem, _ = rn.engine.iterate(rn.problem, 3)
    t1 = np.asarray(rn.problem.traj[:, :3])
    assert np.abs(t1[1:-1] - t0[1:-1]).max() > 0  # base moved
    mod.destroy(run=h)


def test_momentum_leapfrog(world):
    """use_momentum: AG accumulates; first step is a half step
    (chomp.c:533-548)."""
    mod, r = world
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   n_points=8, use_momentum=True)
    rn = mod.runs[h]
    assert bool(rn.problem.hmc.leapfrog_first)
    rn.problem, c1 = rn.engine.iterate(rn.problem, 1)
    assert not bool(rn.problem.hmc.leapfrog_first)
    ag1 = np.asarray(rn.problem.AG).copy()
    assert np.abs(ag1).max() > 0
    rn.problem, c2 = rn.engine.iterate(rn.problem, 1)
    ag2 = np.asarray(rn.problem.AG)
    assert not np.allclose(ag1, ag2)  # accumulated
    mod.destroy(run=h)


def test_hmc_resamples(world):
    """use_hmc: momentum is resampled at iteration 0 and the next
    resample iteration is scheduled (orcdchomp_mod.cpp:2754-2768)."""
    mod, r = world
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   n_points=8, use_hmc=True, seed=42)
    rn = mod.runs[h]
    assert int(rn.problem.hmc.resample_iter) == 0
    rn.problem, _ = rn.engine.iterate(rn.problem, 1)
    nxt = int(rn.problem.hmc.resample_iter)
    assert nxt >= 1
    # deterministic under the same seed
    h2 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                    n_points=8, use_hmc=True, seed=42)
    rn2 = mod.runs[h2]
    rn2.problem, _ = rn2.engine.iterate(rn2.problem, 1)
    np.testing.assert_allclose(np.asarray(rn.problem.traj),
                               np.asarray(rn2.problem.traj), atol=0)
    # different seed ⇒ different momentum
    h3 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                    n_points=8, use_hmc=True, seed=7)
    rn3 = mod.runs[h3]
    rn3.problem, _ = rn3.engine.iterate(rn3.problem, 1)
    assert not np.allclose(np.asarray(rn.problem.AG),
                           np.asarray(rn3.problem.AG))
    for hh in (h, h2, h3):
        mod.destroy(run=hh)


def test_starttraj_resample(world):
    """starttraj is linearly resampled to n_points
    (orcdchomp_mod.cpp:2375-2416)."""
    mod, r = world
    src = np.linspace(r.q_active, GOAL, 5)
    h = mod.create(robot="wam", starttraj=src, lambda_=100.0, n_points=9)
    rn = mod.runs[h]
    traj = np.asarray(rn.problem.traj)
    assert traj.shape == (9, 7)
    np.testing.assert_allclose(traj[0], src[0], atol=1e-9)
    np.testing.assert_allclose(traj[-1], src[-1], atol=1e-9)
    # linear interior
    expect = np.linspace(src[0], src[-1], 9)
    np.testing.assert_allclose(traj, expect, atol=1e-9)
    mod.destroy(run=h)
