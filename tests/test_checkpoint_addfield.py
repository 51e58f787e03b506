"""Checkpoint/resume of solver state + addfield_fromobsarray ingestion."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.checkpoint import load_problem, save_problem
from or_cdchomp_jax.transport import send_command

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


def test_checkpoint_resume_bitexact(world, tmp_path):
    """save → load → continue must equal an uninterrupted run."""
    mod = world
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=9,
                   use_hmc=True, seed=11)
    rn = mod.runs[h]
    eng = rn.engine

    p_mid, _ = eng.iterate(rn.problem, 4)
    path = str(tmp_path / "ckpt")
    save_problem(path, p_mid)
    restored = load_problem(path, p_mid)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), p_mid, restored)

    p_resumed, _ = eng.iterate(restored, 4)
    p_straight, _ = eng.iterate(p_mid, 4)
    np.testing.assert_array_equal(np.asarray(p_resumed.traj),
                                  np.asarray(p_straight.traj))
    mod.destroy(run=h)


def test_checkpoint_batched(world, tmp_path):
    from or_cdchomp_jax.parallel.batch import problem_batch_from_grid

    mod = world
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=9)
    rn = mod.runs[h]
    rng = np.random.default_rng(0)
    starts = np.tile(np.array([2.5, -1.8, 0, 2.0, 0, 0.2, 0]), (6, 1)) \
        + 0.01 * rng.normal(size=(6, 7))
    goals = np.tile(GOAL, (6, 1))
    probs = problem_batch_from_grid(rn.problem, starts, goals, rn.engine)
    path = str(tmp_path / "batch_ckpt")
    save_problem(path, probs)
    back = load_problem(path, probs)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), probs, back)
    mod.destroy(run=h)


def test_addfield_fromobsarray_direct(world):
    """A user occupancy array becomes a queryable signed field
    (orcdchomp_mod.cpp:592-722)."""
    mod = world
    occ = np.zeros((8, 8, 8))
    occ[3:5, 3:5, 3:5] = 1.0
    mod.add_kinbody(KinBody("blob", oc.Scene.empty()))
    mod.addfield_fromobsarray(kinbody="blob", obsarray=occ,
                              sizes=[8, 8, 8], lengths=[0.8, 0.8, 0.8],
                              pose=[0, 0, 0, 0, 0, 0, 1])
    entry = [s for s in mod.sdfs if s.kinbody_name == "blob"][0]
    d = np.asarray(entry.grid.data)
    assert (d < 0).any() and (d > 0).any() and np.isfinite(d).all()
    mod.removefield(kinbody="blob")
    assert not [s for s in mod.sdfs if s.kinbody_name == "blob"]


def test_addfield_fromobsarray_wire(world, tmp_path):
    mod = world
    occ = np.zeros((6, 5, 4))
    occ[2:4, 2:3, 1:3] = 1.0
    npy = str(tmp_path / "occ.npy")
    np.save(npy, occ)
    mod.add_kinbody(KinBody("blob2", oc.Scene.empty()))
    send_command(mod, f"addfield_fromobsarray kinbody blob2 obsarray "
                      f"'{npy}' sizes '6 5 4' lengths '0.6 0.5 0.4' "
                      f"pose '0 0 0 0 0 0 1'")
    entry = [s for s in mod.sdfs if s.kinbody_name == "blob2"][0]
    assert (np.asarray(entry.grid.data) < 0).any()
    send_command(mod, "removefield kinbody blob2")
