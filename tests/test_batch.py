"""Batched + sharded solve tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.chomp import metric as mm
from or_cdchomp_jax.parallel.batch import (
    BatchSolver, best_of_batch, problem_batch_from_grid, stack_problems)


@pytest.fixture(scope="module")
def setup():
    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    goal = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=8)
    return mod, mod.runs[h], goal


def _batch(run, goal, n):
    engine = run.engine
    ops = mm.build_metric(engine.spec.m, engine.spec.dt, D=engine.spec.D)
    rng = np.random.default_rng(0)
    starts = (np.tile(np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]), (n, 1))
              + 0.01 * rng.normal(size=(n, 7)))
    goals = np.tile(goal, (n, 1)) + 0.01 * rng.normal(size=(n, 7))
    return problem_batch_from_grid(run.problem, starts, goals, engine, ops), \
        starts, goals


def test_devices_available():
    assert len(jax.devices()) == 8


def test_batch_matches_single(setup):
    """Row i of the batched solve equals an independent single solve."""
    mod, run, goal = setup
    probs, starts, goals = _batch(run, goal, 4)
    solver = BatchSolver(run.engine)
    out, costs = solver.iterate(solver.shard(probs), 3)

    # independent single solve of row 2
    single = jax.tree.map(lambda x: x[2], probs)
    s_out, s_costs = run.engine.iterate(single, 3)
    np.testing.assert_allclose(np.asarray(out.traj[2]),
                               np.asarray(s_out.traj), atol=1e-5)
    np.testing.assert_allclose(np.asarray(costs[:, 2]),
                               np.asarray(s_costs), rtol=1e-5)


def test_endpoints_pinned(setup):
    mod, run, goal = setup
    probs, starts, goals = _batch(run, goal, 4)
    solver = BatchSolver(run.engine)
    out, _ = solver.iterate(solver.shard(probs), 3)
    np.testing.assert_allclose(np.asarray(out.traj[:, 0]), starts, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.traj[:, -1]), goals, atol=1e-6)


def test_solve_driver_and_best(setup):
    mod, run, goal = setup
    probs, _, _ = _batch(run, goal, 4)
    solver = BatchSolver(run.engine)
    out, finals, done = solver.solve(probs, n_iter=4, chunk=2)
    assert done == 4
    assert finals.shape == (4, 3)
    best, idx = best_of_batch(out, finals)
    assert best.traj.shape == out.traj.shape[1:]
    assert finals[idx, 0] == jnp.min(finals[:, 0])


def test_stack_problems(setup):
    mod, run, goal = setup
    probs = stack_problems([run.problem, run.problem])
    assert probs.traj.shape == (2,) + run.problem.traj.shape


def test_chunked_iterate_matches_flat(setup):
    """Large batches run as lax.map over chunks on single-device
    meshes; results must match the flat run.  (Not bit-for-bit: the
    batch-native SoA step compiles per batch shape, and XLA's reduction
    order differs between the chunk shape and the flat shape — f32
    rounding noise only.)"""
    import jax
    from jax.sharding import Mesh

    mod, run, goal = setup
    engine = run.engine
    rng = np.random.default_rng(3)
    B = 12
    starts = np.tile(np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]),
                     (B, 1)) + 0.01 * rng.normal(size=(B, 7))
    goals = np.tile(goal, (B, 1)) + 0.01 * rng.normal(size=(B, 7))
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)

    dev = np.asarray(jax.devices()[:1])
    flat = BatchSolver(engine, mesh=Mesh(dev, ("dp",)), chunk=None)
    chunked = BatchSolver(engine, mesh=Mesh(dev, ("dp",)), chunk=4)
    p1, c1 = flat.iterate(probs, 5)
    p2, c2 = chunked.iterate(probs, 5)
    np.testing.assert_allclose(np.asarray(p1.traj), np.asarray(p2.traj),
                               atol=5e-6)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=5e-5, atol=5e-4)


def test_solve_convergence_tol_early_stop(setup):
    """solve(tol=...) early-stops when every problem's per-chunk cost
    improvement drops below tol, and the early-stopped answer equals
    running the same number of iterations directly (the collective
    convergence reduction of BASELINE.json)."""
    mod, run, goal = setup
    probs, _, _ = _batch(run, goal, 4)
    solver = BatchSolver(run.engine)

    # huge tol: converged after the first chunk
    out1, finals1, done1 = solver.solve(probs, n_iter=40, chunk=5, tol=1e9)
    assert done1 == 5

    # tiny tol: never converges, runs the full budget
    out2, finals2, done2 = solver.solve(probs, n_iter=20, chunk=5, tol=-1.0)
    assert done2 == 20

    # realistic tol: stops somewhere in between, and the result equals
    # a direct run of exactly `done` iterations
    out3, finals3, done3 = solver.solve(probs, n_iter=200, chunk=5,
                                        tol=0.05)
    assert 5 <= done3 < 200
    direct = solver.shard(probs)
    direct, _ = solver.iterate(direct, done3)
    np.testing.assert_allclose(np.asarray(out3.traj),
                               np.asarray(direct.traj), atol=1e-12)
    finals_direct = run.engine.final_costs_batch(direct)
    np.testing.assert_allclose(np.asarray(finals3[:, 0]),
                               np.asarray(finals_direct[0]), rtol=1e-12)
