"""Round-4 batch-driver features: masked batched iteration (one
executable across varying budgets/tolerances) and vectorized affine
construction for problem batches.

VERDICT r3 #7: BatchSolver.iterate recompiled per static n_iter and
iterate_until per (chunk, tol); sweeps that vary budgets or tolerances
paid a fresh XLA compile each call.  The masked drivers trace the valid
count and tolerance.

VERDICT r3 #10: problem_batch_from_grid built metric affine terms in a
per-problem host loop (10,240 build_affine calls for config 5); now two
outer products (metric.affine_generators).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.parallel.batch import (
    BatchSolver, problem_batch_from_grid)

Q_START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
Q_GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


@pytest.fixture(scope="module")
def setup():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=Q_START.copy())
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    h = mod.create(robot="wam", adofgoal=Q_GOAL, n_points=9,
                   lambda_=100.0)
    return mod, mod.runs[h]


def _batch(run, B, seed=0):
    rng = np.random.default_rng(seed)
    starts = np.tile(Q_START, (B, 1)) + 0.01 * rng.normal(size=(B, 7))
    goals = np.tile(Q_GOAL, (B, 1)) + 0.01 * rng.normal(size=(B, 7))
    return problem_batch_from_grid(run.problem, starts, goals, run.engine)


def test_masked_matches_static_iterate(setup):
    mod, run = setup
    probs = _batch(run, 6)
    solver = BatchSolver(run.engine)
    p1, c1 = solver.iterate(probs, 5)
    p2, c2 = solver.iterate_masked(probs, 5, 8)
    np.testing.assert_allclose(np.asarray(p1.traj), np.asarray(p2.traj),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(c1),
                               np.asarray(c2[:5]), atol=1e-12)


def test_masked_driver_single_compile_across_budgets(setup):
    """A sweep over different budgets and tolerances must reuse ONE
    executable per (engine, chunk_size)."""
    mod, run = setup
    probs = _batch(run, 6)
    solver = BatchSolver(run.engine)

    # warm one call each so the per-solver jit wrappers exist
    # (solver-owned caches since round 5), then count what a sweep adds
    probs, _ = solver.iterate_masked(probs, 2, 8)
    probs, _, _ = solver.iterate_until(probs, 4, 8, 1e9)
    wm = solver._jits["iterate_masked"]
    wu = solver._jits["iterate_until"]
    n0m = wm._cache_size()
    n0u = wu._cache_size()
    for valid in (2, 5, 8, 3):
        probs, _ = solver.iterate_masked(probs, valid, 8)
    for tol in (0.05, -1.0):
        probs, _, _ = solver.iterate_until(probs, 4, 8, tol)
    assert wm._cache_size() == n0m
    assert wu._cache_size() == n0u


def test_solve_tail_chunk_no_recompile(setup):
    """solve() with a ragged tail (n_iter % chunk != 0) stays on the
    masked executable and produces the same trajectories as a direct
    static run of the same iteration count."""
    mod, run = setup
    probs = _batch(run, 6)
    solver = BatchSolver(run.engine)
    out, finals, done = solver.solve(probs, n_iter=13, chunk=5)
    assert done == 13
    ref, _ = solver.iterate(probs, 13)
    np.testing.assert_allclose(np.asarray(out.traj), np.asarray(ref.traj),
                               atol=1e-12)


def test_solve_tol_early_stop_still_works(setup):
    mod, run = setup
    probs = _batch(run, 4)
    solver = BatchSolver(run.engine)
    out1, _, done1 = solver.solve(probs, n_iter=40, chunk=5, tol=1e9)
    assert done1 == 5
    out2, _, done2 = solver.solve(probs, n_iter=20, chunk=5, tol=-1.0)
    assert done2 == 20


def test_affine_batch_matches_per_problem_loop(setup):
    """Vectorized build_affine_batch == the round-3 per-problem loop,
    in dense and sep metric modes and at D=2."""
    mod, run = setup
    engine = run.engine
    n = engine.spec.n
    npts = engine.spec.n_points
    rng = np.random.default_rng(1)
    P = 5
    starts = np.tile(Q_START, (P, 1)) + 0.05 * rng.normal(size=(P, 7))
    goals = np.tile(Q_GOAL, (P, 1)) + 0.05 * rng.normal(size=(P, 7))

    def check(eng):
        Bb, trCb, Evb = eng.build_affine_batch(starts, goals, n)
        for i in range(P):
            B1, trC1, Ev1 = eng.build_affine(starts[i], goals[i], n)
            np.testing.assert_allclose(Bb[i], np.asarray(B1), atol=1e-12)
            np.testing.assert_allclose(trCb[i], float(trC1), rtol=1e-12)
            np.testing.assert_allclose(Evb[i], np.asarray(Ev1), atol=1e-12)

    check(engine)   # dense D=1 (m=7 < SEP_MIN_M)

    # sep mode on the same spec
    from or_cdchomp_jax.chomp.solver import ChompEngine
    eng_sep = ChompEngine(engine.spec, run.robot.model, engine.fields,
                          dtype=jnp.float64, metric_mode="sep")
    check(eng_sep)

    # dense D=2
    h2 = mod.create(robot="wam", adofgoal=Q_GOAL, n_points=9,
                    derivative=2)
    check(mod.runs[h2].engine)
    mod.destroy(run=h2)
