"""Production-dtype correctness: the f32 path vs the f64 engine on the
flagship shape (SURVEY §7 hard part (e)).

The reference is all-double (libcd chomp.c throughout; LAPACK dgesv
chomp.c:579-581) and BASELINE.md sets a ≤1e-3 per-solve trajectory
error bar.  The f64 engine is oracle-pinned at ≤1e-6
(tests/test_oracle_full_matrix.py); this test closes the remaining gap
by bounding the *f32 production path* (the dtype every benchmark and
the driver metric run in) against the f64 engine on the exact flagship
workload: WAM7, n_points=101, 100 iterations, batch 64, λ=100,
obs_factor=500, via the batch-native SoA step.  These run on the CPU;
chip_smoke.py holds the same bar on the GPU, where float32 products
must ask for full precision (a GPU may run them in TF32).
"""

import numpy as np

import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.parallel.batch import problem_batch_from_grid

Q_START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
Q_GOAL = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
BATCH = 64
N_ITER = 100


def _solve(dtype, starts, goals):
    mod = oc.CHOMPModule(dtype=dtype)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.35, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    r = Robot("wam", oc.wam7(), q_active=Q_START.copy())
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    r.enabled = True
    h = mod.create(robot="wam", adofgoal=Q_GOAL, n_points=101,
                   lambda_=100.0, obs_factor=500.0)
    rn = mod.runs[h]
    probs = problem_batch_from_grid(rn.problem, starts, goals, rn.engine)
    out, costs = rn.engine.iterate_batch(probs, N_ITER)
    return (np.asarray(out.traj, dtype=np.float64),
            np.asarray(costs, dtype=np.float64))


def test_f32_flagship_within_1e3_of_f64():
    """Flagship shape in f32 vs f64 on identical problems: max per-solve
    trajectory error must stay under the 1e-3 reference-parity bar."""
    rng = np.random.default_rng(0)
    starts = np.tile(Q_START, (BATCH, 1)) + 0.02 * rng.normal(
        size=(BATCH, 7))
    goals = np.tile(Q_GOAL, (BATCH, 1)) + 0.02 * rng.normal(
        size=(BATCH, 7))

    traj64, costs64 = _solve(jnp.float64, starts, goals)
    traj32, costs32 = _solve(jnp.float32, starts, goals)

    per_solve = np.abs(traj32 - traj64).reshape(BATCH, -1).max(axis=1)
    assert per_solve.max() <= 1e-3, per_solve.max()
    # and the final cost report agrees to ~1e-3 relative
    c64 = costs64[:, -1, 0]
    c32 = costs32[:, -1, 0]
    assert np.max(np.abs(c32 - c64) / np.abs(c64)) <= 1e-3


def _solve_floating_tsr(dtype, starts, goals, n_iter=60):
    """Config-4 shape: floating base + everyn TSR through the batched
    SoA step — exercises the f32 constraint projection (Cholesky /
    quasiseparable scan) and base quaternion renorm."""
    from or_cdchomp_jax.tsr import TSR

    mod = oc.CHOMPModule(dtype=dtype)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.35, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    r = Robot("wam", oc.wam7(), q_active=Q_START.copy())
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.06)
    r.enabled = True
    tsr = TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))
    basegoal = np.array([0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0])
    h = mod.create(robot="wam", adofgoal=Q_GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=250.0, obs_factor=150.0,
                   n_points=31, everyn_tsr=tsr)
    rn = mod.runs[h]
    probs = problem_batch_from_grid(rn.problem, starts, goals, rn.engine)
    out, costs = rn.engine.iterate_batch(probs, n_iter)
    return (np.asarray(out.traj, dtype=np.float64),
            np.asarray(costs, dtype=np.float64))


def test_f32_floating_tsr_within_1e3_of_f64():
    """The constrained floating-base path (config-4 shape) also holds
    the 1e-3 bar in f32 — covering the projection solve and SE(3)
    renorm, not just the unconstrained flagship."""
    B = 16
    rng = np.random.default_rng(1)
    base0 = np.array([0, 0, 0, 0, 0, 0, 1.0])
    starts = np.concatenate(
        [np.tile(base0, (B, 1)),
         np.tile(Q_START, (B, 1)) + 0.02 * rng.normal(size=(B, 7))],
        axis=1)
    goals = np.concatenate(
        [np.tile(np.array([0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0]), (B, 1)),
         np.tile(Q_GOAL, (B, 1)) + 0.02 * rng.normal(size=(B, 7))],
        axis=1)

    traj64, costs64 = _solve_floating_tsr(jnp.float64, starts, goals)
    traj32, costs32 = _solve_floating_tsr(jnp.float32, starts, goals)

    per_solve = np.abs(traj32 - traj64).reshape(B, -1).max(axis=1)
    assert per_solve.max() <= 1e-3, per_solve.max()
    c64 = costs64[:, -1, 0]
    c32 = costs32[:, -1, 0]
    assert np.max(np.abs(c32 - c64) / np.abs(c64)) <= 1e-3
