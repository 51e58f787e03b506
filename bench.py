"""Benchmark: WAM7 CHOMP solves/s/chip on the reference workload shape.

Workload (BASELINE.md): WAM7 (n=7 DOF), n_points=101 (m=99 moving),
100 iterations, λ=100, obs_factor=500, 16 spheres, 1 SDF — the
test_wam7.py scenario.  The device path solves a batch of independent
problems (perturbed starts/goals) in one jitted scan; throughput =
batch · repeats / wall-clock.

Baseline: the reference publishes no numbers (BASELINE.md: "measured,
not quoted").  The denominator is a fixed, documented estimate of the
reference's single-thread CPU throughput on this workload:
REF_SOLVES_PER_S = 0.5 — i.e. ~2 s for a 100-iteration WAM7 solve,
consistent with published CHOMP planning times on WAM/HERB-class
problems and with the reference's own per-iteration cost drivers
(m FK calls + m·16 Jacobians + dense m×m gemms on one core,
BASELINE.md).  vs_baseline = device solves/s ÷ REF_SOLVES_PER_S.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import time

import numpy as np

N_ITER = 100
N_POINTS = 101
BATCH = 256
REF_SOLVES_PER_S = 0.5  # documented ESTIMATE, not a measurement — see
# module docstring; OpenRAVE is unavailable here so the reference was
# never run.  vs_baseline therefore carries estimate uncertainty.
REPS = 5            # timed reps per attempt (median is the headline)
SPREAD_TOL = 0.15   # (max-min)/median above this triggers one retry


def build(mod_dtype, n_points):
    import jax.numpy as jnp

    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot

    mod = oc.CHOMPModule(dtype=mod_dtype)
    # table + mug scene in front of the arm (test_wam7.py:23-33
    # analog); endpoints verified feasible — the solved trajectories
    # pass gettraj's strict collision re-check (benchmarks/configs.py)
    table = KinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))]))
    mug = KinBody("mug", oc.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)]))
    mod.add_kinbody(table)
    mod.add_kinbody(mug)
    robot = Robot("wam", oc.wam7(),
                  q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=n_points)
    return mod, mod.runs[h], goal


def main():
    import jax
    import jax.numpy as jnp

    from or_cdchomp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from or_cdchomp_jax.chomp import metric as mm
    from or_cdchomp_jax.parallel.batch import BatchSolver, problem_batch_from_grid

    mod, run, goal = build(jnp.float32, N_POINTS)
    engine = run.engine
    spec = engine.spec
    ops = mm.build_metric(spec.m, spec.dt, D=spec.D)

    rng = np.random.default_rng(0)
    starts = (np.tile(np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]),
                      (BATCH, 1)) + 0.02 * rng.normal(size=(BATCH, 7)))
    goals = np.tile(goal, (BATCH, 1)) + 0.02 * rng.normal(size=(BATCH, 7))
    probs = problem_batch_from_grid(run.problem, starts, goals, engine, ops)

    solver = BatchSolver(engine)
    probs_dev = solver.shard(probs)

    # warmup/compile (twice: first pays compile, second pays any lazy
    # autotuning cost so timed reps see steady state)
    for _ in range(2):
        out, costs = solver.iterate(probs_dev, N_ITER)
        jax.block_until_ready(out)

    def timed_reps(n):
        """Per-rep blocking walls: each pays one dispatch and one
        host sync — pessimistic for throughput, but what the spread
        diagnostics need."""
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            out, _ = solver.iterate(probs_dev, N_ITER)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        return ts

    def timed_pipelined(n):
        """n async-dispatched solves, one final block: the steady-state
        per-solve wall of a saturated server (dispatch overlaps
        compute; matches the same-process A/B harness, ab.py)."""
        t0 = time.perf_counter()
        out = probs_dev
        for _ in range(n):
            out, _ = solver.iterate(out, N_ITER)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n

    # >=5 per-rep walls for a spread check with one retry; the
    # headline is the pipelined steady-state median.
    times = timed_reps(REPS)
    spread = (max(times) - min(times)) / np.median(times)
    retried = False
    if spread > SPREAD_TOL:
        retried = True
        times = timed_reps(REPS)
        spread = (max(times) - min(times)) / np.median(times)

    pipe = [timed_pipelined(REPS) for _ in range(3)]
    med = float(np.median(pipe))
    solves_per_s = BATCH / med
    best_solves_per_s = BATCH / min(pipe)

    note = ""
    if spread > SPREAD_TOL:
        note = (f"NOISY: rep spread {spread:.1%} > {SPREAD_TOL:.0%} "
                "after one retry; treat the median with caution.")

    rec = {
        "metric": "wam7_chomp_solves_per_s_per_chip"
                  f" (n_points={N_POINTS}, {N_ITER} iters, batch={BATCH})",
        "value": round(solves_per_s, 3),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / REF_SOLVES_PER_S, 3),
        "best": round(best_solves_per_s, 3),
        "pipelined_rep_s": [round(t, 6) for t in pipe],
        "blocking_rep_s": [round(t, 6) for t in times],
        "spread": round(float(spread), 4),
        "retried": retried,
    }
    if note:
        rec["note"] = note
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
