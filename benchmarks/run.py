"""Benchmark harness for the five measured configs (BASELINE.md).

Prints one JSON line per config:
  {"config": ..., "solves_per_s": ..., "batch": ..., "n_iter": ...,
   "final_cost_mean": ..., "wall_s": ...}

Usage:  python benchmarks/run.py [--configs 1,2,3,4,5] [--batch 256]
        [--n-iter 100] [--f64]

Config 5 runs 10,240 problems sharded over every visible device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _measure(engine, run, goal, batch, n_iter, *, best_of=False,
             label="", mesh=None, reps=4):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from or_cdchomp_jax.parallel.batch import (
        BatchSolver, best_of_batch, problem_batch_from_grid)
    from benchmarks.configs import START

    spec = engine.spec
    rng = np.random.default_rng(0)
    n = spec.n
    start = np.asarray(run.problem.traj)[0]
    goal = np.asarray(run.problem.traj)[-1]
    starts = np.tile(start, (batch, 1)) + 0.02 * rng.normal(size=(batch, n))
    goals = np.tile(goal, (batch, 1)) + 0.02 * rng.normal(size=(batch, n))
    if spec.floating_base:
        # keep quaternions valid: perturb only positions + arm dofs
        starts[:, 3:7] = start[3:7]
        goals[:, 3:7] = goal[3:7]
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)

    solver = BatchSolver(engine, mesh=mesh)
    probs_dev = solver.shard(probs)
    out, costs = solver.iterate(probs_dev, n_iter)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for _ in range(reps):
        out, costs = solver.iterate(probs_dev, n_iter)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps

    finals = engine.final_costs_batch(out)
    total = np.asarray(finals[0])
    rec = {
        "config": label,
        "solves_per_s": round(batch / dt, 2),
        "batch": batch,
        "n_iter": n_iter,
        "final_cost_mean": round(float(total.mean()), 4),
        "wall_s": round(dt, 4),
    }
    if best_of:
        best, idx = best_of_batch(out, jnp.stack(finals, axis=-1))
        rec["best_cost"] = round(float(total[int(idx)]), 4)
        rec["best_idx"] = int(idx)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from benchmarks import configs as C

    dtype = jnp.float64 if args.f64 else jnp.float32
    want = {int(s) for s in args.configs.split(",")}

    if 1 in want:
        mod, run, goal = C.wam7_single_sdf(dtype)
        _measure(run.engine, run, goal, args.batch, args.n_iter,
                 label="1:wam7_single_sdf")
    if 2 in want:
        mod, run, goal = C.cluttered_multi_sdf(dtype)
        _measure(run.engine, run, goal, args.batch, args.n_iter,
                 label="2:cluttered_multi_sdf")
    if 3 in want:
        mod, run, goal = C.hmc_best_of(dtype)
        _measure(run.engine, run, goal, args.batch, args.n_iter,
                 best_of=True, label="3:hmc_best_of")
    if 4 in want:
        mod, run, goal = C.floating_everyn_tsr(dtype)
        _measure(run.engine, run, goal, args.batch, args.n_iter,
                 label="4:floating_everyn_tsr")
    if 5 in want:
        mod, run, goal = C.wam7_single_sdf(dtype)
        _measure(run.engine, run, goal, 10240, args.n_iter,
                 label="5:batch_10k")


if __name__ == "__main__":
    main()
