"""Fleet workflow demo: solve a batch, validate the whole batch on
device, keep the best feasible trajectory.

The reference plans and validates one run at a time
(orcdchomp_mod.cpp:2854-3011); this is the batched production loop:

  1. solve B perturbed problems in one jitted batched scan
  2. retime + strictly collision-re-check ALL of them in one
     `gettraj_batch` call (FK + sphere tests on device)
  3. filter to feasible, pick the lowest-cost survivor

Run:  python examples/batch_validate_demo.py [--batch 256] [--n-iter 100]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n-iter", type=int, default=100)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot
    from or_cdchomp_jax.parallel.batch import (
        BatchSolver, problem_batch_from_grid)

    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(KinBody("mug", oc.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    start = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    robot = Robot("wam", oc.wam7(), q_active=start.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04,
                             cache_filename="/tmp/demo_sdf_table.npy")
    robot.enabled = True
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    run = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                     obs_factor=500.0, n_points=101)
    rn = mod.runs[run]

    B = args.batch
    rng = np.random.default_rng(0)
    starts = np.tile(start, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    goals = np.tile(goal, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    probs = problem_batch_from_grid(rn.problem, starts, goals, rn.engine)

    solver = BatchSolver(rn.engine)
    probs = solver.shard(probs)
    t0 = time.time()
    probs, costs = solver.iterate(probs, args.n_iter)
    jax.block_until_ready(probs)
    t_solve = time.time() - t0
    final = np.asarray(costs[-1, :, 0])       # costs: (n_iter, B, 3)

    t0 = time.time()
    trajs, in_col = mod.gettraj_batch(run=run, probs=probs)
    t_check = time.time() - t0

    ok = ~in_col
    print(f"solved {B} problems in {t_solve:.2f}s, validated in "
          f"{t_check:.2f}s (both include one-time jit compile)")
    print(f"feasible: {int(ok.sum())}/{B}")
    if ok.any():
        b = int(np.flatnonzero(ok)[np.argmin(final[ok])])
        best = trajs[b]
        print(f"best feasible: problem {b}, final cost {final[b]:.3f}, "
              f"duration {best.duration:.2f}s, "
              f"{len(best.times)} waypoints")
    mod.destroy(run=run)


if __name__ == "__main__":
    main()
