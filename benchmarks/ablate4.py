"""Ablation timing for config 4 (floating base + everyn TSR).

Times the batched 100-iteration solve with pieces of the step disabled
to attribute the ~10 ms step:
  full          — the real step
  no_constraint — engine built without the TSR set (skips eval+project)
  no_solve      — projection with the (K,K) linalg.solve replaced by h
  no_eval       — constraint eval replaced by zeros (keeps projection)

Run: timeout 1500 python -m benchmarks.ablate4
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np


def measure(engine, run, batch=256, n_iter=100, reps=2):
    from or_cdchomp_jax.parallel.batch import (
        BatchSolver, problem_batch_from_grid)

    spec = engine.spec
    rng = np.random.default_rng(0)
    n = spec.n
    start = np.asarray(run.problem.traj)[0]
    goal = np.asarray(run.problem.traj)[-1]
    starts = np.tile(start, (batch, 1)) + 0.02 * rng.normal(size=(batch, n))
    goals = np.tile(goal, (batch, 1)) + 0.02 * rng.normal(size=(batch, n))
    starts[:, 3:7] = start[3:7]
    goals[:, 3:7] = goal[3:7]
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)
    solver = BatchSolver(engine)
    probs_dev = solver.shard(probs)
    out, _ = solver.iterate(probs_dev, n_iter)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out, _ = solver.iterate(probs_dev, n_iter)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return batch / dt, dt / n_iter


def main():
    from benchmarks import configs as C
    from or_cdchomp_jax.chomp import constraints as cons_mod
    from or_cdchomp_jax.chomp.constraints import TSRConstraintSet
    from or_cdchomp_jax.chomp.solver import ChompEngine

    dtype = jnp.float32
    mod, run, goal = C.floating_everyn_tsr(dtype)
    eng = run.engine

    def fresh(cons, proj=None, ev=None):
        e = ChompEngine(eng.spec, eng.fk.model, eng.fields,
                        cons=cons, dtype=dtype, metric_mode=eng.metric_mode)
        if proj is not None:
            e._ablate_proj = proj
        return e

    variants = {}
    variants["full"], step_full = measure(eng, run)

    e2 = fresh(TSRConstraintSet.build(()))
    variants["no_constraint"], _ = measure(e2, run)

    # no_solve: patch module fn; engines key jit on instance, so a fresh
    # engine per arm re-traces with the patch in effect
    orig_proj = cons_mod.project_constraints
    orig_solve = jnp.linalg.solve
    try:
        jnp.linalg.solve = lambda A, b: b
        e3 = fresh(eng.cons)
        variants["no_kk_solve"], _ = measure(e3, run)
    finally:
        jnp.linalg.solve = orig_solve

    try:
        def no_eval(spec, fk, prob, T_full, cons, kin):
            C_ = cons.n_constraints
            n = spec.n
            return (jnp.zeros((C_, 6), dtype), jnp.zeros((C_, 6, n), dtype))
        import or_cdchomp_jax.chomp.solver as sol_mod
        orig_eval = sol_mod.eval_tsr_all
        sol_mod.eval_tsr_all = no_eval
        e4 = fresh(eng.cons)
        variants["no_tsr_eval"], _ = measure(e4, run)
    finally:
        sol_mod.eval_tsr_all = orig_eval

    try:
        import or_cdchomp_jax.chomp.solver as sol_mod
        orig_p = sol_mod.project_constraints
        sol_mod.project_constraints = \
            lambda spec, cons, e, lam, AG, T, val, jac: jnp.zeros_like(T)
        e5 = fresh(eng.cons)
        variants["no_projection"], _ = measure(e5, run)
    finally:
        sol_mod.project_constraints = orig_p

    print(f"step_full = {step_full*1e3:.3f} ms")
    for k, v in variants.items():
        print(f"{k:16s} {v:8.1f} solves/s")


if __name__ == "__main__":
    main()
