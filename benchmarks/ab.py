"""In-process A/B harness for the SoA step's backend knobs.

One process, one world build; each arm monkeypatches the module knobs
and compiles a FRESH jitted callable (the engine-method jit caches key
on the engine instance, so arms must not reuse them).

  python benchmarks/ab.py [--arms base,selfcol_pairs,abl_lookup,...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", default="base,selfcol_pairs,selfcol_sym")
    ap.add_argument("--config", type=int, default=1,
                    help="benchmark config to A/B on (1, 2, or 4)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks import configs as C
    from or_cdchomp_jax.chomp import constraints as cons_mod
    from or_cdchomp_jax.chomp import cost_soa
    from or_cdchomp_jax.chomp import solver as solver_mod
    from or_cdchomp_jax.parallel.batch import problem_batch_from_grid

    builder = {1: C.wam7_single_sdf, 2: C.cluttered_multi_sdf,
               4: C.floating_everyn_tsr}[args.config]
    mod, run, goal = builder(jnp.float32)
    eng = run.engine
    spec = eng.spec
    rng = np.random.default_rng(0)
    start = np.asarray(run.problem.traj)[0]
    goal_r = np.asarray(run.problem.traj)[-1]
    starts = np.tile(start, (args.batch, 1)) + 0.02 * rng.normal(
        size=(args.batch, spec.n))
    goals = np.tile(goal_r, (args.batch, 1)) + 0.02 * rng.normal(
        size=(args.batch, spec.n))
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    probs = jax.device_put(probs)

    ARMS = {
        "base": {},
        "iter_u2": {"iter_unroll": 2},
        "iter_u4": {"iter_unroll": 4},
        "selfcol_pairs": {"selfcol": "pairs"},
        "selfcol_sym": {"selfcol": "sym"},
        "selfcol_symv": {"selfcol": "symv"},
        "selfcol_xla2": {"selfcol": "xla2"},
        "abl_selfcol": {"ablate": {"selfcol"}},
        "abl_obstacle": {"ablate": {"obstacle"}},
        "abl_lookup": {"ablate": {"lookup"}},
        "abl_jtmap": {"ablate": {"jtmap"}},
        "abl_limits": {"ablate": {"limits"}},
        "abl_constraint": {"ablate": {"constraint"}},
        "abl_con_eval": {"ablate": {"constraint_eval"}},
        "abl_con_proj": {"ablate": {"constraint_proj"}},
        "abl_con_math": {"ablate": {"constraint_math"}},
        "tsr_aos": {"tsr_eval": "aos"},
        "sss_u4": {"sss_unroll": 4},
        "sss_u7": {"sss_unroll": 7},
        "sss_u49": {"sss_unroll": 49},
    }

    base = dict(selfcol=cost_soa._SELFCOL, ablate=cost_soa._ABLATE)
    base["sss_unroll"] = cons_mod._SSS_UNROLL
    base["tsr_eval"] = solver_mod._TSR_EVAL
    base["iter_unroll"] = solver_mod._ITER_UNROLL
    try:
        for arm in args.arms.split(","):
            cfg = ARMS[arm]
            cost_soa._SELFCOL = cfg.get("selfcol", base["selfcol"])
            cost_soa._ABLATE = cfg.get("ablate", base["ablate"])
            cons_mod._SSS_UNROLL = cfg.get("sss_unroll",
                                           base["sss_unroll"])
            solver_mod._TSR_EVAL = cfg.get("tsr_eval", base["tsr_eval"])
            solver_mod._ITER_UNROLL = cfg.get("iter_unroll",
                                              base["iter_unroll"])
            fn = jax.jit(lambda p: eng.iterate_batched_nojit(p, args.n_iter))
            try:
                out, _ = fn(probs)
                jax.block_until_ready(out)
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    out, costs = fn(probs)
                jax.block_until_ready(out)
                dt = (time.perf_counter() - t0) / args.reps
                print(json.dumps({
                    "arm": arm,
                    "solves_per_s": round(args.batch / dt, 2),
                    "step_us": round(dt / args.n_iter * 1e6, 1),
                    "final_cost_mean": round(
                        float(jnp.mean(costs[:, -1, 0])), 4),
                }), flush=True)
            except Exception as exc:  # report and continue the sweep
                print(json.dumps({"arm": arm, "error": repr(exc)[:300]}),
                      flush=True)
    finally:
        # restore every patched knob so programmatic callers see a
        # consistent module state even if the sweep raises
        cost_soa._SELFCOL = base["selfcol"]
        cost_soa._ABLATE = base["ablate"]
        cons_mod._SSS_UNROLL = base["sss_unroll"]
        solver_mod._TSR_EVAL = base["tsr_eval"]
        solver_mod._ITER_UNROLL = base["iter_unroll"]


if __name__ == "__main__":
    main()
