"""Single-problem (B=1) latency: the interactive-planner number.

Measures a jitted 100-iteration solve of ONE flagship problem through
the available paths and prints one JSON line per path:

  python benchmarks/latency.py [--n-iter 100]

Paths:
  aos     — per-problem engine.iterate (the api path)
  soa1    — batch-native SoA step at B=1 (B is the minor axis)
  chunk   — api-style masked ITER_CHUNK driver (what mod.iterate uses)
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
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from benchmarks import configs as C

    mod, run, goal = C.wam7_single_sdf(jnp.float32)
    eng = run.engine
    prob = run.problem
    n_iter = args.n_iter

    def timed(fn, *a):
        out = fn(*a)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.reps

    # per-problem AoS scan
    dt = timed(lambda: eng.iterate(prob, n_iter))
    print(json.dumps({"path": "aos", "n_iter": n_iter,
                      "ms": round(dt * 1e3, 3)}), flush=True)

    # SoA batch-native at B=1
    probs1 = jax.tree.map(lambda x: jnp.asarray(x)[None], prob)
    fn_soa = jax.jit(lambda p: eng.iterate_batched_nojit(p, n_iter))
    dt = timed(lambda: fn_soa(probs1))
    print(json.dumps({"path": "soa1", "n_iter": n_iter,
                      "ms": round(dt * 1e3, 3)}), flush=True)

    # api masked-chunk driver (16-step chunks, host loop between)
    def chunked():
        p = prob
        done = 0
        while done < n_iter:
            todo = min(eng.ITER_CHUNK, n_iter - done)
            p, _ = eng.iterate_masked(p, todo, eng.ITER_CHUNK)
            done += todo
        return p
    dt = timed(chunked)
    print(json.dumps({"path": "chunk", "n_iter": n_iter,
                      "ms": round(dt * 1e3, 3)}), flush=True)


if __name__ == "__main__":
    main()
