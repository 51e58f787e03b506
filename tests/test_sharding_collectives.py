"""Sharded-solve communication contract.

Independent problems sharded over a dp mesh must exchange (almost)
nothing per iteration: the ONLY permitted per-step collective is the
joint-limit repair loop's global `reduce_or` condition (the
reference's "repeat while any violation" semantics, chomp.c:608-655,
made SPMD — a 1-byte pred all-reduce).

A flat query reshape that merges the sharded minor batch axis makes
the lookup all-gather its index tensors and run REPLICATED on every
device.  This test compiles the real sharded solve and fails if any
data-bearing collective ever appears.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.parallel.batch import (
    BatchSolver, problem_batch_from_grid)

COLLECTIVE = re.compile(
    r"= (\([^)]*\)|\S+) (all-reduce|all-gather|reduce-scatter|"
    r"collective-permute|all-to-all)\(")


def _payload_bytes(shape_str):
    n = 0
    for st in re.finditer(r"\b(f32|bf16|f64|s32|u32|pred|s8|u8)"
                          r"\[([0-9,]*)\]", shape_str):
        bpe = {"f32": 4, "bf16": 2, "f64": 8, "s32": 4, "u32": 4,
               "pred": 1, "s8": 1, "u8": 1}[st.group(1)]
        k = 1
        if st.group(2):
            for d in st.group(2).split(","):
                k *= int(d)
        n += k * bpe
    return n


def test_sharded_iterate_has_no_data_collectives():
    mod = oc.CHOMPModule(dtype=jnp.float32)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    h = mod.create(robot="wam",
                   adofgoal=[0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0],
                   lambda_=100.0, obs_factor=500.0, n_points=12)
    run = mod.runs[h]
    eng = run.engine
    rng = np.random.default_rng(0)
    B = 16
    start = np.asarray(run.problem.traj)[0]
    goal = np.asarray(run.problem.traj)[-1]
    starts = np.tile(start, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    goals = np.tile(goal, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)

    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("hosts", "dp"))
    solver = BatchSolver(eng, mesh=mesh, axis=("hosts", "dp"))
    probs = solver.shard(probs)
    hlo = jax.jit(lambda p: eng.iterate_batched_nojit(p, 4)).lower(
        probs).compile().as_text()

    colls = [(m.group(2), _payload_bytes(m.group(1)))
             for m in COLLECTIVE.finditer(hlo)]
    data_bearing = [(k, b) for k, b in colls if b > 16]
    assert not data_bearing, (
        "per-iteration data collectives crept back into the sharded "
        f"solve: {data_bearing} (flat query reshapes replicate the "
        "lookup — keep queries (m·S, B))")
    # scalar latency-bound conditions (limit-repair reduce_or) are fine
    assert len(colls) <= 2, colls

    # and the dominant matrix work must actually be sharded: no dot may
    # see the full 16-problem query count (16/8 = 2 per device)
    full_q = 10 * 15 * B     # m * S * B
    for m_ in re.finditer(r"= \S*?f32\[(\d+),(\d+)\][^ ]* (dot|"
                          r"convolution)\(", hlo):
        dims = (int(m_.group(1)), int(m_.group(2)))
        assert full_q not in dims, (
            f"replicated lookup dot {dims} — batch sharding lost")
