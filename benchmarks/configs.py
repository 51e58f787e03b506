"""Shared world/problem builders for the five measured benchmark
configurations of BASELINE.md:

  1. WAM7 single-SDF parity run (the test_wam7.py scenario)
  2. cluttered multi-SDF + self-collision
  3. HMC batch-of-256 best-of selection
  4. floating base + everyn_tsr
  5. 10k-problem pod sweep (sharded over every visible device)

Each builder returns (module, run, goal) for a CHOMPModule problem that
`run.py` turns into a throughput/quality measurement.
"""

from __future__ import annotations

import numpy as np

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.tsr import TSR

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
# goal used by every config: both endpoints verified clear of each
# scene and of self-collision (tests/test_bench_configs.py pins
# clearance ≥ 1 cm per config) and the solves end collision-free — the
# round-3 workload's fixed endpoints penetrated the table by 2.5 cm,
# and the round-4 configs 2/4 kept a start 2.5-4.9 cm inside the table
# and a goal 16 cm into self-collision, making every benchmarked
# "solve" end in unavoidable collision
GOAL1 = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])


def _wam(mod):
    # base y = −1.2: at the round-4 y = −1.0 the base-link sphere
    # (r = 0.15) overlapped the table edge by 2.5 cm at EVERY
    # configuration (endpoint feasibility is scene geometry, not a
    # trajectory property)
    robot = Robot("wam", oc.wam7(),
                  pose=np.array([0.0, -1.2, 1.0, 0.0, 0.70711, 0.0, 0.70711]),
                  q_active=START.copy())
    mod.add_robot(robot)
    return robot


def wam7_single_sdf(dtype, n_points=101):
    """Config 1 — table+mug scene, one SDF (test_wam7.py:23-33 analog).

    Endpoints are feasible by construction (see GOAL1) so the solved
    trajectories pass gettraj's strict collision re-check."""
    mod = oc.CHOMPModule(dtype=dtype)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(KinBody("mug", oc.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = Robot("wam", oc.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    h = mod.create(robot="wam", adofgoal=GOAL1, lambda_=100.0,
                   obs_factor=500.0, n_points=n_points)
    return mod, mod.runs[h], GOAL1


def cluttered_multi_sdf(dtype, n_points=101):
    """Config 2 — three separate SDFs (table, shelf, mug cluster) so
    every sphere runs the multi-field min-select, plus default
    self-collision terms."""
    mod = oc.CHOMPModule(dtype=dtype)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.0, 0.0, 0.7, 0, 0, 0, 1), (0.35, 0.75, 0.02))])))
    mod.add_kinbody(KinBody("shelf", oc.Scene.build(
        boxes=[((0.45, 0.5, 1.0, 0, 0, 0, 1), (0.05, 0.3, 0.3)),
               ((0.45, 0.5, 1.3, 0, 0, 0, 1), (0.3, 0.3, 0.02))])))
    mod.add_kinbody(KinBody("mugs", oc.Scene.build(
        cylinders=[((0.1, 0.2, 0.76, 0, 0, 0, 1), 0.04, 0.06),
                   ((-0.1, -0.3, 0.76, 0, 0, 0, 1), 0.05, 0.08)])))
    robot = _wam(mod)
    robot.enabled = False
    for name in ("table", "shelf", "mugs"):
        mod.computedistancefield(kinbody=name, cube_extent=0.05)
    robot.enabled = True
    h = mod.create(robot="wam", adofgoal=GOAL1, lambda_=100.0,
                   obs_factor=500.0, obs_factor_self=10.0,
                   epsilon_self=0.04, n_points=n_points)
    return mod, mod.runs[h], GOAL1


def hmc_best_of(dtype, n_points=101):
    """Config 3 — HMC momentum resampling; the batch is the restart
    pool and the measurement selects best-of-batch."""
    mod, run, goal = wam7_single_sdf(dtype, n_points)
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=n_points,
                   use_hmc=True, hmc_resample_lambda=0.02, seed=7)
    return mod, mod.runs[h], goal


def floating_everyn_tsr(dtype, n_points=51):
    """Config 4 — SE(3) floating base (n=14) with an upright everyn
    TSR on the end effector at every moving point.

    Scene = the verified-feasible config-1 table+mug (the round-4
    stand-alone table at (0.5, 0, 0.6) intersected the arm's elbow
    sphere at the fixed endpoints regardless of base placement); the
    base translates by (0.15, 0.1, 0) over the solve."""
    mod = oc.CHOMPModule(dtype=dtype)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(KinBody("mug", oc.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = Robot("wam", oc.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.08)
    robot.enabled = True
    tsr = TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))
    basegoal = np.array([0.15, 0.1, 0.0, 0.0, 0.0, 0.0, 1.0])
    # λ=200/obs=200: the TSR projection and obstacle gradient interact
    # through A⁻¹ on 14 dims — smaller steps keep the whole perturbed
    # batch convergent (CHOMP has no step-size control, same as the
    # reference; λ=100/obs=500 diverges for a tail of problems)
    h = mod.create(robot="wam", adofgoal=GOAL1, basegoal=basegoal,
                   floating_base=True, lambda_=200.0, obs_factor=200.0,
                   n_points=n_points, everyn_tsr=tsr)
    return mod, mod.runs[h], np.concatenate([basegoal, GOAL1])
