"""Multi-host helpers on the single-process 8-device CPU rig."""

import numpy as np
import jax
import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.parallel import multihost as mh
from or_cdchomp_jax.parallel.batch import (
    BatchSolver, problem_batch_from_grid)


def test_pod_mesh_shapes():
    m1 = mh.pod_mesh()
    assert m1.devices.size == len(jax.devices())
    assert m1.axis_names == ("dp",)
    m2 = mh.pod_mesh(hosts_axis="hosts")
    assert m2.axis_names == ("hosts", "dp")
    assert m2.devices.shape == (1, len(jax.devices()))


def test_host_local_batch_partition():
    # single process: full range
    start, size = mh.host_local_batch(37)
    assert (start, size) == (0, 37)


def test_global_problems_solve():
    """make_global_problems + a sharded solve end to end on the mesh."""
    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    goal = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0, n_points=10)
    run = mod.runs[h]
    engine = run.engine

    batch = 16
    rng = np.random.default_rng(0)
    starts = np.tile(r.q_active, (batch, 1)) + 0.01 * rng.normal(size=(batch, 7))
    goals = np.tile(goal, (batch, 1)) + 0.01 * rng.normal(size=(batch, 7))
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)

    mesh = mh.pod_mesh()
    gprobs = mh.make_global_problems(probs, mesh)
    solver = BatchSolver(engine, mesh=mesh)
    out, costs = solver.iterate(gprobs, 3)
    finals = engine.final_costs_batch(out)
    best, idx = mh.all_hosts_best(out, jnp.stack(finals, axis=-1))
    assert np.isfinite(float(finals[0][int(idx)]))
    assert best.traj.shape == (10, 7)
