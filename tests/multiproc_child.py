"""Child process for the true multi-process distributed test
(tests/test_multiproc.py).  Each process owns 2 CPU devices, joins a
jax.distributed coordinator, contributes its local rows of a global
problem batch via make_global_problems, and runs the sharded
BatchSolver.  Prints one JSON result line.

Run:  python multiproc_child.py <rank> <nprocs> <port>
"""

import json
import sys

import numpy as np


def build_world(jnp):
    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot

    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.12)
    r.enabled = True
    goal = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=8)
    return mod, mod.runs[h], goal


def global_batch(run, engine, goal, n):
    from or_cdchomp_jax.parallel.batch import problem_batch_from_grid

    rng = np.random.default_rng(0)
    start = np.asarray(run.problem.traj, dtype=np.float64)[0]
    starts = np.tile(start, (n, 1)) + 0.01 * rng.normal(size=(n, 7))
    goals = np.tile(goal, (n, 1)) + 0.01 * rng.normal(size=(n, 7))
    return problem_batch_from_grid(run.problem, starts, goals, engine)


GLOBAL_BATCH = 8
N_ITER = 4


def main():
    rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_enable_x64", True)

    from or_cdchomp_jax.parallel import multihost as mh
    mh.initialize(coordinator_address=f"127.0.0.1:{port}",
                  num_processes=nprocs, process_id=rank)

    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 2 * nprocs

    import jax.numpy as jnp
    from or_cdchomp_jax.parallel.batch import BatchSolver

    mod, run, goal = build_world(jnp)
    engine = run.engine

    probs_all = global_batch(run, engine, goal, GLOBAL_BATCH)
    start, size = mh.host_local_batch(GLOBAL_BATCH)
    probs_local = jax.tree.map(
        lambda x: np.asarray(x)[start:start + size], probs_all)

    mesh = mh.pod_mesh()
    probs = mh.make_global_problems(probs_local, mesh)
    solver = BatchSolver(engine, mesh=mesh, chunk=None)
    probs, costs = solver.iterate(probs, N_ITER)
    finals = engine.final_costs_batch(probs)
    best, idx = mh.all_hosts_best(probs, jnp.stack(finals, axis=-1))

    total_mean = float(jax.jit(jnp.mean)(finals[0]))

    # --- same solve on the 2-d (hosts, local) mesh: the batch sharded
    # over BOTH axes host-major (VERDICT r3 #8 — pod_mesh(hosts_axis=…)
    # executing at process_count > 1) ---
    mesh2 = mh.pod_mesh(hosts_axis="hosts")
    assert mesh2.devices.shape == (nprocs, 2), mesh2.devices.shape
    probs2 = mh.make_global_problems(probs_local, mesh2, ("hosts", "dp"))
    solver2 = BatchSolver(engine, mesh=mesh2, axis=("hosts", "dp"),
                          chunk=None)
    probs2, _ = solver2.iterate(probs2, N_ITER)
    finals2 = engine.final_costs_batch(probs2)
    best2, idx2 = mh.all_hosts_best(probs2, jnp.stack(finals2, axis=-1))

    result = {
        "rank": rank,
        "process_count": jax.process_count(),
        "local_rows": [int(start), int(size)],
        "best_idx": int(idx),
        "best_cost": float(jax.jit(jnp.min)(finals[0])),
        "finals_mean": total_mean,
        "hosts_mesh_shape": list(mesh2.devices.shape),
        "hosts_best_idx": int(idx2),
        "hosts_best_cost": float(jax.jit(jnp.min)(finals2[0])),
        "hosts_finals_mean": float(jax.jit(jnp.mean)(finals2[0])),
    }
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
