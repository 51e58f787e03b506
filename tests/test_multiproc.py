"""True multi-process distributed bring-up (VERDICT round-2 #4).

Spawns 2 OS processes, each with 2 CPU devices, joined through
jax.distributed.initialize with a local coordinator.  Each process
contributes its host_local_batch rows of a global 8-problem batch via
make_global_problems (the jax.make_array_from_process_local_data path),
runs the sharded BatchSolver, and reduces best-of across hosts.  The
result must equal the single-process answer bit-for-bit (float64).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_children(nprocs=2, timeout=600):
    port = _free_port()
    child = os.path.join(os.path.dirname(__file__), "multiproc_child.py")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, child, str(rank), str(nprocs), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = {}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"child {rank} failed rc={p.returncode}:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"child {rank} produced no RESULT line:\n{out[-2000:]}"
        results[rank] = json.loads(line[-1][len("RESULT "):])
    return results


def test_two_process_distributed_matches_single_process():
    results = _run_children(nprocs=2)
    r0, r1 = results[0], results[1]

    # both processes saw the 2-process global world and split the batch
    assert r0["process_count"] == 2 and r1["process_count"] == 2
    assert r0["local_rows"] == [0, 4] and r1["local_rows"] == [4, 4]

    # replicated reductions agree across hosts
    assert r0["best_idx"] == r1["best_idx"]
    np.testing.assert_allclose(r0["best_cost"], r1["best_cost"], rtol=0)
    np.testing.assert_allclose(r0["finals_mean"], r1["finals_mean"], rtol=0)

    # the 2-d (hosts, local) mesh ran at process_count=2 and produced
    # the flat-mesh answer bit-for-bit (VERDICT r3 #8)
    for r in (r0, r1):
        assert r["hosts_mesh_shape"] == [2, 2]
        assert r["hosts_best_idx"] == r["best_idx"]
        np.testing.assert_allclose(r["hosts_best_cost"], r["best_cost"],
                                   rtol=0)
        np.testing.assert_allclose(r["hosts_finals_mean"],
                                   r["finals_mean"], rtol=0)

    # single-process reference: same world, same batch, no distribution
    import jax
    import jax.numpy as jnp
    from or_cdchomp_jax.parallel.batch import BatchSolver, best_of_batch
    from tests import multiproc_child as mc

    mod, run, goal = mc.build_world(jnp)
    engine = run.engine
    probs = mc.global_batch(run, engine, goal, mc.GLOBAL_BATCH)
    solver = BatchSolver(engine, chunk=None)
    probs = solver.shard(probs)
    probs, _ = solver.iterate(probs, mc.N_ITER)
    finals = engine.final_costs_batch(probs)
    best, idx = best_of_batch(probs, jnp.stack(finals, axis=-1))

    assert int(idx) == r0["best_idx"]
    np.testing.assert_allclose(float(jnp.min(finals[0])), r0["best_cost"],
                               rtol=1e-12)
    np.testing.assert_allclose(float(jnp.mean(finals[0])), r0["finals_mean"],
                               rtol=1e-12)
