"""Batched + sharded CHOMP solves.

The reference iterates one heap-allocated problem at a time on one CPU
thread (orcdchomp_mod.cpp:2752).  The batched replacement treats a
problem as a pytree row and solves thousands at once:

 - ``stack_problems`` / ``make_problem_batch``: build a ChompProblem
   whose every leaf has a leading problem axis.
 - ``BatchSolver``: vmap(engine.step) under one jit, with the problem
   axis sharded over a ``Mesh`` 'dp' axis via NamedSharding — XLA
   inserts the collectives; per-iteration cost telemetry is reduced
   with jnp means (a psum over 'dp' once sharded).
 - convergence-aware driver: run in chunks, stop when every problem's
   total-cost improvement drops below tol (a psum-reduced all-batch
   test — the "collective convergence reduction" of BASELINE.json).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from or_cdchomp_jax.chomp.problem import ChompProblem
from or_cdchomp_jax.chomp.solver import ChompEngine


def stack_problems(problems) -> ChompProblem:
    """Stack a list of per-problem pytrees into one batched pytree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *problems)


def pad_problems(probs: ChompProblem, multiple: int):
    """Pad the problem axis to a multiple (repeating the last row) so a
    ragged batch shards evenly; returns (padded, original_P).  Slice
    results back with ``jax.tree.map(lambda x: x[:original_P], out)``."""
    P_ = int(jax.tree.leaves(probs)[0].shape[0])
    pad = (-P_) % multiple
    if pad == 0:
        return probs, P_
    padded = jax.tree.map(
        lambda x: jnp.concatenate(
            [x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])]), probs)
    return padded, P_


def problem_batch_from_grid(problem: ChompProblem, starts, goals,
                            engine: ChompEngine, metric_ops=None, seeds=None):
    """Vectorized batch construction: broadcast a template problem to a
    (P,) batch with per-problem straight-line trajectories, metric
    affine terms, and RNG keys.

    starts/goals: (P, n) arrays.  The template supplies everything else
    (fields, limits, weights).  ``metric_ops`` is optional — the
    engine's metric backend builds the affine terms.
    """
    starts = np.asarray(starts, dtype=np.float64)
    goals = np.asarray(goals, dtype=np.float64)
    P_, n = starts.shape
    npts = engine.spec.n_points
    a = np.linspace(0.0, 1.0, npts)[None, :, None]
    trajs = (1 - a) * starts[:, None, :] + a * goals[:, None, :]

    # vectorized affine terms: two outer products + three dot products
    # (metric.affine_generators) instead of P per-problem K/E stacks —
    # the round-3 host loop cost multiple seconds at P = 10,240
    B, trC, Ev = engine.build_affine_batch(trajs[:, 0], trajs[:, -1], n)

    if seeds is None:
        seeds = np.arange(P_)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))

    dtype = engine.dtype

    def bcast(x):
        return jnp.broadcast_to(x, (P_,) + x.shape)

    batched = jax.tree.map(bcast, problem)
    batched = batched._replace(
        traj=jnp.asarray(trajs, dtype=dtype),
        B=jnp.asarray(B, dtype=dtype),
        trC=jnp.asarray(trC, dtype=dtype),
        Evels=jnp.asarray(Ev, dtype=dtype),
        AG=jnp.zeros((P_, engine.spec.m, n), dtype=dtype),
        hmc=problem.hmc._replace(
            key=keys,
            resample_iter=jnp.zeros(P_, jnp.int32),
            leapfrog_first=jnp.ones(P_, bool)),
        iteration=jnp.zeros(P_, jnp.int32),
    )
    return batched


class BatchSolver:
    """Sharded batched solve driver for one ChompEngine.

    ``chunk``: batches that are a multiple of ``chunk`` and at least
    ``min_chunks`` chunks long run as a lax.map over chunk-sized
    problem groups on single-device meshes, on the premise that very
    large flat batches schedule worse inside the scan; smaller batches
    run flat.  Set chunk=None to disable.  The defaults (128, 3) are
    not yet measured on the H100 (ROADMAP 1.5).
    """

    def __init__(self, engine: ChompEngine, mesh: Optional[Mesh] = None,
                 axis: str = "dp", chunk: Optional[int] = 128,
                 min_chunks: int = 3):
        self.engine = engine
        if mesh is None:
            devs = np.asarray(jax.devices())
            mesh = Mesh(devs.reshape(-1), ("dp",))
            axis = "dp"
        self.mesh = mesh
        self.axis = axis
        self.chunk = chunk
        self.min_chunks = min_chunks
        self._sharding = NamedSharding(mesh, P(axis))
        self._replicated = NamedSharding(mesh, P())

    def shard(self, probs: ChompProblem) -> ChompProblem:
        """Place the batch with the problem axis sharded over the mesh.

        NamedSharding needs the batch size divisible by the mesh axis;
        for ragged batches fall back to the largest divisor sub-mesh
        (replicated if coprime) so small/odd batches still run — full
        utilization needs P % mesh_size == 0 (see pad_problems).
        """
        P_ = int(jax.tree.leaves(probs)[0].shape[0])
        size = int(np.prod(self.mesh.devices.shape))
        if P_ % size == 0:
            return jax.device_put(probs, self._sharding)
        d = int(np.gcd(P_, size))
        if d <= 1:
            return jax.device_put(probs, self._replicated)
        sub = Mesh(self.mesh.devices.reshape(-1)[:d], (self.axis,))
        return jax.device_put(probs, NamedSharding(sub, P(self.axis)))

    def _jitted(self, name, impl, static_argnums=()):
        # per-solver jit wrappers (as in ChompEngine._jitted): a
        # class-level @jit(static_argnums=(0,)) would pin every solver
        # + engine + FieldStack in the global jit cache forever,
        # defeating api._evict_engines
        d = self.__dict__.setdefault("_jits", {})
        w = d.get(name)
        if w is None:
            w = jax.jit(impl, static_argnums=static_argnums)
            d[name] = w
        return w

    def iterate(self, probs: ChompProblem, n_iter: int):
        return self._jitted("iterate", self._iterate_impl, (1,))(
            probs, n_iter)

    def _iterate_impl(self, probs: ChompProblem, n_iter: int):
        """(P,)-batched scan of n_iter steps.  Returns
        (problems, costs (n_iter, P, 3))."""
        if self.engine.batch_native_ok:
            def run(p):
                return self.engine.iterate_batched_nojit(p, n_iter)
        else:
            def run(p):
                return jax.vmap(
                    lambda q: self.engine.iterate_nojit(q, n_iter))(p)

        P_ = int(jax.tree.leaves(probs)[0].shape[0])
        ch = self.chunk
        if (ch and P_ >= self.min_chunks * ch and P_ % ch == 0
                and int(np.prod(self.mesh.devices.shape)) == 1):
            folded = jax.tree.map(
                lambda x: x.reshape((P_ // ch, ch) + x.shape[1:]), probs)
            probs, costs = jax.lax.map(run, folded)
            probs = jax.tree.map(
                lambda x: x.reshape((P_,) + x.shape[2:]), probs)
            costs = costs.reshape((P_, n_iter, 3))
        else:
            probs, costs = run(probs)
        return probs, jnp.moveaxis(costs, 1, 0)

    # -- masked drivers: one executable across varying budgets/tols -----
    #
    # The static-n_iter iterate() above recompiles per (n_iter) value;
    # a sweep that varies per-call budgets or tolerances pays a fresh
    # XLA compile each time (round-3 weak #6).  These mirror
    # ChompEngine.iterate_masked at the batch level: the step count
    # inside the scan is a *traced* valid count over a fixed chunk, and
    # the convergence tolerance is traced too — one compile per
    # (engine, chunk_size) serves every budget and tolerance.

    def _masked_scan(self, probs: ChompProblem, valid, chunk_size: int):
        valid = jnp.asarray(valid, jnp.int32)
        if self.engine.batch_native_ok:
            step = self.engine.step_batched
        else:
            def step(p):
                p2, costs = jax.vmap(self.engine.step)(p)
                return p2, jnp.stack(costs, axis=-1)

        def body(p, i):
            p2, costs = step(p)
            take = i < valid
            p2 = jax.tree.map(lambda a, b: jnp.where(take, a, b), p2, p)
            return p2, costs

        def run(p):
            return jax.lax.scan(body, p,
                                jnp.arange(chunk_size, dtype=jnp.int32))

        # same problem-axis chunking as iterate(): very large batches
        # degrade XLA's fusion scheduling inside the scan
        P_ = int(jax.tree.leaves(probs)[0].shape[0])
        ch = self.chunk
        if (ch and P_ >= self.min_chunks * ch and P_ % ch == 0
                and int(np.prod(self.mesh.devices.shape)) == 1):
            folded = jax.tree.map(
                lambda x: x.reshape((P_ // ch, ch) + x.shape[1:]), probs)
            probs, costs = jax.lax.map(run, folded)
            probs = jax.tree.map(
                lambda x: x.reshape((P_,) + x.shape[2:]), probs)
            costs = jnp.moveaxis(costs, 0, 1).reshape(
                (chunk_size, P_, 3))
            return probs, costs
        return run(probs)

    def iterate_masked(self, probs: ChompProblem, valid, chunk_size: int):
        """``chunk_size`` batched steps with the first ``valid`` (a
        *traced* scalar) applied.  Returns (problems,
        costs (chunk_size, P, 3)); rows ≥ valid are garbage."""
        return self._jitted("iterate_masked", self._masked_scan, (2,))(
            probs, valid, chunk_size)

    def iterate_until(self, probs: ChompProblem, valid, chunk_size: int,
                      tol=0.0):
        return self._jitted("iterate_until", self._iterate_until_impl,
                            (2,))(probs, valid, chunk_size, tol)

    def _iterate_until_impl(self, probs: ChompProblem, valid,
                            chunk_size: int, tol=0.0):
        """One convergence-checked masked chunk: run ``valid`` of
        ``chunk_size`` iterations, report (problems, last_costs (P, 3),
        all_converged ()).  ``valid`` and ``tol`` are traced — varying
        budgets and tolerances reuse one executable.

        The convergence test is a full-batch reduction — under dp
        sharding XLA lowers the global all() to an ICI psum.
        """
        probs, costs = self._masked_scan(probs, valid, chunk_size)
        valid = jnp.asarray(valid, jnp.int32)
        last = jax.lax.dynamic_index_in_dim(costs, valid - 1, axis=0,
                                            keepdims=False)
        drop = costs[0, :, 0] - last[:, 0]
        converged = jnp.all(drop < tol)
        return probs, last, converged

    def solve(self, probs: ChompProblem, n_iter: int, chunk: int = 10,
              tol: Optional[float] = None):
        """Host driver: runs up to n_iter iterations in chunks; stops
        early when converged (if tol given).  All chunks — including the
        ragged tail — reuse one compiled executable per engine."""
        probs = self.shard(probs)
        done = 0
        while done < n_iter:
            todo = min(chunk, n_iter - done)
            if tol is None:
                probs, _ = self.iterate_masked(probs, todo, chunk)
            else:
                probs, _, conv = self.iterate_until(probs, todo, chunk,
                                                    tol)
                if bool(conv):
                    done += todo
                    break
            done += todo
        finals = self.engine.final_costs_batch(probs)
        return probs, jnp.stack(finals, axis=-1), done


def best_of_batch(probs: ChompProblem, final_costs):
    """Select the lowest-total-cost trajectory across the batch — the
    best-of-HMC-restarts reduction (BASELINE.json config 3).  Under dp
    sharding the argmin is a cross-device reduction."""
    idx = jnp.argmin(final_costs[..., 0])
    best = jax.tree.map(lambda x: x[idx], probs)
    return best, idx
