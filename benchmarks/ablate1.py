"""Ablation timing for config 1 (the headline WAM7 workload).

Attributes the ~1.2 ms step by replacing pieces with shape-compatible
stand-ins (fresh engine per arm; jit keys on the engine instance):

  full        — the real step
  no_lookup   — SDF interp+grad replaced by a cheap analytic function
  no_fk       — FK replaced by a linear map of the trajectory
  no_selfcol  — self-collision term zeroed
  no_jtmap    — Jᵀ map replaced by a slice
  no_metric   — A/Ainv gemms replaced by identity maps
  cost_only   — only the cost callbacks, no smoothgrad/limits

Run: timeout 1500 python -m benchmarks.ablate1
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def patched(mod, name, repl):
    orig = getattr(mod, name)
    setattr(mod, name, repl)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def main():
    from benchmarks import configs as C
    import or_cdchomp_jax.chomp.cost as cost_mod
    from or_cdchomp_jax.chomp.solver import ChompEngine
    from or_cdchomp_jax.chomp.constraints import TSRConstraintSet

    dtype = jnp.float32
    mod, run, goal = C.wam7_single_sdf(dtype)
    eng = run.engine

    def fresh():
        return ChompEngine(eng.spec, eng.fk.model, eng.fields,
                           cons=TSRConstraintSet.build(()), dtype=dtype,
                           metric_mode=eng.metric_mode)

    results = {}
    results["full"], step_full = measure(eng, run)

    # --- no_lookup: analytic pseudo-SDF (plane z=0.5), keeps all shapes
    def fake_interp(data, sizes, lengths, p, method="auto"):
        v = p[..., 2] - 0.5
        g = jnp.zeros_like(p).at[..., 2].set(1.0)
        return v, g, jnp.ones(v.shape, bool)
    with patched(cost_mod, "multigrid_interp_grad", fake_interp):
        results["no_lookup"], _ = measure(fresh(), run)

    # --- no_fk: sphere positions as a linear map of the traj
    real_tk = cost_mod.trajectory_kinematics

    def fake_tk(spec, fk, T_full, robot_pose=None):
        S = len(np.asarray(fk.sphere_radius))
        base = jnp.mean(T_full, axis=-1)        # (n_points,)
        x_all = (base[:, None, None]
                 + jnp.arange(S, dtype=T_full.dtype)[None, :, None]
                 * jnp.ones((3,), T_full.dtype) * 0.01)
        dt = spec.dt
        lo = 0 if spec.start_tsr else 1
        x_mov = x_all[lo:lo + spec.m]
        vel = (x_all[2:] - x_all[:-2]) / (2 * dt)
        acc = (x_all[:-2] - 2 * x_all[1:-1] + x_all[2:]) / (dt * dt)
        if spec.start_tsr:
            vel = jnp.concatenate([vel[:1], vel], 0)
            acc = jnp.concatenate([acc[:1], acc], 0)
        npts = T_full.shape[0]
        anchors = jnp.zeros((npts, fk.n_dof, 7), T_full.dtype) \
            .at[..., 6].set(1.0)
        red = jnp.zeros((npts, fk.n_red, 7), T_full.dtype).at[..., 6].set(1.0)
        bm = jnp.zeros((spec.m, 7), T_full.dtype).at[..., 6].set(1.0)
        return cost_mod.TrajKinematics(
            x_all=x_all, x_mov=x_mov, vel=vel, acc=acc,
            anchors_mov=anchors[lo:lo + spec.m], base_mov=bm,
            red_poses=red, anchors=anchors)
    with patched(cost_mod, "trajectory_kinematics", fake_tk):
        results["no_fk"], _ = measure(fresh(), run)

    # --- no_selfcol
    def fake_self(spec, same_link_mask, radii_act, radii_all, prob, kin,
                  want_grad):
        z = jnp.zeros(())
        return (z, jnp.zeros_like(kin.x_mov)) if want_grad else (z, None)
    with patched(cost_mod, "self_collision_cost_grad", fake_self):
        results["no_selfcol"], _ = measure(fresh(), run)

    # --- no_jtmap: G = slice of w
    import or_cdchomp_jax.models.robot as robot_mod
    orig_jt = robot_mod.CompiledFK.apply_sphere_jacT
    try:
        robot_mod.CompiledFK.apply_sphere_jacT = \
            lambda self, anchors, x, w: jnp.sum(w, axis=-2)[..., :self.n_dof]
        results["no_jtmap"], _ = measure(fresh(), run)
    finally:
        robot_mod.CompiledFK.apply_sphere_jacT = orig_jt

    # --- no_metric: identity A maps
    e = fresh()
    e.apply_A = lambda X: X
    e.solve_A = lambda G: G
    results["no_metric"], _ = measure(e, run)

    print(f"step_full = {step_full*1e3:.3f} ms")
    for k, v in results.items():
        print(f"{k:12s} {v:8.1f} solves/s   ({256.0/v*1e3/100:6.3f} ms/step)")


if __name__ == "__main__":
    main()
