"""Smoke run of the CHOMP solver on an NVIDIA GPU.

Drives the solver's main path once through the entry points a user
calls (``CHOMPModule``, ``BatchSolver``, ``gettraj_batch``) at the full
width of the WAM7 model (16 spheres, n_points=101, 100 iterations,
float32), and holds the float32 result to the repository's 1e-3 bar
against the float64 engine on the same card and against the NumPy
oracle of the reference math (tests/ref/oracle.py).

  a. device        refuse anything but a GPU; print the card and versions
  b. interactive   computedistancefield, runchomp with the strict
                   collision re-check, create + iterate(100)
  c. batch         config 1, 256 problems: f32 against f64 and the oracle,
                   gettraj_batch validation, compile time and solves/s
  d. step classes  config 2 (multi-SDF), config 4 (floating base +
                   everyn TSR) and the semiseparable metric, 20 iterations
  e. SDF lookup    the cell gathers on config 1's grid against NumPy
  f. four cards    (--four-cards only) 1,024 config-1 problems sharded
                   over four cards against the same problems on one card

Every phase but f pins a one-card mesh.  A failed check raises, so the
script exits non-zero before the last line, which is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Run from the repository root:

    python chip_smoke.py                # phases a-e on one card
    python chip_smoke.py --four-cards   # phases a and f on four cards
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import or_cdchomp_jax as oc
from benchmarks import configs
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.chomp import metric
from or_cdchomp_jax.ops import soa
from or_cdchomp_jax.ops.grid import lookup_cells
from or_cdchomp_jax.parallel.batch import (
    BatchSolver, best_of_batch, problem_batch_from_grid)

PARITY_BAR = 1e-3     # f32 against f64 / oracle (tests/test_f32_parity.py)
SHARDED_BAR = 1e-4    # four cards against one: same math, other rounding
N_POINTS = 101
N_ITER = 100
BATCH = 256


def require_gpu():
    """The devices JAX sees; exits non-zero unless they are GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found "
                 f"{devs[0].platform} ({devs[0].device_kind})")
    return devs


def result_line(devs) -> str:
    """The contract's last line for the devices the run used."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def perturbed(run, n, seed=0):
    """n (start, goal) pairs around the run's own endpoints (bench.py's
    perturbation); a floating base keeps its endpoint poses."""
    rng = np.random.default_rng(seed)
    traj = np.asarray(run.problem.traj, np.float64)
    starts = traj[0] + 0.02 * rng.normal(size=(n, traj.shape[1]))
    goals = traj[-1] + 0.02 * rng.normal(size=(n, traj.shape[1]))
    if run.spec.floating_base:
        starts[:, :7] = traj[0, :7]
        goals[:, :7] = traj[-1, :7]
    return starts, goals


def solve(run, starts, goals, n_iter, mesh):
    """BatchSolver.iterate on the mesh; returns (solver, probs, out,
    costs (P, n_iter, 3), seconds of the first call)."""
    solver = BatchSolver(run.engine, mesh=mesh)
    probs = solver.shard(problem_batch_from_grid(
        run.problem, starts, goals, run.engine))
    t0 = time.perf_counter()
    out, costs = solver.iterate(probs, n_iter)
    jax.block_until_ready(out)
    return (solver, probs, out, np.moveaxis(np.asarray(costs), 0, 1),
            time.perf_counter() - t0)


def parity(traj_a, costs_a, traj_b, costs_b):
    """(max per-solve trajectory error, max final-cost relative error)."""
    a = np.asarray(traj_a, np.float64)
    b = np.asarray(traj_b, np.float64)
    per_solve = np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)
    ca = np.asarray(costs_a, np.float64)[:, -1, 0]
    cb = np.asarray(costs_b, np.float64)[:, -1, 0]
    return float(per_solve.max()), float(np.max(np.abs(ca - cb)
                                                / np.abs(cb)))


def handle_of(mod, run):
    return next(h for h, r in mod.runs.items() if r is run)


def one_card_mesh(devs):
    return Mesh(np.asarray(devs[:1]), ("dp",))


# -- phase b ---------------------------------------------------------------

def interactive_phase():
    """The canonical drive (drive.py) through CHOMPModule."""
    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.35, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    robot = Robot("wam", oc.wam7(),
                  q_active=np.array([2.5, -1.8, 0, 2.0, 0, 0.2, 0]))
    mod.add_robot(robot)
    robot.enabled = False
    t0 = time.perf_counter()
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    t_sdf = time.perf_counter() - t0
    goal = [0.4, 0.6, 0.1, 1.3, 0, -0.5, 0]
    t0 = time.perf_counter()
    # runchomp's gettraj re-checks collisions strictly and raises on one
    traj = mod.runchomp(robot="wam", n_iter=N_ITER, lambda_=100.0,
                        obs_factor=500.0, n_points=N_POINTS, adofgoal=goal)
    t_run = time.perf_counter() - t0
    check(not traj.in_collision, "runchomp trajectory in collision")
    h = mod.create(robot="wam", adofgoal=goal, n_points=N_POINTS,
                   lambda_=100.0, obs_factor=500.0)
    walls = []
    for _ in range(2):
        cost = [0.0]
        t0 = time.perf_counter()
        mod.iterate(run=h, n_iter=N_ITER, cost=cost)
        walls.append(time.perf_counter() - t0)
    mod.destroy(run=h)
    check(np.isfinite(cost[0]), f"final cost {cost[0]}")
    print(f"[b] interactive: SDF build {t_sdf:.3f} s, runchomp "
          f"{t_run:.3f} s, strict gettraj clear; iterate({N_ITER}) final "
          f"cost {cost[0]:.6f}, cold {walls[0]:.3f} s, warm "
          f"{walls[1]:.3f} s", flush=True)


# -- phase c ---------------------------------------------------------------

def load_oracle():
    """tests/ref/oracle.py, loaded by path: ``tests`` is no package, so
    an installed package of that name would shadow it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "ref", "oracle.py")
    spec = importlib.util.spec_from_file_location("chomp_oracle", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def oracle_solve(mod, run, starts, goals, n_iter):
    """The NumPy oracle on the given problems: (trajs, costs)."""
    from or_cdchomp_jax.utils import np_pose

    OracleChomp = load_oracle().OracleChomp

    sdfs = [(np.asarray(s.grid.data, np.float64),
             np.asarray(s.grid.lengths, np.float64),
             np_pose.compose(mod.bodies[s.kinbody_name].pose, s.pose))
            for s in mod.sdfs]
    p = run.problem
    npts = run.spec.n_points
    a = np.linspace(0.0, 1.0, npts)[:, None]
    trajs, costs = [], []
    for s, g in zip(starts, goals):
        orc = OracleChomp(
            model=run.robot.model, robot_pose=run.robot.pose,
            traj=(1 - a) * s + a * g, lambda_=float(p.lambda_),
            epsilon=float(p.epsilon), epsilon_self=float(p.epsilon_self),
            obs_factor=float(p.obs_factor),
            obs_factor_self=float(p.obs_factor_self), sdfs=sdfs,
            jlimit_lower=np.asarray(p.jlimit_lower, np.float64),
            jlimit_upper=np.asarray(p.jlimit_upper, np.float64))
        costs.append([orc.iterate(True) for _ in range(n_iter)])
        trajs.append(orc.traj.copy())
    return np.stack(trajs), np.asarray(costs)


def batch_phase(mesh, card, batch=BATCH, n_iter=N_ITER, n_oracle=2,
                reps=5):
    """Config 1 through BatchSolver and gettraj_batch, against the f64
    engine and the oracle.  Returns the solved f32 batch for phase e."""
    mod, run, _ = configs.wam7_single_sdf(jnp.float32)
    starts, goals = perturbed(run, batch)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the oracle is host Python; it overlaps the device phases
        oracle = pool.submit(oracle_solve, mod, run, starts[:n_oracle],
                             goals[:n_oracle], n_iter)
        solver, probs, out, costs, t_first = solve(
            run, starts, goals, n_iter, mesh)
        _, bad32 = mod.gettraj_batch(run=handle_of(mod, run), probs=out)
        with jax.enable_x64(True):
            mod64, run64, _ = configs.wam7_single_sdf(jnp.float64)
            _, _, out64, costs64, _ = solve(run64, starts, goals, n_iter,
                                            mesh)
            _, bad64 = mod64.gettraj_batch(run=handle_of(mod64, run64),
                                           probs=out64)
        traj_o, costs_o = oracle.result()
    # timed once the oracle thread is done: it holds the interpreter
    # lock for long stretches and would delay the dispatches
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(solver.iterate(probs, n_iter))
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls))
    print(f"[c] config 1, B={batch}, {n_iter} iterations, f32: first call "
          f"(compile + run) {t_first:.3f} s; steady state median "
          f"{med:.6f} s = {batch / med:.2f} solves/s (walls "
          f"{[round(w, 6) for w in walls]}) on {card}", flush=True)
    e_t, e_c = parity(out.traj, costs, out64.traj, costs64)
    o_t, o_c = parity(np.asarray(out.traj)[:n_oracle], costs[:n_oracle],
                      traj_o, costs_o)
    n32, n64 = int((~bad32).sum()), int((~bad64).sum())
    print(f"[c] f32 vs f64 engine: max per-solve trajectory error {e_t:.3e},"
          f" max final-cost rel error {e_c:.3e}; f32 vs NumPy oracle "
          f"({n_oracle} problems): {o_t:.3e}, {o_c:.3e}; gettraj_batch "
          f"collision-free: f32 {n32}/{batch}, f64 {n64}/{batch}",
          flush=True)
    for name, v in (("f32-f64 trajectory", e_t), ("f32-f64 cost", e_c),
                    ("f32-oracle trajectory", o_t),
                    ("f32-oracle cost", o_c)):
        check(v <= PARITY_BAR, f"{name} error {v:.3e} > {PARITY_BAR}")
    check(bool(np.all(bad32 == bad64)),
          f"gettraj_batch verdicts differ: f32 {n32}, f64 {n64}")
    return run, probs, out


# -- phase d ---------------------------------------------------------------

STEP_CLASSES = (
    # (label, config function, n_points, batch)
    ("config 2 multi-SDF", configs.cluttered_multi_sdf, N_POINTS, 64),
    ("config 4 floating base + everyn TSR", configs.floating_everyn_tsr,
     51, 64),
    ("semiseparable metric", configs.wam7_single_sdf, metric.SEP_MIN_M + 2,
     16),
)


def step_class_phase(mesh, n_iter=20, classes=STEP_CLASSES):
    for label, build, n_points, batch in classes:
        _, run, _ = build(jnp.float32, n_points=n_points)
        if n_points >= metric.SEP_MIN_M:
            check(run.engine.metric_mode == "sep", f"{label}: not sep")
        starts, goals = perturbed(run, batch, seed=1)
        _, _, out, costs, t_first = solve(run, starts, goals, n_iter, mesh)
        with jax.enable_x64(True):
            _, run64, _ = build(jnp.float64, n_points=n_points)
            _, _, out64, costs64, _ = solve(run64, starts, goals, n_iter,
                                            mesh)
        e_t, e_c = parity(out.traj, costs, out64.traj, costs64)
        print(f"[d] {label}: n_points={n_points}, B={batch}, {n_iter} "
              f"iterations, first call {t_first:.3f} s; f32 vs f64 max "
              f"per-solve trajectory error {e_t:.3e}, max final-cost rel "
              f"error {e_c:.3e}", flush=True)
        check(e_t <= PARITY_BAR and e_c <= PARITY_BAR,
              f"{label}: f32 vs f64 {e_t:.3e} / {e_c:.3e}")


# -- phase e ---------------------------------------------------------------

def lookup_phase(run, probs, out):
    """The SDF cell gathers at every config-1 query (moving points ×
    spheres × problems) against a NumPy float64 selection of the same
    four cells.  A gather copies table entries, so they must be equal;
    only queries whose cell choice sits within float32 rounding of a
    cell boundary or center are left out, since float32 and float64
    may choose differently there."""
    eng = run.engine
    fields = eng.fields
    traj = jnp.transpose(out.traj, (1, 2, 0))
    comps = lambda a, n: tuple(a[:, i] for i in range(n))
    fk = eng.fk.fk_soa(traj, comps(probs.robot_pose[:, :3], 3),
                       comps(probs.robot_pose[:, 3:], 4))
    x = tuple(c[1:-1] for c in fk.x)                   # (m, S, B)
    pg = probs.pose_gsdf_world[:, 0]
    p = soa.add(soa.qrot(comps(pg[:, 3:], 4), x), comps(pg[:, :3], 3))
    dims = fields.data.shape[1:]
    look = jax.jit(lookup_cells, static_argnums=1)
    v0, vn, use_next, _, in_b = jax.device_get(look(
        fields.data[0].reshape(-1), dims, fields.sizes[0],
        fields.lengths[0], p))

    data = np.asarray(fields.data[0], np.float64)
    sizes = np.asarray(fields.sizes[0])
    lengths = np.asarray(fields.lengths[0], np.float64)
    p64 = [np.asarray(c, np.float64).ravel() for c in p]
    sub, nbr, nxt, sure = [], [], [], np.ones(p64[0].shape, bool)
    for i in range(3):
        u = p64[i] / lengths[i] * sizes[i]
        s = np.clip(np.floor(u), 0, sizes[i] - 1).astype(np.int64)
        # f32 may round a point across a cell boundary or its center
        frac = u - np.floor(u)
        sure &= np.minimum(frac, 1 - frac) > 1e-5
        sure &= np.abs(frac - 0.5) > 1e-5
        un = np.where(s == 0, True, u - s >= 0.5)
        un = np.where(s == sizes[i] - 1, False, un)
        sub.append(s)
        nxt.append(un)
        nbr.append(np.clip(s + np.where(un, 1, -1), 0, sizes[i] - 1))
    # the center cell, then the chosen neighbor along each axis
    cells = [tuple(sub)] + [tuple(nbr[i] if k == i else sub[k]
                                  for k in range(3)) for i in range(3)]
    mism = sum(int(np.sum((np.ravel(got) != data[c]) & sure))
               for got, c in zip((v0, *vn), cells))
    mism += sum(int(np.sum((np.ravel(use_next[i]) != nxt[i]) & sure))
                for i in range(3))
    n_q = sure.size
    inside = int(np.sum(in_b))
    print(f"[e] SDF cell gathers on config 1's {dims} grid: {n_q} queries "
          f"x 4 cells, {int(sure.sum())} with an unambiguous cell choice "
          f"({inside} inside the grid); mismatches against NumPy float64 "
          f"selection: {mism} (bar: 0, exact)", flush=True)
    check(n_q == eng.spec.m * eng.n_spheres_active * probs.traj.shape[0],
          f"query count {n_q}")
    check(mism == 0, f"{mism} gathered cells differ from the table")


# -- phase f ---------------------------------------------------------------

def four_card_phase(devs, n_problems=1024, n_points=N_POINTS,
                    n_iter=N_ITER):
    """Config 1 sharded over a flat four-card ("dp",) mesh, then
    best_of_batch, against the same problems solved on card 0 alone.
    Returns (max trajectory difference, best-cost relative difference).
    """
    _, run, _ = configs.wam7_single_sdf(jnp.float32, n_points=n_points)
    eng = run.engine
    starts, goals = perturbed(run, n_problems, seed=2)
    results = {}
    for label, mesh in (("4 cards", Mesh(np.asarray(devs[:4]), ("dp",))),
                        ("1 card", Mesh(np.asarray(devs[:1]), ("dp",)))):
        solver, probs, out, _, t_first = solve(run, starts, goals, n_iter,
                                               mesh)
        if label == "4 cards":
            rows = sorted({s.data.shape[0]
                           for s in out.traj.addressable_shards})
            devices = {s.device for s in out.traj.addressable_shards}
            check(rows == [n_problems // 4] and len(devices) == 4,
                  f"shards hold {rows} rows on {len(devices)} devices")
        finals = jnp.stack(eng.final_costs_batch(out), axis=-1)
        best, idx = best_of_batch(out, finals)
        results[label] = (np.asarray(out.traj), np.asarray(finals),
                          int(idx))
        print(f"[f] {label}: {n_problems} problems, first call "
              f"{t_first:.3f} s, best problem {int(idx)} cost "
              f"{float(finals[int(idx), 0]):.6f}", flush=True)
    t4, f4, i4 = results["4 cards"]
    t1, f1, i1 = results["1 card"]
    d_traj = float(np.max(np.abs(t4.astype(np.float64) - t1)))
    d_best = float(abs(f4[i4, 0] - f1[i1, 0]) / abs(f1[i1, 0]))
    print(f"[f] sharded vs single card: max trajectory difference "
          f"{d_traj:.3e}, best-cost rel difference {d_best:.3e} (bar "
          f"{SHARDED_BAR})", flush=True)
    check(d_traj <= SHARDED_BAR, f"trajectory difference {d_traj:.3e}")
    check(d_best <= SHARDED_BAR, f"best-cost difference {d_best:.3e}")
    return d_traj, d_best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    devs = require_gpu()
    from or_cdchomp_jax import native
    from or_cdchomp_jax.utils.compile_cache import enable_compile_cache

    card = card_line()
    print(card, flush=True)
    import jaxlib
    print(f"[a] device_kind {devs[0].device_kind}, "
          f"{len(devs)} visible; jax {jax.__version__}, jaxlib "
          f"{jaxlib.__version__}; native library loaded: "
          f"{native._load() is not None}; compile cache "
          f"{enable_compile_cache()}", flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
        used = devs[:4]
        four_card_phase(used)
    else:
        used = devs[:1]
        mesh = one_card_mesh(devs)
        with jax.default_device(devs[0]):
            interactive_phase()
            run, probs, out = batch_phase(mesh, card)
            step_class_phase(mesh)
            lookup_phase(run, probs, out)
    print(f"{card}; all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(result_line(used))


if __name__ == "__main__":
    main()
