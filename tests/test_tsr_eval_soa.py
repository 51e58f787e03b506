"""Batch-native TSR evaluation ≡ vmapped AoS chain.

eval_tsr_all_soa computes the same constraint values/Jacobians as
eval_tsr_all (orcdchomp_mod.cpp:1330-1657 chains) component-wise with
the batch minor; outputs must agree to f64 round-off for fixed-base
and floating-base problems, con/everyn layouts, and heterogeneous
enabled masks (the projection consumes only enabled rows, but the full
(6, n) Jacobian must match).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.chomp.constraints import eval_tsr_all, eval_tsr_all_soa
from or_cdchomp_jax.chomp.cost import TrajKinematics
from or_cdchomp_jax.chomp import cost_soa
from or_cdchomp_jax.parallel.batch import problem_batch_from_grid
from or_cdchomp_jax.tsr import TSR

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _module():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=START)
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    return mod


def _tsr(bw):
    return TSR.from_matrices(np.eye(4), np.eye(4), Bw=np.asarray(bw))


UPRIGHT = [[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0],
           [-np.pi, np.pi]]
POSED = [[0, 0], [-10, 10], [0, 0], [0, 0], [-1, 1], [0, 0]]


def _compare(mod, h, batch=5):
    run = mod.runs[h]
    eng = run.engine
    spec = eng.spec
    assert eng.cons.k_total > 0
    rng = np.random.default_rng(2)
    start = np.asarray(run.problem.traj)[0]
    goal = np.asarray(run.problem.traj)[-1]
    starts = np.tile(start, (batch, 1)) + 0.05 * rng.normal(
        size=(batch, spec.n))
    goals = np.tile(goal, (batch, 1)) + 0.05 * rng.normal(
        size=(batch, spec.n))
    if spec.floating_base:
        starts[:, 3:7] = start[3:7]
        goals[:, 3:7] = goal[3:7]
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)

    # FK outputs exactly as the batched step computes them
    Tt = jnp.transpose(probs.traj, (1, 2, 0))
    if spec.floating_base:
        fk_out = eng.fk.fk_soa(Tt[:, 7:, :],
                               tuple(Tt[:, i, :] for i in range(3)),
                               tuple(Tt[:, i, :] for i in range(3, 7)))
    else:
        fk_out = eng.fk.fk_soa(
            Tt, tuple(probs.robot_pose[:, i] for i in range(3)),
            tuple(probs.robot_pose[:, i] for i in range(3, 7)))

    val_s, jac_s = eval_tsr_all_soa(spec, eng.fk, probs, probs.traj,
                                    eng.cons, fk_out)

    red_aos = cost_soa.stack_pose_aos(fk_out.red_pos, fk_out.red_q)
    anch_aos = cost_soa.stack_pose_aos(fk_out.anch_pos, fk_out.anch_q)

    def eval_one(traj, red, anch, p):
        z = traj[:0]
        kin = TrajKinematics(x_all=z, x_mov=z, vel=z, acc=z,
                             anchors_mov=z, base_mov=z,
                             red_poses=red, anchors=anch)
        return eval_tsr_all(spec, eng.fk, p, traj, eng.cons, kin)

    val_a, jac_a = jax.vmap(eval_one)(probs.traj, red_aos, anch_aos,
                                      probs)
    np.testing.assert_allclose(np.asarray(val_s), np.asarray(val_a),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(jac_s), np.asarray(jac_a),
                               rtol=1e-10, atol=1e-12)


def test_fixed_base_con_tsr_end():
    mod = _module()
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9,
                   con_tsr=("end", _tsr(UPRIGHT)))
    _compare(mod, h)


def test_fixed_base_everyn_posed():
    mod = _module()
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9,
                   everyn_tsr=_tsr(POSED))
    _compare(mod, h)


def test_floating_base_everyn():
    mod = _module()
    basegoal = np.array([0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0])
    h = mod.create(robot="wam", adofgoal=GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=200.0, obs_factor=200.0,
                   n_points=7, everyn_tsr=_tsr(UPRIGHT))
    _compare(mod, h)


def test_noncontiguous_points():
    """Two separate con_tsrs at start and end → a non-contiguous
    point set exercises the gather branch of take()."""
    mod = _module()
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9,
                   con_tsrs=[("start", _tsr(UPRIGHT)),
                             ("end", _tsr(UPRIGHT))])
    _compare(mod, h)
