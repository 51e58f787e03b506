"""TSR constraint tests: serialization round-trip, Jacobian vs finite
differences, and projection behavior (constraint drift stays bounded)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.chomp.constraints import (
    TSRConstraintSet, eval_tsr_all, tsr_enabled_from_bw)
from or_cdchomp_jax.chomp.cost import trajectory_kinematics
from or_cdchomp_jax.tsr import TSR


def test_tsr_parse_serialize_roundtrip():
    t = TSR.from_matrices(
        np.array([[1, 0, 0, 0.5], [0, 0, -1, 0.2], [0, 1, 0, 0.8],
                  [0, 0, 0, 1]]),
        np.eye(4),
        Bw=np.array([[0, 0], [0, 0], [-0.1, 0.1],
                     [0, 0], [-np.pi, np.pi], [0, 0]]),
    )
    t2 = TSR.parse(t.serialize())
    np.testing.assert_allclose(t2.T0w, t.T0w, atol=1e-12)
    np.testing.assert_allclose(t2.Twe, t.Twe, atol=1e-12)
    np.testing.assert_allclose(t2.Bw, t.Bw, atol=1e-12)
    assert t.enabled_mask() == (True, True, False, True, False, True)


def test_enabled_from_bw():
    bw = np.zeros((6, 2))
    bw[2] = [-1, 1]
    assert tsr_enabled_from_bw(bw) == (True, True, False, True, True, True)


@pytest.fixture(scope="module")
def world():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    return mod, r


def _upright_tsr():
    """Constrain ee position x/y and roll/pitch (z free, yaw free)."""
    return TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[0, 0], [0, 0], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))


def test_tsr_jacobian_fd(world):
    """Full 6-d constraint Jacobian vs finite differences of the value."""
    mod, r = world
    goal = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0, n_points=8,
                   everyn_tsr=_upright_tsr())
    rn = mod.runs[h]
    eng = rn.engine
    spec = eng.spec
    prob = rn.problem

    def val_at(traj):
        kin = trajectory_kinematics(spec, eng.fk, traj, prob.robot_pose)
        v, _ = eval_tsr_all(spec, eng.fk, prob, traj, eng.cons, kin)
        return v

    kin = trajectory_kinematics(spec, eng.fk, prob.traj, prob.robot_pose)
    val, jac = eval_tsr_all(spec, eng.fk, prob, prob.traj, eng.cons, kin)
    jac = np.asarray(jac)

    eps = 1e-6
    ci = 2                      # constraint at moving point 2 → traj row 3
    row = eng.cons.point_idx[ci] + 1
    for d in range(spec.n):
        tp = prob.traj.at[row, d].add(eps)
        tm = prob.traj.at[row, d].add(-eps)
        fd = (np.asarray(val_at(tp))[ci] - np.asarray(val_at(tm))[ci]) / (2 * eps)
        np.testing.assert_allclose(jac[ci, :, d], fd, atol=2e-5,
                                   err_msg=f"dof {d}")
    mod.destroy(run=h)


def test_projection_reduces_constraint_value(world):
    """The goal-set projection is a Newton step on the constraint: with
    everyn_tsr active, the enabled constraint values shrink toward 0
    across iterations (chomp.c:553-600)."""
    mod, r = world
    goal = np.array([2.3, -1.5, 0.1, 1.8, 0.0, 0.1, 0.0])
    # TSR frame placed at the initial ee position so the initial
    # violation is moderate
    tsr = TSR.from_matrices(
        np.array([[1, 0, 0, 0.2], [0, 1, 0, -0.6], [0, 0, 1, 1.0],
                  [0, 0, 0, 1]]),
        np.eye(4),
        Bw=np.array([[0, 0], [0, 0], [-10, 10],
                     [-np.pi, np.pi], [-np.pi, np.pi], [-np.pi, np.pi]]))
    h = mod.create(robot="wam", adofgoal=goal, lambda_=50.0,
                   n_points=8, everyn_tsr=tsr)
    rn = mod.runs[h]
    eng = rn.engine

    def max_violation(prob):
        kin = trajectory_kinematics(eng.spec, eng.fk, prob.traj,
                                    prob.robot_pose)
        val, _ = eval_tsr_all(eng.spec, eng.fk, prob, prob.traj,
                              eng.cons, kin)
        rows = np.asarray([[c, d] for (c, d) in eng.cons.rows])
        return float(np.abs(np.asarray(val)[rows[:, 0], rows[:, 1]]).max())

    v_before = max_violation(rn.problem)
    rn.problem, _ = eng.iterate(rn.problem, 5)
    v_after = max_violation(rn.problem)
    assert v_after < 0.5 * v_before, (v_before, v_after)
    mod.destroy(run=h)


def test_sss_solve_matches_dense():
    """The O(C) quasiseparable scan solve equals the dense
    (Ainv ∘ JJᵀ)⁻¹ solve for the D=1 metric (it is the same Cholesky,
    factored through the semiseparable generators)."""
    from or_cdchomp_jax.chomp import metric as metric_mod
    from or_cdchomp_jax.chomp.constraints import _sss_solve

    rng = np.random.default_rng(3)
    m, dt, n, k = 23, 1.0 / 24, 9, 3
    pts = np.arange(m)
    C = len(pts)
    J = jnp.asarray(rng.normal(size=(C, k, n)))
    h = jnp.asarray(rng.normal(size=(C, k)))
    Acc = np.asarray(metric_mod.sep_ainv_entries(pts[:, None], pts[None, :],
                                                 m, dt))
    JJt = np.einsum("aip,bjp->aibj", np.asarray(J), np.asarray(J))
    M = (JJt * Acc[:, None, :, None]).reshape(C * k, C * k)
    x_dense = np.linalg.solve(M, np.asarray(h).reshape(-1))

    alpha = jnp.asarray((dt * dt) * (pts + 1.0))
    beta = jnp.asarray(float(m) - pts)
    x_sss = np.asarray(_sss_solve(J, h, alpha, beta)).reshape(-1)
    np.testing.assert_allclose(x_sss, x_dense, rtol=1e-8, atol=1e-9)


def test_sss_solve_nonuniform_points():
    """Non-contiguous (but sorted) point subsets keep the
    semiseparable factorization exact (min/max generators only need
    ordering, not contiguity)."""
    from or_cdchomp_jax.chomp import metric as metric_mod
    from or_cdchomp_jax.chomp.constraints import _sss_solve

    rng = np.random.default_rng(5)
    m, dt, n, k = 40, 1.0 / 41, 14, 2
    pts = np.array([0, 3, 4, 11, 12, 30, 39])
    C = len(pts)
    J = jnp.asarray(rng.normal(size=(C, k, n)))
    h = jnp.asarray(rng.normal(size=(C, k)))
    Acc = np.asarray(metric_mod.sep_ainv_entries(pts[:, None], pts[None, :],
                                                 m, dt))
    JJt = np.einsum("aip,bjp->aibj", np.asarray(J), np.asarray(J))
    M = (JJt * Acc[:, None, :, None]).reshape(C * k, C * k)
    x_dense = np.linalg.solve(M, np.asarray(h).reshape(-1))

    alpha = jnp.asarray((dt * dt) * (pts + 1.0))
    beta = jnp.asarray(float(m) - pts)
    x_sss = np.asarray(_sss_solve(J, h, alpha, beta)).reshape(-1)
    np.testing.assert_allclose(x_sss, x_dense, rtol=1e-8, atol=1e-9)
