"""Golden parity across the full feature matrix (VERDICT round-2 #2/#3).

Extends the float64 oracle parity beyond fixed-base unconstrained CHOMP:
floating base (orcdchomp_mod.cpp:991-1086, 2805-2808), momentum and
fixed-noise HMC resampling (chomp.c:533-548, orcdchomp_mod.cpp:2754-2768),
TSR constraint projection for con/everyn/start (chomp.c:553-600,
orcdchomp_mod.cpp:1330-1784), start_tsr end-to-end, and multi-SDF
min-select with inactive spheres.  Each test asserts ≤1e-6 per-iteration
trajectory agreement — far below the 1e-3 target of BASELINE.md.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.chomp.problem import HmcState
from or_cdchomp_jax.tsr import TSR
from or_cdchomp_jax.utils import np_pose
from tests.ref.oracle import OracleChomp

Q_START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
Q_GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _world(n_obstacles=1):
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    if n_obstacles >= 2:
        mod.add_kinbody(KinBody("shelf", oc.Scene.build(
            boxes=[((0.45, 0.5, 1.0, 0, 0, 0, 1), (0.05, 0.3, 0.3))])))
    if n_obstacles >= 3:
        mod.add_kinbody(KinBody("mug", oc.Scene.build(
            cylinders=[((0.1, 0.2, 0.7, 0, 0, 0, 1), 0.04, 0.06)])))
    r = Robot("wam", oc.wam7(), q_active=Q_START.copy())
    mod.add_robot(r)
    r.enabled = False
    for name in list(mod.bodies):
        if name != "wam":
            mod.computedistancefield(kinbody=name, cube_extent=0.07)
    r.enabled = True
    return mod, r


def _oracle_from_run(mod, rn, constraints=(), **kw):
    sdfs = []
    for s in mod.sdfs:
        body = mod.bodies[s.kinbody_name]
        sdfs.append((np.asarray(s.grid.data, dtype=np.float64),
                     np.asarray(s.grid.lengths, dtype=np.float64),
                     np_pose.compose(body.pose, s.pose)))
    spec = rn.spec
    return OracleChomp(
        model=rn.robot.model,
        robot_pose=rn.robot.pose,
        traj=np.asarray(rn.problem.traj, dtype=np.float64),
        lambda_=float(rn.problem.lambda_),
        epsilon=float(rn.problem.epsilon),
        epsilon_self=float(rn.problem.epsilon_self),
        obs_factor=float(rn.problem.obs_factor),
        obs_factor_self=float(rn.problem.obs_factor_self),
        sdfs=sdfs,
        jlimit_lower=np.asarray(rn.problem.jlimit_lower),
        jlimit_upper=np.asarray(rn.problem.jlimit_upper),
        floating_base=spec.floating_base,
        use_momentum=spec.use_momentum,
        start_tsr=spec.start_tsr,
        constraints=constraints,
        **kw)


def _assert_iters_match(rn, orc, n=4, atol=1e-6):
    for it in range(n):
        rn.problem, costs = rn.engine.iterate(rn.problem, 1)
        total_o, obs_o, smooth_o = orc.iterate(True)
        costs = np.asarray(costs)[0]
        np.testing.assert_allclose(costs[1], obs_o, rtol=1e-6, atol=1e-9,
                                   err_msg=f"obs cost iter {it}")
        np.testing.assert_allclose(costs[2], smooth_o, rtol=1e-6, atol=1e-9,
                                   err_msg=f"smooth cost iter {it}")
        np.testing.assert_allclose(
            np.asarray(rn.problem.traj), orc.traj, atol=atol,
            err_msg=f"trajectory diverged at iter {it}")


# ---------------------------------------------------------------------------
# floating base
# ---------------------------------------------------------------------------

def test_floating_base_parity():
    """SE(3) base prefix: damped base point Jacobian, base spatial
    columns, per-iteration quaternion renorm — all against the oracle
    (orcdchomp_mod.cpp:991-1086, 2805-2808)."""
    mod, r = _world()
    basegoal = np.array([0.15, 0.1, 0.05, 0.0, 0.0, 0.0, 1.0])
    h = mod.create(robot="wam", adofgoal=Q_GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=200.0, obs_factor=200.0,
                   n_points=9)
    rn = mod.runs[h]
    orc = _oracle_from_run(mod, rn)
    np.testing.assert_allclose(np.asarray(rn.engine.A), orc.A, atol=1e-9)
    _assert_iters_match(rn, orc, n=4)
    # base actually moved and quats stayed unit
    traj = np.asarray(rn.problem.traj)
    assert np.linalg.norm(traj[4, :3] - traj[0, :3]) > 1e-4
    np.testing.assert_allclose(np.linalg.norm(traj[:, 3:7], axis=1), 1.0,
                               atol=1e-12)
    mod.destroy(run=h)


# ---------------------------------------------------------------------------
# momentum / HMC
# ---------------------------------------------------------------------------

def test_momentum_leapfrog_parity():
    """use_momentum: AG accumulates with the 0.5/λ leapfrog half-step
    on first use (chomp.c:533-548)."""
    mod, r = _world()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, use_momentum=True)
    rn = mod.runs[h]
    orc = _oracle_from_run(mod, rn)
    _assert_iters_match(rn, orc, n=5)
    mod.destroy(run=h)


def test_hmc_fixed_noise_parity():
    """HMC resample mechanics with *identical injected noise* on both
    sides: AG := noise, leapfrog_first := True at a resample iteration
    (orcdchomp_mod.cpp:2754-2765), then leapfrog momentum continues."""
    mod, r = _world()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, use_momentum=True)
    rn = mod.runs[h]
    orc = _oracle_from_run(mod, rn)
    spec = rn.spec
    rng = np.random.default_rng(42)

    _assert_iters_match(rn, orc, n=2)

    # inject the same resample noise into both implementations
    noise = rng.normal(size=(spec.m, spec.n)) / np.sqrt(
        100.0 * np.exp(0.02 * 2))
    rn.problem = rn.problem._replace(
        AG=jnp.asarray(noise),
        hmc=HmcState(key=rn.problem.hmc.key,
                     resample_iter=rn.problem.hmc.resample_iter,
                     leapfrog_first=jnp.array(True)))
    orc.resample_momentum(noise)

    _assert_iters_match(rn, orc, n=3)
    mod.destroy(run=h)


def test_hmc_gap_distribution():
    """The Exp(λ) resample-gap discretization 1+floor(−ln u/λ) matches
    the reference's gsl-based schedule (orcdchomp_mod.cpp:2767)
    statistically: E[gap] = 1 + 1/(e^λ − 1), gaps are integers ≥ 1."""
    lam = 0.02
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (200_000,), jnp.float64, minval=1e-12)
    gaps = 1 + np.floor(-np.log(np.asarray(u)) / lam).astype(int)
    assert gaps.min() >= 1
    expected_mean = 1.0 + 1.0 / (np.exp(lam) - 1.0)
    assert abs(gaps.mean() - expected_mean) / expected_mean < 0.02
    # tail check: P(gap > k) = e^{-λ(k-1)} within sampling error
    for k in (10, 50, 100):
        emp = (gaps > k).mean()
        theory = np.exp(-lam * k)
        assert abs(emp - theory) < 0.01, (k, emp, theory)


def test_hmc_solver_resample_schedule():
    """The in-solver resample draws integer gaps ≥ 1 and resets the
    leapfrog flag exactly at resample iterations."""
    mod, r = _world()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, use_hmc=True,
                   hmc_resample_lambda=0.5, seed=3)
    rn = mod.runs[h]
    seen_resamples = 0
    for it in range(12):
        before = int(rn.problem.hmc.resample_iter)
        rn.problem, _ = rn.engine.iterate(rn.problem, 1)
        after = int(rn.problem.hmc.resample_iter)
        if after != before:
            seen_resamples += 1
            assert after - it >= 1   # gap ≥ 1 from the current iter
    assert seen_resamples >= 2       # λ=0.5 → mean gap ≈ 2.5
    mod.destroy(run=h)


# ---------------------------------------------------------------------------
# TSR constraints
# ---------------------------------------------------------------------------

def _upright_tsr():
    return TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))


def test_con_tsr_end_parity():
    """A con_tsr pinned at the last moving point: the projected update
    (h solve through JAJᵀ and A⁻¹ columns) matches chomp.c:553-600."""
    mod, r = _world()
    tsr = _upright_tsr()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=150.0,
                   obs_factor=200.0, n_points=9, con_tsr=("end", tsr))
    rn = mod.runs[h]
    m = rn.spec.m
    cons = [(m - 1, tsr.enabled_mask(), tsr.T0w, tsr.Twe)]
    orc = _oracle_from_run(mod, rn, constraints=cons)
    _assert_iters_match(rn, orc, n=4)
    mod.destroy(run=h)


def test_everyn_tsr_parity():
    """everyn_tsr at every moving point (orcdchomp_mod.cpp:2582-2592)."""
    mod, r = _world()
    tsr = _upright_tsr()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=200.0,
                   obs_factor=200.0, n_points=8, everyn_tsr=tsr)
    rn = mod.runs[h]
    m = rn.spec.m
    cons = [(i, tsr.enabled_mask(), tsr.T0w, tsr.Twe) for i in range(m)]
    orc = _oracle_from_run(mod, rn, constraints=cons)
    _assert_iters_match(rn, orc, n=3)
    mod.destroy(run=h)


def test_floating_everyn_tsr_parity():
    """Config-4 shape: floating base + everyn TSR — the base spatial
    Jacobian columns enter the constraint chain (con_everyn_tsr
    orcdchomp_mod.cpp:1500-1657)."""
    mod, r = _world()
    tsr = _upright_tsr()
    basegoal = np.array([0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0])
    h = mod.create(robot="wam", adofgoal=Q_GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=250.0, obs_factor=150.0,
                   n_points=8, everyn_tsr=tsr)
    rn = mod.runs[h]
    m = rn.spec.m
    cons = [(i, tsr.enabled_mask(), tsr.T0w, tsr.Twe) for i in range(m)]
    orc = _oracle_from_run(mod, rn, constraints=cons)
    _assert_iters_match(rn, orc, n=3)
    mod.destroy(run=h)


# ---------------------------------------------------------------------------
# start_tsr end-to-end
# ---------------------------------------------------------------------------

def test_start_tsr_end_to_end():
    """start_tsr: m = n_points−1, the start point moves, the metric has
    no init endpoint term, the shifted vel/acc windows match the oracle,
    and the point-0 constraint is driven toward zero
    (orcdchomp_mod.cpp:1659-1784, 2569-2572)."""
    mod, r = _world()
    # TSR at the start EE pose, constraining only z (so the start point
    # can still move in the other dims)
    from or_cdchomp_jax.models.robot import CompiledFK
    fk = CompiledFK(r.model, dtype=jnp.float64)
    lp, _ = fk.link_poses(jnp.asarray(Q_START, jnp.float64),
                          base_pose=jnp.asarray(r.pose, jnp.float64))
    ee = np.asarray(lp)[r.model.ee_link]
    ee_tool = np_pose.compose(ee, r.model.ee_origin)
    H = np.eye(4)
    H[:3, 3] = ee_tool[:3]
    tsr = TSR.from_matrices(
        H, np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [0, 0],
                     [-np.pi, np.pi], [-np.pi, np.pi], [-np.pi, np.pi]]))
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=150.0,
                   obs_factor=200.0, n_points=9, start_tsr=tsr)
    rn = mod.runs[h]
    assert rn.spec.start_tsr
    assert rn.spec.m == 9 - 1          # n_points − 1 moving points

    cons = [(0, tsr.enabled_mask(), tsr.T0w, tsr.Twe)]
    orc = _oracle_from_run(mod, rn, constraints=cons)
    np.testing.assert_allclose(np.asarray(rn.engine.A), orc.A, atol=1e-9)
    start_before = np.asarray(rn.problem.traj)[0].copy()
    _assert_iters_match(rn, orc, n=4)

    # the start point moved (it is a moving point under start_tsr)
    start_after = np.asarray(rn.problem.traj)[0]
    assert np.linalg.norm(start_after - start_before) > 1e-6

    # the constraint value at point 0 shrinks over iterations
    val0, _ = orc._con_eval(0, orc.traj[0])
    for _ in range(8):
        rn.problem, _ = rn.engine.iterate(rn.problem, 1)
        orc.iterate(True)
    val1, _ = orc._con_eval(0, orc.traj[0])
    assert np.linalg.norm(val1) < np.linalg.norm(val0) + 1e-9
    assert np.linalg.norm(val1) < 0.02
    mod.destroy(run=h)


def test_start_tsr_transport():
    """start_tsr through the 38-token string transport (create parses
    the serialized TSR and builds the m=n_points−1 run)."""
    mod, r = _world()
    tsr = _upright_tsr()
    goal = " ".join(str(v) for v in Q_GOAL)
    cmd = (f"create robot wam adofgoal '{goal}' n_points 9 "
           f"lambda 150.0 start_tsr '{tsr.serialize()}'")
    handle = mod.SendCommand(cmd)
    rn = mod.runs[handle]
    assert rn.spec.start_tsr and rn.spec.m == 8
    mod.SendCommand(f"iterate run {handle} n_iter 2")
    traj = np.asarray(rn.problem.traj)
    assert np.all(np.isfinite(traj))
    mod.SendCommand(f"destroy run {handle}")


# ---------------------------------------------------------------------------
# multi-SDF + inactive spheres
# ---------------------------------------------------------------------------

def test_multi_sdf_inactive_parity():
    """Three registered fields: each sphere independently min-selects
    its field (orcdchomp_mod.cpp:1169-1196) while the inactive wam0
    sphere contributes fixed-position self-collision terms."""
    mod, r = _world(n_obstacles=3)
    assert len(mod.sdfs) == 3
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9)
    rn = mod.runs[h]
    # the model has at least one inactive sphere (wam0 base sphere)
    assert rn.engine.n_spheres_total > rn.engine.n_spheres_active
    orc = _oracle_from_run(mod, rn)
    assert orc.inactive_pos.shape[0] >= 1
    _assert_iters_match(rn, orc, n=4)
    mod.destroy(run=h)


# ---------------------------------------------------------------------------
# gettraj affine parity
# ---------------------------------------------------------------------------

def test_gettraj_base_timing_and_velocities():
    """The floating-base output inherits the active-DOF deltatimes and
    carries affine_velocities = Δpose/deltatime, zeros at waypoint 0 —
    the merged-trajectory content of orcdchomp_mod.cpp:2914-2956."""
    mod, r = _world()
    basegoal = np.array([0.15, 0.1, 0.05, 0.0, 0.0, 0.0, 1.0])
    h = mod.create(robot="wam", adofgoal=Q_GOAL, basegoal=basegoal,
                   floating_base=True, lambda_=200.0, obs_factor=200.0,
                   n_points=9)
    mod.iterate(run=h, n_iter=3)
    traj = mod.gettraj(run=h, no_collision_check=True)
    assert traj.base_poses is not None and traj.base_velocities is not None
    assert traj.base_velocities.shape == traj.base_poses.shape
    np.testing.assert_array_equal(traj.base_velocities[0], 0.0)
    dt = np.diff(traj.times)
    np.testing.assert_allclose(
        traj.base_velocities[1:],
        (traj.base_poses[1:] - traj.base_poses[:-1]) / dt[:, None],
        atol=1e-12)
    # joint timing at velocity limits (LinearTrajectoryRetimer parity)
    vmax = np.asarray(r.model.dof_max_vel)
    seg = np.abs(np.diff(traj.positions, axis=0)) / vmax[None, :]
    np.testing.assert_allclose(dt, np.maximum(seg.max(axis=1), 1e-6),
                               atol=1e-12)
    mod.destroy(run=h)
