"""Round-4 oracle parity: derivative ≥ 2 end to end, and heterogeneous
TSR mixes through the general (mixed-enabled-mask) projection path.

 - The reference runs the whole pipeline at any D (K/E stacks
   chomp.c:239-340 incl. zero higher-order endpoints chomp.c:131-141;
   ``derivative`` param orcdchomp_mod.cpp:2016-2017).  Round 3 only
   tested metric *construction* at D=2/3; these tests drive full
   create/iterate solves through the update at D=2 and D=3.
 - The reference accepts repeated con_tsr entries with arbitrary
   per-TSR Bw masks (orcdchomp_mod.cpp:2574-2614); when two TSRs
   enable different dims the repo takes the general per-row-gather
   projection path (constraints.py), previously untested.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.tsr import TSR
from or_cdchomp_jax.utils import np_pose
from tests.ref.oracle import OracleChomp

Q_START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
Q_GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _world():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=Q_START.copy())
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.07)
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
# derivative ≥ 2 end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 3])
def test_derivative_end_to_end_parity(D):
    """Full create/iterate solve at derivative=D: the D-th order K/E
    stacks, B/trC windows, A⁻¹ spread, and smooth-cost report all match
    the oracle through the update (chomp.c:239-340,
    orcdchomp_mod.cpp:2016-2017)."""
    mod, r = _world()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, derivative=D)
    rn = mod.runs[h]
    assert rn.spec.D == D
    orc = _oracle_from_run(mod, rn, D=D)
    # the metric operators themselves
    np.testing.assert_allclose(np.asarray(rn.engine.A), orc.A, atol=1e-9)
    np.testing.assert_allclose(np.asarray(rn.problem.B), orc.B, atol=1e-9)
    np.testing.assert_allclose(float(rn.problem.trC), orc.trC, rtol=1e-12)
    # and the solve through them
    _assert_iters_match(rn, orc, n=4)
    mod.destroy(run=h)


def test_derivative2_differs_from_d1():
    """Sanity: D=2 actually changes the update (the acceleration metric
    is not the velocity metric)."""
    mod, r = _world()
    h1 = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                    n_points=9, derivative=1)
    h2 = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                    n_points=9, derivative=2)
    rn1, rn2 = mod.runs[h1], mod.runs[h2]
    rn1.problem, _ = rn1.engine.iterate(rn1.problem, 2)
    rn2.problem, _ = rn2.engine.iterate(rn2.problem, 2)
    assert not np.allclose(np.asarray(rn1.problem.traj),
                           np.asarray(rn2.problem.traj), atol=1e-8)
    mod.destroy(run=h1)
    mod.destroy(run=h2)


def test_derivative2_momentum_parity():
    """derivative=2 composed with use_momentum (leapfrog through the
    D=2 metric solve)."""
    mod, r = _world()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=9, derivative=2,
                   use_momentum=True)
    rn = mod.runs[h]
    orc = _oracle_from_run(mod, rn, D=2)
    _assert_iters_match(rn, orc, n=4)
    mod.destroy(run=h)


# ---------------------------------------------------------------------------
# heterogeneous TSR mixes (general mixed-mask projection path)
# ---------------------------------------------------------------------------

def _tsr_z_only():
    """Constrains z of the EE in the TSR frame (one enabled row)."""
    return TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [0, 0],
                     [-np.pi, np.pi], [-np.pi, np.pi], [-np.pi, np.pi]]))


def _tsr_upright():
    """Constrains roll+pitch (two enabled rows)."""
    return TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))


def _hetero_cons(rn, specs):
    """specs: list of (moving_point_idx, tsr) → oracle constraint list."""
    return [(pi, t.enabled_mask(), t.T0w, t.Twe) for pi, t in specs]


def test_heterogeneous_tsr_masks_parity():
    """Two TSRs with *different* enabled masks at different points hit
    the general per-row projection path and match chomp.c:553-600
    (registration semantics orcdchomp_mod.cpp:2574-2614)."""
    mod, r = _world()
    ta, tb = _tsr_z_only(), _tsr_upright()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=150.0,
                   obs_factor=200.0, n_points=9,
                   con_tsrs=[("start", ta), ("end", tb)])
    rn = mod.runs[h]
    m = rn.spec.m
    # confirm this is the general (non-uniform) path
    assert len(set(rn.engine.cons.enabled)) == 2
    assert rn.engine.cons.k_total == 3       # 1 (z) + 2 (roll,pitch)
    orc = _oracle_from_run(
        mod, rn, constraints=_hetero_cons(rn, [(0, ta), (m - 1, tb)]))
    _assert_iters_match(rn, orc, n=4)
    mod.destroy(run=h)


def test_duplicated_point_tsr_parity():
    """Two TSRs with different masks pinning the SAME moving point —
    their rows concatenate into one projection system exactly as the
    reference stacks repeated con_tsr entries."""
    mod, r = _world()
    ta, tb = _tsr_z_only(), _tsr_upright()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=150.0,
                   obs_factor=200.0, n_points=9,
                   con_tsrs=[("end", ta), ("end", tb)])
    rn = mod.runs[h]
    m = rn.spec.m
    assert len(set(rn.engine.cons.enabled)) == 2
    orc = _oracle_from_run(
        mod, rn, constraints=_hetero_cons(rn, [(m - 1, ta), (m - 1, tb)]))
    _assert_iters_match(rn, orc, n=4)
    mod.destroy(run=h)


def test_hetero_tsr_batch_native_equivalence():
    """The heterogeneous mix also runs through the batch-native SoA
    step (solver.step_batched vmaps the AoS constraint chain); pin it
    to the per-problem path."""
    import jax

    mod, r = _world()
    ta, tb = _tsr_z_only(), _tsr_upright()
    h = mod.create(robot="wam", adofgoal=Q_GOAL, lambda_=150.0,
                   obs_factor=200.0, n_points=9,
                   con_tsrs=[("start", ta), ("end", tb)])
    rn = mod.runs[h]
    eng = rn.engine
    assert eng.batch_native_ok
    B = 3
    probs = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), rn.problem)
    out_soa, c_soa = eng.iterate_batched_nojit(probs, 3)
    out_aos, c_aos = jax.vmap(lambda p: eng.iterate_nojit(p, 3))(probs)
    np.testing.assert_allclose(np.asarray(out_soa.traj),
                               np.asarray(out_aos.traj), atol=1e-9)
    np.testing.assert_allclose(np.asarray(c_soa), np.asarray(c_aos),
                               atol=1e-9)
    mod.destroy(run=h)
