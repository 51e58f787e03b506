"""Semiseparable (closed-form A⁻¹) metric backend vs the dense one.

The default CHOMP metric (D=1, both endpoints fixed) has
A = tridiag(-1,2,-1)/(dt²·(m+1)) whose inverse is the closed form
Ainv[p,q] = dt²·(p+1)·(m−q) for p ≤ q — so the dense O(m²) apply and
O(m³) init (chomp.c:392-403, 529-530) collapse to O(m·n) cumsums.
These tests pin the closed form against the dense operators and check
the full engine produces identical trajectories in either mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.chomp import metric as mm
from or_cdchomp_jax.chomp.solver import ChompEngine

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("m", [1, 2, 5, 33])
def test_sep_matches_dense_operators(m):
    dt = 1.0 / (m + 1)
    ops = mm.build_metric(m, dt, D=1)
    G = RNG.normal(size=(m, 4))

    np.testing.assert_allclose(
        np.asarray(mm.sep_solve(jnp.asarray(G), dt)), ops.Ainv @ G,
        rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(mm.sep_apply_A(jnp.asarray(G), dt)), ops.A @ G,
        rtol=1e-9, atol=1e-9)

    p = jnp.arange(m)
    entries = np.asarray(mm.sep_ainv_entries(p[:, None], p[None, :], m, dt))
    np.testing.assert_allclose(entries, ops.Ainv, rtol=1e-9, atol=1e-9)


def test_sep_affine_terms():
    m, n, dt = 7, 3, 0.125
    ops = mm.build_metric(m, dt, D=1)
    init0 = RNG.normal(size=n)
    final0 = RNG.normal(size=n)
    B_d, trC_d = mm.build_B_trC(ops, init0, final0, n)
    B_s, trC_s = mm.sep_B_trC(m, dt, init0, final0, n)
    np.testing.assert_allclose(B_s, B_d, atol=1e-12)
    np.testing.assert_allclose(trC_s, trC_d, atol=1e-12)
    np.testing.assert_allclose(mm.sep_Evels(m, dt, init0, final0, n),
                               mm.build_Evels(ops, init0, final0, n),
                               atol=1e-12)


def test_sep_batched_solve_shape():
    """sep_solve broadcasts over leading problem axes."""
    m, dt = 11, 0.1
    G = jnp.asarray(RNG.normal(size=(4, m, 3)))
    out = mm.sep_solve(G, dt)
    ops = mm.build_metric(m, dt, D=1)
    np.testing.assert_allclose(np.asarray(out),
                               np.einsum("ij,bjn->bin", ops.Ainv,
                                         np.asarray(G)),
                               rtol=1e-9, atol=1e-9)


def test_engine_sep_equals_dense_end_to_end():
    """Full CHOMP iterations agree between metric backends."""
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
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=10)
    run = mod.runs[h]
    assert run.engine.metric_mode == "dense"   # m=8 < SEP_MIN_M

    sep_engine = ChompEngine(
        run.spec, r.model, run.engine.fields, cons=run.engine.cons,
        dtype=mod.dtype, metric_mode="sep")
    p_d, c_d = run.engine.iterate(run.problem, 5)
    p_s, c_s = sep_engine.iterate(run.problem, 5)
    # f32 engine state: tolerances at f32 resolution (the backends share
    # the cost path; only the metric solve differs)
    np.testing.assert_allclose(np.asarray(p_s.traj), np.asarray(p_d.traj),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(c_s), np.asarray(c_d),
                               rtol=1e-5, atol=1e-6)


def test_api_auto_sep_long_trajectory(monkeypatch):
    """n_points past the threshold auto-selects the sep backend and
    solves without building any m×m matrix.  (Threshold patched small —
    the virtual-CPU backend compiles long-m graphs too slowly for CI.)"""
    monkeypatch.setattr(mm, "SEP_MIN_M", 16)
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
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=mm.SEP_MIN_M + 10)
    run = mod.runs[h]
    assert run.engine.metric_mode == "sep"
    assert run.engine.A is None and run.engine.Ainv is None
    total = mod.iterate(run=h, n_iter=2)
    assert np.isfinite(total)
