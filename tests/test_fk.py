"""FK / Jacobian tests: vs finite differences and the oracle FK.

All FK evaluations are batched (leading axis) because this backend's
rank-0 transcendentals are f32-sloppy while rank-1+ are exact.
"""

import numpy as np
import jax.numpy as jnp

from or_cdchomp_jax.models.robot import CompiledFK
from or_cdchomp_jax.models.wam7 import wam7
from tests.ref import oracle as orc

RNG = np.random.default_rng(5)


def _fk1(fk, q, base=None):
    """Single-config FK via the batched path."""
    qb = jnp.asarray(np.asarray(q)[None])
    bb = None if base is None else jnp.asarray(np.asarray(base)[None])
    lp, anchors = fk.link_poses(qb, base_pose=bb)
    return np.asarray(lp[0]), np.asarray(anchors[0])


def test_fk_matches_oracle():
    model = wam7()
    fk = CompiledFK(model, dtype=jnp.float64)
    for _ in range(3):
        q = RNG.normal(size=7)
        base = np.array([0.3, -0.2, 0.1, 0, 0, 0.38268343, 0.92387953])
        lp, anchors = _fk1(fk, q, base)
        poses_o, anchors_o = orc.fk_link_poses(model, q, base)
        np.testing.assert_allclose(lp, poses_o, atol=1e-6)
        np.testing.assert_allclose(anchors, anchors_o, atol=1e-6)
        x = np.asarray(fk.sphere_positions(jnp.asarray(lp[None])))[0]
        x_o = orc.sphere_positions(model, poses_o)
        np.testing.assert_allclose(x, x_o, atol=1e-6)


def test_jacobian_matches_fd():
    model = wam7()
    fk = CompiledFK(model, dtype=jnp.float64)
    q = RNG.normal(size=7)
    eps = 1e-6
    qs = [q]
    for d in range(7):
        qp, qm = q.copy(), q.copy()
        qp[d] += eps
        qm[d] -= eps
        qs += [qp, qm]
    x, J, _ = fk.fk_spheres(jnp.asarray(np.stack(qs)))
    x, J = np.asarray(x), np.asarray(J)
    for d in range(7):
        fd = (x[1 + 2 * d] - x[2 + 2 * d]) / (2 * eps)
        np.testing.assert_allclose(J[0][..., d], fd, atol=1e-6)


def test_jacobian_matches_oracle():
    model = wam7()
    fk = CompiledFK(model, dtype=jnp.float64)
    q = RNG.normal(size=7)
    lp, anchors = _fk1(fk, q)
    x = np.asarray(fk.sphere_positions(jnp.asarray(lp[None])))[0]
    J = np.asarray(fk.sphere_jacobians(
        jnp.asarray(anchors[None]), jnp.asarray(x[None])))[0]
    for s in range(len(model.sphere_link)):
        J_o = orc.sphere_jacobian(model, anchors, x[s],
                                  int(model.sphere_link[s]))
        np.testing.assert_allclose(J[s], J_o, atol=1e-6)


def test_frozen_joints():
    """Inactive finger joints frozen at nonzero values still move the
    finger spheres with the arm."""
    full = wam7(active="all")
    names = full.dof_names
    qfull = np.zeros(full.n_dof)
    qfull[names.index("JF1")] = 0.7
    frozen = full.set_active(["J1", "J2", "J3", "J4", "J5", "J6", "J7"],
                             q_current=qfull)
    fk_froz = CompiledFK(frozen, dtype=jnp.float64)
    fk_full = CompiledFK(full, dtype=jnp.float64)
    q7 = RNG.normal(size=7)
    qf = qfull.copy()
    qf[:7] = q7  # arm dofs come first in construction order
    lp1, _ = _fk1(fk_froz, q7)
    lp2, _ = _fk1(fk_full, qf)
    x1 = np.asarray(fk_froz.sphere_positions(jnp.asarray(lp1[None])))[0]
    x2 = np.asarray(fk_full.sphere_positions(jnp.asarray(lp2[None])))[0]
    np.testing.assert_allclose(x1, x2, atol=1e-6)


def test_sphere_subset_order():
    model = wam7()
    act = model.sphere_active_mask()
    order = np.concatenate([np.where(act)[0], np.where(~act)[0]])
    fk = CompiledFK(model, dtype=jnp.float64, sphere_subset=order[:act.sum()])
    q = RNG.normal(size=7)
    lp, _ = _fk1(fk, q)
    x = np.asarray(fk.sphere_positions(jnp.asarray(lp[None])))[0]
    fk_all = CompiledFK(model, dtype=jnp.float64)
    lp2, _ = _fk1(fk_all, q)
    x_all = np.asarray(fk_all.sphere_positions(jnp.asarray(lp2[None])))[0]
    np.testing.assert_allclose(x, x_all[order[:act.sum()]], atol=1e-12)


def test_batched_fk():
    model = wam7()
    fk = CompiledFK(model, dtype=jnp.float64)
    q = jnp.asarray(RNG.normal(size=(4, 5, 7)))
    lp, anchors = fk.link_poses(q)
    assert lp.shape == (4, 5, fk.n_links, 7)
    x = fk.sphere_positions(lp)
    assert x.shape == (4, 5, 16, 3)
    lp0, _ = fk.link_poses(q[0])
    np.testing.assert_allclose(np.asarray(lp[0]), np.asarray(lp0),
                               atol=1e-12)
