"""Pose/quaternion algebra unit tests (vs identities + the oracle)."""

import numpy as np
import jax.numpy as jnp
import pytest

from or_cdchomp_jax.ops import quat as qt
from tests.ref import oracle as orc

RNG = np.random.default_rng(0)


def rand_pose(batch=()):
    q = RNG.normal(size=batch + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = RNG.normal(size=batch + (3,))
    return jnp.asarray(np.concatenate([p, q], axis=-1))


def test_compose_matches_oracle():
    a, b = rand_pose((16,)), rand_pose((16,))
    got = np.asarray(qt.pose_compose(a, b))
    for i in range(16):
        want = orc.p_mul(np.asarray(a[i]), np.asarray(b[i]))
        np.testing.assert_allclose(got[i], want, atol=1e-12)


def test_invert_roundtrip():
    p = rand_pose((8,))
    ident = qt.pose_compose(p, qt.pose_invert(p))
    np.testing.assert_allclose(np.asarray(ident[..., :3]), 0, atol=1e-12)
    np.testing.assert_allclose(np.abs(np.asarray(ident[..., 6])), 1, atol=1e-12)


def test_rotate_vs_R():
    p = rand_pose((8,))
    v = jnp.asarray(RNG.normal(size=(8, 3)))
    r1 = np.asarray(qt.quat_rotate(p[..., 3:], v))
    R = np.asarray(qt.quat_to_R(p[..., 3:]))
    r2 = np.einsum("bij,bj->bi", R, np.asarray(v))
    np.testing.assert_allclose(r1, r2, atol=1e-12)


def test_quat_from_R_roundtrip():
    q = rand_pose((32,))[..., 3:]
    R = qt.quat_to_R(q)
    q2 = qt.quat_from_R(R)
    # up to sign
    dot = np.abs(np.sum(np.asarray(q) * np.asarray(q2), axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-9)


def test_xyzypr_roundtrip():
    p = rand_pose((32,))
    x = qt.pose_to_xyzypr(p)
    p2 = qt.pose_from_xyzypr(x)
    # same rotation up to quat sign
    dot = np.abs(np.sum(np.asarray(p[..., 3:]) * np.asarray(p2[..., 3:]),
                        axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p[..., :3]),
                               np.asarray(p2[..., :3]), atol=1e-12)


def test_ypr_jacobian_fd():
    # batched evaluation: this backend's rank-0 transcendentals are
    # f32-sloppy, rank-1+ are exact
    q = np.asarray(rand_pose((1,))[0, 3:])
    J = np.asarray(qt.quat_to_ypr_J(jnp.asarray(q[None])))[0]
    eps = 1e-7
    pts = []
    for k in range(4):
        qp, qm = q.copy(), q.copy()
        qp[k] += eps
        qm[k] -= eps
        pts += [qp, qm]
    vals = np.asarray(qt.quat_to_ypr(jnp.asarray(np.stack(pts))))
    for k in range(4):
        fd = (vals[2 * k] - vals[2 * k + 1]) / (2 * eps)
        np.testing.assert_allclose(J[:, k], fd, atol=1e-5)


def test_gimbal_lock_guard():
    # pitch = +90deg
    q = np.asarray(qt.quat_from_ypr(jnp.asarray([0.3, np.pi / 2, 0.0])))
    ypr = np.asarray(qt.quat_to_ypr(jnp.asarray(q)))
    assert abs(ypr[1] - np.pi / 2) < 1e-6


def test_axisangle_roundtrip():
    axis = np.array([0.0, 0.6, 0.8])
    q = qt.quat_from_axisangle(jnp.asarray(axis), jnp.asarray(1.2))
    ax2, ang2 = qt.quat_to_axisangle(q)
    np.testing.assert_allclose(np.asarray(ax2), axis, atol=1e-9)
    np.testing.assert_allclose(float(ang2), 1.2, atol=1e-9)


def test_flip_closerto():
    q = jnp.asarray([0.0, 0.0, 0.0, 1.0])
    t = jnp.asarray([0.0, 0.0, 0.0, -1.0])
    out = qt.quat_flip_closerto(q, t)
    np.testing.assert_allclose(np.asarray(out), [0, 0, 0, -1.0])


# ---- kin.c:545-583, 754-844 additions ---------------------------------

def test_axisangle_rotate_matches_quat():
    rng = np.random.default_rng(7)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = 1.234
    v = rng.normal(size=(5, 3))
    out = np.asarray(qt.axisangle_rotate(
        jnp.asarray(axis), jnp.asarray(angle), jnp.asarray(v)))
    q = qt.quat_from_axisangle(jnp.asarray(axis), jnp.asarray(angle))
    ref = np.asarray(qt.quat_rotate(q, jnp.asarray(v)))
    np.testing.assert_allclose(out, ref, atol=1e-12)
    R = np.asarray(qt.axisangle_to_R(jnp.asarray(axis), jnp.asarray(angle)))
    np.testing.assert_allclose((R @ v.T).T, ref, atol=1e-12)


def test_pose_pos_quat_pack():
    rng = np.random.default_rng(8)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    pos = rng.normal(size=3)
    pose = qt.pose_from_pos_quat(jnp.asarray(pos), jnp.asarray(q))
    p2, q2 = qt.pose_to_pos_quat(pose)
    np.testing.assert_allclose(np.asarray(p2), pos)
    np.testing.assert_allclose(np.asarray(q2), q)
    d, R = qt.pose_to_dR(pose)
    np.testing.assert_allclose(np.asarray(d), pos)
    np.testing.assert_allclose(np.asarray(R),
                               np.asarray(qt.quat_to_R(jnp.asarray(q))))


def test_pose_from_op():
    """+Z points from 'from' to 'to'; frame is orthonormal; length is
    the separation (kin.c:772-844), including the |z_x|>0.9 branch."""
    rng = np.random.default_rng(9)
    cases = [(rng.normal(size=3), rng.normal(size=3)),
             (np.zeros(3), np.array([5.0, 0.01, 0.0])),   # x-dominant branch
             (np.ones(3), np.array([1.0, 2.0, 1.0]))]
    for frm, to in cases:
        pose, length = qt.pose_from_op(jnp.asarray(frm), jnp.asarray(to))
        pose = np.asarray(pose)
        np.testing.assert_allclose(float(length), np.linalg.norm(to - frm),
                                   atol=1e-12)
        np.testing.assert_allclose(pose[:3], frm, atol=1e-12)
        R = np.asarray(qt.quat_to_R(jnp.asarray(pose[3:])))
        np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-9)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-9)
        np.testing.assert_allclose(R[:, 2], (to - frm) / np.linalg.norm(to - frm),
                                   atol=1e-9)
