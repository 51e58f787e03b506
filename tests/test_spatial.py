"""Spatial-algebra tests: pose_jac vs finite differences, inverse."""

import numpy as np
import jax.numpy as jnp

from or_cdchomp_jax.ops import quat as qt
from or_cdchomp_jax.ops import spatial as sp

RNG = np.random.default_rng(1)


def rand_pose():
    q = RNG.normal(size=4)
    q /= np.linalg.norm(q)
    return np.concatenate([RNG.normal(size=3), q])


def test_pose_jac_inverse_is_right_inverse():
    """pose_jac (6×7) ∘ pose_jac_inverse (7×6) = I₆ for unit-quat poses
    (spatial.c:295-375)."""
    for _ in range(5):
        p = jnp.asarray(rand_pose())
        J = np.asarray(sp.pose_jac(p))
        Jinv = np.asarray(sp.pose_jac_inverse(p))
        np.testing.assert_allclose(J @ Jinv, np.eye(6), atol=1e-9)


def test_pose_jac_semantics():
    """Angular rows: ω = 2·q̇·q⁻¹ (vector part).  Linear rows:
    v = ṗ − ω×p — spatial velocity of the body-fixed point at the
    world origin (spatial.c:295-337)."""
    p = rand_pose()
    J = np.asarray(sp.pose_jac(jnp.asarray(p[None])))[0]
    q = p[3:]
    # angular columns: per quat component k, ω_k = 2 · (e_k ⊗ q⁻¹)_vec
    for k in range(4):
        dq = np.zeros(4)
        dq[k] = 1.0
        om = 2.0 * np.asarray(qt.quat_compose(
            jnp.asarray(dq[None]), qt.quat_invert(jnp.asarray(q[None]))))[0, :3]
        np.testing.assert_allclose(J[:3, 3 + k], om, atol=1e-12)
    np.testing.assert_allclose(J[:3, :3], 0, atol=1e-12)
    # linear block: identity for position, −ω×p for quat columns
    np.testing.assert_allclose(J[3:, :3], np.eye(3), atol=1e-12)
    pred = -np.cross(J[:3, 3:].T, p[:3]).T
    np.testing.assert_allclose(J[3:, 3:], pred, atol=1e-12)


def test_xm_from_pose_blocks():
    p = jnp.asarray(rand_pose())
    X = np.asarray(sp.xm_from_pose(p))
    R = np.asarray(qt.quat_to_R(p[3:]))
    np.testing.assert_allclose(X[:3, :3], R, atol=1e-12)
    np.testing.assert_allclose(X[3:, 3:], R, atol=1e-12)
    np.testing.assert_allclose(X[:3, 3:], 0, atol=1e-12)
    rx = np.asarray(sp.cross_mat(p[:3]))
    np.testing.assert_allclose(X[3:, :3], rx @ R, atol=1e-12)


def test_x_pose_roundtrips():
    """xm/xf ↔ pose round-trips (spatial.c:33-135)."""
    for _ in range(4):
        p = rand_pose()
        p[3:] *= np.sign(p[6]) or 1.0  # canonical sign for comparison
        pm = np.array(sp.xm_to_pose(sp.xm_from_pose(jnp.asarray(p))))
        pf = np.array(sp.xf_to_pose(sp.xf_from_pose(jnp.asarray(p))))
        for out in (pm, pf):
            if np.dot(out[3:], p[3:]) < 0:
                out[3:] = -out[3:]
            np.testing.assert_allclose(out, p, atol=1e-9)


def test_x_invert():
    """X⁻¹ = per-block transpose for motion transforms of pure
    rotations; general identity Xm(pose)·x_invert-of-Xf(pose)ᵀ… checked
    via Xm(p)⁻¹ = Xm(p⁻¹) (spatial.c:251-268)."""
    p = rand_pose()
    Xm = np.asarray(sp.xm_from_pose(jnp.asarray(p)))
    Xm_inv = np.asarray(sp.xm_from_pose(qt.pose_invert(jnp.asarray(p))))
    np.testing.assert_allclose(Xm @ Xm_inv, np.eye(6), atol=1e-9)
    # x_invert transposes each 3x3 block
    Xi = np.asarray(sp.x_invert(jnp.asarray(Xm)))
    for bi in range(2):
        for bj in range(2):
            np.testing.assert_allclose(
                Xi[3 * bi:3 * bi + 3, 3 * bj:3 * bj + 3],
                Xm[3 * bi:3 * bi + 3, 3 * bj:3 * bj + 3].T, atol=1e-12)


def test_se3_expmap_consistency():
    """pose_from_spavel_unittime agrees with H_from_spavel_unittime,
    including the small-angle branch (spatial.c:152-248)."""
    for tw in [RNG.normal(size=6), np.array([1e-5, -2e-5, 1e-5, 0.3, -0.1, 0.2]),
               np.zeros(6)]:
        pose = np.asarray(sp.pose_from_spavel_unittime(jnp.asarray(tw)))
        H = np.asarray(sp.H_from_spavel_unittime(jnp.asarray(tw)))
        Hp = np.asarray(qt.pose_to_H(jnp.asarray(pose)))
        np.testing.assert_allclose(Hp, H, atol=1e-8)


def test_se3_expmap_pure_rotation_and_translation():
    w = np.array([0.0, 0.0, 0.7, 0.0, 0.0, 0.0])
    pose = np.asarray(sp.pose_from_spavel_unittime(jnp.asarray(w)))
    np.testing.assert_allclose(pose[:3], 0.0, atol=1e-12)
    np.testing.assert_allclose(pose[3:], [0, 0, np.sin(0.35), np.cos(0.35)],
                               atol=1e-12)
    v = np.array([0.0, 0.0, 0.0, 1.0, 2.0, 3.0])
    pose = np.asarray(sp.pose_from_spavel_unittime(jnp.asarray(v)))
    np.testing.assert_allclose(pose[:3], v[3:], atol=1e-9)
    np.testing.assert_allclose(pose[3:], [0, 0, 0, 1], atol=1e-9)


def test_point_shifts_roundtrip():
    """v_to_pos/v_from_pos and f_to_pos/f_from_pos are inverse pairs
    (spatial.c:270-292)."""
    v = jnp.asarray(RNG.normal(size=6))
    pos = jnp.asarray(RNG.normal(size=3))
    np.testing.assert_allclose(
        np.asarray(sp.v_from_pos(sp.v_to_pos(v, pos), pos)),
        np.asarray(v), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(sp.f_from_pos(sp.f_to_pos(v, pos), pos)),
        np.asarray(v), atol=1e-12)


def test_inertia_roundtrip_and_transform():
    """inertia_from_com ↔ inertia_to_com round-trip; inertia_x preserves
    kinetic energy ½vᵀIv (spatial.c:137-149, 377-461)."""
    mass = 2.5
    com = RNG.normal(size=3)
    A = RNG.normal(size=(3, 3))
    Icom = A @ A.T + 3.0 * np.eye(3)
    I6 = np.asarray(sp.inertia_from_com(mass, jnp.asarray(com),
                                        jnp.asarray(Icom)))
    m2, c2, Ic2 = sp.inertia_to_com(jnp.asarray(I6))
    np.testing.assert_allclose(float(m2), mass, atol=1e-12)
    np.testing.assert_allclose(np.asarray(c2), com, atol=1e-12)
    np.testing.assert_allclose(np.asarray(Ic2), Icom, atol=1e-9)

    p = rand_pose()
    Ia = np.asarray(sp.inertia_x(jnp.asarray(p), jnp.asarray(I6)))
    v_a = RNG.normal(size=6)
    Xm_ba = np.asarray(sp.xm_from_pose(qt.pose_invert(jnp.asarray(p))))
    v_b = Xm_ba @ v_a
    np.testing.assert_allclose(v_a @ Ia @ v_a, v_b @ I6 @ v_b, rtol=1e-9)


def test_inertia_sphere_solid():
    I6 = np.asarray(sp.inertia_sphere_solid(jnp.zeros(3), 2.0, 0.5))
    np.testing.assert_allclose(I6[:3, :3], 0.4 * 2.0 * 0.25 * np.eye(3),
                               atol=1e-12)
    np.testing.assert_allclose(I6[3:, 3:], 2.0 * np.eye(3), atol=1e-12)


def test_vxIv_orthogonal_to_velocity_rotation():
    """For a pure angular velocity, the bias force does no work:
    ωᵀ·(v×*Iv)_ang = 0 (spatial.c:473-482)."""
    I6 = np.asarray(sp.inertia_sphere_solid(
        jnp.asarray(RNG.normal(size=3)), 1.5, 0.3))
    w = RNG.normal(size=3)
    v = np.concatenate([w, np.zeros(3)])
    out = np.asarray(sp.vxIv(jnp.asarray(v), jnp.asarray(I6)))
    np.testing.assert_allclose(w @ out[:3], 0.0, atol=1e-9)


def test_spring_damper_restoring():
    """At rest and displaced, the wrench pulls back toward the
    reference (spatial.c:484-608)."""
    ref = np.array([0.0, 0, 0, 0, 0, 0, 1.0])
    cur = np.array([0.1, 0, 0, 0, 0, 0, 1.0])
    f = np.asarray(sp.spring_damper(
        jnp.asarray(cur), jnp.zeros(6), jnp.asarray(ref),
        Klin=10.0, Blin=1.0, Kang=5.0, Bang=0.5))
    np.testing.assert_allclose(f[3:], [-1.0, 0, 0], atol=1e-12)
    # rotated about z by 0.2 rad → restoring torque about −z
    q = np.array([0, 0, np.sin(0.1), np.cos(0.1)])
    cur2 = np.concatenate([np.zeros(3), q])
    f2 = np.asarray(sp.spring_damper(
        jnp.asarray(cur2), jnp.zeros(6), jnp.asarray(ref),
        Klin=10.0, Blin=1.0, Kang=5.0, Bang=0.5))
    np.testing.assert_allclose(f2[:3], [0, 0, -5.0 * 0.2], atol=1e-9)
    np.testing.assert_allclose(f2[3:], 0.0, atol=1e-12)


def _spring_damper_ref(pose, vel, pose_ref, vel_ref, Klin, Blin, Kang, Bang):
    """Scalar transcription of spatial.c:484-608 (float64)."""
    cx, cy, cz, cqx, cqy, cqz, cqw = pose
    cwx, cwy, cwz = vel[:3]
    cvx = vel[3] + cz * cwy - cy * cwz
    cvy = vel[4] - cz * cwx + cx * cwz
    cvz = vel[5] + cy * cwx - cx * cwy
    rx, ry, rz, rqx, rqy, rqz, rqw = pose_ref
    if vel_ref is not None:
        rwx, rwy, rwz = vel_ref[:3]
        rvx = vel_ref[3] + rz * rwy - ry * rwz
        rvy = vel_ref[4] - rz * rwx + rx * rwz
        rvz = vel_ref[5] + ry * rwx - rx * rwy
    else:
        rwx = rwy = rwz = rvx = rvy = rvz = 0.0
    rwqx, rwqy, rwqz, rwqw = -rqx, -rqy, -rqz, rqw
    rcqx = rwqw * cqx + rwqx * cqw + rwqy * cqz - rwqz * cqy
    rcqy = rwqw * cqy - rwqx * cqz + rwqy * cqw + rwqz * cqx
    rcqz = rwqw * cqz + rwqx * cqy - rwqy * cqx + rwqz * cqw
    rcqw = min(rwqw * cqw - rwqx * cqx - rwqy * cqy - rwqz * cqz, 1.0)
    denom = np.sqrt(1.0 - rcqw * rcqw)
    if denom == 0.0:
        raa = np.zeros(3)
    else:
        raa = 2.0 * np.arccos(rcqw) * np.array([rcqx, rcqy, rcqz]) / denom
    qx2, qy2, qz2, qw2 = rqx * rqx, rqy * rqy, rqz * rqz, rqw * rqw
    xy, xz, xw = rqx * rqy, rqx * rqz, rqx * rqw
    yz, yw, zw = rqy * rqz, rqy * rqw, rqz * rqw
    waa = np.array([
        raa[0] * (qx2 - qy2 - qz2 + qw2) + 2 * raa[1] * (xy - zw) + 2 * raa[2] * (xz + yw),
        2 * raa[0] * (xy + zw) + raa[1] * (-qx2 + qy2 - qz2 + qw2) + 2 * raa[2] * (yz - xw),
        2 * raa[0] * (xz - yw) + 2 * raa[1] * (yz + xw) + raa[2] * (-qx2 - qy2 + qz2 + qw2),
    ])
    fx = -Klin * (cx - rx) - Blin * (cvx - rvx)
    fy = -Klin * (cy - ry) - Blin * (cvy - rvy)
    fz = -Klin * (cz - rz) - Blin * (cvz - rvz)
    fnx = -Kang * waa[0] - Bang * (cwx - rwx) - cz * fy + cy * fz
    fny = -Kang * waa[1] - Bang * (cwy - rwy) + cz * fx - cx * fz
    fnz = -Kang * waa[2] - Bang * (cwz - rwz) - cy * fx + cx * fy
    return np.array([fnx, fny, fnz, fx, fy, fz])


def test_spring_damper_moving_matches_reference():
    """Nonzero angular velocity with the body off-origin: the Blin
    damping acts on v + w×p, the body-point velocity (spatial.c:517-519
    uses cvx = vel[3] + cz*cwy - cy*cwz)."""
    for seed in range(5):
        rng = np.random.default_rng(seed)
        pose = np.concatenate([rng.normal(size=3), rng.normal(size=4)])
        pose[3:] /= np.linalg.norm(pose[3:])
        pref = np.concatenate([rng.normal(size=3), rng.normal(size=4)])
        pref[3:] /= np.linalg.norm(pref[3:])
        vel = rng.normal(size=6)
        vref = rng.normal(size=6)
        for vr in (vref, None):
            want = _spring_damper_ref(pose, vel, pref, vr,
                                      10.0, 2.0, 5.0, 0.5)
            got = np.asarray(sp.spring_damper(
                jnp.asarray(pose), jnp.asarray(vel), jnp.asarray(pref),
                None if vr is None else jnp.asarray(vr),
                Klin=10.0, Blin=2.0, Kang=5.0, Bang=0.5))
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_cross_matrices():
    v = jnp.asarray(RNG.normal(size=6))
    u = jnp.asarray(RNG.normal(size=6))
    Cf = np.asarray(sp.mat_crossf(v))
    Cm = np.asarray(sp.mat_crossm(v))
    np.testing.assert_allclose(Cf, -Cm.T, atol=1e-12)
    # crossm action matches the cross-product definition
    w, vl = np.asarray(v[:3]), np.asarray(v[3:])
    uw, ul = np.asarray(u[:3]), np.asarray(u[3:])
    expect = np.concatenate([np.cross(w, uw), np.cross(vl, uw) + np.cross(w, ul)])
    np.testing.assert_allclose(Cm @ np.asarray(u), expect, atol=1e-12)
