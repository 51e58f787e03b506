"""Batched spatial (6-D motion/force) vector algebra.

Full parity with libcd's cd_spatial layer (spatial.h:29-69):
 - motion/force transforms ↔ pose    (spatial.c:33-135)
 - spatial inertia transform          (spatial.c:137-149)
 - se(3) exponential map              (spatial.c:152-248)
 - X-inversion, v/f point shifts      (spatial.c:251-290)
 - pose-velocity Jacobian + inverse   (spatial.c:295-375)
 - inertia from/to COM, solid sphere  (spatial.c:377-471)
 - v × Iv bias force                  (spatial.c:473-482)
 - spatial spring-damper              (spatial.c:484-608)
 - cross-product matrices             (spatial.c:610-669)

Spatial vectors are ordered [angular(3); linear(3)], matching the
reference's convention (rows 0-2 angular, 3-5 linear).
All functions broadcast over leading batch axes and contain no
data-dependent control flow (singularities handled with ``where``),
so they vmap/jit cleanly.
"""

from __future__ import annotations

import jax.numpy as jnp

from or_cdchomp_jax.ops.quat import (
    quat_compose as _quat_compose, quat_from_axisangle, quat_from_R,
    quat_invert, quat_rotate, quat_to_R)


def _mm(a, b):
    # full float32 precision: a GPU may otherwise run the product in TF32
    return jnp.matmul(a, b, precision="highest")


def cross_mat(v):
    """Skew-symmetric matrix [v]x, (..., 3, 3). (spatial.c:610-637)"""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def xm_from_pose(pose):
    """Spatial motion transform (..., 6, 6) from pose.

    Layout (spatial.c:71-102)::

        [ R      0 ]
        [ [r]x R R ]
    """
    R = quat_to_R(pose[..., 3:])
    rx = cross_mat(pose[..., :3])
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, zero], axis=-1)
    bottom = jnp.concatenate([_mm(rx, R), R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def _unskew(m):
    """Extract v from [v]x (averaging the antisymmetric pair)."""
    return 0.5 * jnp.stack(
        [m[..., 2, 1] - m[..., 1, 2],
         m[..., 0, 2] - m[..., 2, 0],
         m[..., 1, 0] - m[..., 0, 1]], axis=-1)


def xm_to_pose(xm):
    """Recover pose from a spatial motion transform. (spatial.c:33-51)

    r from [r]x = BL·Rᵀ; quaternion from the top-left R.
    """
    R = xm[..., 0:3, 0:3]
    rx = _mm(xm[..., 3:6, 0:3], jnp.swapaxes(R, -1, -2))
    r = _unskew(rx)
    return jnp.concatenate([r, quat_from_R(R)], axis=-1)


def xf_from_pose(pose):
    """Spatial force transform (..., 6, 6) from pose. (spatial.c:105-135)

    Layout::

        [ R  [r]x R ]
        [ 0      R  ]
    """
    R = quat_to_R(pose[..., 3:])
    rx = cross_mat(pose[..., :3])
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, _mm(rx, R)], axis=-1)
    bottom = jnp.concatenate([zero, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def xf_to_pose(xf):
    """Recover pose from a spatial force transform. (spatial.c:53-69)"""
    R = xf[..., 0:3, 0:3]
    rx = _mm(xf[..., 0:3, 3:6], jnp.swapaxes(R, -1, -2))
    r = _unskew(rx)
    return jnp.concatenate([r, quat_from_R(R)], axis=-1)


def inertia_x(pose_ab, inertia_b):
    """Transform a 6×6 spatial inertia from frame b to frame a:
    I_a = Xm_baᵀ · I_b · Xm_ba. (spatial.c:137-149)"""
    from or_cdchomp_jax.ops.quat import pose_invert
    xm_ba = xm_from_pose(pose_invert(pose_ab))
    return _mm(jnp.swapaxes(xm_ba, -1, -2), _mm(inertia_b, xm_ba))


def pose_from_spavel_unittime(spavel):
    """se(3) exponential map: twist → pose after unit time.
    (spatial.c:152-198; small-angle branch via Taylor series, selected
    with ``where`` instead of an if.)"""
    w = spavel[..., :3]
    v = spavel[..., 3:]
    w2 = jnp.sum(w * w, axis=-1)
    wdotv = jnp.sum(w * v, axis=-1)
    small = w2 < 1e-7

    # Taylor-series coefficients (small ‖w‖)
    c_cross_s = 0.5 - w2 / 24.0 + w2 ** 2 / 720.0 - w2 ** 3 / 40320.0
    c_v_s = 1.0 - w2 / 6.0 + w2 ** 2 / 120.0 - w2 ** 3 / 5040.0
    c_w_s = (1.0 / 6.0 - w2 / 120.0 + w2 ** 2 / 5040.0
             - w2 ** 3 / 362880.0) * wdotv
    # quaternion via series: q = [w·sinc(θ/2)/2 …, cos(θ/2)]
    qv_s = 0.5 - w2 / 48.0 + w2 ** 2 / 3840.0 - w2 ** 3 / 645120.0
    qw_s = 1.0 - w2 / 8.0 + w2 ** 2 / 384.0 - w2 ** 3 / 46080.0
    q_small = jnp.concatenate(
        [qv_s[..., None] * w, qw_s[..., None]], axis=-1)

    # exact coefficients (guarded against w2 == 0)
    w2_safe = jnp.where(small, 1.0, w2)
    th = jnp.sqrt(w2_safe)
    c_cross_e = (1.0 - jnp.cos(th)) / w2_safe
    c_v_e = jnp.sin(th) / th
    c_w_e = (1.0 - c_v_e) * wdotv / w2_safe
    q_exact = quat_from_axisangle(w / th[..., None], th)

    c_cross = jnp.where(small, c_cross_s, c_cross_e)[..., None]
    c_v = jnp.where(small, c_v_s, c_v_e)[..., None]
    c_w = jnp.where(small, c_w_s, c_w_e)[..., None]
    q = jnp.where(small[..., None], q_small, q_exact)

    pos = c_cross * jnp.cross(w, v) + c_v * v + c_w * w
    return jnp.concatenate([pos, q], axis=-1)


def H_from_spavel_unittime(spavel):
    """se(3) exp map as a homogeneous matrix:
    H = I + S + s2·S² + s3·S³ with S the 4×4 screw matrix.
    (spatial.c:200-248)"""
    w = spavel[..., :3]
    w2 = jnp.sum(w * w, axis=-1)
    small = w2 < 1e-7
    w2_safe = jnp.where(small, 1.0, w2)
    th = jnp.sqrt(w2_safe)
    s2 = jnp.where(small,
                   0.5 - w2 / 24.0 + w2 ** 2 / 720.0 - w2 ** 3 / 40320.0,
                   (1.0 - jnp.cos(th)) / w2_safe)
    s3 = jnp.where(small,
                   1.0 / 6.0 - w2 / 120.0 + w2 ** 2 / 5040.0
                   - w2 ** 3 / 362880.0,
                   (th - jnp.sin(th)) / (th * w2_safe))
    batch = spavel.shape[:-1]
    S = jnp.zeros(batch + (4, 4), dtype=spavel.dtype)
    S = S.at[..., :3, :3].set(cross_mat(w))
    S = S.at[..., :3, 3].set(spavel[..., 3:])
    S2 = _mm(S, S)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=spavel.dtype), S.shape)
    return (eye + S + s2[..., None, None] * S2
            + s3[..., None, None] * _mm(S, S2))


def x_invert(x):
    """Invert a spatial transform by transposing each 3×3 block.
    (spatial.c:251-268)"""
    blocks = x.reshape(x.shape[:-2] + (2, 3, 2, 3))
    return jnp.swapaxes(blocks, -1, -3).reshape(x.shape)


def v_to_pos(vel, pos):
    """Re-express a spatial velocity at a point: lin += w × pos.
    (spatial.c:270-274; cd_mat_cross accumulates, mat.c:126-132)"""
    return jnp.concatenate(
        [vel[..., :3], vel[..., 3:] + jnp.cross(vel[..., :3], pos)], axis=-1)


def v_from_pos(vel, pos):
    """Inverse point shift: lin += pos × w. (spatial.c:276-280)"""
    return jnp.concatenate(
        [vel[..., :3], vel[..., 3:] + jnp.cross(pos, vel[..., :3])], axis=-1)


def f_to_pos(force, pos):
    """Spatial force point shift: ang += f × pos. (spatial.c:282-286)"""
    return jnp.concatenate(
        [force[..., :3] + jnp.cross(force[..., 3:], pos), force[..., 3:]],
        axis=-1)


def f_from_pos(force, pos):
    """Inverse force point shift: ang += pos × f. (spatial.c:288-292)"""
    return jnp.concatenate(
        [force[..., :3] + jnp.cross(pos, force[..., 3:]), force[..., 3:]],
        axis=-1)


def pose_jac(pose):
    """Jacobian mapping pose7 derivatives to world spatial velocity.

    (..., 6, 7); rows 0-2 angular, 3-5 linear. (spatial.c:295-337)
    """
    x, y, z = pose[..., 0], pose[..., 1], pose[..., 2]
    qxt2 = 2.0 * pose[..., 3]
    qyt2 = 2.0 * pose[..., 4]
    qzt2 = 2.0 * pose[..., 5]
    qwt2 = 2.0 * pose[..., 6]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows = [
        # angular rows: d(omega)/d(x y z qx qy qz qw)
        [zero, zero, zero, qwt2, -qzt2, qyt2, -qxt2],
        [zero, zero, zero, qzt2, qwt2, -qxt2, -qyt2],
        [zero, zero, zero, -qyt2, qxt2, qwt2, -qzt2],
        # linear rows
        [one, zero, zero, -z * qzt2 - y * qyt2, -z * qwt2 + y * qxt2,
         z * qxt2 + y * qwt2, z * qyt2 - y * qzt2],
        [zero, one, zero, z * qwt2 + x * qyt2, -z * qzt2 - x * qxt2,
         z * qyt2 - x * qwt2, -z * qxt2 + x * qzt2],
        [zero, zero, one, -y * qwt2 + x * qzt2, y * qzt2 + x * qwt2,
         -y * qyt2 - x * qxt2, y * qxt2 - x * qyt2],
    ]
    J = jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)
    return J


def pose_jac_inverse(pose):
    """Pseudo-inverse Jacobian: world spatial velocity → pose7 rates.

    (..., 7, 6). (spatial.c:339-375)
    """
    x, y, z = pose[..., 0], pose[..., 1], pose[..., 2]
    qxd2 = 0.5 * pose[..., 3]
    qyd2 = 0.5 * pose[..., 4]
    qzd2 = 0.5 * pose[..., 5]
    qwd2 = 0.5 * pose[..., 6]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows = [
        [zero, z, -y, one, zero, zero],
        [-z, zero, x, zero, one, zero],
        [y, -x, zero, zero, zero, one],
        [qwd2, qzd2, -qyd2, zero, zero, zero],
        [-qzd2, qwd2, qxd2, zero, zero, zero],
        [qyd2, -qxd2, qwd2, zero, zero, zero],
        [-qxd2, -qyd2, -qzd2, zero, zero, zero],
    ]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def inertia_from_com(mass, com, Icom):
    """6×6 spatial inertia from mass, COM offset and COM-frame rotational
    inertia (spatial.c:377-423)::

        [ Icom + m·[c]x[c]xᵀ   m·[c]x ]
        [ m·[c]xᵀ              m·I    ]
    """
    mass = jnp.asarray(mass)
    com = jnp.asarray(com)
    Icom = jnp.asarray(Icom)
    cx = cross_mat(com)
    m_ = mass[..., None, None]
    tl = Icom + m_ * _mm(cx, jnp.swapaxes(cx, -1, -2))
    tr = m_ * cx
    bl = m_ * jnp.swapaxes(cx, -1, -2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=tl.dtype), tl.shape)
    br = m_ * eye
    top = jnp.concatenate([tl, tr], axis=-1)
    bottom = jnp.concatenate([bl, br], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def inertia_to_com(inertia):
    """Decompose a 6×6 spatial inertia → (mass, com, Icom).
    (spatial.c:425-461; note the reference's Icom[0][0] line has a
    ``-+`` typo that still parses as subtraction — behavior matched,
    not the typo.)"""
    mass = (inertia[..., 3, 3] + inertia[..., 4, 4] + inertia[..., 5, 5]) / 3.0
    # COM from the antisymmetric off-diagonal blocks (averaged)
    com = (_unskew(inertia[..., 0:3, 3:6])
           + _unskew(jnp.swapaxes(inertia[..., 3:6, 0:3], -1, -2))) \
        / (2.0 * mass[..., None])
    cx = cross_mat(com)
    Icom = inertia[..., 0:3, 0:3] - mass[..., None, None] * (
        _mm(cx, jnp.swapaxes(cx, -1, -2)))
    return mass, com, Icom


def inertia_sphere_solid(pos, mass, radius):
    """Spatial inertia of a solid sphere at ``pos``. (spatial.c:463-471)"""
    mass = jnp.asarray(mass)
    radius = jnp.asarray(radius)
    Ielem = 0.4 * mass * radius * radius
    eye = jnp.eye(3, dtype=jnp.result_type(mass, radius, jnp.float32))
    Icom = Ielem[..., None, None] * eye
    return inertia_from_com(mass, pos, Icom)


def vxIv(v, I):
    """Velocity-product bias force v ×* (I·v). (spatial.c:473-482)

    result = [w × (Iv)_ang + vlin × (Iv)_lin ; w × (Iv)_lin]
    """
    Iv = jnp.einsum("...ij,...j->...i", I, v, precision="highest")
    w, vlin = v[..., :3], v[..., 3:]
    ang = jnp.cross(w, Iv[..., :3]) + jnp.cross(vlin, Iv[..., 3:])
    lin = jnp.cross(w, Iv[..., 3:])
    return jnp.concatenate([ang, lin], axis=-1)


def spring_damper(pose, vel, pose_ref, vel_ref=None,
                  Klin=0.0, Blin=0.0, Kang=0.0, Bang=0.0):
    """Spatial PD spring-damper wrench pulling ``pose`` toward
    ``pose_ref``. (spatial.c:484-608)

    vel/vel_ref are world-frame spatial velocities at the origin; the
    returned 6-vector is the world wrench [torque; force] at the origin
    (the reference *accumulates* into its ``force`` argument — here the
    increment is returned).
    """
    p, q = pose[..., :3], pose[..., 3:]
    w = vel[..., :3]
    # linear velocity of the body point: v + w×p (spatial.c:517-519,
    # cvx = vel[3] + cz*cwy - cy*cwz = vel[3] + (w×p)_x)
    v_at_body = vel[..., 3:] + jnp.cross(w, p)
    rp, rq = pose_ref[..., :3], pose_ref[..., 3:]
    if vel_ref is None:
        rw = jnp.zeros_like(w)
        rv_at_body = jnp.zeros_like(v_at_body)
    else:
        rw = vel_ref[..., :3]
        rv_at_body = vel_ref[..., 3:] + jnp.cross(rw, rp)

    # orientation error as a world-frame rotation vector
    q_err = _quat_compose(quat_invert(rq), q)
    qw = jnp.clip(q_err[..., 3], -1.0, 1.0)
    sin_half = jnp.sqrt(jnp.maximum(1.0 - qw * qw, 0.0))
    angle = 2.0 * jnp.arccos(qw)
    scale = jnp.where(sin_half < 1e-12, 0.0,
                      angle / jnp.where(sin_half < 1e-12, 1.0, sin_half))
    aa_ref = scale[..., None] * q_err[..., :3]
    aa_world = quat_rotate(rq, aa_ref)

    f = -Klin * (p - rp) - Blin * (v_at_body - rv_at_body)
    n = -Kang * aa_world - Bang * (w - rw) + jnp.cross(p, f)
    return jnp.concatenate([n, f], axis=-1)


def mat_crossf(v):
    """Spatial force cross matrix [v ×*] (..., 6, 6). (spatial.c:643-669)

    Layout::

        [ [w]x  [v]x ]
        [  0    [w]x ]
    """
    wx = cross_mat(v[..., :3])
    vx = cross_mat(v[..., 3:])
    zero = jnp.zeros_like(wx)
    top = jnp.concatenate([wx, vx], axis=-1)
    bottom = jnp.concatenate([zero, wx], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def mat_crossm(v):
    """Spatial motion cross matrix [v ×] (..., 6, 6) — the dual of
    mat_crossf (crossf = −crossmᵀ)::

        [ [w]x   0   ]
        [ [v]x  [w]x ]
    """
    wx = cross_mat(v[..., :3])
    vx = cross_mat(v[..., 3:])
    zero = jnp.zeros_like(wx)
    top = jnp.concatenate([wx, zero], axis=-1)
    bottom = jnp.concatenate([vx, wx], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)
