"""Batched quaternion / pose7 algebra.

A ``pose`` is a length-7 vector ``[x, y, z, qx, qy, qz, qw]`` giving the
transform of frame B in frame A (position then unit quaternion).  All
functions operate on arrays whose *last* axis is the pose/quat axis and
broadcast over any leading batch axes — shaped for ``vmap``/``pjit``.

Behavioral parity with libcd's cd_kin quaternion/pose layer
(reference: src/libcd/kin.c:33-326 for identity/normalize/compose/
invert, kin.c:348-420 for R/H conversion, kin.c:585-752 for xyz-ypr and
its Jacobian).  Implemented from the underlying math, designed for
accelerators: pure elementwise arithmetic and small contractions, no
data-dependent control flow.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Structure tensors.
#
# The quaternion product, the quaternion sandwich rotation, and the
# quaternion→R conversion are bilinear/quadratic forms in the quaternion
# components.  Expressing them as einsum contractions against small
# constant tensors keeps each operation a *single* fused contraction in
# the compiled graph instead of dozens of scalar slice/mul/add ops —
# critical for XLA CPU (per-op dispatch overhead over deep FK chains).
# Every contraction asks for full float32 precision: a GPU may
# otherwise run a float32 dot in TF32, which keeps about 3 digits.
# Coefficients reproduce kin.c:117-136 (product), kin.c:389-420
# (rotate, pure quadratic form) and kin.c:348-368 (R, 1−2(...) form)
# exactly, up to float reassociation.
# ---------------------------------------------------------------------------

_X, _Y, _Z, _W = 0, 1, 2, 3


def _build_qmul():
    """M[k,i,j] with (a⊗b)[k] = Σ_ij M[k,i,j] a[i] b[j] (Hamilton)."""
    M = np.zeros((4, 4, 4))
    terms = {
        _X: [(_W, _X, 1), (_X, _W, 1), (_Y, _Z, 1), (_Z, _Y, -1)],
        _Y: [(_W, _Y, 1), (_X, _Z, -1), (_Y, _W, 1), (_Z, _X, 1)],
        _Z: [(_W, _Z, 1), (_X, _Y, 1), (_Y, _X, -1), (_Z, _W, 1)],
        _W: [(_W, _W, 1), (_X, _X, -1), (_Y, _Y, -1), (_Z, _Z, -1)],
    }
    for k, rows in terms.items():
        for i, j, s in rows:
            M[k, i, j] = s
    return M


def _build_qrot():
    """T[a,b,i,j] with R(q)[a,b] = Σ_ij T[a,b,i,j] q[i] q[j]; the pure
    quadratic sandwich form (exact for unit q), kin.c:389-420."""
    T = np.zeros((3, 3, 4, 4))
    # diagonal: x row -> (+xx -yy -zz +ww), cycled
    sgn = {
        (0, 0): (1, -1, -1, 1), (1, 1): (-1, 1, -1, 1), (2, 2): (-1, -1, 1, 1),
    }
    for (a, b), s in sgn.items():
        for c, sc in zip((_X, _Y, _Z, _W), s):
            T[a, b, c, c] = sc
    # off-diagonal: R[0,1] = 2(xy - zw), R[0,2] = 2(xz + yw),
    # R[1,0] = 2(xy + zw), R[1,2] = 2(yz - xw),
    # R[2,0] = 2(xz - yw), R[2,1] = 2(yz + xw)
    off = {
        (0, 1): [(_X, _Y, 2), (_Z, _W, -2)],
        (0, 2): [(_X, _Z, 2), (_Y, _W, 2)],
        (1, 0): [(_X, _Y, 2), (_Z, _W, 2)],
        (1, 2): [(_Y, _Z, 2), (_X, _W, -2)],
        (2, 0): [(_X, _Z, 2), (_Y, _W, -2)],
        (2, 1): [(_Y, _Z, 2), (_X, _W, 2)],
    }
    for (a, b), rows in off.items():
        for i, j, s in rows:
            # symmetrize so T contracts cleanly against q⊗q
            T[a, b, i, j] += s / 2.0
            T[a, b, j, i] += s / 2.0
    return T


def _build_qR():
    """T[a,b,i,j] with R(q) = I + Σ_ij T[a,b,i,j] q[i] q[j]; the
    1−2(...) form of kin.c:348-368 (also exact only for unit q)."""
    T = np.zeros((3, 3, 4, 4))
    diag = {0: (_Y, _Z), 1: (_X, _Z), 2: (_X, _Y)}
    for a, (i, j) in diag.items():
        T[a, a, i, i] = -2.0
        T[a, a, j, j] = -2.0
    off = {
        (0, 1): [(_X, _Y, 2), (_Z, _W, -2)],
        (0, 2): [(_X, _Z, 2), (_Y, _W, 2)],
        (1, 0): [(_X, _Y, 2), (_Z, _W, 2)],
        (1, 2): [(_Y, _Z, 2), (_X, _W, -2)],
        (2, 0): [(_X, _Z, 2), (_Y, _W, -2)],
        (2, 1): [(_Y, _Z, 2), (_X, _W, 2)],
    }
    for (a, b), rows in off.items():
        for i, j, s in rows:
            T[a, b, i, j] += s / 2.0
            T[a, b, j, i] += s / 2.0
    return T


_QMUL64 = _build_qmul()
_QROT64 = _build_qrot()
_QR64 = _build_qR()


def _const(arr64, dtype):
    return jnp.asarray(arr64, dtype=dtype)


def quat_identity(dtype=jnp.float32):
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def pose_identity(dtype=jnp.float32):
    return jnp.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_normalize(q):
    """Unit-normalize quaternion(s). (kin.c:55-62)"""
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def pose_normalize(pose):
    """Normalize the quaternion part of pose(s). (kin.c:64-70)"""
    pos, q = pose[..., :3], pose[..., 3:]
    return jnp.concatenate([pos, quat_normalize(q)], axis=-1)


def quat_flip_closerto(q, target):
    """Negate q where -q is closer (L2) to target. (kin.c:72-90)"""
    d_orig = jnp.sum((q - target) ** 2, axis=-1, keepdims=True)
    d_flip = jnp.sum((-q - target) ** 2, axis=-1, keepdims=True)
    return jnp.where(d_flip < d_orig, -q, q)


def pose_flip_closerto(pose, target):
    """Quaternion-flip pose(s) toward target pose(s). (kin.c:92-115)"""
    pos = pose[..., :3]
    q = quat_flip_closerto(pose[..., 3:], target[..., 3:])
    return jnp.concatenate([pos, q], axis=-1)


def quat_compose(qab, qbc):
    """Hamilton product q_ac = q_ab * q_bc. (kin.c:117-136)

    One einsum contraction against the constant (4,4,4) structure
    tensor — a single fused op per call instead of ~30 scalar ops,
    which keeps deep FK chains cheap to compile and execute."""
    M = _const(_QMUL64, jnp.result_type(qab, qbc))
    return jnp.einsum("kij,...i,...j->...k", M, qab, qbc,
                      precision="highest")


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by quaternion(s) q. (kin.c:389-420)

    v' = R(q)·v with R(q)[a,b] = Σ T[a,b,i,j] q_i q_j (the pure
    quadratic sandwich form) — two einsum contractions."""
    T = _const(_QROT64, jnp.result_type(q, v))
    R = jnp.einsum("abij,...i,...j->...ab", T, q, q, precision="highest")
    return jnp.einsum("...ab,...b->...a", R, v, precision="highest")


def quat_rotate_const(q, v_const):
    """Rotate a *constant* 3-vector by quaternion(s) q: the structure
    tensor is pre-contracted with v at trace time, so this is one
    quadratic einsum instead of two contractions — used by the reduced
    FK chain where every joint origin is a compile-time constant."""
    dtype = q.dtype
    Mv = jnp.einsum("abij,b->aij", _const(_QROT64, dtype),
                    jnp.asarray(v_const, dtype), precision="highest")
    return jnp.einsum("aij,...i,...j->...a", Mv, q, q, precision="highest")


def quat_compose_const(q, k_const):
    """Hamilton product q ⊗ k with *constant* k: pre-contracting the
    product tensor with k turns the compose into a single (..., 4)@(4,4)
    matmul."""
    dtype = q.dtype
    Mk = jnp.einsum("kij,j->ki", _const(_QMUL64, dtype),
                    jnp.asarray(k_const, dtype), precision="highest")
    return jnp.einsum("ki,...i->...k", Mk, q, precision="highest")


def pose_compose(pab, pbc):
    """Compose pose_ac = pose_ab ∘ pose_bc. (kin.c:138-212)"""
    q = quat_compose(pab[..., 3:], pbc[..., 3:])
    pos = quat_rotate(pab[..., 3:], pbc[..., :3]) + pab[..., :3]
    return jnp.concatenate([pos, q], axis=-1)


def pose_apply(pab, pos_bc):
    """Transform point(s): pos_ac = R_ab * pos_bc + t_ab. (kin.c:214-245)"""
    return quat_rotate(pab[..., 3:], pos_bc) + pab[..., :3]


def pose_rotate_vec(pab, vec_bc):
    """Rotate free vector(s) (velocity etc.) by pose rotation. (kin.c:247-271)"""
    return quat_rotate(pab[..., 3:], vec_bc)


def quat_invert(q):
    """Conjugate of unit quaternion(s). (kin.c:273-287)"""
    return jnp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def pose_invert(pose):
    """Invert pose(s). (kin.c:289-326)"""
    qinv = quat_invert(pose[..., 3:])
    pos = -quat_rotate(qinv, pose[..., :3])
    return jnp.concatenate([pos, qinv], axis=-1)


def quat_to_R(q):
    """Unit quaternion(s) → rotation matrix (..., 3, 3). (kin.c:348-368)

    R = I + Σ T[a,b,i,j] q_i q_j (the 1−2(...) form) as one einsum."""
    T = _const(_QR64, q.dtype)
    return jnp.eye(3, dtype=q.dtype) + jnp.einsum(
        "abij,...i,...j->...ab", T, q, q, precision="highest")


def quat_from_R(R):
    """Rotation matrix (..., 3, 3) → unit quaternion(s).

    Shepperd's branch-free-ish method (kin.c:422-508 uses the trace
    variant); here all four candidate solutions are computed and the
    best-conditioned (largest denominator) is selected with `where`,
    which is both numerically robust and branch-free on a device.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidates, indexed by which diagonal term dominates
    def cand_w():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, 1e-12)) * 2  # s = 4*qw
        return jnp.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1)

    def cand_x():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2
        return jnp.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)

    def cand_y():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2
        return jnp.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1)

    def cand_z():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2
        return jnp.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1)

    qw, qx, qy, qz = cand_w(), cand_x(), cand_y(), cand_z()
    # selection criteria
    use_w = (tr > 0.0)[..., None]
    x_max = ((m00 > m11) & (m00 > m22))[..., None]
    y_max = (m11 > m22)[..., None]
    q = jnp.where(use_w, qw, jnp.where(x_max, qx, jnp.where(y_max, qy, qz)))
    return quat_normalize(q)


def pose_to_H(pose):
    """Pose(s) → homogeneous matrix (..., 4, 4). (kin.c:470-508)"""
    R = quat_to_R(pose[..., 3:])
    t = pose[..., :3]
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def pose_from_H(H):
    """Homogeneous matrix (..., 4, 4) → pose(s)."""
    q = quat_from_R(H[..., :3, :3])
    return jnp.concatenate([H[..., :3, 3], q], axis=-1)


def pose_from_dR(d, R):
    """Position + rotation matrix → pose. (kin.c:510-517)"""
    return jnp.concatenate([d, quat_from_R(R)], axis=-1)


def quat_from_axisangle(axis, angle):
    """so(3) exp map. (kin.c:532-543)"""
    a2 = 0.5 * angle
    s = jnp.sin(a2)
    return jnp.concatenate(
        [s[..., None] * axis, jnp.cos(a2)[..., None]], axis=-1
    )


def quat_to_axisangle(q):
    """Unit quaternion → (axis, angle). (kin.c:519-530)"""
    a2 = jnp.arccos(jnp.clip(q[..., 3], -1.0, 1.0))
    s = jnp.sin(a2)
    safe = jnp.where(jnp.abs(s) < 1e-12, 1.0, s)
    axis = q[..., :3] / safe[..., None]
    axis = jnp.where(
        (jnp.abs(s) < 1e-12)[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], q.dtype), axis.shape),
        axis,
    )
    return axis, 2.0 * a2


def quat_to_ypr(q):
    """Quaternion → yaw-pitch-roll, with gimbal-lock guards.

    (kin.c:587-615; same ±0.49999 singularity thresholds.)
    """
    qx, qy, qz, qw = (q[..., i] for i in range(4))
    sinp2 = qw * qy - qz * qx
    yaw_n = jnp.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    pitch_n = jnp.arcsin(jnp.clip(2.0 * sinp2, -1.0, 1.0))
    roll_n = jnp.arctan2(2.0 * (qw * qx + qy * qz), 1.0 - 2.0 * (qx * qx + qy * qy))
    at = jnp.arctan2(qx, qw)
    qtr = jnp.pi / 2.0
    hi = sinp2 > 0.49999
    lo = sinp2 < -0.49999
    yaw = jnp.where(hi, -2.0 * at, jnp.where(lo, 2.0 * at, yaw_n))
    pitch = jnp.where(hi, qtr, jnp.where(lo, -qtr, pitch_n))
    roll = jnp.where(hi | lo, 0.0, roll_n)
    return jnp.stack([yaw, pitch, roll], axis=-1)


def pose_to_xyzypr(pose):
    """Pose → [x y z yaw pitch roll]. (kin.c:617-646)"""
    return jnp.concatenate([pose[..., :3], quat_to_ypr(pose[..., 3:])], axis=-1)


def quat_to_ypr_J(q):
    """d(ypr)/d(quat): (..., 3, 4). No gimbal-lock handling, matching
    the reference (kin.c:648-678)."""
    qx, qy, qz, qw = (q[..., i] for i in range(4))
    # yaw
    nu = 2.0 * (qw * qz + qx * qy)
    de = 1.0 - 2.0 * (qy * qy + qz * qz)
    den = de * de + nu * nu
    Jy = jnp.stack(
        [
            de / den * (2 * qy),
            de / den * (2 * qx) - nu / den * (-4 * qy),
            de / den * (2 * qw) - nu / den * (-4 * qz),
            de / den * (2 * qz),
        ],
        axis=-1,
    )
    # pitch
    asq = 2.0 * (qw * qy - qz * qx)
    inv = 1.0 / jnp.sqrt(jnp.maximum(1.0 - asq * asq, 1e-12))
    Jp = jnp.stack([inv * 2 * (-qz), inv * 2 * qw, inv * 2 * (-qx), inv * 2 * qy], axis=-1)
    # roll
    nu2 = 2.0 * (qw * qx + qy * qz)
    de2 = 1.0 - 2.0 * (qx * qx + qy * qy)
    den2 = de2 * de2 + nu2 * nu2
    Jr = jnp.stack(
        [
            de2 / den2 * (2 * qw) - nu2 / den2 * (-4 * qx),
            de2 / den2 * (2 * qz) - nu2 / den2 * (-4 * qy),
            de2 / den2 * (2 * qy),
            de2 / den2 * (2 * qx),
        ],
        axis=-1,
    )
    return jnp.stack([Jy, Jp, Jr], axis=-2)


def pose_to_xyzypr_J(pose):
    """d(xyzypr)/d(pose7): (..., 6, 7). (kin.c:680-715)"""
    q = pose[..., 3:]
    batch = pose.shape[:-1]
    Jq = quat_to_ypr_J(q)  # (..., 3, 4)
    J = jnp.zeros(batch + (6, 7), dtype=pose.dtype)
    eye = jnp.eye(3, dtype=pose.dtype)
    J = J.at[..., :3, :3].set(jnp.broadcast_to(eye, batch + (3, 3)))
    J = J.at[..., 3:, 3:].set(Jq)
    return J


def quat_from_ypr(ypr):
    """Yaw-pitch-roll → quaternion. (kin.c:717-731)"""
    cy2, sy2 = jnp.cos(0.5 * ypr[..., 0]), jnp.sin(0.5 * ypr[..., 0])
    cp2, sp2 = jnp.cos(0.5 * ypr[..., 1]), jnp.sin(0.5 * ypr[..., 1])
    cr2, sr2 = jnp.cos(0.5 * ypr[..., 2]), jnp.sin(0.5 * ypr[..., 2])
    return jnp.stack(
        [
            -sy2 * sp2 * cr2 + cy2 * cp2 * sr2,
            cy2 * sp2 * cr2 + sy2 * cp2 * sr2,
            -cy2 * sp2 * sr2 + sy2 * cp2 * cr2,
            sy2 * sp2 * sr2 + cy2 * cp2 * cr2,
        ],
        axis=-1,
    )


def pose_from_xyzypr(xyzypr):
    """[x y z yaw pitch roll] → pose. (kin.c:733-752)"""
    return jnp.concatenate([xyzypr[..., :3], quat_from_ypr(xyzypr[..., 3:])], axis=-1)


def axisangle_rotate(axis, angle, v):
    """Rotate vector(s) v about ``axis`` by ``angle`` (Rodrigues).
    (kin.c:545-560)"""
    c = jnp.cos(angle)[..., None]
    s = jnp.sin(angle)[..., None]
    return (v * c + jnp.cross(axis, v) * s
            + axis * (jnp.sum(axis * v, axis=-1, keepdims=True) * (1.0 - c)))


def axisangle_to_R(axis, angle):
    """Axis-angle → rotation matrix (..., 3, 3). (kin.c:562-583)"""
    return quat_to_R(quat_from_axisangle(axis, angle))


def pose_to_dR(pose):
    """Pose → (position (...,3), rotation matrix (...,3,3)).
    (kin.c:470-508 pose_to_dR path)"""
    return pose[..., :3], quat_to_R(pose[..., 3:])


def pose_to_pos_quat(pose):
    """Pose → (pos (...,3), quat (...,4)). (kin.c:754-761)"""
    return pose[..., :3], pose[..., 3:]


def pose_from_pos_quat(pos=None, quat=None, dtype=jnp.float32):
    """(pos, quat) → pose, either part defaulting to identity.
    (kin.c:762-770)"""
    if pos is None and quat is None:
        return pose_identity(dtype)
    if pos is None:
        pos = jnp.zeros(quat.shape[:-1] + (3,), dtype=quat.dtype)
    if quat is None:
        quat = jnp.broadcast_to(quat_identity(pos.dtype),
                                pos.shape[:-1] + (4,))
    return jnp.concatenate([pos, quat], axis=-1)


def pose_from_op(from_pos, to_pos):
    """Pose at ``from_pos`` whose +Z axis points at ``to_pos``; returns
    (pose, length).  (kin.c:772-786)"""
    return pose_from_op_diff(from_pos, to_pos - from_pos)


def pose_from_op_diff(from_pos, to_diff):
    """Pose at ``from_pos`` with +Z along ``to_diff``; returns
    (pose, ‖to_diff‖).  Frame completion picks the better-conditioned
    of two Gram-Schmidt branches with ``where`` — branch-free version
    of kin.c:788-844.
    """
    length = jnp.linalg.norm(to_diff, axis=-1)
    z = to_diff / length[..., None]
    zx, zy, zz = z[..., 0], z[..., 1], z[..., 2]

    # branch A (|z_x| > 0.9): X from e2 × Z, then Y = Z × X
    lenA = jnp.sqrt(zz * zz + zx * zx)
    xA = jnp.stack([zz / lenA, jnp.zeros_like(zz), -zx / lenA], axis=-1)
    yA = jnp.cross(z, xA)
    # branch B: Y from Z × e1, then X = Y × Z
    lenB = jnp.sqrt(zz * zz + zy * zy)
    yB = jnp.stack([jnp.zeros_like(zz), zz / lenB, -zy / lenB], axis=-1)
    xB = jnp.cross(yB, z)

    useA = (jnp.abs(zx) > 0.9)[..., None]
    x = jnp.where(useA, xA, xB)
    y = jnp.where(useA, yA, yB)
    R = jnp.stack([x, y, z], axis=-1)
    return pose_from_dR(from_pos, R), length
