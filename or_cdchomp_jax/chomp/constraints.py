"""TSR (Task Space Region) trajectory constraints + projection math.

The reference supports three kinds of hard constraints, all evaluated
as "selected xyz-ypr components of the pose of a virtual object in a
TSR frame" with an analytic Jacobian chain
(con_tsr orcdchomp_mod.cpp:1330-1497, con_everyn_tsr 1500-1657,
con_start_tsr 1659-1784):

    value = select(xyzypr( T0w⁻¹ ∘ pose_ee ∘ Twe⁻¹ ))
    J     = select( xyzypr_J · pose_jac⁻¹ · Xm(T0w⁻¹) · J_spatial )

A constrained dimension is one whose Bw bounds are both exactly zero
(orcdchomp_mod.cpp:2466-2518).  The per-iteration projection is the
goal-set CHOMP update (chomp.c:553-600): solve the dense
(J A⁻¹ Jᵀ)-weighted system over all constraint rows and push the
correction back through A⁻¹ columns.

Design: every constraint evaluates its full 6-dim value/Jacobian
(uniform shapes, vmappable); the *static* enabled-dimension masks then
gather the exact active rows into one concatenated system, so the
linear solve has a fixed size known at trace time.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from or_cdchomp_jax.chomp.problem import ChompProblem, ChompSpec

import os as _os

# scan unroll factor for the quasiseparable projection solve: each of
# the two C-length scans carries tiny (n, n)/(k,) state, so its cost is
# per-iteration loop overhead, not compute.  AUTO (0) fully unrolls up
# to _SSS_UNROLL_MAX points and falls back to 8 beyond (compile time
# grows with the unroll).  Not yet measured on the H100.
_SSS_UNROLL = int(_os.environ.get("CDX_SSS_UNROLL", "0"))
_SSS_UNROLL_MAX = 128


def _sss_unroll(C):
    if _SSS_UNROLL > 0:
        return min(_SSS_UNROLL, C)
    return C if C <= _SSS_UNROLL_MAX else 8
from or_cdchomp_jax.ops import quat as qt
from or_cdchomp_jax.ops import spatial as sp

# Bw-row order is (x y z roll pitch yaw); xyzypr order is
# (x y z yaw pitch roll): dims 3..5 flip via 8-i (orcdchomp_mod.cpp:1413)
_DIM_MAP = np.array([0, 1, 2, 5, 4, 3])


def _spd_solve(M, b):
    """Solve M x = b for symmetric positive-definite M via Cholesky.

    JAJᵀ = J·A⁻¹·Jᵀ is SPD (A is SPD; J has full row rank whenever the
    constraint system the reference's dgesv solves is non-singular,
    chomp.c:579-581), so Cholesky computes the same solution without
    LU's pivoting."""
    L = jnp.linalg.cholesky(M)
    y = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
    return jax.scipy.linalg.solve_triangular(L, y, lower=True,
                                             trans=1)[..., 0]


def _chol_unrolled(S, k):
    """Cholesky of a (k, k) block as k² unrolled scalar ops (k is
    static and ≤6; jnp.linalg.cholesky on tiny matrices lowers to a
    serialized blocked loop that cannot fuse into the scan body)."""
    L = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            acc = S[..., i, j]
            for t in range(j):
                acc = acc - L[i][t] * L[j][t]
            L[i][j] = jnp.sqrt(acc) if i == j else acc / L[j][j]
    return L


def _fwd_sub(L, b, k):
    """y = L⁻¹ b, unrolled; b is a list of k scalars."""
    y = [None] * k
    for i in range(k):
        acc = b[i]
        for t in range(i):
            acc = acc - L[i][t] * y[t]
        y[i] = acc / L[i][i]
    return y


def _bwd_sub(L, b, k):
    """x = L⁻ᵀ b, unrolled."""
    x = [None] * k
    for i in reversed(range(k)):
        acc = b[i]
        for t in range(i + 1, k):
            acc = acc - L[t][i] * x[t]
        x[i] = acc / L[i][i]
    return x


def _sss_solve(J, h, alpha, beta):
    """Exact O(C) solve of (Ainv ∘ JJᵀ) x = h for the D=1 metric.

    The default metric's inverse is semiseparable:
    Ainv[a, b] = α_min(a,b) · β_max(a,b) with α_p = dt²(p+1),
    β_p = m − p (metric.sep_ainv_entries).  The projection system's
    blocks therefore factor as M_ab = (α_a J_a)(β_b J_b)ᵀ for a ≤ b —
    a symmetric block-quasiseparable matrix of generator rank n.  Its
    Cholesky factor inherits the structure: G_ab = V_a Z_bᵀ (a > b)
    with V_a = β_a J_a and per-block (k, k) diagonal factors, so the
    factorization + both triangular solves run as two lax.scans over
    the C constraint points carrying only an (n, n) accumulator — no
    (C·k)² matrix is ever built and no dense factorization runs.  Exact
    same math as the reference's dgesv solve (chomp.c:579-581),
    reorganized.

    J: (C, k, n); h: (C, k); alpha, beta: (C,).  Returns x (C, k).
    """
    C, k, n = J.shape

    def fwd(carry, inp):
        P, s = carry                             # (n, n), (n,)
        Jb, hb, al, be = inp
        Vb = be * Jb                             # (k, n)
        # all contractions are broadcast-sum over n (tiny-K batched
        # dots would lower to many tiny matrix products)
        PV = jnp.sum(P[:, None, :] * Vb[None, :, :], axis=-1)   # (n, k)
        JJ = jnp.sum(Jb[:, None, :] * Jb[None, :, :], axis=-1)  # (k, k)
        VPV = jnp.sum(Vb[:, None, :] * PV.T[None, :, :], axis=-1)
        S = al * be * JJ - VPV                   # (k, k) Schur block
        L = _chol_unrolled(S, k)
        # Zᵀ = (Ubᵀ − P Vbᵀ) L⁻ᵀ, column-unrolled   (n, k)
        W = al * Jb.T - PV                       # Ubᵀ − P Vbᵀ  (n, k)
        Zcols = [None] * k
        for j in range(k):
            acc = W[:, j]
            for t in range(j):
                acc = acc - L[j][t] * Zcols[t]
            Zcols[j] = acc / L[j][j]
        ZT = jnp.stack(Zcols, axis=-1)           # (n, k)
        fb = hb - jnp.sum(Vb * s[None, :], axis=-1)
        y = _fwd_sub(L, [fb[i] for i in range(k)], k)
        yv = jnp.stack(y, axis=-1)               # (k,)
        s2 = s + jnp.sum(ZT * yv[None, :], axis=-1)
        P2 = P + jnp.sum(ZT[:, None, :] * ZT[None, :, :], axis=-1)
        Lr = jnp.stack([jnp.stack([L[i][j] if j <= i else
                                   jnp.zeros_like(L[i][i])
                                   for j in range(k)]) for i in range(k)])
        return (P2, s2), (Lr, ZT, Vb, yv)

    P0 = jnp.zeros((n, n), J.dtype)
    s0 = jnp.zeros((n,), J.dtype)
    _, (Ls, ZTs, Vs, ys) = jax.lax.scan(
        fwd, (P0, s0), (J, h, alpha.astype(J.dtype), beta.astype(J.dtype)),
        unroll=_sss_unroll(C))

    def bwd(t, inp):
        Lr, ZT, Vb, yv = inp
        L = [[Lr[i, j] for j in range(k)] for i in range(k)]
        g = yv - jnp.sum(ZT * t[:, None], axis=0)          # (k,)
        x = _bwd_sub(L, [g[i] for i in range(k)], k)
        xv = jnp.stack(x, axis=-1)
        t2 = t + jnp.sum(Vb * xv[:, None], axis=0)         # (n,)
        return t2, xv

    t0 = jnp.zeros((n,), J.dtype)
    _, xs = jax.lax.scan(bwd, t0, (Ls, ZTs, Vs, ys), reverse=True,
                         unroll=_sss_unroll(C))
    return xs                                              # (C, k)


class TSRConstraintSet(NamedTuple):
    """Static layout of all active TSR constraints.

    A problem's dynamic TSR frames live in ChompProblem
    (tsr_T0w_inv / tsr_Twe_inv, shape (C, 7)); this object carries the
    static structure: which moving point each constraint pins, and
    which of its 6 rows are enabled.
    """

    point_idx: tuple          # (C,) moving-point index per constraint
    enabled: tuple            # (C,) tuple of 6 bools each
    rows: tuple               # K static (constraint, dim) pairs

    @property
    def n_constraints(self):
        return len(self.point_idx)

    @property
    def k_total(self):
        return len(self.rows)

    @classmethod
    def build(cls, entries: Sequence):
        """entries: sequence of (point_idx, enabled6)."""
        point_idx = tuple(int(e[0]) for e in entries)
        enabled = tuple(tuple(bool(b) for b in e[1]) for e in entries)
        rows = tuple(
            (c, d) for c in range(len(entries)) for d in range(6)
            if enabled[c][d])
        return cls(point_idx=point_idx, enabled=enabled, rows=rows)


def tsr_enabled_from_bw(bw) -> tuple:
    """Enabled mask from a 6×2 Bw bound array: dim constrained iff both
    bounds are 0.0 (orcdchomp_mod.cpp:2466-2518)."""
    bw = np.asarray(bw, dtype=float).reshape(6, 2)
    return tuple(bool(bw[i, 0] == 0.0 and bw[i, 1] == 0.0) for i in range(6))


def eval_tsr_all(spec: ChompSpec, fk, prob: ChompProblem, T_full,
                 cons: TSRConstraintSet, kin):
    """Evaluate value + Jacobian of every constraint.

    kin: TrajKinematics (link poses/anchors already computed for all
    trajectory points by the cost pass).

    Returns (val (C, 6), jac (C, 6, n)).
    """
    # constraint points index *moving* points; map to full-trajectory
    # rows.  point_idx is STATIC: when contiguous (everyn, or any single
    # point) gather rows with a static slice instead of a fancy-index
    # gather batched over problems
    off = 0 if spec.start_tsr else 1
    idx_t = tuple(cons.point_idx)
    lo = idx_t[0] + off
    if idx_t == tuple(range(idx_t[0], idx_t[0] + len(idx_t))):
        def take_rows(arr):
            return jax.lax.slice_in_dim(arr, lo, lo + len(idx_t), axis=0)
    else:
        full_idx = jnp.asarray(idx_t) + off

        def take_rows(arr):
            return arr[full_idx]

    ee_link_pose = fk.link_pose_red(take_rows(kin.red_poses),
                                    fk.model.ee_link)           # (C, 7)
    ee_origin = jnp.asarray(fk.model.ee_origin if fk.model.ee_origin
                            is not None else np.array([0, 0, 0, 0, 0, 0, 1.0]),
                            dtype=ee_link_pose.dtype)
    pose_ee = qt.pose_compose(ee_link_pose, ee_origin)

    pose_obj = qt.pose_compose(pose_ee, prob.tsr_Twe_inv)
    pose_table_obj = qt.pose_compose(prob.tsr_T0w_inv, pose_obj)
    xyzypr = qt.pose_to_xyzypr(pose_table_obj)                  # (C, 6)
    val = xyzypr[:, _DIM_MAP]                                   # Bw row order

    # --- spatial Jacobian of the ee *link* about the world origin ---
    anchors = take_rows(kin.anchors)                            # (C, n_dof, 7)
    axis_local = jnp.stack(
        [fk._axis[fk._dof_link[d]] for d in range(fk.n_dof)]) \
        if fk.n_dof else jnp.zeros((0, 3), ee_link_pose.dtype)
    axis_w = qt.quat_rotate(anchors[..., 3:], axis_local)       # (C, D, 3)
    origin_w = anchors[..., :3]
    ee_mask = jnp.asarray(
        fk.model.ancestor_dof_mask()[fk.model.ee_link])         # (D,)
    rev = jnp.asarray(fk._jtype_per_dof == 1)
    ang_cols = jnp.where((ee_mask & rev)[None, :, None], axis_w, 0.0)
    # linear part of a point at the world origin: axis × (0 − o)
    lin_rev = jnp.cross(axis_w, -origin_w)
    lin_cols = jnp.where(ee_mask[None, :, None],
                         jnp.where(rev[None, :, None], lin_rev, axis_w), 0.0)
    arm_spajac = jnp.concatenate(
        [jnp.swapaxes(ang_cols, -1, -2), jnp.swapaxes(lin_cols, -1, -2)],
        axis=-2)                                                # (C, 6, n_dof)

    if spec.floating_base:
        base_cols = sp.pose_jac(take_rows(T_full)[:, :7])       # (C, 6, 7)
        spajac = jnp.concatenate([base_cols, arm_spajac], axis=-1)
    else:
        spajac = arm_spajac                                     # (C, 6, n)

    # chain: xyzypr_J · pose_jac_inverse · Xm(table←world) · spajac
    # (orcdchomp_mod.cpp:1466-1481).  Contractions are broadcast-sum,
    # not batched @: (C,6,7)@(C,7,6)-style K≈6 batched dots would
    # lower to many tiny matrix products under the problem vmap.
    xm_tw = sp.xm_from_pose(prob.tsr_T0w_inv)                   # (C, 6, 6)
    jac_inv = sp.pose_jac_inverse(pose_table_obj)               # (C, 7, 6)
    to_ypr = qt.pose_to_xyzypr_J(pose_table_obj)                # (C, 6, 7)

    def bmm(a, b):
        return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)

    full = bmm(bmm(bmm(to_ypr, jac_inv), xm_tw), spajac)        # (C, 6, n)
    jac = full[:, _DIM_MAP, :]
    return val, jac


def _mm_ll(A, B):
    """Multiply list-of-list matrices whose entries are batched arrays,
    python floats (constants), or None (structural zeros).

    Small-matrix algebra in this form keeps the big batch axes minor
    and skips every structurally-zero MAC, where the dense
    (..., 6, 7)-minor AoS layout carries tiny minor axes."""
    rows, inner, cols = len(A), len(B), len(B[0])
    out = []
    for i in range(rows):
        row = []
        for j in range(cols):
            acc = None
            for t in range(inner):
                a, b = A[i][t], B[t][j]
                if a is None or b is None:
                    continue
                term = a * b
                acc = term if acc is None else acc + term
            row.append(acc)
        out.append(row)
    return out


def eval_tsr_all_soa(spec: ChompSpec, fk, probs, T_full,
                     cons: TSRConstraintSet, fk_out):
    """Batch-native constraint evaluation: identical math to
    :func:`eval_tsr_all` (orcdchomp_mod.cpp:1330-1657 chains), computed
    component-wise with the problem batch on the minor axis.

    The vmapped-AoS form carries every intermediate as (B, C, 6, 7)-ish
    tensors with tiny minor 6×7 dims, and needs (B, n_points, ·, 7)
    relayouts of the SoA FK outputs.  Here every quantity is a (C, B)
    array: quaternion chains via ops/soa, the small matrices as
    list-of-lists with structural zeros skipped (``_mm_ll``), world joint
    axes straight from ``fk_out.axis_w`` (already SoA).  Outputs are
    assembled into the (B, C, 6) / (B, C, 6, n) AoS layout the
    projection consumes — two small transposes at the very end.

    probs: batched ChompProblem (leaves (B, ...)); T_full (B, m+2, n);
    fk_out: FkSoA.  Returns (val (B, C, 6), jac (B, C, 6, n)).
    """
    from or_cdchomp_jax.ops import soa

    off = 0 if spec.start_tsr else 1
    idx_t = tuple(cons.point_idx)
    C = len(idx_t)
    lo = idx_t[0] + off
    contiguous = idx_t == tuple(range(idx_t[0], idx_t[0] + C))

    def take(comp):
        if contiguous:
            return jax.lax.slice_in_dim(comp, lo, lo + C, axis=0)
        return comp[jnp.asarray(idx_t) + off]

    ee = fk.model.ee_link
    slot = fk._red_slot[ee]
    pos = tuple(take(c)[:, slot] for c in fk_out.red_pos)     # (C, B)
    q = tuple(take(c)[:, slot] for c in fk_out.red_q)
    if not fk._off_id[ee]:
        o = np.asarray(fk._off64[ee], dtype=np.float64)
        pos = soa.add(pos, soa.qrot_const(q, o[:3]))
        q = soa.qmul_const(q, o[3:])
    if fk.model.ee_origin is not None:
        eo = np.asarray(fk.model.ee_origin, dtype=np.float64)
        pos = soa.add(pos, soa.qrot_const(q, eo[:3]))
        q = soa.qmul_const(q, eo[3:])

    def comps(aos, k):                         # (B, C, k) → k × (C, B)
        return tuple(jnp.transpose(aos[:, :, i]) for i in range(k))

    twe = comps(probs.tsr_Twe_inv, 7)
    pos = soa.add(pos, soa.qrot(q, twe[:3]))
    q = soa.qmul(q, twe[3:])
    t0w = comps(probs.tsr_T0w_inv, 7)
    pos = soa.add(t0w[:3], soa.qrot(t0w[3:], pos))
    q = soa.qmul(t0w[3:], q)                   # pose_table_obj comps

    qx, qy, qz, qw = q
    px, py, pz = pos

    # --- value: xyzypr with the reference's gimbal guards
    # (kin.c:587-615), reordered by _DIM_MAP ---
    sinp2 = qw * qy - qz * qx
    yaw_n = jnp.arctan2(2.0 * (qw * qz + qx * qy),
                        1.0 - 2.0 * (qy * qy + qz * qz))
    pitch_n = jnp.arcsin(jnp.clip(2.0 * sinp2, -1.0, 1.0))
    roll_n = jnp.arctan2(2.0 * (qw * qx + qy * qz),
                         1.0 - 2.0 * (qx * qx + qy * qy))
    at = jnp.arctan2(qx, qw)
    qtr = jnp.pi / 2.0
    hi = sinp2 > 0.49999
    lo_g = sinp2 < -0.49999
    yaw = jnp.where(hi, -2.0 * at, jnp.where(lo_g, 2.0 * at, yaw_n))
    pitch = jnp.where(hi, qtr, jnp.where(lo_g, -qtr, pitch_n))
    roll = jnp.where(hi | lo_g, 0.0, roll_n)
    val6 = [px, py, pz, roll, pitch, yaw]      # _DIM_MAP order

    # --- d(ypr)/d(quat) (kin.c:648-678) ---
    nu = 2.0 * (qw * qz + qx * qy)
    de = 1.0 - 2.0 * (qy * qy + qz * qz)
    den = de * de + nu * nu
    Jy = [de / den * (2 * qy),
          de / den * (2 * qx) - nu / den * (-4 * qy),
          de / den * (2 * qw) - nu / den * (-4 * qz),
          de / den * (2 * qz)]
    asq = 2.0 * (qw * qy - qz * qx)
    inv = 1.0 / jnp.sqrt(jnp.maximum(1.0 - asq * asq, 1e-12))
    Jp = [inv * 2 * (-qz), inv * 2 * qw, inv * 2 * (-qx), inv * 2 * qy]
    nu2 = 2.0 * (qw * qx + qy * qz)
    de2 = 1.0 - 2.0 * (qx * qx + qy * qy)
    den2 = de2 * de2 + nu2 * nu2
    Jr = [de2 / den2 * (2 * qw) - nu2 / den2 * (-4 * qx),
          de2 / den2 * (2 * qz) - nu2 / den2 * (-4 * qy),
          de2 / den2 * (2 * qy),
          de2 / den2 * (2 * qx)]
    # pose_to_xyzypr_J: [[I3, 0], [0, Jq]]  (6 × 7)
    to_ypr = [[1.0 if j == i else None for j in range(7)]
              for i in range(3)]
    to_ypr += [[None, None, None] + Jrow for Jrow in (Jy, Jp, Jr)]

    # --- pose_jac_inverse(pose_table_obj) (spatial.c:339-375), 7×6 ---
    qxd2, qyd2, qzd2, qwd2 = 0.5 * qx, 0.5 * qy, 0.5 * qz, 0.5 * qw
    jac_inv = [
        [None, pz, -py, 1.0, None, None],
        [-pz, None, px, None, 1.0, None],
        [py, -px, None, None, None, 1.0],
        [qwd2, qzd2, -qyd2, None, None, None],
        [-qzd2, qwd2, qxd2, None, None, None],
        [qyd2, -qxd2, qwd2, None, None, None],
        [-qxd2, -qyd2, -qzd2, None, None, None],
    ]

    # --- Xm(table←world) from T0w_inv (spatial.c:71-102): [[R,0],[rxR,R]] ---
    tx, ty, tz = t0w[0], t0w[1], t0w[2]
    ax_, ay, az, aw = t0w[3], t0w[4], t0w[5], t0w[6]
    R = [[1 - 2 * (ay * ay + az * az), 2 * (ax_ * ay - az * aw),
          2 * (ax_ * az + ay * aw)],
         [2 * (ax_ * ay + az * aw), 1 - 2 * (ax_ * ax_ + az * az),
          2 * (ay * az - ax_ * aw)],
         [2 * (ax_ * az - ay * aw), 2 * (ay * az + ax_ * aw),
          1 - 2 * (ax_ * ax_ + ay * ay)]]
    rx = [[None, -tz, ty], [tz, None, -tx], [-ty, tx, None]]
    rxR = _mm_ll(rx, R)
    xm = [R[i] + [None, None, None] for i in range(3)] + \
         [rxR[i] + R[i] for i in range(3)]

    # --- spatial Jacobian of the ee link about the world origin ---
    ee_mask = fk.model.ancestor_dof_mask()[ee]           # (D,) static
    rev = fk._jtype_per_dof_np == 1
    axis_w = tuple(take(c) for c in fk_out.axis_w)       # (C, D, B)
    origin_w = tuple(take(c) for c in fk_out.anch_pos)
    n_arm = fk.n_dof
    arm_cols = []
    for d in range(n_arm):
        if not ee_mask[d]:
            arm_cols.append([None] * 6)
            continue
        aw3 = tuple(c[:, d] for c in axis_w)             # (C, B)
        if rev[d]:
            ow3 = tuple(-c[:, d] for c in origin_w)
            lin = soa.cross(aw3, ow3)                    # axis × (0 − o)
            col = list(aw3) + list(lin)
        else:
            col = [None, None, None] + list(aw3)
        arm_cols.append(col)
    if spec.floating_base:
        # base block: pose_jac of the base pose rows (spatial.c:295-337)
        base7 = comps(jax.lax.slice_in_dim(T_full, lo, lo + C, axis=1)
                      if contiguous else
                      T_full[:, jnp.asarray(idx_t) + off], 7)
        bx, by, bz = base7[0], base7[1], base7[2]
        bqx2, bqy2 = 2.0 * base7[3], 2.0 * base7[4]
        bqz2, bqw2 = 2.0 * base7[5], 2.0 * base7[6]
        base_rows = [
            [None, None, None, bqw2, -bqz2, bqy2, -bqx2],
            [None, None, None, bqz2, bqw2, -bqx2, -bqy2],
            [None, None, None, -bqy2, bqx2, bqw2, -bqz2],
            [1.0, None, None, -bz * bqz2 - by * bqy2,
             -bz * bqw2 + by * bqx2, bz * bqx2 + by * bqw2,
             bz * bqy2 - by * bqz2],
            [None, 1.0, None, bz * bqw2 + bx * bqy2,
             -bz * bqz2 - bx * bqx2, bz * bqy2 - bx * bqw2,
             -bz * bqx2 + bx * bqz2],
            [None, None, 1.0, -by * bqw2 + bx * bqz2,
             by * bqz2 + bx * bqw2, -by * bqy2 - bx * bqx2,
             by * bqx2 - bx * bqy2],
        ]
        base_cols = [[base_rows[i][j] for i in range(6)]
                     for j in range(7)]
        cols = base_cols + arm_cols
    else:
        cols = arm_cols
    spajac = [[cols[j][i] for j in range(len(cols))] for i in range(6)]

    # --- chain: to_ypr · jac_inv · Xm · spajac, rows in _DIM_MAP order
    full = _mm_ll(_mm_ll(_mm_ll(to_ypr, jac_inv), xm), spajac)
    full = [full[i] for i in _DIM_MAP]

    zero = jnp.zeros_like(px)
    val = jnp.stack([v + zero if isinstance(v, float) else v
                     for v in val6])                       # (6, C, B)
    jacs = jnp.stack([jnp.stack(
        [zero if e is None else e + zero for e in row])
        for row in full])                                  # (6, n, C, B)
    return (jnp.transpose(val, (2, 1, 0)),
            jnp.transpose(jacs, (3, 2, 0, 1)))


def project_constraints(spec: ChompSpec, cons: TSRConstraintSet, engine,
                        lambda_, AG, T_mov, val, jac):
    """Goal-set CHOMP constraint projection (chomp.c:553-600).

    ``engine`` supplies the metric-inverse entries (dense Ainv indexing
    or the analytic semiseparable form — see ChompEngine.ainv_block).
    Returns the T correction (m, n) to *add* to the trajectory.
    """
    if cons.k_total == 0:
        return jnp.zeros_like(T_mov)
    pts_t = tuple(cons.point_idx)
    C = cons.n_constraints
    contiguous = pts_t == tuple(range(pts_t[0], pts_t[0] + C))
    uniform = len(set(cons.enabled)) == 1

    if uniform:
        # gather-free fast path (covers everyn/start/single-TSR runs —
        # every constraint enables the same dims): constraint rows stay
        # in (C, k) blocks, point rows come from a static slice, and
        # the static row/column index sets on the constant A⁻¹ fold at
        # compile time, with no batched fancy-index gathers.
        dims = [d for d in range(6) if cons.enabled[0][d]]
        k = len(dims)
        h0 = val[:, dims]                         # (C, k) — static slices
        J = jac[:, dims, :]                       # (C, k, n)
        if contiguous:
            AGp = jax.lax.slice_in_dim(AG, pts_t[0], pts_t[0] + C, axis=0)
        else:
            AGp = AG[jnp.asarray(pts_t)]
        # h += −(1/λ) J · AG[pt]  (chomp.c:563-565)
        h = h0 - (1.0 / lambda_) * jnp.sum(J * AGp[:, None, :], axis=-1)

        pts_np = np.asarray(pts_t)
        from or_cdchomp_jax.chomp import metric as metric_mod
        sss_ok = (metric_mod.sep_eligible(spec.D, not spec.start_tsr)
                  and C >= 4 and np.all(np.diff(pts_np) >= 0))
        if sss_ok:
            # semiseparable Ainv ⇒ block-quasiseparable system: exact
            # O(C) scan solve, never building the (C·k)² matrix
            alpha = jnp.asarray((spec.dt * spec.dt) * (pts_np + 1.0))
            beta = jnp.asarray(float(spec.m) - pts_np)
            x = _sss_solve(J, h, alpha, beta).reshape(C * k)
        else:
            # JAJT[(a,i),(b,j)] = Ainv[pt_a, pt_b] · (J_ai · J_bj)
            # (chomp.c:568-575) — broadcast-sum over n, not a batched dot
            JJt = jnp.sum(J[:, :, None, None, :] * J[None, None, :, :, :],
                          axis=-1)                # (C, k, C, k)
            Acc = engine.ainv_block(pts_np)       # (C, C), constant-folded
            JAJT = (JJt * Acc[:, None, :, None]).reshape(C * k, C * k)
            x = _spd_solve(JAJT, h.reshape(C * k))   # (chomp.c:579-581)

        # T −= Σ_c Ainv[:, pt_c] ⊗ (J_cᵀ x_c)  (chomp.c:593-599)
        delta = jnp.sum(J * x.reshape(C, k)[:, :, None], axis=1)  # (C, n)
        cols = engine.ainv_cols(pts_np)           # (m, C), constant-folded
        correction = -jnp.sum(cols[:, :, None] * delta[None, :, :], axis=1)
        return correction

    # general path: per-row gathers (mixed enabled masks)
    rows_c = jnp.asarray([r[0] for r in cons.rows])
    rows_d = jnp.asarray([r[1] for r in cons.rows])
    idx = jnp.asarray(cons.point_idx)

    h = val[rows_c, rows_d]                       # (K,)
    J = jac[rows_c, rows_d, :]                    # (K, n)
    row_pt = idx[rows_c]                          # (K,) moving-point index

    # h += −(1/λ) J · AG[pt]  (chomp.c:563-565)
    h = h - (1.0 / lambda_) * jnp.sum(J * AG[row_pt], axis=-1)

    # JAJT[a,b] = Ainv[pt_a, pt_b] · (J_a · J_b)  (chomp.c:568-575);
    # K×K over a small n contraction — broadcast-sum, not a batched dot
    JJt = jnp.sum(J[:, None, :] * J[None, :, :], axis=-1)
    JAJT = JJt * engine.ainv_block(np.asarray([pts_t[int(c)]
                                               for c, _ in cons.rows]))

    x = _spd_solve(JAJT, h)                       # (chomp.c:579-581 dgesv)

    # T −= Σ_k Ainv[:, pt_k] ⊗ (J_k x_k)  (chomp.c:593-599)
    cols = engine.ainv_cols(np.asarray([pts_t[int(c)]
                                        for c, _ in cons.rows]))
    correction = -jnp.einsum("mk,k,kn->mn", cols, x, J, precision="highest")
    return correction
