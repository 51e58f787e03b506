"""Batch-native (structure-of-arrays) obstacle + self-collision cost.

Same math as chomp/cost.py — the per-iteration callback pair of the
reference (sphere_cost_pre orcdchomp_mod.cpp:968-1132, sphere_cost
1134-1327) — but computed for the whole problem batch at once with the
batch axis *minor* and every x/y/z component its own array (see
ops/soa.py for the layout rationale: the vmapped AoS layout puts tiny
trailing (3,) / (6, 7) axes minor on the hot self-collision / FK / Jᵀ
tensors).

Scope: the fast path of solver.step_batched — everything except
start_tsr (which shifts the moving-point window) and extra_cost hooks
(arbitrary per-problem callables); floating base and con/everyn TSR
problems run here too (solver.batch_native_ok).  The vmapped AoS path
stays the parity anchor; equivalence of the two paths is pinned by
tests/test_soa_batch.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from or_cdchomp_jax.chomp.cost import _BASE_JAC_DAMP, _VEL_EPS, FieldStack
from or_cdchomp_jax.chomp.problem import ChompProblem, ChompSpec
from or_cdchomp_jax.ops import soa
from or_cdchomp_jax.ops.grid import field_interp_grad

import os as _os

# self-collision form: "xla" = the dense broadcast form (default),
# "pairs" = compacted static pair list, "sym"/"symv" = single-pass
# symmetric weights, "xla2" = dense with fewer reduced quantities
_SELFCOL = _os.environ.get("CDX_SELFCOL", "xla")
# measurement-only ablation knob: zero out one phase of the SoA cost
# to get its wall share by subtraction (benchmarks/ab.py).
# NEVER set in production: results are wrong by construction — so a
# non-empty set screams at import time (a stray env var must not
# silently corrupt a production solve).
_ABLATE = set(filter(None, _os.environ.get("CDX_ABLATE", "").split(",")))
if _ABLATE:
    import warnings as _warnings

    _warnings.warn(
        f"CDX_ABLATE={sorted(_ABLATE)} is set: these cost phases are "
        "STUBBED OUT and every solve is wrong by construction. "
        "Measurement-only — unset CDX_ABLATE for real results.",
        stacklevel=2)


def _components(arr2, n):
    """(B, n) → tuple of n (B,) arrays."""
    return tuple(arr2[:, i] for i in range(n))


def stack_pose_aos(pos, quat):
    """SoA pose components → AoS (B, n_points, ·, 7) pose array.

    pos: vec3, quat: quat4 of (n_points, ·, B) arrays.  One relayout
    per consumer (the TSR constraint chains), a few MB per step.
    """
    comps = [jnp.transpose(c, (2, 0, 1)) for c in (*pos, *quat)]
    return jnp.stack(comps, axis=-1)


def _obstacle_soa(spec: ChompSpec, fields: FieldStack, radii,
                  probs: ChompProblem, x, vel, acc, dtype):
    """SoA obstacle cost + workspace gradient (chomp/cost.py
    obstacle_cost_grad semantics, orcdchomp_mod.cpp:1134-1246).

    x, vel, acc: vec3 of (m, S, B).  Returns (cost_sphere (m, S, B)
    pre-summed? no — (c_obs (B,), wgrad vec3 with the ‖ẋ‖ scale)).
    """
    F = fields.data.shape[0]

    v2 = soa.norm2(vel)
    vnorm = jnp.sqrt(v2)
    eps = probs.epsilon                      # (B,)
    inf = jnp.asarray(jnp.inf, dtype)

    best_v = None
    best_g = None
    for f in range(F):
        pg = probs.pose_gsdf_world[:, f]     # (B, 7)
        p = soa.add(soa.qrot(_components(pg[:, 3:], 4), x),
                    _components(pg[:, :3], 3))          # vec3 (m, S, B)
        if "lookup" in _ABLATE:
            # measurement-only: input-dependent stand-ins so consumers
            # keep their shapes but the lookup vanishes
            value, g = p[0] * 0.1, tuple(c * 0.1 for c in p)
        else:
            value, g, _ = field_interp_grad(
                fields.data[f].reshape(-1), fields.data.shape[1:],
                fields.sizes[f], fields.lengths[f], p)
        off = ~probs.field_enabled[:, f]
        value = jnp.where(off, inf, value)
        g = tuple(jnp.where(off, 0.0, gi) for gi in g)

        # rotate gradient to world per field, before the min-select
        pw = probs.pose_world_gsdf[:, f]
        gw = soa.qrot(_components(pw[:, 3:], 4), tuple(g))

        if best_v is None:
            best_v, best_g = value, gw
        else:
            take = value < best_v                     # strict: first wins ties
            best_v = jnp.where(take, value, best_v)
            best_g = tuple(jnp.where(take, a, b)
                           for a, b in zip(gw, best_g))

    has_field = jnp.isfinite(best_v)
    dist = jnp.where(has_field, best_v, 0.0)
    d = dist - radii[None, :, None]                  # radii (S,)

    # hinge cost scaled by workspace speed (orcdchomp_mod.cpp:1201-1205)
    c_in = probs.obs_factor * (0.5 * eps - d)
    c_mid = probs.obs_factor * (0.5 / eps) * (d - eps) ** 2
    cost_sphere = vnorm * jnp.where(d < 0.0, c_in,
                                    jnp.where(d < eps, c_mid, 0.0))
    cost_sphere = jnp.where(has_field, cost_sphere, 0.0)
    c_obs = jnp.sum(cost_sphere, axis=(0, 1))        # (B,)

    # cost-slope scaling (orcdchomp_mod.cpp:1218-1223)
    slope = jnp.where(d < 0.0, -1.0, jnp.where(d < eps, d / eps - 1.0, 0.0))
    sc = jnp.where(has_field, slope * vnorm * probs.obs_factor, 0.0)
    x_grad = soa.scale(best_g, sc)

    # projection off the velocity + curvature (orcdchomp_mod.cpp:1225-1241)
    safe = vnorm > _VEL_EPS
    v2s = jnp.where(safe, v2, 1.0)
    proj = jnp.where(safe, soa.dot(x_grad, vel) / v2s, 0.0)
    x_grad = soa.sub(x_grad, soa.scale(vel, proj))
    aproj = jnp.where(safe, soa.dot(acc, vel) / v2s, 0.0)
    curv = soa.scale(soa.sub(acc, soa.scale(vel, aproj)),
                     jnp.where(safe, 1.0 / v2s, 0.0))
    x_grad = soa.sub(x_grad, soa.scale(curv, cost_sphere))

    return c_obs, soa.scale(x_grad, vnorm), vnorm, v2, safe


def _selfcol_pairs_static(same_link, radii_act, radii_all, Sa, SI):
    """Static (trace-time) compacted pair tables for _selfcol_soa_pairs.

    Returns (pi, pj, two_sided, rsum, M) numpy arrays: pi/pj (P,) pair
    sphere indices (pj indexes the concatenated active+inactive list),
    two_sided (P,) marks active-active pairs (both ordered twins live
    in one slot), rsum (P,) radius sums, M (P, Sa) the ±1 scatter
    matrix (+1 at pi, −1 at pj for two-sided pairs).
    """
    import numpy as np

    same_np = np.asarray(same_link)
    ra = np.asarray(radii_act, dtype=np.float64)
    rall = np.asarray(radii_all, dtype=np.float64)
    ii, jj = np.nonzero(~same_np[:, :Sa])
    keep = ii < jj
    pi, pj = ii[keep], jj[keep]
    two_sided = np.ones(pi.shape[0], dtype=bool)
    if SI:
        i2, j2 = np.nonzero(~same_np[:, Sa:])
        pi = np.concatenate([pi, i2])
        pj = np.concatenate([pj, Sa + j2])
        two_sided = np.concatenate([two_sided,
                                    np.zeros(i2.shape[0], dtype=bool)])
    rsum = ra[pi] + rall[pj]
    P = pi.shape[0]
    M = np.zeros((P, Sa), dtype=np.float32)
    M[np.arange(P), pi] = 1.0
    aa = np.nonzero(two_sided)[0]
    M[aa, pj[aa]] = -1.0
    return pi, pj, two_sided, rsum, M


def _selfcol_soa_pairs(spec: ChompSpec, same_link, radii_act, radii_all,
                       probs: ChompProblem, x_i, vel, vnorm, v2, safe):
    """Compacted static-pair-list self-collision (same ordered-pair
    semantics as the dense form / orcdchomp_mod.cpp:1249-1317).

    The dense form computes all Sa·So slots; only ~P non-same-link
    pairs carry cost, and the ordered twins (i,j)/(j,i) share all the
    geometry (distance, hinge, slope) and differ only in the velocity-
    side scalars.  This form gathers each unordered pair once (static
    indices), computes the shared geometry once, forms the *combined*
    directed gradient h = g'_ij − g'_ji (the reference maps +g' through
    J_i and −g' through J_j, orcdchomp_mod.cpp:1310-1316, so per
    unordered pair sphere i nets +h and sphere j nets −h), and scatters
    with one ±1 constant (P, Sa) matmul per component.  Active→inactive
    pairs ride the same pair axis one-sided (w_j masked to 0, no −h
    scatter).
    """
    m, Sa, B = x_i[0].shape
    SI = probs.inactive_pos.shape[1]
    dtype = x_i[0].dtype
    pi, pj, two_sided, rsum_np, M_np = _selfcol_pairs_static(
        same_link, radii_act, radii_all, Sa, SI)
    P = pi.shape[0]
    if P == 0:
        return (jnp.zeros((B,), dtype),
                tuple(jnp.zeros_like(c) for c in x_i))

    import numpy as np

    rsum = jnp.asarray(rsum_np, dtype=dtype)[None, :, None]  # (1, P, 1)
    pi_j = jnp.asarray(pi)
    # pj for active-side gathers: one-sided slots clipped to 0 and
    # masked out below, so the gather index stays in [0, Sa)
    pj_act = jnp.asarray(np.where(two_sided, pj, 0))
    ts = jnp.asarray(two_sided)[None, :, None]            # (1, P, 1)
    M = jnp.asarray(M_np, dtype=dtype)                    # (P, Sa)

    if SI:
        inact = probs.inactive_pos                        # (B, SI, 3)
        io = tuple(jnp.broadcast_to(
            jnp.transpose(inact[:, :, ci])[None], (m, SI, B))
            for ci in range(3))
        x_o = tuple(jnp.concatenate([a, b], axis=1)
                    for a, b in zip(x_i, io))
        pj_j = jnp.asarray(pj)
    else:
        x_o = x_i
        pj_j = jnp.asarray(pj)

    inv_v2 = jnp.where(safe, 1.0 / jnp.where(safe, v2, 1.0), 0.0)
    take = lambda arr, idx: jnp.take(arr, idx, axis=1)    # (m, P, B)
    xi_p = tuple(take(c, pi_j) for c in x_i)
    xj_p = tuple(take(c, pj_j) for c in x_o)
    diff = tuple(a - b for a, b in zip(xi_p, xj_p))
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    inv_cd = jax.lax.rsqrt(jnp.maximum(d2, 1e-24))        # guarded 1/dist
    cdist = d2 * inv_cd                                   # √d2 (0 at 0)

    eps_s = probs.epsilon_self                            # (B,)
    inv_eps = 1.0 / eps_s                                 # hoisted: no
    # divide ever runs on the (m, P, B) pair tensors
    pair_on = cdist <= rsum + eps_s
    d = cdist - rsum
    c = jnp.where(d < 0.0, 0.5 * eps_s - d,
                  (0.5 * inv_eps) * (d - eps_s) ** 2)
    slope = jnp.where(d < 0.0, -1.0, d * inv_eps - 1.0)
    c_on = jnp.where(pair_on, c, 0.0)

    of = probs.obs_factor_self                            # (B,)
    vn_i = take(vnorm, pi_j)
    iv_i = take(inv_v2, pi_j)
    vn_j_eff = jnp.where(ts, take(vnorm, pj_act), 0.0)
    iv_j = take(inv_v2, pj_act)
    vel_i = tuple(take(c_, pi_j) for c_ in vel)
    vel_j = tuple(take(c_, pj_act) for c_ in vel)
    cost_p = (of * c_on) * (vn_i + vn_j_eff)
    c_self = jnp.sum(cost_p, axis=(0, 1))                 # (B,)

    w_geom = jnp.where(pair_on, slope * of * inv_cd, 0.0)
    w1_i = w_geom * vn_i
    w1_j = w_geom * vn_j_eff                  # 0 for one-sided pairs

    dv_i = (diff[0] * vel_i[0] + diff[1] * vel_i[1]
            + diff[2] * vel_i[2])
    dv_j = (diff[0] * vel_j[0] + diff[1] * vel_j[1]
            + diff[2] * vel_j[2])
    w2_i = w1_i * dv_i * iv_i
    w2_j = w1_j * dv_j * iv_j

    # h = g'_ij − g'_ji = (w1_i + w1_j)·diff − w2_i·v_i − w2_j·v_j
    w1s = w1_i + w1_j
    H = jnp.stack(tuple(
        w1s * diff[ci] - w2_i * vel_i[ci] - w2_j * vel_j[ci]
        for ci in range(3)))                              # (3, m, P, B)
    net3 = jnp.einsum("cmpb,ps->cmsb", H, M, precision="highest")
    return c_self, (net3[0], net3[1], net3[2])


def _selfcol_soa_sym(spec: ChompSpec, same_link, radii_act, radii_all,
                     probs: ChompProblem, x_i, vel, vnorm, v2, safe,
                     variadic=False):
    """Single-pass symmetric-weight self-collision (same math as the
    dense form / orcdchomp_mod.cpp:1249-1317).

    The dense form's cost is not memory traffic — XLA fuses the
    (m, Sa, So, B) pair tensors away — it is *recompute*: the net
    gradient needs reductions over BOTH pair axes (Σ_j outgoing,
    Σ_i incoming), XLA emits a separate reduce fusion per axis/operand
    group, and every fusion re-derives the ~30-op pair pipeline from
    scratch.

    Key identity: the geometric pair weight
        W_ij = [pair_ok]·slope(d_ij)·obs_self / ‖x_i−x_j‖
    is SYMMETRIC on the active-active block (distance, radii and hinge
    all are; only the velocity-side factors vn_i/iv_i/v_i break the
    symmetry of the full w1/w2).  Every incoming sum over i can
    therefore be re-indexed as a sum over j of W_sj times a per-j
    channel:  Σ_i W_is·f(i) = Σ_j W_sj·f(j).  With all 18 reductions
    over the SAME axis and sharing one producer graph, XLA's sibling
    multi-output fusion computes W (and the cost hinge) once per pair
    slot and accumulates every channel in registers — one pass over
    the pair space instead of ~4.
    """
    m, Sa, B = x_i[0].shape
    SI = probs.inactive_pos.shape[1]
    dtype = x_i[0].dtype

    if SI:
        inact = probs.inactive_pos                       # (B, SI, 3)
        io = tuple(jnp.broadcast_to(
            jnp.transpose(inact[:, :, ci])[None], (m, SI, B))
            for ci in range(3))
        x_o = tuple(jnp.concatenate([a, b], axis=1)
                    for a, b in zip(x_i, io))
        pad_j = lambda a: jnp.concatenate(
            [a, jnp.zeros((m, SI, B), dtype)], axis=1)   # act-only chans
    else:
        x_o = x_i
        pad_j = lambda a: a

    eps_s = probs.epsilon_self                           # (B,)
    inv_eps = 1.0 / eps_s                                # hoisted
    of = probs.obs_factor_self                           # (B,)

    # per-sphere scalars (cheap, (m, S, B))
    xi2 = soa.norm2(x_i)
    xo2 = soa.norm2(x_o)
    xv = soa.dot(x_i, vel)                               # x_i·v_i
    inv_v2 = jnp.where(safe, 1.0 / jnp.where(safe, v2, 1.0), 0.0)

    # pair weight + cost hinge, computed once inside the fused reduces.
    # Layout (m, So, Sa, B) — the reduced axis (j over So) is third-
    # minor, so every channel sum accumulates whole (Sa, B) slices.
    xio = sum(b[:, :, None, :] * a[:, None, :, :]
              for a, b in zip(x_i, x_o))                 # (m, So, Sa, B)
    d2 = jnp.maximum(
        xo2[:, :, None, :] + xi2[:, None, :, :] - 2.0 * xio, 0.0)
    inv_cd = jax.lax.rsqrt(jnp.maximum(d2, 1e-24))
    cdist = d2 * inv_cd
    rsum = (radii_all[:, None] + radii_act[None, :])[:, :, None]  # (So,Sa,1)
    same_t = jnp.transpose(same_link)                    # (So, Sa)
    pair_ok = (~same_t[:, :, None]) & (cdist <= rsum + eps_s)
    d = cdist - rsum
    slope = jnp.where(d < 0.0, -1.0, d * inv_eps - 1.0)
    W = jnp.where(pair_ok, slope * of * inv_cd, 0.0)     # symmetric (aa)
    c_hinge = jnp.where(d < 0.0, 0.5 * eps_s - d,
                        (0.5 * inv_eps) * (d - eps_s) ** 2)
    c_on = jnp.where(pair_ok, c_hinge, 0.0)

    # per-j channels (m, So, B); incoming (A*) channels are zero for
    # inactive j, which restricts those sums to the active block
    vn_a = pad_j(vnorm)
    qa = pad_j(vnorm * inv_v2)                           # vn_j·iv_j
    chans = [None,                                       # R0: Σ W
             x_o[0], x_o[1], x_o[2],                     # R1
             vn_a,                                       # A0
             vn_a * x_o[0], vn_a * x_o[1], vn_a * x_o[2],  # A1
             qa * pad_j(xv * vel[0]), qa * pad_j(xv * vel[1]),
             qa * pad_j(xv * vel[2]),                    # A2
             qa * pad_j(vel[0] * vel[0]), qa * pad_j(vel[0] * vel[1]),
             qa * pad_j(vel[0] * vel[2]), qa * pad_j(vel[1] * vel[1]),
             qa * pad_j(vel[1] * vel[2]),
             qa * pad_j(vel[2] * vel[2])]                # A3 (sym 6)
    if variadic:
        # one HLO reduce with 18 operands: the shared producer graph
        # (W, c_on) fuses in and is computed ONCE per pair slot, with
        # all accumulators live simultaneously — immune to whether the
        # sibling multi-output fusion pass groups independent reduces
        ops = [W] + [W * ch[:, :, None, :] for ch in chans[1:]] + [c_on]
        zero = jnp.zeros((), dtype)
        out = jax.lax.reduce(
            tuple(ops), tuple(zero for _ in ops),
            lambda accs, vals: tuple(a + v for a, v in zip(accs, vals)),
            (1,))
        red, RC = list(out[:-1]), out[-1]
    else:
        red = [jnp.sum(W, axis=1)]
        red += [jnp.sum(W * ch[:, :, None, :], axis=1)
                for ch in chans[1:]]
        RC = jnp.sum(c_on, axis=1)                       # cost channel
    (R0, R1x, R1y, R1z, A0, A1x, A1y, A1z, A2x, A2y, A2z,
     Axx, Axy, Axz, Ayy, Ayz, Azz) = red

    c_self = jnp.sum(of * vnorm * RC, axis=(0, 1))       # (B,)

    R1 = (R1x, R1y, R1z)
    R1v = R1x * vel[0] + R1y * vel[1] + R1z * vel[2]
    w2s = vnorm * inv_v2 * (xv * R0 - R1v)               # Σ_j w2_sj
    A3 = ((Axx, Axy, Axz), (Axy, Ayy, Ayz), (Axz, Ayz, Azz))
    net = tuple(
        vnorm * (x_i[ci] * R0 - R1[ci]) - w2s * vel[ci]
        - (A1x if ci == 0 else A1y if ci == 1 else A1z)
        + x_i[ci] * A0
        + (A2x if ci == 0 else A2y if ci == 1 else A2z)
        - (x_i[0] * A3[0][ci] + x_i[1] * A3[1][ci]
           + x_i[2] * A3[2][ci])
        for ci in range(3))
    return c_self, net


def _selfcol_soa(spec: ChompSpec, same_link, radii_act, radii_all,
                 probs: ChompProblem, x_i, vel, vnorm, v2, safe,
                 method=None):
    """SoA all-pairs self-collision (chomp/cost.py
    self_collision_cost_grad semantics, orcdchomp_mod.cpp:1249-1317).

    x_i, vel: vec3 of (m, Sa, B).  Returns (c_self (B,), net vec3).
    """
    method = _SELFCOL if method is None else method
    if method in ("sym", "symv"):
        return _selfcol_soa_sym(spec, same_link, radii_act, radii_all,
                                probs, x_i, vel, vnorm, v2, safe,
                                variadic=(method == "symv"))
    if method == "pairs":
        return _selfcol_soa_pairs(spec, same_link, radii_act, radii_all,
                                  probs, x_i, vel, vnorm, v2, safe)
    m, Sa, B = x_i[0].shape
    SI = probs.inactive_pos.shape[1]
    if SI:
        inact = probs.inactive_pos                   # (B, SI, 3)
        io = tuple(jnp.broadcast_to(
            jnp.transpose(inact[:, :, ci])[None], (m, SI, B))
            for ci in range(3))
        x_o = tuple(jnp.concatenate([a, b], axis=1)
                    for a, b in zip(x_i, io))
    else:
        x_o = x_i

    eps_s = probs.epsilon_self                       # (B,)
    inv_eps = 1.0 / eps_s                            # (B,) — hoisted so
    # no divide ever runs on the big (m, Sa, So, B) pair tensors
    xi2 = soa.norm2(x_i)                             # (m, Sa, B)
    xo2 = soa.norm2(x_o)                             # (m, So, B)
    xio = sum(a[:, :, None, :] * b[:, None, :, :]
              for a, b in zip(x_i, x_o))             # (m, Sa, So, B)
    d2 = jnp.maximum(
        xi2[:, :, None, :] + xo2[:, None, :, :] - 2.0 * xio, 0.0)
    inv_cd = jax.lax.rsqrt(jnp.maximum(d2, 1e-24))   # = 1/cdist, guarded
    cdist = d2 * inv_cd                              # = √d2 (exactly 0 at 0)
    rsum = (radii_act[:, None] + radii_all[None, :])[:, :, None]  # (Sa,So,1)
    pair_ok = (~same_link[:, :, None]) & (cdist <= rsum + eps_s)

    d = cdist - rsum
    c = jnp.where(d < 0.0, 0.5 * eps_s - d,
                  (0.5 * inv_eps) * (d - eps_s) ** 2)
    ofv = (probs.obs_factor_self * vnorm)[:, :, None, :]   # (m, Sa, 1, B)
    cost_pair = jnp.where(pair_ok, c, 0.0) * ofv
    c_self = jnp.sum(cost_pair, axis=(0, 1, 2))            # (B,)

    slope = jnp.where(d < 0.0, -1.0, d * inv_eps - 1.0)
    w1 = jnp.where(pair_ok, slope * ofv * inv_cd, 0.0)

    xv = soa.dot(x_i, vel)                                 # (m, Sa, B)
    xov = sum(a[:, :, None, :] * b[:, None, :, :]
              for a, b in zip(vel, x_o))
    b_ = xv[:, :, None, :] - xov
    inv_v2 = jnp.where(safe, 1.0 / jnp.where(safe, v2, 1.0), 0.0)
    w2 = w1 * b_ * inv_v2[:, :, None, :]

    if method == "xla2":
        # fewer reduced quantities: fold the factored 13 sums into 7
        # direct per-component integrands (outgoing Σ_j g'_c, incoming
        # Σ_i g'_c, cost) so XLA's sibling reduce grouping re-derives
        # the w1/w2 pair pipeline fewer times
        w1a = w1[:, :, :Sa]
        w2a = w2[:, :, :Sa]
        net = tuple(
            jnp.sum(w1 * (x_i[ci][:, :, None, :]
                          - x_o[ci][:, None, :, :])
                    - w2 * vel[ci][:, :, None, :], axis=2)
            - jnp.sum(w1a * (x_i[ci][:, :, None, :]
                             - x_i[ci][:, None, :, :])
                      - w2a * vel[ci][:, :, None, :], axis=1)
            for ci in range(3))
        return c_self, net
    w1a = w1[:, :, :Sa]
    w2a = w2[:, :, :Sa]
    r1 = jnp.sum(w1, axis=2)                               # (m, Sa, B)
    r2 = jnp.sum(w2, axis=2)
    c1 = jnp.sum(w1a, axis=1)
    net = tuple(
        x_i[ci] * r1
        - jnp.sum(w1 * x_o[ci][:, None, :, :], axis=2)
        - vel[ci] * r2
        - jnp.sum(w1a * x_i[ci][:, :, None, :], axis=1)
        + x_i[ci] * c1
        + jnp.sum(w2a * vel[ci][:, :, None, :], axis=1)
        for ci in range(3))
    return c_self, net


def total_cost_grad_batched(spec: ChompSpec, fk, fields: FieldStack,
                            same_link, radii_act, radii_all,
                            probs: ChompProblem):
    """Full batched obstacle+self cost and config-space gradient.

    probs: every leaf carries a leading batch axis B.  No start_tsr.
    Returns (cost (B,), G (B, m, n), fk_out FkSoA) — averaged over
    moving points like the AoS path (chomp.c:489-492); fk_out feeds the
    constraint evaluation in solver.step_batched.
    """
    dtype = probs.traj.dtype
    dt = spec.dt
    with jax.named_scope("callback_pre"):
        Tt = jnp.transpose(probs.traj, (1, 2, 0))      # (n_points, n, B)
        with jax.named_scope("fk"):
            if spec.floating_base:
                fk_out = fk.fk_soa(
                    Tt[:, 7:, :],
                    tuple(Tt[:, i, :] for i in range(3)),
                    tuple(Tt[:, i, :] for i in range(3, 7)))
            else:
                fk_out = fk.fk_soa(
                    Tt,
                    _components(probs.robot_pose[:, :3], 3),
                    _components(probs.robot_pose[:, 3:], 4))
        x_all = fk_out.x
        x_mov = tuple(c[1:-1] for c in x_all)
        anch_mov = tuple(c[1:-1] for c in fk_out.anch_pos)
        axw_mov = tuple(c[1:-1] for c in fk_out.axis_w)
        with jax.named_scope("pre_velsaccs"):
            vel = tuple((c[2:] - c[:-2]) / (2.0 * dt) for c in x_all)
            acc = tuple((c[:-2] - 2.0 * c[1:-1] + c[2:]) / (dt * dt)
                        for c in x_all)

    with jax.named_scope("obstacle"):
        if "obstacle" in _ABLATE:
            v2 = soa.norm2(vel)
            vnorm = jnp.sqrt(v2)
            safe = vnorm > _VEL_EPS
            c_obs = jnp.zeros(x_mov[0].shape[-1], dtype)
            w_obs = tuple(jnp.zeros_like(c) for c in x_mov)
        else:
            c_obs, w_obs, vnorm, v2, safe = _obstacle_soa(
                spec, fields, radii_act, probs, x_mov, vel, acc, dtype)
    with jax.named_scope("selfcol"):
        if "selfcol" in _ABLATE:
            c_self = jnp.zeros_like(c_obs)
            w_self = tuple(jnp.zeros_like(c) for c in x_mov)
        else:
            c_self, w_self = _selfcol_soa(
                spec, same_link, radii_act, radii_all, probs,
                x_mov, vel, vnorm, v2, safe)

    with jax.named_scope("jtmap"):
        w = soa.add(w_obs, w_self)
        if "jtmap" in _ABLATE:
            G_arm = jnp.sum(w[0][:, :, None, :] * 0.0, axis=1) \
                + jnp.zeros((x_mov[0].shape[0], fk.n_dof,
                             x_mov[0].shape[-1]), dtype)
        else:
            G_arm = fk.apply_sphere_jacT_soa(anch_mov, axw_mov, x_mov, w)
        G_arm = jnp.transpose(G_arm, (2, 0, 1))        # (B, m, n_arm)
        if spec.floating_base:
            # base block (orcdchomp_mod.cpp:1050-1086): Jᵀw =
            # damp·(Jsp[:3]ᵀ Σ(x×w) + Jsp[3:]ᵀ Σw), computed
            # component-wise with the batch axis minor instead of an
            # AoS (B, m, 6, 7) spatial-Jacobian tensor with tiny
            # trailing axes
            xw = soa.cross(x_mov, w)
            s1 = tuple(jnp.sum(c, axis=1) for c in xw)  # (m, B) ×3
            s2 = tuple(jnp.sum(c, axis=1) for c in w)
            m = spec.m
            bp = tuple(jnp.transpose(probs.traj[:, 1:1 + m, i])
                       for i in range(7))               # (m, B) ×7
            bx, by, bz = bp[0], bp[1], bp[2]
            qx2, qy2 = 2.0 * bp[3], 2.0 * bp[4]
            qz2, qw2 = 2.0 * bp[5], 2.0 * bp[6]
            # pose_jac rows (spatial.c:295-337): rows 0-2 angular
            # (couple to s1), rows 3-5 linear (couple to s2);
            # Gb[j] = Σ_r Jsp[r][j]·s[r]
            a0, a1, a2 = s1
            l0, l1, l2 = s2
            Gb = [
                l0,
                l1,
                l2,
                qw2 * a0 + qz2 * a1 - qy2 * a2
                + (-bz * qz2 - by * qy2) * l0
                + (bz * qw2 + bx * qy2) * l1
                + (-by * qw2 + bx * qz2) * l2,
                -qz2 * a0 + qw2 * a1 + qx2 * a2
                + (-bz * qw2 + by * qx2) * l0
                + (-bz * qz2 - bx * qx2) * l1
                + (by * qz2 + bx * qw2) * l2,
                qy2 * a0 - qx2 * a1 + qw2 * a2
                + (bz * qx2 + by * qw2) * l0
                + (bz * qy2 - bx * qw2) * l1
                + (-by * qy2 - bx * qx2) * l2,
                -qx2 * a0 - qy2 * a1 - qz2 * a2
                + (bz * qy2 - by * qz2) * l0
                + (-bz * qx2 + bx * qz2) * l1
                + (by * qx2 - bx * qy2) * l2,
            ]
            G_base = _BASE_JAC_DAMP * jnp.transpose(
                jnp.stack(Gb), (2, 1, 0))               # (B, m, 7)
            G = jnp.concatenate([G_base, G_arm], axis=-1) / spec.m
        else:
            G = G_arm / spec.m                          # (B, m, n)
    return (c_obs + c_self) / spec.m, G, fk_out
