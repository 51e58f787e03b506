"""Batched obstacle + self-collision cost and functional gradient.

This is the batched replacement for the reference's per-iteration callback
pair:

 - ``sphere_cost_pre`` (orcdchomp_mod.cpp:968-1132): FK + Jacobians for
   every trajectory point, finite-difference workspace velocities and
   accelerations of every robot sphere.
 - ``sphere_cost`` (orcdchomp_mod.cpp:1134-1327): per (point, sphere)
   multi-SDF min-select lookup, velocity-scaled hinge obstacle cost,
   the CHOMP workspace functional gradient (orthogonal projection +
   curvature correction), and all-pairs self-collision cost/gradient.

Instead of m sequential FK calls crossing into an external engine, the
whole thing is one pure function over the full trajectory, vectorized
over (points × spheres × fields) and vmappable over problems.  The
self-collision gradient is reorganized so the (S×S) pair Jacobian
difference J−J₂ (orcdchomp_mod.cpp:1308-1315) is never materialized:
pair workspace gradients are reduced over partners first and mapped
through each sphere's own Jacobian once.

Numerical-robustness deviation: the reference divides the curvature
term by ‖ẋ‖² unconditionally (orcdchomp_mod.cpp:1237) which produces
inf/NaN for exactly stationary spheres; here the velocity-dependent
projection/curvature terms are gated on ‖ẋ‖ > 1e-6 (the same threshold
the reference uses for its projection guard).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from or_cdchomp_jax.chomp.problem import ChompProblem, ChompSpec
from or_cdchomp_jax.ops import quat as qt
from or_cdchomp_jax.ops import spatial as sp
from or_cdchomp_jax.ops.grid import multigrid_interp_grad

_VEL_EPS = 1e-6   # ‖ẋ‖ guard, orcdchomp_mod.cpp:1226/1285
_BASE_JAC_DAMP = 0.01  # floating-base Jacobian damping, orcdchomp_mod.cpp:1075-1080


class FieldStack(NamedTuple):
    """Padded stack of registered SDF grids (engine-level constant)."""

    data: jnp.ndarray     # (F, mx, my, mz)
    sizes: jnp.ndarray    # (F, 3) int32
    lengths: jnp.ndarray  # (F, 3)


class TrajKinematics(NamedTuple):
    """Cached per-iteration kinematic quantities (the sphere_cost_pre
    outputs, orcdchomp_mod.cpp:930-935)."""

    x_all: jnp.ndarray    # (n_points, S_act, 3) sphere world positions
    x_mov: jnp.ndarray    # (m, S_act, 3) at moving points
    vel: jnp.ndarray      # (m, S_act, 3) workspace velocities
    acc: jnp.ndarray      # (m, S_act, 3) workspace accelerations
    anchors_mov: jnp.ndarray  # (m, n_dof, 7) joint frames at moving pts
    base_mov: jnp.ndarray     # (m, 7) base poses at moving points
    red_poses: jnp.ndarray   # (n_points, R, 7) reduced-chain link poses
    anchors: jnp.ndarray     # (n_points, n_dof, 7)


def trajectory_kinematics(spec: ChompSpec, fk, T_full,
                          robot_pose=None) -> TrajKinematics:
    """FK + finite-difference workspace vel/acc over the trajectory.

    fk: CompiledFK for the (possibly frozen) robot.
    T_full: (n_points, n); robot_pose: (7,) fixed base placement for
    non-floating robots (the robot's world transform).
    """
    dt = spec.dt
    with jax.named_scope("fk"):
        if spec.floating_base:
            base = T_full[:, :7]
            q = T_full[:, 7:]
            red_poses, anchors = fk.red_poses(q, base_pose=base)
        else:
            base = jnp.broadcast_to(robot_pose, (T_full.shape[0], 7))
            red_poses, anchors = fk.red_poses(T_full, base_pose=base)
        x_all = fk.sphere_positions_red(red_poses)   # (n_points, S, 3)

    # moving-point windows (orcdchomp_mod.cpp:1040-1046: ti_mov offset).
    # No sphere Jacobian tensor is built: the Jᵀ map is applied in
    # factored form (CompiledFK.apply_sphere_jacT) from anchors alone.
    if spec.start_tsr:
        x_mov = x_all[:-1]
        anchors_mov = anchors[:-1]
        base_mov = base[:-1]
    else:
        x_mov = x_all[1:-1]
        anchors_mov = anchors[1:-1]
        base_mov = base[1:-1]

    # central-difference velocities/accelerations over *all* points
    # (orcdchomp_mod.cpp:1099-1127)
    with jax.named_scope("pre_velsaccs"):
        internal_vel = (x_all[2:] - x_all[:-2]) / (2.0 * dt)   # (n_points-2, S, 3)
        internal_acc = (x_all[:-2] - 2.0 * x_all[1:-1] + x_all[2:]) / (dt * dt)
        if spec.start_tsr:
            v0 = (x_all[1:2] - x_all[0:1]) / dt
            vel = jnp.concatenate([v0, internal_vel], axis=0)
            acc = jnp.concatenate([internal_acc[0:1], internal_acc], axis=0)
        else:
            vel = internal_vel
            acc = internal_acc

    return TrajKinematics(
        x_all=x_all, x_mov=x_mov, vel=vel, acc=acc,
        anchors_mov=anchors_mov, base_mov=base_mov,
        red_poses=red_poses, anchors=anchors)


def obstacle_cost_grad(spec: ChompSpec, fields: FieldStack, radii,
                       prob: ChompProblem, kin: TrajKinematics,
                       want_grad: bool):
    """SDF obstacle cost + config-space gradient.

    radii: (S_act,) active sphere radii.
    Returns (cost (), wgrad (m, S, 3) or None, cost_per_sphere (m, S)).
    ``wgrad`` is the per-sphere *workspace* gradient with the ‖ẋ‖ scale
    already applied; the caller maps it through Jᵀ once, jointly with
    the self-collision workspace gradient, so the (m,S,3,n) Jacobian is
    contracted a single time (orcdchomp_mod.cpp:1243-1245 semantics).
    cost_per_sphere carries the obstacle-only per-sphere cost used by
    the curvature correction (orcdchomp_mod.cpp:1241 scales by the
    sphere cost accumulated *before* self-collision terms).
    """
    x = kin.x_mov                                # (m, S, 3)
    vel = kin.vel
    vnorm = jnp.linalg.norm(vel, axis=-1)        # (m, S)
    eps = prob.epsilon

    # per-field grid-frame query points (orcdchomp_mod.cpp:1169-1196)
    g_point = qt.pose_apply(prob.pose_gsdf_world, x[:, :, None, :])  # (m,S,F,3)
    dist_f, grad_f, _ = multigrid_interp_grad(
        fields.data, fields.sizes, fields.lengths, g_point)
    inf = jnp.asarray(jnp.inf, dist_f.dtype)
    dist_f = jnp.where(prob.field_enabled, dist_f, inf)

    # min-select across fields (first field wins ties)
    best = jnp.argmin(dist_f, axis=-1)                          # (m, S)
    dist = jnp.min(dist_f, axis=-1)
    has_field = jnp.isfinite(dist)
    dist = jnp.where(has_field, dist, 0.0)

    # distance from sphere surface (orcdchomp_mod.cpp:1198)
    d = dist - radii

    # hinge cost scaled by workspace speed (orcdchomp_mod.cpp:1201-1205)
    c_in = prob.obs_factor * (0.5 * eps - d)
    c_mid = prob.obs_factor * (0.5 / eps) * (d - eps) ** 2
    cost_sphere = vnorm * jnp.where(d < 0.0, c_in,
                                    jnp.where(d < eps, c_mid, 0.0))
    cost_sphere = jnp.where(has_field, cost_sphere, 0.0)

    if not want_grad:
        return jnp.sum(cost_sphere), None, cost_sphere

    # gradient of best field, rotated to world (orcdchomp_mod.cpp:1207-1216);
    # the rotation is applied per field *before* the select so no
    # (m,S)-indexed pose gather is needed
    w_grad_f = qt.pose_rotate_vec(prob.pose_world_gsdf, grad_f)  # (m, S, F, 3)
    w_grad = jnp.take_along_axis(
        w_grad_f, best[..., None, None], axis=-2)[..., 0, :]    # (m, S, 3)

    # cost-slope scaling (orcdchomp_mod.cpp:1218-1223)
    slope = jnp.where(d < 0.0, -1.0, jnp.where(d < eps, d / eps - 1.0, 0.0))
    x_grad = w_grad * (slope * vnorm * prob.obs_factor)[..., None]
    x_grad = jnp.where(has_field[..., None], x_grad, 0.0)

    # remove component along the velocity (orcdchomp_mod.cpp:1225-1230)
    v2 = jnp.sum(vel * vel, axis=-1)
    safe = vnorm > _VEL_EPS
    proj = jnp.where(safe, jnp.sum(x_grad * vel, axis=-1) /
                     jnp.where(safe, v2, 1.0), 0.0)
    x_grad = x_grad - proj[..., None] * vel

    # curvature correction κ = (I − x̂x̂ᵀ)ẍ / ‖ẋ‖² (orcdchomp_mod.cpp:1232-1241)
    acc = kin.acc
    aproj = jnp.where(safe, jnp.sum(acc * vel, axis=-1) /
                      jnp.where(safe, v2, 1.0), 0.0)
    curv = (acc - aproj[..., None] * vel) * \
        jnp.where(safe, 1.0 / jnp.where(safe, v2, 1.0), 0.0)[..., None]
    x_grad = x_grad - cost_sphere[..., None] * curv

    # speed scale of the Jᵀ map (orcdchomp_mod.cpp:1243-1245), applied
    # here; the Jacobian contraction happens jointly in total_cost_grad
    return jnp.sum(cost_sphere), x_grad * vnorm[..., None], cost_sphere


def self_collision_cost_grad(spec: ChompSpec, same_link_mask, radii_act,
                             radii_all, prob: ChompProblem,
                             kin: TrajKinematics, want_grad: bool):
    """All-pairs sphere self-collision cost + gradient.

    same_link_mask: (S_act, S_all) bool — skip pairs on one link
    (orcdchomp_mod.cpp:1256).
    radii_act: (S_act,), radii_all: (S_all,) with the active block
    first, matching the reference's sphere list ordering.
    """
    x_i = kin.x_mov                                       # (m, S_act, 3)
    m = x_i.shape[0]
    if prob.inactive_pos.shape[0]:
        x_other = jnp.concatenate(
            [x_i, jnp.broadcast_to(prob.inactive_pos,
                                   (m,) + prob.inactive_pos.shape)], axis=1)
    else:
        x_other = x_i                                      # (m, S_all, 3)

    vel = kin.vel
    vnorm = jnp.linalg.norm(vel, axis=-1)                  # (m, S_act)
    eps_s = prob.epsilon_self

    # Pair distances via dot products instead of the (m, Sa, So, 3)
    # difference tensor: every pairwise quantity below is a *scalar*
    # (m, Sa, So) matrix, and the pair direction vectors are never
    # materialized — 3x less elementwise traffic on the hottest tensors
    # of the step.  NB the pair contractions are written as broadcast-
    # multiply + reduce, NOT einsum/dot: a K=3 contraction batched over
    # (m, Sa) would lower to many tiny matrix products, while the
    # broadcast form fuses into one elementwise loop.
    xi2 = jnp.sum(x_i * x_i, axis=-1)                      # (m, Sa)
    xo2 = jnp.sum(x_other * x_other, axis=-1)              # (m, So)
    xio = jnp.sum(x_i[:, :, None, :] * x_other[:, None, :, :], axis=-1)
    cdist = jnp.sqrt(jnp.maximum(
        xi2[:, :, None] + xo2[:, None, :] - 2.0 * xio, 0.0))
    rsum = radii_act[:, None] + radii_all[None, :]         # (Sa, So)
    pair_ok = (~same_link_mask) & (cdist <= rsum + eps_s)

    d = cdist - rsum
    # hinge cost (orcdchomp_mod.cpp:1281-1288); the else branch has no
    # upper cutoff because pairs beyond rsum+eps_self were skipped
    c = jnp.where(d < 0.0, 0.5 * eps_s - d, (0.5 / eps_s) * (d - eps_s) ** 2)
    cost_pair = jnp.where(pair_ok, c, 0.0) * \
        (prob.obs_factor_self * vnorm)[..., None]
    cost = jnp.sum(cost_pair)

    if not want_grad:
        return cost, None

    # g_ij = w1_ij (x_i − x_j) with the scalar pair weight
    # w1 = [ok]·slope·obs_self·‖ẋ_i‖ / max(‖x_i−x_j‖, 1e-12)
    # (u·slope·scale of orcdchomp_mod.cpp:1290-1295, factored so the
    # direction vector never exists)
    slope = jnp.where(d < 0.0, -1.0, d / eps_s - 1.0)
    w1 = jnp.where(pair_ok,
                   slope * (prob.obs_factor_self * vnorm)[..., None]
                   / jnp.maximum(cdist, 1e-12), 0.0)       # (m, Sa, So)

    # projection off the velocity of sphere i (orcdchomp_mod.cpp:1297-1301):
    # g'_ij = g_ij − (g_ij·v_i/‖v_i‖²) v_i, and
    # g_ij·v_i = w1_ij (x_i·v_i − x_j·v_i)  — again scalar matrices
    v2 = jnp.sum(vel * vel, axis=-1)                       # (m, Sa)
    safe = vnorm > _VEL_EPS
    xv = jnp.sum(x_i * vel, axis=-1)                       # (m, Sa)
    xov = jnp.sum(vel[:, :, None, :] * x_other[:, None, :, :], axis=-1)
    b = xv[:, :, None] - xov
    w2 = jnp.where(safe[..., None],
                   w1 * b / jnp.where(safe, v2, 1.0)[..., None], 0.0)

    # net workspace gradient per active sphere:
    #   Σ_j g'_sj − Σ_i g'_is[active]
    # = x_s·Σ_j w1_sj − (w1 @ x_other)_s − v_s·Σ_j w2_sj
    #   − [(w1ᵃᵀ x)_s − x_s·Σ_i w1ᵃ_is − (w2ᵃᵀ v)_s]
    # (J2 = J_i − J_j is likewise never materialized; the caller maps
    # this net through each sphere's own Jᵀ once)
    s_act = x_i.shape[1]
    w1a = w1[:, :, :s_act]
    w2a = w2[:, :, :s_act]
    r1 = jnp.sum(w1, axis=2)                               # (m, Sa)
    r2 = jnp.sum(w2, axis=2)
    c1 = jnp.sum(w1a, axis=1)                              # (m, Sa) col sums
    xo_b = x_other[:, None, :, :]                          # (m, 1, So, 3)
    net = (x_i * r1[..., None]
           - jnp.sum(w1[..., None] * xo_b, axis=2)         # w1 @ x_other
           - vel * r2[..., None]
           - jnp.sum(w1a[..., None] * x_i[:, :, None, :], axis=1)  # w1ᵃᵀ x
           + x_i * c1[..., None]
           + jnp.sum(w2a[..., None] * vel[:, :, None, :], axis=1))  # w2ᵃᵀ v
    return cost, net, cost_pair


def total_cost_grad(spec: ChompSpec, fk, fields: FieldStack,
                    same_link_mask, radii_act, radii_all,
                    prob: ChompProblem, want_grad: bool = True):
    """Full obstacle+self cost and gradient for one problem.

    Returns (cost_obs (), G (m, n) or None, kin).  Cost and gradient
    are averaged over moving points (chomp.c:489-492).
    """
    with jax.named_scope("callback_pre"):
        kin = trajectory_kinematics(spec, fk, prob.traj, prob.robot_pose)
    with jax.named_scope("obstacle"):
        c_obs, w_obs, _ = obstacle_cost_grad(
            spec, fields, radii_act, prob, kin, want_grad)
    with jax.named_scope("selfcol"):
        out_self = self_collision_cost_grad(
            spec, same_link_mask, radii_act, radii_all, prob, kin, want_grad)
    c_self, w_self = out_self[0], out_self[1]
    cost = (c_obs + c_self) / spec.m
    if not want_grad:
        return cost, None, kin
    # single joint Jᵀ map for both workspace gradients, in factored form
    # (apply_sphere_jacT): the (m,S,3,n) Jacobian tensor is never built
    with jax.named_scope("jtmap"):
        w = w_obs + w_self
        G_arm = fk.apply_sphere_jacT(kin.anchors_mov, kin.x_mov, w)
        if spec.floating_base:
            # base block (orcdchomp_mod.cpp:1050-1086), transposed:
            # Jᵀw = 0.01·(Jsp[:3]ᵀ Σ(x×w) + Jsp[3:]ᵀ Σw)
            # using cross_mat(−x)ᵀ w = x × w
            Jsp = sp.pose_jac(kin.base_mov)              # (m, 6, 7)
            sxw = jnp.sum(jnp.cross(kin.x_mov, w), axis=1)  # (m, 3)
            sw = jnp.sum(w, axis=1)                         # (m, 3)
            G_base = _BASE_JAC_DAMP * (
                jnp.sum(Jsp[:, 0:3] * sxw[:, :, None], axis=1)
                + jnp.sum(Jsp[:, 3:6] * sw[:, :, None], axis=1))  # (m, 7)
            G = jnp.concatenate([G_base, G_arm], axis=-1) / spec.m
        else:
            G = G_arm / spec.m
    return cost, G, kin
