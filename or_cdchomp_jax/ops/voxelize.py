"""Analytic scene primitives: voxelization + exact point distances.

The reference voxelizes by sweeping a probe cube kinbody through every
grid cell and asking the OpenRAVE collision checker
(orcdchomp_mod.cpp:495-525).  There is no collision engine on the device, so
scenes are described analytically — oriented boxes, spheres, cylinders,
triangle meshes — and occupancy is computed in-graph as a batched
cell-cube-vs-primitive overlap test over all cells × primitives:

 - sphere vs cell cube: exact (closest-point distance ≤ radius)
 - oriented box vs cell cube: exact 15-axis SAT
 - triangle mesh vs cell cube: exact 13-axis triangle-cube SAT per
   face (occupancy is the surface shell; closed interiors are filled
   by the flood-fill exterior pass exactly like the reference's
   unreached-cells rule, orcdchomp_mod.cpp:540-548)
 - cylinder vs cell cube: exact up to the 1e-4 m contact tolerance
   `_AP_TOL` (native path: gap² ≤ 1e-8 m²) — inscribed/circumscribed
   sphere bounds decide all but a thin shell of cells, and shell cells
   run an alternating-projection (Cheney–Goldstein) closest-pair
   iteration between the solid cube and solid cylinder (both convex,
   so the iteration converges to the true set distance; cells within
   0.1 mm of contact classify as hits).
   Round 3 used the circumscribed-sphere bound alone, biasing cylinder
   occupancy outward by up to (√3−1)·cube_extent vs the reference's
   exact probe-cube collision check (orcdchomp_mod.cpp:495-525).

The same primitive set provides exact signed point distances, used by
the trajectory validity re-check (the replacement for gettraj's sampled
CheckCollision pass, orcdchomp_mod.cpp:2958-3006).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from or_cdchomp_jax.ops.quat import pose_apply, pose_invert, quat_rotate


class Scene(NamedTuple):
    """Static analytic obstacle set (all arrays may be empty).

    Poses give primitive frame in scene (kinbody) frame.
    """

    box_pose: jnp.ndarray      # (B, 7)
    box_half: jnp.ndarray      # (B, 3)
    sphere_center: jnp.ndarray # (S, 3)
    sphere_radius: jnp.ndarray # (S,)
    cyl_pose: jnp.ndarray      # (C, 7)  axis = local +z
    cyl_radius: jnp.ndarray    # (C,)
    cyl_half: jnp.ndarray      # (C,)  half-height
    tri_verts: jnp.ndarray     # (T, 3, 3) mesh triangles, scene frame

    @classmethod
    def empty(cls, dtype=jnp.float32):
        z = lambda *s: jnp.zeros(s, dtype=dtype)
        return cls(z(0, 7), z(0, 3), z(0, 3), z(0), z(0, 7), z(0), z(0),
                   z(0, 3, 3))

    @classmethod
    def build(cls, boxes=(), spheres=(), cylinders=(), meshes=(),
              dtype=jnp.float32):
        """boxes: [(pose7, half_extents)], spheres: [(center, radius)],
        cylinders: [(pose7, radius, half_height)],
        meshes: [(pose7, vertices (V, 3), faces (F, 3) int)] — triangle
        meshes like the reference demo's rolly-table.iv / mug3.iv
        (test_wam7.py:22-28); triangles are baked into the scene frame
        at build time."""
        def arr(rows, width):
            if not rows:
                return jnp.zeros((0, width), dtype=dtype)
            return jnp.asarray(np.asarray(rows, dtype=np.float64), dtype=dtype)

        bp = arr([b[0] for b in boxes], 7)
        bh = arr([b[1] for b in boxes], 3)
        sc = arr([s[0] for s in spheres], 3)
        sr = jnp.asarray(
            np.asarray([s[1] for s in spheres], dtype=np.float64), dtype=dtype
        ) if spheres else jnp.zeros((0,), dtype=dtype)
        cp = arr([c[0] for c in cylinders], 7)
        cr = jnp.asarray(
            np.asarray([c[1] for c in cylinders], dtype=np.float64), dtype=dtype
        ) if cylinders else jnp.zeros((0,), dtype=dtype)
        ch = jnp.asarray(
            np.asarray([c[2] for c in cylinders], dtype=np.float64), dtype=dtype
        ) if cylinders else jnp.zeros((0,), dtype=dtype)
        tris = []
        from or_cdchomp_jax.utils import np_pose
        for pose, verts, faces in meshes:
            v = np.asarray(verts, dtype=np.float64)
            f = np.asarray(faces, dtype=np.int64)
            pose = np.asarray(pose, dtype=np.float64)
            vw = np.stack([np_pose.apply(pose, vi) for vi in v]) \
                if v.shape[0] else v.reshape(0, 3)
            tris.append(vw[f])                       # (F, 3, 3)
        tv = (jnp.asarray(np.concatenate(tris, axis=0), dtype=dtype)
              if tris else jnp.zeros((0, 3, 3), dtype=dtype))
        return cls(bp, bh, sc, sr, cp, cr, ch, tv)

    def bounding_spheres(self):
        """(centers (N, 3), radii (N,)) covering every primitive —
        sphere primitives exactly, boxes/cylinders by their circumscribed
        spheres.  Used when a grabbed body's geometry becomes robot
        collision spheres (orcdchomp_mod.cpp:2200-2208 analog)."""
        centers, radii = [], []
        sc = np.asarray(self.sphere_center, dtype=np.float64)
        sr = np.asarray(self.sphere_radius, dtype=np.float64)
        for i in range(sc.shape[0]):
            centers.append(sc[i])
            radii.append(float(sr[i]))
        bp = np.asarray(self.box_pose, dtype=np.float64)
        bh = np.asarray(self.box_half, dtype=np.float64)
        for i in range(bp.shape[0]):
            centers.append(bp[i, :3])
            radii.append(float(np.linalg.norm(bh[i])))
        cp = np.asarray(self.cyl_pose, dtype=np.float64)
        cr = np.asarray(self.cyl_radius, dtype=np.float64)
        ch = np.asarray(self.cyl_half, dtype=np.float64)
        for i in range(cp.shape[0]):
            centers.append(cp[i, :3])
            radii.append(float(np.sqrt(cr[i] ** 2 + ch[i] ** 2)))
        tv = np.asarray(self.tri_verts, dtype=np.float64)
        if tv.shape[0]:
            pts = tv.reshape(-1, 3)
            c = 0.5 * (pts.min(axis=0) + pts.max(axis=0))
            centers.append(c)
            radii.append(float(np.linalg.norm(pts - c, axis=1).max()))
        if not centers:
            return np.zeros((0, 3)), np.zeros((0,))
        return np.stack(centers), np.asarray(radii)


# ---------------------------------------------------------------------------
# mesh generators (reference demo scene shapes as triangle meshes)
# ---------------------------------------------------------------------------

def box_trimesh(half):
    """(verts (8, 3), faces (12, 3)) of a centered axis-aligned box —
    closed, outward-wound."""
    hx, hy, hz = (float(h) for h in np.asarray(half, np.float64))
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 dtype=np.float64)
    # index = 4*x + 2*y + z with -:0 +:1
    f = np.array([
        [0, 1, 3], [0, 3, 2],          # -x
        [4, 7, 5], [4, 6, 7],          # +x
        [0, 5, 1], [0, 4, 5],          # -y
        [2, 3, 7], [2, 7, 6],          # +y
        [0, 2, 6], [0, 6, 4],          # -z
        [1, 5, 7], [1, 7, 3],          # +z
    ], dtype=np.int64)
    return v, f


def cylinder_trimesh(radius, half, n=24):
    """(verts, faces) of a closed z-aligned centered cylinder with an
    n-gon cross-section (inscribed in the analytic cylinder)."""
    r, h = float(radius), float(half)
    ang = 2.0 * np.pi * np.arange(n) / n
    ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)
    bot = np.concatenate([ring, np.full((n, 1), -h)], axis=-1)
    top = np.concatenate([ring, np.full((n, 1), h)], axis=-1)
    v = np.concatenate([bot, top,
                        [[0.0, 0.0, -h]], [[0.0, 0.0, h]]], axis=0)
    cb, ct = 2 * n, 2 * n + 1
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i],     # side
                  [cb, j, i], [ct, n + i, n + j]]       # caps
    return v, np.asarray(faces, dtype=np.int64)


# ---------------------------------------------------------------------------
# point signed distances (exact)
# ---------------------------------------------------------------------------

def sd_box(p_local, half):
    """Signed distance of local-frame point(s) to a centered box."""
    q = jnp.abs(p_local) - half
    outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


def sd_cylinder(p_local, radius, half):
    """Signed distance to a z-aligned centered cylinder."""
    dr = jnp.linalg.norm(p_local[..., :2], axis=-1) - radius
    dz = jnp.abs(p_local[..., 2]) - half
    q = jnp.stack([dr, dz], axis=-1)
    outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


def _closest_tri_dist(p, tri):
    """Distance from point(s) p (..., 3) to each triangle (T, 3, 3) →
    (..., T).  Ericson's 6-region closest-point algorithm, branchless."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]           # (T, 3)
    pe = p[..., None, :]                                # (..., 1, 3)
    ab = b - a
    ac = c - a
    ap = pe - a
    dot = lambda u, v: jnp.sum(u * v, axis=-1)
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = pe - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = pe - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    safe = lambda den: jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
    # face region (default), then override by edge/vertex regions
    denom = safe(va + vb + vc)
    v = vb / denom
    w = vc / denom
    closest = a + ab * v[..., None] + ac * w[..., None]
    t_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    closest = jnp.where(on_bc[..., None],
                        b + (c - b) * t_bc[..., None], closest)
    t_ac = d2 / safe(d2 - d6)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    closest = jnp.where(on_ac[..., None], a + ac * t_ac[..., None], closest)
    t_ab = d1 / safe(d1 - d3)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    closest = jnp.where(on_ab[..., None], a + ab * t_ab[..., None], closest)
    closest = jnp.where(((d6 >= 0) & (d5 <= d6))[..., None], c, closest)
    closest = jnp.where(((d3 >= 0) & (d4 <= d3))[..., None], b, closest)
    closest = jnp.where(((d1 <= 0) & (d2 <= 0))[..., None], a, closest)
    return jnp.linalg.norm(pe - closest, axis=-1)


def sd_trimesh(p, tri_verts):
    """Signed distance from point(s) (..., 3) to a closed triangle
    mesh (T, 3, 3): unsigned surface distance, negated inside.

    Inside/outside by the generalized winding number (van Oosterom-
    Strackee signed solid angles): exact for closed watertight meshes
    like the reference demo's .iv models, and free of the ray-casting
    edge/vertex degeneracies (a ray through a cap apex counts every
    adjacent face).
    """
    dist = jnp.min(_closest_tri_dist(p, tri_verts), axis=-1)
    pe = p[..., None, :]
    a = tri_verts[:, 0] - pe                             # (..., T, 3)
    b = tri_verts[:, 1] - pe
    c = tri_verts[:, 2] - pe
    la = jnp.linalg.norm(a, axis=-1)
    lb = jnp.linalg.norm(b, axis=-1)
    lc = jnp.linalg.norm(c, axis=-1)
    det = jnp.sum(a * jnp.cross(b, c), axis=-1)
    dot = lambda u, v: jnp.sum(u * v, axis=-1)
    denom = (la * lb * lc + dot(a, b) * lc + dot(b, c) * la
             + dot(c, a) * lb)
    omega = jnp.sum(jnp.arctan2(det, denom), axis=-1)    # Σ Ω/2
    winding = omega / (2.0 * jnp.pi)
    return jnp.where(winding > 0.5, -dist, dist)


def scene_distance(scene: Scene, p):
    """Min signed distance from point(s) (..., 3) to all primitives.

    Returns +inf for an empty scene.
    """
    dists = []
    if scene.box_pose.shape[0]:
        pl = pose_apply(pose_invert(scene.box_pose), p[..., None, :])
        dists.append(jnp.min(sd_box(pl, scene.box_half), axis=-1))
    if scene.sphere_center.shape[0]:
        d = jnp.linalg.norm(p[..., None, :] - scene.sphere_center, axis=-1)
        dists.append(jnp.min(d - scene.sphere_radius, axis=-1))
    if scene.cyl_pose.shape[0]:
        pl = pose_apply(pose_invert(scene.cyl_pose), p[..., None, :])
        dists.append(jnp.min(sd_cylinder(pl, scene.cyl_radius, scene.cyl_half), axis=-1))
    if scene.tri_verts.shape[0]:
        dists.append(sd_trimesh(p, scene.tri_verts))
    if not dists:
        return jnp.full(p.shape[:-1], jnp.inf, dtype=p.dtype)
    return jnp.min(jnp.stack(dists, axis=0), axis=0)


# ---------------------------------------------------------------------------
# cell-cube occupancy (probe-cube replacement)
# ---------------------------------------------------------------------------

def _obb_aabb_overlap(center, half_aabb, box_pose, box_half):
    """Exact SAT between an axis-aligned cube (at ``center`` with half
    extents ``half_aabb``) and oriented box(es).  Shapes broadcast:
    center (..., 3) vs box_pose (B, 7) → (..., B) bool."""
    from or_cdchomp_jax.ops.quat import quat_to_R

    R = quat_to_R(box_pose[..., 3:])         # (B, 3, 3) box→world
    t = box_pose[..., :3] - center[..., None, :]  # (..., B, 3) box center rel cube
    # SAT in the cube (world-aligned) frame; box axes are columns of R.
    absR = jnp.abs(R) + 1e-7

    a = half_aabb  # scalar or (3,)
    b = box_half   # (B, 3)

    # world axes: |t.e_i| <= a_i + sum_j b_j * |R_ij|
    ra = a + jnp.einsum("...bij,...bj->...bi", absR,
                        jnp.broadcast_to(b, t.shape), precision="highest")
    sep_w = jnp.any(jnp.abs(t) > ra, axis=-1)

    # box axes: |t . R_:,j| <= b_j + sum_i a_i |R_ij|
    t_in_box = jnp.einsum("...bij,...bi->...bj", R, t, precision="highest")
    rb = b + jnp.einsum("...bij,...i->...bj", absR, jnp.broadcast_to(
        jnp.asarray(a), t[..., 0, :].shape), precision="highest")
    sep_b = jnp.any(jnp.abs(t_in_box) > rb, axis=-1)

    # cross axes e_i × R_:,j  (9 of them)
    sep_c = jnp.zeros(sep_w.shape, dtype=bool)
    a_vec = jnp.broadcast_to(jnp.asarray(a), (3,)) * jnp.ones_like(t)
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            # L = e_i × R_:,j ; project t, cube, box onto L
            tl = t[..., i2] * R[..., i1, j] - t[..., i1] * R[..., i2, j]
            ra_c = a_vec[..., i1] * absR[..., i2, j] + a_vec[..., i2] * absR[..., i1, j]
            rb_c = b[..., j1] * absR[..., i, j2] + b[..., j2] * absR[..., i, j1]
            sep_c = sep_c | (jnp.abs(tl) > ra_c + rb_c)

    return ~(sep_w | sep_b | sep_c)


def _tri_cube_overlap(centers, e, tri):
    """Exact 13-axis SAT between axis-aligned cubes (at ``centers``
    (..., 3), half extent ``e``) and triangles (T, 3, 3) → (..., T)
    bool (Akenine-Möller triangle-box test).

    Thresholds carry a 1e-9 inclusive tolerance so exact-touch
    contacts (a face coplanar with a cube side) classify as hits
    regardless of rounding — mirroring the 1e-7 |R| inflation of the
    OBB SAT above."""
    tol = 1e-9
    v = tri - centers[..., None, None, :]               # (..., T, 3, 3)
    # 3 cube face axes: triangle AABB vs cube
    mn = jnp.min(v, axis=-2)
    mx = jnp.max(v, axis=-2)
    sep = jnp.any((mn > e + tol) | (mx < -e - tol), axis=-1)  # (..., T)

    v0, v1, v2 = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    f0, f1, f2 = v1 - v0, v2 - v1, v0 - v2
    # 1 triangle plane axis
    n = jnp.cross(f0, f1)
    d = jnp.sum(n * v0, axis=-1)
    r = e * jnp.sum(jnp.abs(n), axis=-1)
    sep = sep | (jnp.abs(d) > r + tol)

    # 9 edge-cross axes a = e_i × f_k (component i of a is 0)
    for f in (f0, f1, f2):
        for i in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            # a = e_i × f → a[i]=0, a[i1]=−f[i2], a[i2]=f[i1]
            p0 = -v0[..., i1] * f[..., i2] + v0[..., i2] * f[..., i1]
            p1 = -v1[..., i1] * f[..., i2] + v1[..., i2] * f[..., i1]
            p2 = -v2[..., i1] * f[..., i2] + v2[..., i2] * f[..., i1]
            rad = e * (jnp.abs(f[..., i2]) + jnp.abs(f[..., i1])) + tol
            pmin = jnp.minimum(jnp.minimum(p0, p1), p2)
            pmax = jnp.maximum(jnp.maximum(p0, p1), p2)
            sep = sep | (pmin > rad) | (pmax < -rad)
    return ~sep


def voxelize_scene(scene: Scene, centers, cube_extent):
    """Occupancy of probe cubes at ``centers`` (..., 3) in scene frame.

    Matches the reference's per-cell collision test
    (orcdchomp_mod.cpp:495-525) with analytic primitives.
    """
    occ = jnp.zeros(centers.shape[:-1], dtype=bool)
    if scene.box_pose.shape[0]:
        hit = _obb_aabb_overlap(centers, cube_extent, scene.box_pose, scene.box_half)
        occ = occ | jnp.any(hit, axis=-1)
    if scene.sphere_center.shape[0]:
        # exact sphere-vs-cube: closest point in cube to sphere center
        d = scene.sphere_center - centers[..., None, :]
        closest = jnp.clip(d, -cube_extent, cube_extent)
        dist = jnp.linalg.norm(d - closest, axis=-1)
        occ = occ | jnp.any(dist <= scene.sphere_radius, axis=-1)
    if scene.cyl_pose.shape[0]:
        hit = _cyl_cube_overlap(centers, cube_extent, scene.cyl_pose,
                                scene.cyl_radius, scene.cyl_half)
        occ = occ | jnp.any(hit, axis=-1)
    if scene.tri_verts.shape[0]:
        # surface-shell occupancy; closed interiors become obstacle via
        # the flood-fill unreached rule (orcdchomp_mod.cpp:540-548),
        # exactly like the reference's probe-cube vs trimesh check
        hit = _tri_cube_overlap(centers, cube_extent, scene.tri_verts)
        occ = occ | jnp.any(hit, axis=-1)
    return occ


# Alternating projections converge slowly on sliver/tangential
# contacts (measured: some true intersections plateau near 1e-4 m
# after hundreds of iterations, while a 40³-per-cube sample brute
# force *misses* genuine slivers entirely) — 96 iterations with a
# 1e-4 m contact tolerance classifies every cell a dense sampler can
# even adjudicate, vs the old (√3−1)·cube_extent ≈ 7e-3 m bias.
_AP_ITERS = 96
_AP_TOL = 1e-4     # meters: contact classification tolerance


def _cyl_cube_overlap(centers, cube_extent, cyl_pose, cyl_radius,
                      cyl_half):
    """Exact axis-aligned-cube vs cylinder overlap (per cell, per cyl).

    centers (..., 3) in scene frame → (..., C) bool.

    Three-stage test per pair:
      sd ≤ e        (cube's inscribed sphere hits)   → exact accept
      sd > e·√3     (circumscribed sphere misses)    → exact reject
      otherwise: alternate closest-point projections between the solid
      cube and solid cylinder; both sets are convex, so the pair
      distance converges to the true set distance (hit iff ≤ _AP_TOL).
    """
    inv = pose_invert(cyl_pose)
    c_l = pose_apply(inv, centers[..., None, :])       # (..., C, 3)
    sd = sd_cylinder(c_l, cyl_radius, cyl_half)
    e = cube_extent
    accept = sd <= e
    reject = sd > e * np.sqrt(3.0)

    # cube axes in cylinder frame: rows of R(q_inv) = columns of R(q)
    from or_cdchomp_jax.ops.quat import quat_to_R
    Rt = quat_to_R(inv[..., 3:])                        # (C, 3, 3)

    def proj_box(q):
        # cube axis i in the cylinder frame is column i of Rt, so cube
        # coords are u = Rtᵀ(q − c_l); the projected point is c_l + Rt u
        rel = q - c_l
        u = jnp.einsum("...cji,...cj->...ci", Rt, rel, precision="highest")
        u = jnp.clip(u, -e, e)
        return c_l + jnp.einsum("...cij,...cj->...ci", Rt, u, precision="highest")

    def proj_cyl(p):
        z = jnp.clip(p[..., 2], -cyl_half, cyl_half)
        rxy = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        s = jnp.where(rxy > cyl_radius,
                      cyl_radius / jnp.maximum(rxy, 1e-30), 1.0)
        return jnp.stack([p[..., 0] * s, p[..., 1] * s, z], axis=-1)

    q0 = proj_cyl(c_l)

    def body(_, q):
        return proj_cyl(proj_box(q))

    q = jax.lax.fori_loop(0, _AP_ITERS, body, q0)
    u = proj_box(q)
    dist = jnp.linalg.norm(u - q, axis=-1)
    return accept | (~reject & (dist <= _AP_TOL))
