"""Triangle-mesh scene primitive: voxelization + signed distance.

The reference's flagship demo scene is trimeshes (rolly-table.iv +
mug3.iv, test_wam7.py:22-28) voxelized by probe-cube collision checks
(orcdchomp_mod.cpp:495-525).  These tests pin this build's mesh
path against the analytic primitives: a meshed box must voxelize and
SDF like the analytic box, the signed point distance must be correct
inside and out, and the native (C++) voxelizer must agree with the
in-graph SAT.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.ops.voxelize import (
    Scene, box_trimesh, cylinder_trimesh, sd_trimesh, voxelize_scene,
    _tri_cube_overlap)

POSE_ID = (0.0, 0.0, 0.0, 0, 0, 0, 1)
HALF = (0.25, 0.15, 0.1)


def _grid_centers(lo, hi, n):
    axes = [np.linspace(lo[i], hi[i], n) for i in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return jnp.asarray(g.reshape(-1, 3))


def test_meshed_box_voxelizes_like_analytic_box():
    """Shell occupancy of the meshed box ⊆ analytic box occupancy, and
    every boundary-crossing cell of the analytic box is in the shell."""
    v, f = box_trimesh(HALF)
    mesh_scene = Scene.build(meshes=[(POSE_ID, v, f)], dtype=jnp.float64)
    box_scene = Scene.build(boxes=[(POSE_ID, HALF)], dtype=jnp.float64)
    e = 0.03
    centers = _grid_centers([-0.4, -0.4, -0.4], [0.4, 0.4, 0.4], 21)
    occ_mesh = np.asarray(voxelize_scene(mesh_scene, centers, e))
    occ_box = np.asarray(voxelize_scene(box_scene, centers, e))
    # the mesh is the box's surface: every mesh hit is a box hit
    assert np.all(occ_box[occ_mesh])
    # a cube that overlaps the box but not its interior-only region
    # must hit the shell: cubes whose center is OUTSIDE the box but
    # that overlap it necessarily cross the surface
    c = np.asarray(centers)
    inside = np.all(np.abs(c) <= np.asarray(HALF), axis=-1)
    boundary = occ_box & ~inside
    assert np.all(occ_mesh[boundary])


def test_sd_trimesh_matches_box_sdf():
    v, f = box_trimesh(HALF)
    tri = jnp.asarray(v[f], dtype=jnp.float64)
    rng = np.random.default_rng(0)
    p = rng.uniform(-0.5, 0.5, size=(500, 3))
    d_mesh = np.asarray(sd_trimesh(jnp.asarray(p), tri))
    # analytic signed distance to the centered box
    q = np.abs(p) - np.asarray(HALF)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    d_box = outside + inside
    np.testing.assert_allclose(d_mesh, d_box, rtol=1e-9, atol=1e-9)


def test_sd_trimesh_cylinder_sign():
    """Inside/outside classification for the meshed cylinder (the
    surface differs from the analytic cylinder by the n-gon chord
    sagitta, so compare signs away from the surface)."""
    v, f = cylinder_trimesh(0.2, 0.3, n=48)
    tri = jnp.asarray(v[f], dtype=jnp.float64)
    pts = np.array([[0.0, 0.0, 0.0],      # deep inside
                    [0.1, 0.0, 0.1],      # inside
                    [0.0, 0.0, 0.5],      # above the cap
                    [0.35, 0.0, 0.0],     # outside radially
                    [0.3, 0.3, 0.3]])     # outside corner
    d = np.asarray(sd_trimesh(jnp.asarray(pts), tri))
    assert d[0] < -0.15 and d[1] < 0
    assert d[2] > 0.15 and d[3] > 0.1 and d[4] > 0.1


def test_native_tri_voxelize_matches_ingraph():
    from or_cdchomp_jax import native
    if not native.available():
        pytest.skip("native library unavailable")
    v, f = box_trimesh(HALF)
    # give the mesh a pose inside its scene to exercise the transform
    pose = (0.05, -0.02, 0.03, 0, 0, 0.19867, 0.98007)  # yaw ~ 0.4 rad
    scene = Scene.build(meshes=[(pose, v, f)], dtype=jnp.float64)
    sizes = (16, 14, 12)
    lengths = np.array([0.8, 0.7, 0.6])
    e = 0.025
    occ_nat = native.voxelize_native(
        [scene], [np.array([0.0, 0, 0, 0, 0, 0, 1])],
        np.array([-0.4, -0.35, -0.3, 0, 0, 0, 1]), sizes, lengths, e)
    # in-graph reference on the same grid: cell centers in the grid
    # frame, shifted by the grid's world pose (scene pose = identity)
    axes = [(np.arange(sizes[i]) + 0.5) * lengths[i] / sizes[i]
            for i in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    centers = g + np.array([-0.4, -0.35, -0.3])
    occ_jax = np.asarray(voxelize_scene(
        scene, jnp.asarray(centers.reshape(-1, 3)), e)).reshape(sizes)
    np.testing.assert_array_equal(occ_nat.astype(bool), occ_jax)


def test_grab_mesh_body_bounding_sphere():
    """Grabbing a mesh-scene body attaches its bounding sphere as a
    robot collision sphere (orcdchomp_mod.cpp:2200-2208 semantics —
    grabbed geometry rides the grabbing link)."""
    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot

    mv, mf = cylinder_trimesh(0.04, 0.06, n=12)
    mug = KinBody("mug", oc.Scene.build(
        meshes=[(POSE_ID, mv, mf)], dtype=jnp.float64),
        pose=np.array([0.5, 0.0, 0.8, 0, 0, 0, 1.0]))
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(mug)
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    n_before = len(r.model.sphere_radius)
    r.grab(mug, "wam7")
    assert len(r.model.sphere_radius) == n_before + 1
    # the bounding sphere of the n-gon cylinder mesh
    expect_r = float(np.sqrt(0.04 ** 2 + 0.06 ** 2))
    np.testing.assert_allclose(
        float(r.model.sphere_radius[-1]), expect_r, rtol=1e-6)
    r.release(mug)
    assert len(r.model.sphere_radius) == n_before


def test_mesh_scene_end_to_end_demo_shape():
    """The reference demo scene (table + mug) as triangle meshes:
    computedistancefield → solve → collision-free gettraj, and the SDF
    interior is negative (flood fill closed the meshed volume)."""
    tv, tf = box_trimesh((0.25, 0.4, 0.02))
    lv, lf = box_trimesh((0.08, 0.08, 0.25))
    mv, mf = cylinder_trimesh(0.04, 0.06, n=16)
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        meshes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), tv, tf),
                ((0.75, 0.0, 0.25, 0, 0, 0, 1), lv, lf)],
        dtype=jnp.float64)))
    mod.add_kinbody(KinBody("mug", oc.Scene.build(
        meshes=[((0.65, 0.15, 0.58, 0, 0, 0, 1), mv, mf)],
        dtype=jnp.float64)))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.08)
    r.enabled = True

    # interior of the meshed tabletop reads negative in the SDF (the
    # flood fill closed the watertight shell into solid obstacle)
    sdf = mod.sdfs[0]
    from or_cdchomp_jax.ops.grid import grid_interp
    from or_cdchomp_jax.utils import np_pose
    inv = np_pose.invert(np.asarray(sdf.pose, np.float64))
    p_local = np_pose.apply(inv, np.array([0.75, 0.0, 0.5]))
    val = grid_interp(sdf.grid.data, sdf.grid.lengths,
                      jnp.asarray(p_local, sdf.grid.data.dtype))[0]
    assert float(val) < 0.0

    h = mod.create(robot="wam",
                   adofgoal=[0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0],
                   lambda_=100.0, obs_factor=500.0, n_points=31)
    mod.iterate(run=h, n_iter=60)
    traj = mod.gettraj(run=h, no_collision_exception=True)
    assert not traj.in_collision
