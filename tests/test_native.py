"""Native host runtime vs JAX pipeline parity (voxelize/flood/EDT/IO).

These run whether or not the shared library builds: every native entry
point falls back to the JAX implementation, and the parity assertions
hold either way (they are exact when the fallback engages).
"""

import numpy as np

import jax.numpy as jnp

from or_cdchomp_jax import native
from or_cdchomp_jax.ops.flood import exterior_free_mask
from or_cdchomp_jax.ops.grid import Grid3D
from or_cdchomp_jax.ops.quat import pose_apply, pose_invert
from or_cdchomp_jax.ops.voxelize import Scene, voxelize_scene
from or_cdchomp_jax.utils import np_pose


def _world():
    rot = np.array([0.0, 0.0, np.sin(0.3), np.cos(0.3)])
    table = Scene.build(
        boxes=[((0.1, 0.0, 0.4, *rot), (0.3, 0.4, 0.02)),
               ((0.0, 0.0, 0.2, 0, 0, 0, 1), (0.05, 0.05, 0.2))],
        spheres=[((0.2, 0.3, 0.5), 0.08)],
        cylinders=[((0.3, -0.2, 0.5, 0, 0, 0, 1), 0.05, 0.1)],
        dtype=jnp.float64)
    mug = Scene.build(spheres=[((0.0, 0.0, 0.0), 0.06)], dtype=jnp.float64)
    scenes = (table, mug)
    poses = (np.array([0.0, 0.0, 0.0, 0, 0, 0, 1.0]),
             np.array([0.25, 0.1, 0.55, 0, 0, 0, 1.0]))
    pose_world_gsdf = np.array([-0.5, -0.6, 0.0, 0, 0, 0, 1.0])
    sizes = (20, 24, 16)
    lengths = np.array([1.4, 1.5, 1.0])
    return scenes, poses, pose_world_gsdf, sizes, lengths


def _jax_occupancy(scenes, poses, pose_world_gsdf, sizes, lengths, e):
    grid = Grid3D.create(sizes, lengths, dtype=jnp.float64)
    centers_w = pose_apply(jnp.asarray(pose_world_gsdf), grid.all_centers())
    occ = np.zeros(sizes, dtype=bool)
    for sc, pose in zip(scenes, poses):
        local = pose_apply(jnp.asarray(np_pose.invert(pose)), centers_w)
        occ |= np.asarray(voxelize_scene(sc, local, e))
    return occ


def test_voxelize_native_matches_jax():
    scenes, poses, pose_world_gsdf, sizes, lengths = _world()
    e = 0.035
    ref = _jax_occupancy(scenes, poses, pose_world_gsdf, sizes, lengths, e)
    assert ref.any() and not ref.all()
    got = native.voxelize_native(scenes, poses, pose_world_gsdf, sizes,
                                 lengths, e)
    np.testing.assert_array_equal(got.astype(bool), ref)


def test_flood_exterior_native_matches_jax():
    rng = np.random.default_rng(0)
    occ = (rng.uniform(size=(12, 13, 9)) < 0.35)
    occ[0, 0, 0] = False
    # carve an enclosed pocket
    occ[5:8, 5:8, 4:7] = True
    occ[6, 6, 5] = False
    ref = np.asarray(exterior_free_mask(occ))
    got = native.flood_exterior_native(occ.astype(np.uint8))
    np.testing.assert_array_equal(got.astype(bool), ref)


def test_build_sdf_native_matches_device_pipeline():
    from or_cdchomp_jax.ops.edt import signed_edt

    scenes, poses, pose_world_gsdf, sizes, lengths = _world()
    e = 0.035
    occ = _jax_occupancy(scenes, poses, pose_world_gsdf, sizes, lengths, e)
    ref = np.asarray(signed_edt(
        np.asarray(exterior_free_mask(occ)), jnp.asarray(lengths)))
    got = native.build_sdf_native(scenes, poses, pose_world_gsdf, sizes,
                                  lengths, e)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)


def test_native_library_builds():
    """The toolchain is present in CI images; the .so must build."""
    assert native.available(), "libcdx_native.so failed to build/load"
