"""ctypes bindings for the native host runtime (libcdx_native.so).

Builds on demand with the in-tree Makefile if the shared object is
missing; every entry point has a pure-Python/JAX fallback, so the
package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libcdx_native.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    def build():
        try:
            subprocess.run(["make", "-B", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
            return True
        except (subprocess.SubprocessError, FileNotFoundError):
            return False

    if not os.path.exists(_SO) and not build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    # a stale .so (built before newer entry points existed) must not
    # crash the declarations below with AttributeError — rebuild once,
    # else fall back to the pure-Python paths
    if not hasattr(lib, "cdx_voxelize_tris"):
        if not build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        if not hasattr(lib, "cdx_voxelize_tris"):
            return None
    lib.cdx_shparse.restype = ctypes.c_int
    lib.cdx_shparse.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64)]
    lib.cdx_sedt_3d.restype = ctypes.c_int
    lib.cdx_sedt_3d.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.cdx_signed_edt.restype = ctypes.c_int
    lib.cdx_signed_edt.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.cdx_voxelize.restype = ctypes.c_int
    lib.cdx_voxelize.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,           # sizes
        ctypes.POINTER(ctypes.c_double), ctypes.c_double,         # lengths, e
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),          # boxes
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),          # spheres
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),          # cylinders
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.cdx_voxelize_tris.restype = ctypes.c_int
    lib.cdx_voxelize_tris.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,           # sizes
        ctypes.POINTER(ctypes.c_double), ctypes.c_double,         # lengths, e
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),          # tris
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.cdx_flood_exterior.restype = ctypes.c_int
    lib.cdx_flood_exterior.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.cdx_grid_read.restype = ctypes.c_int
    lib.cdx_grid_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int64]
    lib.cdx_grid_write.restype = ctypes.c_int
    lib.cdx_grid_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int64]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def shparse_native(text: str):
    """Native tokenizer; raises ValueError on syntax errors (parity
    with utils.shparse.shparse)."""
    lib = _load()
    if lib is None:
        from or_cdchomp_jax.utils.shparse import shparse
        return shparse(text)
    raw = text.encode()
    cap = len(raw) * 2 + 16
    buf = ctypes.create_string_buffer(cap)
    ntok = ctypes.c_int64(0)
    rc = lib.cdx_shparse(raw, buf, cap, ctypes.byref(ntok))
    if rc == -1:
        raise ValueError("shparse syntax error (unterminated quote/escape)")
    if rc != 0:
        raise RuntimeError(f"cdx_shparse failed: {rc}")
    out = []
    pos = 0
    for _ in range(ntok.value):
        end = buf.raw.index(b"\0", pos)
        out.append(buf.raw[pos:end].decode())
        pos = end + 1
    return out


def signed_edt_native(occupied, lengths):
    """Exact signed EDT on the host (O(n) per line); float64 output.

    Falls back to the JAX implementation when the native library is
    unavailable.
    """
    lib = _load()
    occupied = np.ascontiguousarray(occupied, dtype=np.uint8)
    if lib is None:
        from or_cdchomp_jax.ops.edt import signed_edt
        return np.asarray(signed_edt(occupied.astype(bool), lengths),
                          dtype=np.float64)
    nx, ny, nz = occupied.shape
    lengths = np.asarray(lengths, dtype=np.float64)
    res2 = np.ascontiguousarray(
        (lengths / np.array([nx, ny, nz], dtype=np.float64)) ** 2)
    out = np.empty((nx, ny, nz), dtype=np.float64)
    rc = lib.cdx_signed_edt(
        occupied.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nx, ny, nz,
        res2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"cdx_signed_edt failed: {rc}")
    return out


def _dp(a):
    return np.ascontiguousarray(a, dtype=np.float64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_double))


def voxelize_native(scenes, scene_poses, pose_world_gsdf, sizes, lengths,
                    cube_extent, n_threads=0):
    """Multithreaded host voxelization of analytic scenes.

    Same semantics as the device path (ops/voxelize.py:voxelize_scene
    per scene, OR-reduced): exact OBB SAT, exact sphere-vs-cube,
    conservative cylinder.  ``scenes`` are Scene pytrees with primitive
    poses in each scene's frame; ``scene_poses`` are the scenes' world
    poses; the grid frame is ``pose_world_gsdf``.  Returns uint8
    occupancy (1 = hit).  Falls back to the JAX path without the
    native library.
    """
    from or_cdchomp_jax.utils import np_pose

    sizes = tuple(int(s) for s in sizes)
    lengths64 = np.ascontiguousarray(lengths, dtype=np.float64)
    lib = _load()
    if lib is None:
        import jax.numpy as jnp

        from or_cdchomp_jax.ops.grid import Grid3D
        from or_cdchomp_jax.ops.quat import pose_apply, pose_invert
        from or_cdchomp_jax.ops.voxelize import voxelize_scene

        grid = Grid3D.create(sizes, lengths64)
        centers_w = pose_apply(jnp.asarray(pose_world_gsdf, jnp.float64),
                               grid.all_centers())
        occ = np.zeros(sizes, dtype=bool)
        for sc, pose in zip(scenes, scene_poses):
            local = pose_apply(jnp.asarray(np_pose.invert(pose)), centers_w)
            occ |= np.asarray(voxelize_scene(sc, local, cube_extent))
        return occ.astype(np.uint8)

    # transform every primitive into the grid frame on the host
    gsdf_from_world = np_pose.invert(np.asarray(pose_world_gsdf,
                                                dtype=np.float64))
    box_pose, box_half = [], []
    sph_c, sph_r = [], []
    cyl_pose, cyl_r, cyl_h = [], [], []
    tris = []
    for sc, pose in zip(scenes, scene_poses):
        g_from_scene = np_pose.compose(gsdf_from_world,
                                       np.asarray(pose, dtype=np.float64))
        tv = np.asarray(sc.tri_verts, np.float64)
        if tv.shape[0]:
            # one vectorized transform for all 3·T vertices (a Python
            # per-vertex loop costs seconds on 10k-triangle meshes)
            from or_cdchomp_jax.tsr import quat_to_R_np
            R = quat_to_R_np(g_from_scene[3:])
            tris.append(tv.reshape(-1, 3) @ R.T
                        + g_from_scene[:3])
        for i in range(np.asarray(sc.box_pose).shape[0]):
            box_pose.append(np_pose.compose(
                g_from_scene, np.asarray(sc.box_pose, np.float64)[i]))
            box_half.append(np.asarray(sc.box_half, np.float64)[i])
        for i in range(np.asarray(sc.sphere_center).shape[0]):
            sph_c.append(np_pose.apply(
                g_from_scene, np.asarray(sc.sphere_center, np.float64)[i]))
            sph_r.append(float(np.asarray(sc.sphere_radius)[i]))
        for i in range(np.asarray(sc.cyl_pose).shape[0]):
            cyl_pose.append(np_pose.compose(
                g_from_scene, np.asarray(sc.cyl_pose, np.float64)[i]))
            cyl_r.append(float(np.asarray(sc.cyl_radius)[i]))
            cyl_h.append(float(np.asarray(sc.cyl_half)[i]))

    occ = np.zeros(sizes, dtype=np.uint8)
    rc = lib.cdx_voxelize(
        sizes[0], sizes[1], sizes[2], _dp(lengths64), float(cube_extent),
        len(box_half), _dp(np.asarray(box_pose).reshape(-1, 7)),
        _dp(np.asarray(box_half).reshape(-1, 3)),
        len(sph_r), _dp(np.asarray(sph_c).reshape(-1, 3)),
        _dp(np.asarray(sph_r)),
        len(cyl_r), _dp(np.asarray(cyl_pose).reshape(-1, 7)),
        _dp(np.asarray(cyl_r)), _dp(np.asarray(cyl_h)),
        int(n_threads), occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"cdx_voxelize failed: {rc}")
    if tris:
        tri_arr = np.concatenate(tris, axis=0).reshape(-1, 9)
        rc = lib.cdx_voxelize_tris(
            sizes[0], sizes[1], sizes[2], _dp(lengths64),
            float(cube_extent), tri_arr.shape[0],
            _dp(tri_arr), int(n_threads),
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise RuntimeError(f"cdx_voxelize_tris failed: {rc}")
    return occ


def flood_exterior_native(occ):
    """Exterior flood fill: free cells unreachable from the corner are
    reclassified as obstacle (orcdchomp_mod.cpp:540-548).  In-place on
    a uint8 array; returns it.  Falls back to the JAX dilation fill."""
    lib = _load()
    occ = np.ascontiguousarray(occ, dtype=np.uint8)
    if lib is None:
        from or_cdchomp_jax.ops.flood import exterior_free_mask
        return np.asarray(exterior_free_mask(occ.astype(bool))
                          ).astype(np.uint8)
    nx, ny, nz = occ.shape
    rc = lib.cdx_flood_exterior(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nx, ny, nz)
    if rc != 0:
        raise RuntimeError(f"cdx_flood_exterior failed: {rc}")
    return occ


def build_sdf_native(scenes, scene_poses, pose_world_gsdf, sizes, lengths,
                     cube_extent, n_threads=0):
    """Full host-side SDF pipeline: voxelize → exterior flood → signed
    EDT, all native and multithreaded where the library is available.
    Returns float64 (nx, ny, nz).  This is the large-grid path where
    the in-graph cells×primitives broadcast would blow device memory."""
    occ = voxelize_native(scenes, scene_poses, pose_world_gsdf, sizes,
                          lengths, cube_extent, n_threads)
    occ = flood_exterior_native(occ)
    return signed_edt_native(occ, lengths)


def grid_cache_read(path: str, shape, dtype=np.float64):
    """Raw binary cache read with size validation (reference format,
    orcdchomp_mod.cpp:416-444).  Returns None on mismatch/missing."""
    data = np.empty(shape, dtype=dtype)
    lib = _load()
    if lib is None:
        try:
            raw = np.fromfile(path, dtype=dtype)
        except (FileNotFoundError, OSError):
            return None
        if raw.size != data.size:
            return None
        return raw.reshape(shape)
    rc = lib.cdx_grid_read(path.encode(), data.ctypes.data, data.nbytes)
    return data if rc == 0 else None


def grid_cache_write(path: str, array) -> bool:
    array = np.ascontiguousarray(array)
    lib = _load()
    if lib is None:
        array.tofile(path)
        return True
    rc = lib.cdx_grid_write(path.encode(), array.ctypes.data, array.nbytes)
    return rc == 0
