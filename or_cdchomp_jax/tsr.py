"""Task Space Regions (TSR) — frames + bounds container.

Mirrors the reference's ``struct tsr`` (orcdchomp_mod.h:80-88) and its
38-number serialization parser (tsr_create_parse,
orcdchomp_mod.cpp:3068-3110):

    manipindex bodyandlink  AR(9, column-major) Ad(3)
    BR(9, column-major) Bd(3)  Bw(6×2)

T0w = pose(Ad, AR) is the TSR frame in the world; Twe the end-effector
offset; Bw the per-dimension (x y z roll pitch yaw) bounds.  A
dimension is *constrained* when both its bounds are exactly 0
(orcdchomp_mod.cpp:2466-2518).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def quat_from_R_np(R):
    """Rotation matrix → unit quaternion, host float64 (Shepperd)."""
    R = np.asarray(R, dtype=np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([0.25 * s, (R[0, 1] + R[1, 0]) / s,
                      (R[0, 2] + R[2, 0]) / s, (R[2, 1] - R[1, 2]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 1] + R[1, 0]) / s, 0.25 * s,
                      (R[1, 2] + R[2, 1]) / s, (R[0, 2] - R[2, 0]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s,
                      0.25 * s, (R[1, 0] - R[0, 1]) / s])
    return q / np.linalg.norm(q)


def quat_to_R_np(q):
    """Unit quaternion → rotation matrix, host float64. (kin.c:348-368)"""
    qx, qy, qz, qw = np.asarray(q, dtype=np.float64)
    xx, xy, xz, xw = qx * qx, qx * qy, qx * qz, qx * qw
    yy, yz, yw = qy * qy, qy * qz, qy * qw
    zz, zw = qz * qz, qz * qw
    return np.array([
        [1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)],
        [2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw)],
        [2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)],
    ])


def _pose_from_dR(d, R):
    """Position + rotation matrix → pose7 (host, float64).
    (kin.c:510-517)"""
    return np.concatenate([np.asarray(d, dtype=np.float64), quat_from_R_np(R)])


@dataclasses.dataclass
class TSR:
    T0w: np.ndarray       # (7,) TSR frame in world
    Twe: np.ndarray       # (7,) end-effector offset (w in e... see ref)
    Bw: np.ndarray        # (6, 2) bounds, rows x y z roll pitch yaw
    manipindex: int = -1
    bodyandlink: str = "NULL"

    @classmethod
    def from_matrices(cls, T0w_H, Twe_H, Bw, manipindex=-1, bodyandlink="NULL"):
        """From 4×4 homogeneous matrices."""
        T0w_H = np.asarray(T0w_H, dtype=np.float64)
        Twe_H = np.asarray(Twe_H, dtype=np.float64)
        return cls(
            T0w=_pose_from_dR(T0w_H[:3, 3], T0w_H[:3, :3]),
            Twe=_pose_from_dR(Twe_H[:3, 3], Twe_H[:3, :3]),
            Bw=np.asarray(Bw, dtype=np.float64).reshape(6, 2),
            manipindex=manipindex, bodyandlink=bodyandlink,
        )

    @classmethod
    def parse(cls, text: str) -> "TSR":
        """Parse the 38-token serialization (orcdchomp_mod.cpp:3072-3101)."""
        toks = text.split()
        if len(toks) != 38:
            raise ValueError(f"TSR serialization needs 38 tokens, got {len(toks)}")
        manipindex = int(toks[0])
        bodyandlink = toks[1]
        vals = [float(t) for t in toks[2:]]
        AR = np.array(vals[0:9], dtype=np.float64).reshape(3, 3, order="F")
        Ad = np.array(vals[9:12], dtype=np.float64)
        BR = np.array(vals[12:21], dtype=np.float64).reshape(3, 3, order="F")
        Bd = np.array(vals[21:24], dtype=np.float64)
        Bw = np.array(vals[24:36], dtype=np.float64).reshape(6, 2)
        return cls(T0w=_pose_from_dR(Ad, AR), Twe=_pose_from_dR(Bd, BR),
                   Bw=Bw, manipindex=manipindex, bodyandlink=bodyandlink)

    def serialize(self) -> str:
        """Inverse of :meth:`parse` (same token layout the python
        bindings emit, orcdchomp.py:133-146)."""
        AR = quat_to_R_np(self.T0w[3:])
        BR = quat_to_R_np(self.Twe[3:])
        parts = [str(self.manipindex), self.bodyandlink]
        parts += [repr(float(v)) for v in AR.flatten(order="F")]
        parts += [repr(float(v)) for v in self.T0w[:3]]
        parts += [repr(float(v)) for v in BR.flatten(order="F")]
        parts += [repr(float(v)) for v in self.Twe[:3]]
        parts += [repr(float(v)) for v in np.asarray(self.Bw).flatten()]
        return " ".join(parts)

    def enabled_mask(self):
        from or_cdchomp_jax.chomp.constraints import tsr_enabled_from_bw
        return tsr_enabled_from_bw(self.Bw)
