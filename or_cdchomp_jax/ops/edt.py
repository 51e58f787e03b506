"""Exact squared Euclidean distance transforms + signed distance fields.

The reference computes SDFs with the Felzenszwalb-Huttenlocher
lower-envelope algorithm swept per axis (grid.c:269-329 sedt_onedim,
grid.c:462-569 per-axis driver) and combines two transforms into a
signed field ``sqrt(sedt_obs) - sqrt(sedt_free)`` (grid.c:637-687).

The envelope algorithm is inherently sequential per scan line, which is
hostile to an accelerator's wide vector units.  This module instead evaluates the
*definition* of the per-axis transform directly::

    dt[q] = min_p ( (q-p)^2 * res^2 + f[p] )

as a broadcasted minimum over an (n × n) cost matrix, vmapped over all
scan lines and applied per axis in sequence — mathematically identical
to the reference (the per-axis 1-d transform composition is exact), and
embarrassingly parallel: a 128³ grid is three batched (L=16k, 128, 128)
elementwise min-reductions, ~10⁹ elementwise ops.  Lines are processed in
chunks via ``lax.map`` to bound memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from or_cdchomp_jax.ops.grid import Grid3D

_CHUNK = 1024  # scan lines per lax.map step


def _edt_lines(f, res2):
    """1-d squared EDT over batched lines.  f: (L, n) → (L, n)."""
    n = f.shape[-1]
    q = jnp.arange(n, dtype=f.dtype)
    cost = (q[:, None] - q[None, :]) ** 2 * res2  # (n_out, n_in)

    def one_chunk(fc):
        # fc: (chunk, n); result[l, qo] = min_p fc[l, p] + cost[qo, p]
        return jnp.min(fc[:, None, :] + cost[None, :, :], axis=-1)

    L = f.shape[0]
    pad = (-L) % _CHUNK
    fp = jnp.pad(f, ((0, pad), (0, 0)))
    out = jax.lax.map(one_chunk, fp.reshape(-1, _CHUNK, n)).reshape(-1, n)
    return out[:L]


def edt_sq(func, lengths):
    """Exact 3-d squared EDT of a sampled function grid.

    Args:
      func: (nx, ny, nz); typically 0.0 at sites, +inf elsewhere.
      lengths: (3,) grid side lengths (metric scaling per axis,
        matching grid.c:509-535's per-axis res² scaling).

    Returns the squared-distance grid, same shape.
    """
    g = func
    shape = func.shape
    lengths = jnp.asarray(lengths, dtype=func.dtype)
    for axis in range(3):
        n = shape[axis]
        res2 = (lengths[axis] / n) ** 2
        moved = jnp.moveaxis(g, axis, -1).reshape(-1, n)
        moved = _edt_lines(moved, res2)
        g = jnp.moveaxis(
            moved.reshape([shape[a] for a in range(3) if a != axis] + [n]), -1, axis
        )
    return g


def signed_edt(occupied, lengths):
    """Signed distance field from a boolean occupancy grid.

    ``sqrt(sedt_obs) - sqrt(sedt_free)``: positive in free space
    (distance to the nearest obstacle), negative inside obstacles
    (minus distance to the nearest free cell).  (grid.c:637-687)

    If there are no occupied cells at all the result is +inf
    everywhere, matching the reference's HUGE_VAL propagation.
    """
    occupied = jnp.asarray(occupied, dtype=bool)
    inf = jnp.asarray(np.inf, dtype=jnp.float32)
    f_obs = jnp.where(occupied, 0.0, inf)   # sites = obstacle cells
    f_free = jnp.where(occupied, inf, 0.0)  # sites = free cells
    d_obs = edt_sq(f_obs, lengths)
    d_free = edt_sq(f_free, lengths)
    return jnp.sqrt(d_obs) - jnp.sqrt(d_free)


def sdf_grid_from_occupancy(occupied, lengths) -> Grid3D:
    """Convenience: boolean occupancy → signed-distance Grid3D."""
    data = signed_edt(occupied, lengths)
    return Grid3D(data=data, lengths=jnp.asarray(lengths, dtype=data.dtype))
