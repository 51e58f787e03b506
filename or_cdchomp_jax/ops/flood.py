"""Vectorized flood fill over 3-d grids.

The reference marks exterior free space with a stack-based 6-connected
flood fill from the corner cell (grid_flood.c:30-111, seeded at
orcdchomp_mod.cpp:540-543); unreached "free" cells are reclassified as
obstacle interior (orcdchomp_mod.cpp:545-548).

A sequential stack is useless on an accelerator; connectivity is instead computed
as iterated masked dilation inside ``lax.while_loop``: grow the
reachable set by its 6-neighborhood intersected with the free mask
until a fixed point.  Each step dilates by ``_STRIDE`` voxels along
every axis (composing shifts) so the loop count is the grid diameter
divided by ``_STRIDE``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_STRIDE = 8  # dilation steps fused per while_loop iteration


def _dilate6(mask):
    """One 6-connected binary dilation via shifted ORs (no wraparound)."""
    out = mask
    for axis in range(3):
        n = mask.shape[axis]
        idx_lo = [slice(None)] * 3
        idx_hi = [slice(None)] * 3
        idx_lo[axis] = slice(0, n - 1)
        idx_hi[axis] = slice(1, n)
        shifted_up = jnp.zeros_like(mask).at[tuple(idx_hi)].set(mask[tuple(idx_lo)])
        shifted_dn = jnp.zeros_like(mask).at[tuple(idx_lo)].set(mask[tuple(idx_hi)])
        out = out | shifted_up | shifted_dn
    return out


def flood_reachable(free, seed_index=(0, 0, 0)):
    """Cells 6-connected-reachable from ``seed_index`` through ``free``.

    Args:
      free: (nx, ny, nz) bool, True where traversal is allowed.
      seed_index: starting cell (the reference uses flat index 0, i.e.
        the grid corner, orcdchomp_mod.cpp:541).

    Returns a bool mask of reachable cells (False everywhere if the
    seed itself is not free, matching the reference's failed first
    ``replace``).
    """
    free = jnp.asarray(free, dtype=bool)
    seed = jnp.zeros_like(free).at[tuple(seed_index)].set(True) & free

    def cond(state):
        reach, changed = state
        return changed

    def body(state):
        reach, _ = state
        new = reach
        for _ in range(_STRIDE):
            new = _dilate6(new) & free
        return new, jnp.any(new != reach)

    reach, _ = jax.lax.while_loop(cond, body, (seed, jnp.array(True)))
    return reach


def exterior_free_mask(occupied, seed_index=(0, 0, 0)):
    """Occupancy post-processing used by the SDF builder.

    Given a raw collision-test occupancy (True = hit), return the final
    obstacle mask where enclosed "free" pockets count as obstacle
    interior: free cells are only those reachable from the grid corner.
    (orcdchomp_mod.cpp:540-548)
    """
    occupied = jnp.asarray(occupied, dtype=bool)
    reach = flood_reachable(~occupied, seed_index)
    return ~reach  # True = treat as obstacle (occupied or enclosed)
