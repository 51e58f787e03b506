"""3-D value grids with libcd-compatible lookup / interp / gradient.

The reference grid engine (src/libcd/grid.c) stores row-major N-d cell
data over a box ``[0, lengths]`` with cell centers at
``(0.5+sub)/size*length`` and implements

 - point → cell index lookup          (grid.c:191-209)
 - per-axis one-sided finite-difference gradient (grid.c:331-384)
 - first-order Taylor "interp" from the cell center using that same
   one-sided gradient                 (grid.c:386-454)

This module reimplements those exact semantics as batched gather-based
JAX functions: each query point costs 4 gathers (center cell + one
neighbor per axis), fully vectorized over (problems × waypoints ×
spheres × fields).  The planner only ever uses 3-d grids
(orcdchomp_mod.cpp:297-722), so this build is specialized to 3-d.

Grids are pytrees (`Grid3D`) so they live in device memory and flow
through jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Grid3D(NamedTuple):
    """A single 3-d grid. ``data`` has shape (nx, ny, nz)."""

    data: jnp.ndarray      # (nx, ny, nz) float
    lengths: jnp.ndarray   # (3,) float, side lengths in grid frame

    @property
    def sizes(self):
        return self.data.shape

    @classmethod
    def create(cls, sizes, lengths, fill=0.0, dtype=jnp.float32):
        data = jnp.full(tuple(int(s) for s in sizes), fill, dtype=dtype)
        return cls(data=data, lengths=jnp.asarray(lengths, dtype=dtype))

    def cell_extents(self):
        """Per-axis cell side length."""
        sizes = jnp.asarray(self.data.shape, dtype=self.lengths.dtype)
        return self.lengths / sizes

    def center_of_index(self, subs):
        """Grid-frame position of cell center(s); subs (..., 3) int.

        (grid.c:160-190)
        """
        sizes = jnp.asarray(self.data.shape, dtype=self.lengths.dtype)
        return (subs.astype(self.lengths.dtype) + 0.5) / sizes * self.lengths

    def all_centers(self):
        """Grid-frame positions of every cell center, shape (nx,ny,nz,3)."""
        nx, ny, nz = self.data.shape
        ii, jj, kk = jnp.meshgrid(
            jnp.arange(nx), jnp.arange(ny), jnp.arange(nz), indexing="ij"
        )
        subs = jnp.stack([ii, jj, kk], axis=-1)
        return self.center_of_index(subs)


def lookup_cells(flat, dims, sizes, lengths, p):
    """grid.c's four-cell selection for one field (grid.c:191-228,
    331-454), on x/y/z component arrays.

    Args:
      flat: the field's values, flattened from its row-major (possibly
        padded) shape ``dims`` = (mx, my, mz).
      dims: static (mx, my, mz).
      sizes: (3,) int true sizes (≤ dims).
      lengths: (3,) side lengths.
      p: 3 arrays of one shape: grid-frame x, y, z of the queries.

    Returns (v0, vn, use_next, center, in_bounds): the value of the cell
    holding the point, and per axis (tuples of 3) the value of the
    neighbor the one-sided rule picks, that choice, and the cell-center
    coordinate.  Per axis the rule takes the next cell unless the point
    is left of the cell center, with edge cells forced inward.  The
    values are plain gathers: exact copies of the table, ±inf included.
    """
    _, my, mz = dims
    strides = (my * mz, mz, 1)
    in_bounds = None
    idx = 0
    steps, use_next, center = [], [], []
    for i in range(3):
        n = sizes[i].astype(p[i].dtype)
        xi = p[i] / lengths[i]
        ok = (xi >= 0.0) & (xi <= 1.0)
        in_bounds = ok if in_bounds is None else in_bounds & ok
        si = jnp.clip(jnp.floor(xi * n).astype(jnp.int32), 0, sizes[i] - 1)
        ci = (si.astype(p[i].dtype) + 0.5) / n * lengths[i]
        un = jnp.where(si == 0, True, p[i] >= ci)
        un = jnp.where(si == sizes[i] - 1, False, un)
        # a one-cell axis has no neighbor: the clip makes it read the
        # center again instead of a cell of another row
        nb = jnp.clip(si + jnp.where(un, 1, -1), 0, sizes[i] - 1)
        idx = idx + si * strides[i]
        steps.append((nb - si) * strides[i])
        use_next.append(un)
        center.append(ci)
    v0 = jnp.take(flat, idx, mode="clip")
    vn = tuple(jnp.take(flat, idx + st, mode="clip") for st in steps)
    return v0, vn, tuple(use_next), tuple(center), in_bounds


def field_interp_grad(flat, dims, sizes, lengths, p):
    """libcd interp + gradient for one field on component arrays.

    Same arguments as :func:`lookup_cells`.  Returns (value, grad,
    in_bounds) with grad a tuple of 3 arrays in the grid frame.  The
    value is the cell-center value plus the one-sided gradient times
    the offset from the center (grid.c:386-454).  A query out of bounds
    or touching an infinite cell, +inf or -inf, reports +inf and a zero
    gradient (HUGE_VAL propagation, grid.c:405-439): "field does not
    contain the point", orcdchomp_mod.cpp:1179-1182.
    """
    v0, vn, use_next, center, in_bounds = lookup_cells(
        flat, dims, sizes, lengths, p)
    dtype = p[0].dtype
    any_inf = jnp.isinf(v0)
    value = v0
    grad = []
    for i in range(3):
        any_inf = any_inf | jnp.isinf(vn[i])
        sign = jnp.where(use_next[i], 1.0, -1.0).astype(dtype)
        gi = sign * (vn[i] - v0) * (sizes[i].astype(dtype) / lengths[i])
        grad.append(gi)
        value = value + gi * (p[i] - center[i])
    bad = ~in_bounds | any_inf
    value = jnp.where(bad, jnp.asarray(jnp.inf, dtype), value)
    return value, tuple(jnp.where(bad, 0.0, g) for g in grad), in_bounds


def _components(p):
    return tuple(p[..., i] for i in range(3))


def grid_interp_grad(data, lengths, p):
    """libcd-semantics interp + gradient at grid-frame point(s) p.

    Args:
      data: (nx, ny, nz) grid values.
      lengths: (3,) grid side lengths.
      p: (..., 3) query points in the grid frame.

    Returns:
      (value, grad, in_bounds): value (...,), grad (..., 3) w.r.t. the
      grid frame, in_bounds (...,) bool; see :func:`field_interp_grad`.
    """
    value, grad, in_bounds = field_interp_grad(
        data.reshape(-1), data.shape, jnp.asarray(data.shape, jnp.int32),
        lengths, _components(p))
    return value, jnp.stack(grad, axis=-1), in_bounds


def grid_interp(data, lengths, p):
    """Interp only (same semantics as grid_interp_grad)."""
    value, _, in_bounds = grid_interp_grad(data, lengths, p)
    return value, in_bounds


def pad_stack_grids(grids: list[Grid3D]):
    """Stack variable-size grids into padded arrays for jit-friendly
    multi-field lookups.

    Returns (data (F, mx, my, mz), sizes (F, 3) int32, lengths (F, 3)).
    Padding cells are +inf so they can never win a min-select, and the
    true ``sizes`` keep index arithmetic exact.
    """
    f = len(grids)
    shapes = np.array([g.data.shape for g in grids], dtype=np.int32)
    mx, my, mz = shapes.max(axis=0)
    data = np.full((f, mx, my, mz), np.inf, dtype=np.float32)
    lengths = np.zeros((f, 3), dtype=np.float32)
    for i, g in enumerate(grids):
        sx, sy, sz = g.data.shape
        data[i, :sx, :sy, :sz] = np.asarray(g.data, dtype=np.float32)
        lengths[i] = np.asarray(g.lengths, dtype=np.float32)
    return jnp.asarray(data), jnp.asarray(shapes), jnp.asarray(lengths)


def multigrid_interp_grad(data, sizes, lengths, p):
    """Interp + grad across F padded grids at per-field points.

    Args:
      data: (F, mx, my, mz) padded grid stack.
      sizes: (F, 3) int32 true sizes.
      lengths: (F, 3) side lengths.
      p: (..., F, 3) per-field query points (already in each grid frame).

    Returns (value (..., F), grad (..., F, 3), in_bounds (..., F)), each
    field as :func:`field_interp_grad` gives it.
    """
    outs = [field_interp_grad(data[f].reshape(-1), data.shape[1:],
                              sizes[f], lengths[f], _components(p[..., f, :]))
            for f in range(data.shape[0])]
    value = jnp.stack([o[0] for o in outs], axis=-1)
    grad = jnp.stack([jnp.stack(o[1], axis=-1) for o in outs], axis=-2)
    in_bounds = jnp.stack([o[2] for o in outs], axis=-1)
    return value, grad, in_bounds
