"""The SDF lookup: plain gathers of grid.c's four cells.

``lookup_cells`` (and everything built on it: ``field_interp_grad``,
``multigrid_interp_grad`` and the batch step's obstacle cost) must
select exactly the cells of grid.c's one-sided rule and copy their
values bit for bit, ±inf included.  The reference here is a NumPy
float64 implementation of that rule (tests/ref/oracle.py and the
selection below).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from or_cdchomp_jax.ops.grid import (
    Grid3D, lookup_cells, multigrid_interp_grad, pad_stack_grids)
from tests.ref import oracle as orc


def _mk_fields(rng, n_fields=2):
    shapes = [(6, 9, 5), (8, 4, 7), (5, 5, 9)][:n_fields]
    grids = []
    for shape in shapes:
        d = rng.normal(size=shape)
        d[2, 1, 3] = np.inf    # HUGE_VAL interior cell
        d[0, 0, 0] = -np.inf   # occupied corner cell
        grids.append(Grid3D(
            data=jnp.asarray(d, jnp.float32),
            lengths=jnp.asarray(0.1 * np.asarray(shape), jnp.float32)))
    return pad_stack_grids(grids)


def _ref_interp_grad(data, sizes, lengths, p):
    """grid.c semantics per (query, field) from the NumPy oracle."""
    f = data.shape[0]
    q = p.reshape(-1, f, 3)
    val = np.full(q.shape[:2], np.inf)
    grad = np.zeros(q.shape)
    for qi in range(q.shape[0]):
        for fi in range(f):
            sx, sy, sz = sizes[fi]
            d = np.asarray(data[fi, :sx, :sy, :sz], np.float64)
            ln = np.asarray(lengths[fi], np.float64)
            v = orc.grid_interp(d, ln, q[qi, fi])
            if v is not None and np.isfinite(v):
                val[qi, fi] = v
                grad[qi, fi] = orc.grid_grad(d, ln, q[qi, fi])
    return val.reshape(p.shape[:-1]), grad.reshape(p.shape)


@pytest.mark.parametrize("shape", [(11,), (3, 5)])
def test_lookup_matches_numpy_reference(shape):
    rng = np.random.default_rng(0)
    data, sizes, lengths = _mk_fields(rng)
    f = data.shape[0]
    # points spanning inside, near-edge, and out-of-bounds
    p = rng.uniform(-0.2, 1.1, size=shape + (f, 3)).astype(np.float32) \
        * np.asarray(lengths)
    v, g, b = multigrid_interp_grad(data, sizes, lengths, jnp.asarray(p))
    want_v, want_g = _ref_interp_grad(np.asarray(data), np.asarray(sizes),
                                      np.asarray(lengths), p)
    x = p / np.asarray(lengths)
    np.testing.assert_array_equal(
        np.asarray(b), np.all((x >= 0) & (x <= 1), axis=-1))
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(np.asarray(v)), fin)
    assert np.all(np.isposinf(np.asarray(v)[~fin]))
    np.testing.assert_allclose(np.asarray(v)[fin], want_v[fin],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g), want_g, rtol=1e-5, atol=1e-4)


def test_all_occupied_field_not_contained():
    """An all-occupied grid has an empty free-space EDT → every cell is
    −inf.  Such queries must report "field does not contain the point"
    (+inf value, zero gradient) rather than leaking −inf (infinite
    obstacle cost)."""
    g = Grid3D(data=jnp.full((4, 5, 3), -jnp.inf, dtype=jnp.float32),
               lengths=jnp.asarray([0.4, 0.5, 0.3], dtype=jnp.float32))
    data, sizes, lengths = pad_stack_grids([g])
    p = jnp.asarray([[0.2, 0.25, 0.15], [0.05, 0.45, 0.29]],
                    dtype=jnp.float32)[:, None, :]
    v, gr, inb = multigrid_interp_grad(data, sizes, lengths, p)
    assert np.asarray(inb).all()
    assert np.isposinf(np.asarray(v)).all()
    np.testing.assert_array_equal(np.asarray(gr), 0.0)


def _numpy_cells(table, sizes, lengths, p):
    """float64 selection of grid.c's four cells (grid.c:191-228,
    331-454): (v0, vn (3, Q), use_next (3, Q), in_bounds)."""
    u = [p[i] / lengths[i] * sizes[i] for i in range(3)]
    sub = [np.clip(np.floor(u[i]), 0, sizes[i] - 1).astype(int)
           for i in range(3)]
    nxt = []
    for i in range(3):
        un = np.where(sub[i] == 0, True, u[i] - sub[i] >= 0.5)
        nxt.append(np.where(sub[i] == sizes[i] - 1, False, un))
    v0 = table[sub[0], sub[1], sub[2]]
    vn = []
    for i in range(3):
        s = list(sub)
        s[i] = np.clip(sub[i] + np.where(nxt[i], 1, -1), 0, sizes[i] - 1)
        vn.append(table[s[0], s[1], s[2]])
    inb = np.all([(p[i] >= 0) & (p[i] <= lengths[i]) for i in range(3)],
                 axis=0)
    return v0, np.stack(vn), np.stack(nxt), inb


def _cell_query_points(rng, sizes, lengths, n, rank):
    """Cell-interior points away from boundaries and centers (so f32
    and f64 pick the same cells), plus points on the outer side of the
    first and last cells' centers and one out-of-bounds point."""
    sub = rng.integers(0, sizes, size=(n, 3))
    frac = rng.choice([0.2, 0.35, 0.65, 0.8], size=(n, 3))
    pts = (sub + frac) / sizes * lengths
    # the first and last cell along every axis, outside their centers
    edge = np.array([[0.1, 0.1, 0.1], [0.9, 0.9, 0.9]]) * lengths / sizes \
        + np.array([[0, 0, 0], [1, 1, 1]]) * (sizes - 1) / sizes * lengths
    pts = np.concatenate([pts, edge, [[-0.1, 0.5, 0.5]] * lengths])
    shape = {1: (pts.shape[0],), 2: (1, pts.shape[0]),
             3: (1, 1, pts.shape[0])}[rank]
    return tuple(jnp.asarray(pts[:, i].reshape(shape), jnp.float32)
                 for i in range(3))


@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("n_fields", [1, 3])
def test_lookup_cells_exact_against_numpy(n_fields, rank):
    """Gathered cell values equal the NumPy float64 selection exactly,
    per field of a padded stack, with ±inf cells, edge cells and an
    out-of-bounds query, for queries of any rank."""
    rng = np.random.default_rng(10 * n_fields + rank)
    data, sizes, lengths = _mk_fields(rng, n_fields)
    dims = data.shape[1:]
    for f in range(n_fields):
        sz = np.asarray(sizes[f])
        ln = np.asarray(lengths[f], np.float64)
        p = _cell_query_points(rng, sz, ln, 200, rank)
        v0, vn, un, _, inb = lookup_cells(data[f].reshape(-1), dims,
                                          sizes[f], lengths[f], p)
        assert v0.shape == p[0].shape
        table = np.asarray(data[f], np.float64)
        w0, wn, wun, winb = _numpy_cells(
            table, sz, ln, [np.asarray(c, np.float64).ravel() for c in p])
        np.testing.assert_array_equal(np.ravel(v0), w0)
        np.testing.assert_array_equal(
            np.stack([np.ravel(c) for c in vn]), wn)
        np.testing.assert_array_equal(
            np.stack([np.ravel(c) for c in un]), wun)
        np.testing.assert_array_equal(np.ravel(inb), winb)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_edge_cells_use_inward_neighbor(axis):
    """At the first cell the neighbor is the next one even left of the
    center; at the last cell it is the previous one even right of it
    (grid.c:331-384)."""
    table = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    sizes = np.array([4, 5, 6])
    lengths = np.array([0.4, 0.5, 0.6], np.float32)
    mid = lengths / 2
    lo, hi = mid.copy(), mid.copy()
    lo[axis] = 0.01                 # left of the first cell's center
    hi[axis] = lengths[axis] - 0.01  # right of the last cell's center
    p = tuple(jnp.asarray([lo[i], hi[i]]) for i in range(3))
    _, vn, un, _, _ = lookup_cells(jnp.asarray(table).reshape(-1),
                                   table.shape, jnp.asarray(sizes),
                                   jnp.asarray(lengths), p)
    assert bool(un[axis][0]) and not bool(un[axis][1])
    stride = [30, 6, 1][axis]
    s_lo = np.floor(lo / lengths * sizes).astype(int)
    s_hi = np.floor(hi / lengths * sizes).astype(int)
    assert float(vn[axis][0]) == table[tuple(s_lo)] + stride
    assert float(vn[axis][1]) == table[tuple(s_hi)] - stride


def test_lookup_is_gathers_not_dots():
    """The compiled lookup is gathers only: no dot, no one-hot
    contraction whose float32 rounding could alter a cell value."""
    data, sizes, lengths = _mk_fields(np.random.default_rng(3))
    p = jnp.zeros((7, data.shape[0], 3), jnp.float32)
    hlo = jax.jit(multigrid_interp_grad).lower(
        data, sizes, lengths, p).as_text()
    assert "gather" in hlo
    assert "dot_general" not in hlo and "dot(" not in hlo
