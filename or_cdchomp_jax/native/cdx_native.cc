// Native host-side runtime components for or_cdchomp_jax.
//
// The reference implements its entire runtime in C (libcd) / C++
// (plugin).  This build keeps the compute path in XLA, but the
// host-side runtime pieces that the reference implements natively are
// native here too, exposed through a plain C ABI consumed via ctypes:
//
//  - cdx_shparse:   POSIX-shell-like tokenizer
//                   (parity: src/libcd/util_shparse.c:37-128)
//  - cdx_sedt_1d /
//    cdx_sedt_3d:   exact Felzenszwalb-Huttenlocher squared EDT
//                   (parity: src/libcd/grid.c:269-329 / 462-569);
//                   O(n) per scan line — the fast host path for very
//                   large SDF grids where the device's O(n^2)
//                   brute-force line transform is wasteful
//  - cdx_grid_read /
//    cdx_grid_write: raw binary grid cache IO with size validation
//                   (parity: orcdchomp_mod.cpp:416-444 / 570-580)
//
// Build: see Makefile (produces libcdx_native.so).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// shparse
// ---------------------------------------------------------------------------

// Tokenize `text`; writes NUL-separated tokens into `out` (caller
// allocates out_cap bytes) and token count into *ntok.
// Returns 0 on success, -1 on syntax error, -2 if out is too small.
int cdx_shparse(const char* text, char* out, int64_t out_cap,
                int64_t* ntok) {
  int64_t w = 0;
  int64_t count = 0;
  bool in_tok = false;
  auto put = [&](char c) -> bool {
    if (w >= out_cap) return false;
    out[w++] = c;
    return true;
  };
  const char* p = text;
  while (*p) {
    char c = *p;
    if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
      if (in_tok) {
        if (!put('\0')) return -2;
        count++;
        in_tok = false;
      }
      p++;
    } else if (c == '\'') {
      in_tok = true;
      p++;
      while (*p && *p != '\'') {
        if (!put(*p++)) return -2;
      }
      if (!*p) return -1;
      p++;
    } else if (c == '"') {
      in_tok = true;
      p++;
      while (*p && *p != '"') {
        if (*p == '\\' && (p[1] == '"' || p[1] == '\\')) p++;
        if (!put(*p++)) return -2;
      }
      if (!*p) return -1;
      p++;
    } else if (c == '\\') {
      in_tok = true;
      if (!p[1]) return -1;
      if (!put(p[1])) return -2;
      p += 2;
    } else {
      in_tok = true;
      if (!put(c)) return -2;
      p++;
    }
  }
  if (in_tok) {
    if (!put('\0')) return -2;
    count++;
  }
  *ntok = count;
  return 0;
}

// ---------------------------------------------------------------------------
// exact squared EDT (lower-envelope algorithm)
// ---------------------------------------------------------------------------

static void sedt_line(int64_t n, const double* f, double* d, int64_t stride,
                      int* v, double* z) {
  const double INF = std::numeric_limits<double>::infinity();
  int np = 0;
  for (int64_t q = 0; q < n; q++) {
    if (f[q] == INF) continue;
    if (np == 0) {
      np = 1;
      v[0] = static_cast<int>(q);
      z[0] = -INF;
      z[1] = INF;
      continue;
    }
    double s;
    for (;;) {
      s = (f[q] + static_cast<double>(q) * q -
           (f[v[np - 1]] + static_cast<double>(v[np - 1]) * v[np - 1])) /
          (2.0 * (q - v[np - 1]));
      if (s <= z[np - 1]) {
        np--;
        if (np == 0) { s = -INF; break; }
      } else {
        break;
      }
    }
    np++;
    v[np - 1] = static_cast<int>(q);
    z[np - 1] = s;
    z[np] = INF;
  }
  if (np == 0) {
    for (int64_t q = 0; q < n; q++) d[q * stride] = INF;
    return;
  }
  int k = 0;
  for (int64_t q = 0; q < n; q++) {
    while (z[k + 1] < static_cast<double>(q)) k++;
    double dq = static_cast<double>(q) - v[k];
    d[q * stride] = dq * dq + f[v[k]];
  }
}

// In-place 3-d squared EDT over a row-major (nx, ny, nz) grid with
// per-axis metric scaling res2[axis] = (length/size)^2.
int cdx_sedt_3d(double* grid, int64_t nx, int64_t ny, int64_t nz,
                const double* res2) {
  int64_t sizes[3] = {nx, ny, nz};
  int64_t strides[3] = {ny * nz, nz, 1};
  int64_t maxn = nx > ny ? (nx > nz ? nx : nz) : (ny > nz ? ny : nz);
  std::vector<double> f(maxn), z(maxn + 1);
  std::vector<int> v(maxn);

  for (int axis = 0; axis < 3; axis++) {
    int64_t n = sizes[axis];
    int64_t stride = strides[axis];
    double r2 = res2[axis];
    int a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;
    for (int64_t i = 0; i < sizes[a1]; i++) {
      for (int64_t j = 0; j < sizes[a2]; j++) {
        double* line = grid + i * strides[a1] + j * strides[a2];
        for (int64_t q = 0; q < n; q++) f[q] = line[q * stride] / r2;
        sedt_line(n, f.data(), line, stride, v.data(), z.data());
        for (int64_t q = 0; q < n; q++) line[q * stride] *= r2;
      }
    }
  }
  return 0;
}

// Signed distance field from a uint8 occupancy grid (1 = obstacle):
// sqrt(sedt_obs) - sqrt(sedt_free)  (parity: grid.c:637-687).
int cdx_signed_edt(const uint8_t* occ, double* out, int64_t nx, int64_t ny,
                   int64_t nz, const double* res2) {
  const double INF = std::numeric_limits<double>::infinity();
  int64_t ncell = nx * ny * nz;
  std::vector<double> d_obs(ncell), d_free(ncell);
  for (int64_t i = 0; i < ncell; i++) {
    d_obs[i] = occ[i] ? 0.0 : INF;
    d_free[i] = occ[i] ? INF : 0.0;
  }
  cdx_sedt_3d(d_obs.data(), nx, ny, nz, res2);
  cdx_sedt_3d(d_free.data(), nx, ny, nz, res2);
  for (int64_t i = 0; i < ncell; i++) {
    out[i] = std::sqrt(d_obs[i]) - std::sqrt(d_free[i]);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// analytic voxelizer (probe-cube replacement, orcdchomp_mod.cpp:495-525)
// ---------------------------------------------------------------------------
//
// Host-parallel counterpart of ops/voxelize.py:voxelize_scene with the
// same semantics: exact 15-axis SAT for oriented boxes, exact
// closest-point test for spheres, and for cylinders inscribed/
// circumscribed sphere bounds plus an alternating-projection
// closest-pair iteration for the undecided shell (exact to ~1e-6 m,
// matching the reference's probe-cube collision semantics,
// orcdchomp_mod.cpp:495-525).  All primitives are given in the *grid* frame
// (pose7 = [x y z qx qy qz qw]); cell centers are
// (sub+0.5)/size*length.  Used for very large grids where the in-graph
// device voxelization would blow HBM (cells x primitives broadcast).

static void quat_to_R3(const double* q, double R[9]) {
  double x = q[0], y = q[1], z = q[2], w = q[3];
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - z * w);
  R[2] = 2 * (x * z + y * w);
  R[3] = 2 * (x * y + z * w);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - x * w);
  R[6] = 2 * (x * z - y * w);
  R[7] = 2 * (y * z + x * w);
  R[8] = 1 - 2 * (x * x + y * y);
}

namespace {
struct BoxPre {
  double c[3];
  double R[9];     // box->grid rotation, row-major
  double absR[9];  // |R| + eps
  double h[3];     // half extents
};
struct CylPre {
  double c[3];
  double R[9];  // cyl->grid
  double r, hh;
};
}  // namespace

// Exact SAT: axis-aligned cube (center p, half extent e) vs oriented box.
static bool cube_obb_overlap(const double p[3], double e, const BoxPre& b) {
  double t[3] = {b.c[0] - p[0], b.c[1] - p[1], b.c[2] - p[2]};
  // grid axes
  for (int i = 0; i < 3; i++) {
    double ra = e + b.h[0] * b.absR[i * 3] + b.h[1] * b.absR[i * 3 + 1] +
                b.h[2] * b.absR[i * 3 + 2];
    if (std::fabs(t[i]) > ra) return false;
  }
  // box axes (columns of R)
  for (int j = 0; j < 3; j++) {
    double tl = t[0] * b.R[j] + t[1] * b.R[3 + j] + t[2] * b.R[6 + j];
    double ra = e * (b.absR[j] + b.absR[3 + j] + b.absR[6 + j]);
    if (std::fabs(tl) > b.h[j] + ra) return false;
  }
  // cross axes e_i x R_:,j
  for (int i = 0; i < 3; i++) {
    int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
    for (int j = 0; j < 3; j++) {
      int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      double tl = t[i2] * b.R[i1 * 3 + j] - t[i1] * b.R[i2 * 3 + j];
      double ra = e * (b.absR[i1 * 3 + j] + b.absR[i2 * 3 + j]);
      double rb = b.h[j1] * b.absR[i * 3 + j2] + b.h[j2] * b.absR[i * 3 + j1];
      if (std::fabs(tl) > ra + rb) return false;
    }
  }
  return true;
}

int cdx_voxelize(int64_t nx, int64_t ny, int64_t nz, const double* lengths,
                 double cube_extent, int64_t n_box, const double* box_pose,
                 const double* box_half, int64_t n_sph, const double* sph_c,
                 const double* sph_r, int64_t n_cyl, const double* cyl_pose,
                 const double* cyl_r, const double* cyl_h, int n_threads,
                 uint8_t* occ) {
  std::vector<BoxPre> boxes(static_cast<size_t>(n_box));
  for (int64_t i = 0; i < n_box; i++) {
    BoxPre& b = boxes[i];
    for (int k = 0; k < 3; k++) b.c[k] = box_pose[i * 7 + k];
    quat_to_R3(box_pose + i * 7 + 3, b.R);
    for (int k = 0; k < 9; k++) b.absR[k] = std::fabs(b.R[k]) + 1e-7;
    for (int k = 0; k < 3; k++) b.h[k] = box_half[i * 3 + k];
  }
  std::vector<CylPre> cyls(static_cast<size_t>(n_cyl));
  for (int64_t i = 0; i < n_cyl; i++) {
    CylPre& c = cyls[i];
    for (int k = 0; k < 3; k++) c.c[k] = cyl_pose[i * 7 + k];
    quat_to_R3(cyl_pose + i * 7 + 3, c.R);
    c.r = cyl_r[i];
    c.hh = cyl_h[i];
  }
  const double ex = lengths[0] / nx, ey = lengths[1] / ny,
               ez = lengths[2] / nz;
  const double e = cube_extent;
  const double e3 = e * std::sqrt(3.0);

  auto work = [&](int64_t x0, int64_t x1) {
    for (int64_t ix = x0; ix < x1; ix++) {
      double px = (ix + 0.5) * ex;
      for (int64_t iy = 0; iy < ny; iy++) {
        double py = (iy + 0.5) * ey;
        uint8_t* row = occ + (ix * ny + iy) * nz;
        for (int64_t iz = 0; iz < nz; iz++) {
          double p[3] = {px, py, (iz + 0.5) * ez};
          bool hit = false;
          for (int64_t s = 0; !hit && s < n_sph; s++) {
            double d2 = 0.0;
            for (int k = 0; k < 3; k++) {
              double d = sph_c[s * 3 + k] - p[k];
              double cl = d < -e ? -e : (d > e ? e : d);
              double dd = d - cl;
              d2 += dd * dd;
            }
            hit = d2 <= sph_r[s] * sph_r[s];
          }
          for (size_t bi = 0; !hit && bi < boxes.size(); bi++) {
            hit = cube_obb_overlap(p, e, boxes[bi]);
          }
          for (size_t ci = 0; !hit && ci < cyls.size(); ci++) {
            const CylPre& c = cyls[ci];
            double d[3] = {p[0] - c.c[0], p[1] - c.c[1], p[2] - c.c[2]};
            // local = R^T d  (R is cyl->grid)
            double cl[3];
            cl[0] = c.R[0] * d[0] + c.R[3] * d[1] + c.R[6] * d[2];
            cl[1] = c.R[1] * d[0] + c.R[4] * d[1] + c.R[7] * d[2];
            cl[2] = c.R[2] * d[0] + c.R[5] * d[1] + c.R[8] * d[2];
            double dr = std::sqrt(cl[0] * cl[0] + cl[1] * cl[1]) - c.r;
            double dz = std::fabs(cl[2]) - c.hh;
            double qx = dr > 0 ? dr : 0, qy = dz > 0 ? dz : 0;
            double outside = std::sqrt(qx * qx + qy * qy);
            double inside = std::fmax(dr, dz);
            double sd = outside + (inside < 0 ? inside : 0);
            if (sd <= e) { hit = true; continue; }   // inscribed sphere
            if (sd > e3) continue;                   // circumscribed miss
            // shell cell: alternating projections (Cheney-Goldstein)
            // between solid cube and solid cylinder — both convex, so
            // the pair distance converges to the true set distance.
            // Work in the cylinder frame: the cube is an OBB centered
            // at cl with axes = rows of R^T (columns of R), half e.
            double q[3];  // current cylinder-side point
            {
              double z = cl[2] < -c.hh ? -c.hh : (cl[2] > c.hh ? c.hh : cl[2]);
              double rxy = std::sqrt(cl[0] * cl[0] + cl[1] * cl[1]);
              double s = rxy > c.r ? c.r / (rxy > 1e-30 ? rxy : 1e-30) : 1.0;
              q[0] = cl[0] * s; q[1] = cl[1] * s; q[2] = z;
            }
            double u[3] = {0, 0, 0};
            double gap2 = 1e30;
            for (int it = 0; it < 96; it++) {
              // project q onto the cube: coords along cube axes are
              // rows of R (since columns of R are the axes in cyl frame)
              double rel[3] = {q[0] - cl[0], q[1] - cl[1], q[2] - cl[2]};
              for (int k = 0; k < 3; k++) {
                // k-th cube axis in cyl frame = (R[k*3], R[k*3+1], R[k*3+2])^T? no:
                // axis_k = column k of R^T = row k of R
                double a0 = c.R[k * 3], a1 = c.R[k * 3 + 1],
                       a2 = c.R[k * 3 + 2];
                double t = rel[0] * a0 + rel[1] * a1 + rel[2] * a2;
                u[k] = t < -e ? -e : (t > e ? e : t);
              }
              double pbox[3];
              for (int k = 0; k < 3; k++)
                pbox[k] = cl[k] + c.R[0 * 3 + k] * u[0] +
                          c.R[1 * 3 + k] * u[1] + c.R[2 * 3 + k] * u[2];
              // project pbox onto the cylinder
              double z = pbox[2] < -c.hh ? -c.hh
                                         : (pbox[2] > c.hh ? c.hh : pbox[2]);
              double rxy = std::sqrt(pbox[0] * pbox[0] + pbox[1] * pbox[1]);
              double s = rxy > c.r ? c.r / (rxy > 1e-30 ? rxy : 1e-30) : 1.0;
              double qn[3] = {pbox[0] * s, pbox[1] * s, z};
              double dd = (qn[0] - pbox[0]) * (qn[0] - pbox[0]) +
                          (qn[1] - pbox[1]) * (qn[1] - pbox[1]) +
                          (qn[2] - pbox[2]) * (qn[2] - pbox[2]);
              q[0] = qn[0]; q[1] = qn[1]; q[2] = qn[2];
              gap2 = dd;
              if (dd <= 1e-12) break;  // converged to contact
            }
            // 1e-4 m contact tolerance — matches ops/voxelize.py
            // (_AP_TOL); slow tangential convergence still classifies
            if (gap2 <= 1e-8) hit = true;
          }
          row[iz] |= hit ? 1 : 0;
        }
      }
    }
  };

  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > nx) nt = static_cast<int>(nx);
  std::vector<std::thread> threads;
  int64_t chunk = (nx + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t x0 = t * chunk;
    int64_t x1 = x0 + chunk < nx ? x0 + chunk : nx;
    if (x0 >= x1) break;
    threads.emplace_back(work, x0, x1);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Triangle-mesh voxelization: 13-axis SAT (Akenine-Möller) between
// each cell cube and each triangle (already transformed to the grid
// frame).  OR-accumulates into occ so it composes with cdx_voxelize.
// Surface-shell semantics; closed interiors are filled by the flood
// pass (orcdchomp_mod.cpp:540-548), matching the reference's
// probe-cube-vs-trimesh collision check (orcdchomp_mod.cpp:495-525).
static bool cube_tri_overlap(const double* p, double e, const double* tri) {
  // 1e-9 inclusive tolerance: exact-touch contacts classify as hits
  // regardless of rounding (mirrors ops/voxelize.py _tri_cube_overlap)
  const double tol = 1e-9;
  double v[3][3];
  for (int k = 0; k < 3; k++)
    for (int c = 0; c < 3; c++) v[k][c] = tri[k * 3 + c] - p[c];
  for (int c = 0; c < 3; c++) {
    double mn = std::fmin(v[0][c], std::fmin(v[1][c], v[2][c]));
    double mx = std::fmax(v[0][c], std::fmax(v[1][c], v[2][c]));
    if (mn > e + tol || mx < -e - tol) return false;
  }
  double f[3][3];
  for (int c = 0; c < 3; c++) {
    f[0][c] = v[1][c] - v[0][c];
    f[1][c] = v[2][c] - v[1][c];
    f[2][c] = v[0][c] - v[2][c];
  }
  double n[3] = {f[0][1] * f[1][2] - f[0][2] * f[1][1],
                 f[0][2] * f[1][0] - f[0][0] * f[1][2],
                 f[0][0] * f[1][1] - f[0][1] * f[1][0]};
  double d = n[0] * v[0][0] + n[1] * v[0][1] + n[2] * v[0][2];
  double r = e * (std::fabs(n[0]) + std::fabs(n[1]) + std::fabs(n[2]));
  if (std::fabs(d) > r + tol) return false;
  for (int k = 0; k < 3; k++) {
    for (int i = 0; i < 3; i++) {
      int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
      double p0 = -v[0][i1] * f[k][i2] + v[0][i2] * f[k][i1];
      double p1 = -v[1][i1] * f[k][i2] + v[1][i2] * f[k][i1];
      double p2 = -v[2][i1] * f[k][i2] + v[2][i2] * f[k][i1];
      double rad = e * (std::fabs(f[k][i2]) + std::fabs(f[k][i1])) + tol;
      double mn = std::fmin(p0, std::fmin(p1, p2));
      double mx = std::fmax(p0, std::fmax(p1, p2));
      if (mn > rad || mx < -rad) return false;
    }
  }
  return true;
}

int cdx_voxelize_tris(int64_t nx, int64_t ny, int64_t nz,
                      const double* lengths, double cube_extent,
                      int64_t n_tri, const double* tris, int n_threads,
                      uint8_t* occ) {
  const double ex = lengths[0] / nx, ey = lengths[1] / ny,
               ez = lengths[2] / nz;
  const double e = cube_extent;
  auto work = [&](int64_t x0, int64_t x1) {
    for (int64_t ix = x0; ix < x1; ix++) {
      double px = (ix + 0.5) * ex;
      for (int64_t iy = 0; iy < ny; iy++) {
        double py = (iy + 0.5) * ey;
        uint8_t* row = occ + (ix * ny + iy) * nz;
        for (int64_t iz = 0; iz < nz; iz++) {
          if (row[iz]) continue;
          double p[3] = {px, py, (iz + 0.5) * ez};
          for (int64_t t = 0; t < n_tri; t++) {
            if (cube_tri_overlap(p, e, tris + t * 9)) {
              row[iz] = 1;
              break;
            }
          }
        }
      }
    }
  };
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > nx) nt = static_cast<int>(nx);
  std::vector<std::thread> threads;
  int64_t chunk = (nx + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t x0 = t * chunk;
    int64_t x1 = x0 + chunk < nx ? x0 + chunk : nx;
    if (x0 >= x1) break;
    threads.emplace_back(work, x0, x1);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// exterior flood fill (grid_flood.c:30-111 + orcdchomp_mod.cpp:540-548)
// ---------------------------------------------------------------------------

// In place: occ (1 = obstacle) becomes the final obstacle mask where
// free cells NOT 6-connected-reachable from cell (0,0,0) are
// reclassified as obstacle interior.
int cdx_flood_exterior(uint8_t* occ, int64_t nx, int64_t ny, int64_t nz) {
  int64_t ncell = nx * ny * nz;
  std::vector<uint8_t> reach(static_cast<size_t>(ncell), 0);
  if (!occ[0]) {
    std::vector<int64_t> stack;
    stack.push_back(0);
    reach[0] = 1;
    const int64_t sx = ny * nz, sy = nz;
    while (!stack.empty()) {
      int64_t idx = stack.back();
      stack.pop_back();
      int64_t ix = idx / sx, iy = (idx / sy) % ny, iz = idx % nz;
      const int64_t nb[6] = {idx - sx, idx + sx, idx - sy,
                             idx + sy, idx - 1, idx + 1};
      const bool ok[6] = {ix > 0, ix < nx - 1, iy > 0,
                          iy < ny - 1, iz > 0, iz < nz - 1};
      for (int k = 0; k < 6; k++) {
        if (ok[k] && !reach[nb[k]] && !occ[nb[k]]) {
          reach[nb[k]] = 1;
          stack.push_back(nb[k]);
        }
      }
    }
  }
  for (int64_t i = 0; i < ncell; i++) occ[i] = reach[i] ? 0 : 1;
  return 0;
}

// ---------------------------------------------------------------------------
// raw binary grid cache (reference cache format: raw cell bytes)
// ---------------------------------------------------------------------------

// Returns 0 ok; -1 open failure; -2 size mismatch; -3 short read.
int cdx_grid_read(const char* path, void* data, int64_t nbytes) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0L, SEEK_END);
  if (std::ftell(fp) != static_cast<long>(nbytes)) {
    std::fclose(fp);
    return -2;
  }
  std::fseek(fp, 0L, SEEK_SET);
  size_t got = std::fread(data, 1, static_cast<size_t>(nbytes), fp);
  std::fclose(fp);
  return got == static_cast<size_t>(nbytes) ? 0 : -3;
}

int cdx_grid_write(const char* path, const void* data, int64_t nbytes) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  size_t put = std::fwrite(data, 1, static_cast<size_t>(nbytes), fp);
  std::fclose(fp);
  return put == static_cast<size_t>(nbytes) ? 0 : -3;
}

}  // extern "C"
