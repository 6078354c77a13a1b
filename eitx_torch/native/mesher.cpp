// eitx native mesher: constrained-boundary 2-D triangulation.
//
// Replaces the Gmsh C++ kernel the reference drives through
// gmsh.model.geo.* + mesh.generate(2) (femm_generator.py:445-478).
//
// Pipeline:
//   1. resample the input boundary polygon at ~lc spacing,
//   2. scatter interior points on a hexagonal lattice of pitch lc
//      (kept >= 0.62*lc away from the boundary to avoid slivers),
//   3. Bowyer-Watson Delaunay triangulation of boundary+interior points,
//   4. drop triangles whose centroid falls outside the polygon
//      (handles concavities; boundary edges are respected because no
//      interior point sits between adjacent boundary samples).
//
// Exposed as plain C functions for ctypes binding (no pybind11 in image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct P {
  double x, y;
};

struct Tri {
  int a, b, c;
  double cx, cy, r2;  // circumcircle
  bool alive;
};

double dist(const P& a, const P& b) {
  return std::hypot(a.x - b.x, a.y - b.y);
}

bool circumcircle(const P& a, const P& b, const P& c, double* cx, double* cy,
                  double* r2) {
  double d = 2.0 * (a.x * (b.y - c.y) + b.x * (c.y - a.y) + c.x * (a.y - b.y));
  if (std::fabs(d) < 1e-12) return false;
  double a2 = a.x * a.x + a.y * a.y;
  double b2 = b.x * b.x + b.y * b.y;
  double c2 = c.x * c.x + c.y * c.y;
  *cx = (a2 * (b.y - c.y) + b2 * (c.y - a.y) + c2 * (a.y - b.y)) / d;
  *cy = (a2 * (c.x - b.x) + b2 * (a.x - c.x) + c2 * (b.x - a.x)) / d;
  double dx = a.x - *cx, dy = a.y - *cy;
  *r2 = dx * dx + dy * dy;
  return true;
}

bool point_in_poly(const std::vector<P>& poly, double x, double y) {
  bool in = false;
  size_t n = poly.size();
  for (size_t i = 0, j = n - 1; i < n; j = i++) {
    double yi = poly[i].y, yj = poly[j].y;
    double xi = poly[i].x, xj = poly[j].x;
    if (((yi > y) != (yj > y))) {
      double dy = yj - yi;
      if (std::fabs(dy) < 1e-30) dy = 1e-30;
      if (x < (xj - xi) * (y - yi) / dy + xi) in = !in;
    }
  }
  return in;
}

double dist_to_boundary(const std::vector<P>& poly, double x, double y) {
  double best = 1e300;
  size_t n = poly.size();
  for (size_t i = 0, j = n - 1; i < n; j = i++) {
    double vx = poly[i].x - poly[j].x, vy = poly[i].y - poly[j].y;
    double wx = x - poly[j].x, wy = y - poly[j].y;
    double L2 = vx * vx + vy * vy;
    double t = L2 > 0 ? (wx * vx + wy * vy) / L2 : 0.0;
    if (t < 0) t = 0;
    if (t > 1) t = 1;
    double dx = wx - t * vx, dy = wy - t * vy;
    double d = dx * dx + dy * dy;
    if (d < best) best = d;
  }
  return std::sqrt(best);
}

// Bowyer-Watson over a fixed point set. Points must be unique.
void delaunay(const std::vector<P>& pts, std::vector<Tri>* out) {
  // Super-triangle covering everything.
  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
  for (const P& p : pts) {
    minx = std::min(minx, p.x);
    miny = std::min(miny, p.y);
    maxx = std::max(maxx, p.x);
    maxy = std::max(maxy, p.y);
  }
  double dx = maxx - minx, dy = maxy - miny;
  double dmax = std::max(dx, dy) * 10.0 + 1.0;
  double midx = 0.5 * (minx + maxx), midy = 0.5 * (miny + maxy);
  std::vector<P> all = pts;
  int n = (int)pts.size();
  all.push_back({midx - 2 * dmax, midy - dmax});
  all.push_back({midx + 2 * dmax, midy - dmax});
  all.push_back({midx, midy + 2 * dmax});

  std::vector<Tri> tris;
  Tri super{n, n + 1, n + 2, 0, 0, 0, true};
  circumcircle(all[n], all[n + 1], all[n + 2], &super.cx, &super.cy,
               &super.r2);
  tris.push_back(super);

  std::vector<std::pair<int, int>> hole;  // boundary edges of the cavity
  for (int ip = 0; ip < n; ++ip) {
    const P& p = all[ip];
    hole.clear();
    for (Tri& t : tris) {
      if (!t.alive) continue;
      double ddx = p.x - t.cx, ddy = p.y - t.cy;
      if (ddx * ddx + ddy * ddy <= t.r2 * (1.0 + 1e-12)) {
        t.alive = false;
        int e[3][2] = {{t.a, t.b}, {t.b, t.c}, {t.c, t.a}};
        for (auto& ed : e) {
          bool dup = false;
          for (auto& h : hole) {
            if ((h.first == ed[1] && h.second == ed[0]) ||
                (h.first == ed[0] && h.second == ed[1])) {
              h.first = -1;  // shared edge: interior of cavity
              dup = true;
              break;
            }
          }
          if (!dup) hole.push_back({ed[0], ed[1]});
        }
      }
    }
    // compact dead triangles occasionally
    if (tris.size() > 4096) {
      size_t w = 0;
      for (size_t r = 0; r < tris.size(); ++r)
        if (tris[r].alive) tris[w++] = tris[r];
      tris.resize(w);
    }
    for (auto& h : hole) {
      if (h.first < 0) continue;
      Tri t{h.first, h.second, ip, 0, 0, 0, true};
      if (!circumcircle(all[t.a], all[t.b], all[t.c], &t.cx, &t.cy, &t.r2))
        continue;  // degenerate
      tris.push_back(t);
    }
  }
  out->clear();
  for (const Tri& t : tris) {
    if (!t.alive) continue;
    if (t.a >= n || t.b >= n || t.c >= n) continue;  // touches super-tri
    out->push_back(t);
  }
}

}  // namespace

extern "C" {

// Triangulate the interior of a closed polygon.
//   poly:      n_poly * 2 doubles (x, y), closed or open ring
//   lc:        target edge length
//   out_nodes: caller buffer, capacity max_nodes*2 doubles
//   out_tris:  caller buffer, capacity max_tris*3 ints
// Returns 0 on success, negative error code otherwise.
int eitx_triangulate(const double* poly, int n_poly, double lc,
                     double* out_nodes, int max_nodes, int* out_tris,
                     int max_tris, int* n_nodes_out, int* n_tris_out) {
  if (n_poly < 3 || lc <= 0) return -1;
  std::vector<P> ring(poly ? n_poly : 0);
  for (int i = 0; i < n_poly; ++i) ring[i] = {poly[2 * i], poly[2 * i + 1]};
  while (ring.size() > 1 && dist(ring.front(), ring.back()) < 1e-12)
    ring.pop_back();
  if (ring.size() < 3) return -1;

  // 1. resample boundary at ~lc spacing
  std::vector<P> bnd;
  size_t m = ring.size();
  for (size_t i = 0; i < m; ++i) {
    const P& a = ring[i];
    const P& b = ring[(i + 1) % m];
    double L = dist(a, b);
    int k = std::max(1, (int)std::floor(L / lc + 0.5));
    for (int j = 0; j < k; ++j) {
      double t = (double)j / k;
      P q{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y)};
      if (bnd.empty() || dist(bnd.back(), q) > 0.25 * lc) bnd.push_back(q);
    }
  }
  if (bnd.size() >= 2 && dist(bnd.front(), bnd.back()) < 0.25 * lc)
    bnd.pop_back();
  if (bnd.size() < 3) return -2;

  // 2. interior hexagonal lattice
  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
  for (const P& p : ring) {
    minx = std::min(minx, p.x);
    miny = std::min(miny, p.y);
    maxx = std::max(maxx, p.x);
    maxy = std::max(maxy, p.y);
  }
  std::vector<P> pts = bnd;
  double rowh = lc * 0.8660254037844386;  // sqrt(3)/2
  int row = 0;
  for (double y = miny + 0.5 * rowh; y < maxy; y += rowh, ++row) {
    double x0 = minx + ((row % 2) ? 0.75 * lc : 0.25 * lc);
    for (double x = x0; x < maxx; x += lc) {
      if (!point_in_poly(ring, x, y)) continue;
      if (dist_to_boundary(ring, x, y) < 0.62 * lc) continue;
      pts.push_back({x, y});
    }
  }

  // 3. Delaunay
  std::vector<Tri> tris;
  delaunay(pts, &tris);

  // 4. keep triangles with centroid inside and not degenerate
  std::vector<int> keep;
  keep.reserve(tris.size());
  for (size_t i = 0; i < tris.size(); ++i) {
    const Tri& t = tris[i];
    const P& a = pts[t.a];
    const P& b = pts[t.b];
    const P& c = pts[t.c];
    double cx = (a.x + b.x + c.x) / 3.0, cy = (a.y + b.y + c.y) / 3.0;
    double area2 = (b.x - a.x) * (c.y - a.y) - (c.x - a.x) * (b.y - a.y);
    if (std::fabs(area2) < 1e-9 * lc * lc) continue;
    if (!point_in_poly(ring, cx, cy)) continue;
    keep.push_back((int)i);
  }

  if ((int)pts.size() > max_nodes || (int)keep.size() > max_tris) return -3;
  for (size_t i = 0; i < pts.size(); ++i) {
    out_nodes[2 * i] = pts[i].x;
    out_nodes[2 * i + 1] = pts[i].y;
  }
  for (size_t k = 0; k < keep.size(); ++k) {
    const Tri& t = tris[keep[k]];
    // enforce CCW winding
    const P& a = pts[t.a];
    const P& b = pts[t.b];
    const P& c = pts[t.c];
    double area2 = (b.x - a.x) * (c.y - a.y) - (c.x - a.x) * (b.y - a.y);
    if (area2 >= 0) {
      out_tris[3 * k] = t.a;
      out_tris[3 * k + 1] = t.b;
      out_tris[3 * k + 2] = t.c;
    } else {
      out_tris[3 * k] = t.a;
      out_tris[3 * k + 1] = t.c;
      out_tris[3 * k + 2] = t.b;
    }
  }
  *n_nodes_out = (int)pts.size();
  *n_tris_out = (int)keep.size();
  return 0;
}

}  // extern "C"
