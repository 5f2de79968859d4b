// meshkernel: native 2-D Delaunay triangulation + Laplacian smoothing.
//
// The JAX framework's replacement for the reference study's native
// mesher (Gmsh, invoked as a C++ subprocess in the reference's mesh.py).
// Incremental Bowyer-Watson with:
//   - Hilbert-curve insertion order (locality => near-linear point location)
//   - walking point location from the last inserted triangle
//   - filtered geometric predicates: fast double evaluation with a forward
//     error bound, exact fallback via double-double (Dekker/Knuth) products
//   - index-based symbolic tie-breaking for exactly cocircular points
//     (quadtree-seeded point sets are full of cocircular quadruples)
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image):
//   int feu_triangulate(const double* pts, long n,
//                       long* out_tris, long max_tris);
//   int feu_smooth(double* pts, long n, long n_fixed, int n_iters,
//                  long* out_tris, long max_tris);   // smooth+retriangulate
// Return value: number of triangles, or -1 on failure.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// exact-ish predicates: double-double helpers
// ----------------------------------------------------------------------

struct dd { double hi, lo; };

inline dd two_sum(double a, double b) {
  double s = a + b;
  double bb = s - a;
  double err = (a - (s - bb)) + (b - bb);
  return {s, err};
}

inline dd two_prod(double a, double b) {
  double p = a * b;
  double err = std::fma(a, b, -p);
  return {p, err};
}

inline dd dd_add(dd a, dd b) {
  dd s = two_sum(a.hi, b.hi);
  double lo = s.lo + a.lo + b.lo;
  return two_sum(s.hi, lo);
}

inline dd dd_sub(dd a, dd b) { return dd_add(a, {-b.hi, -b.lo}); }

inline dd dd_mul(dd a, dd b) {
  dd p = two_prod(a.hi, b.hi);
  p.lo += a.hi * b.lo + a.lo * b.hi;
  return two_sum(p.hi, p.lo);
}

inline dd dd_from(double x) { return {x, 0.0}; }

// orient2d: sign of (b-a) x (c-a).  Filtered: fast path with error bound.
inline double orient2d_fast(const double* a, const double* b,
                            const double* c, double* errbound) {
  double detleft = (a[0] - c[0]) * (b[1] - c[1]);
  double detright = (a[1] - c[1]) * (b[0] - c[0]);
  double det = detleft - detright;
  double detsum = std::abs(detleft) + std::abs(detright);
  *errbound = 3.3307e-16 * detsum;
  return det;
}

double orient2d_exact(const double* a, const double* b, const double* c) {
  dd acx = two_sum(a[0], -c[0]);
  dd acy = two_sum(a[1], -c[1]);
  dd bcx = two_sum(b[0], -c[0]);
  dd bcy = two_sum(b[1], -c[1]);
  dd det = dd_sub(dd_mul(acx, bcy), dd_mul(acy, bcx));
  return det.hi;
}

inline double orient2d(const double* a, const double* b, const double* c) {
  double err;
  double det = orient2d_fast(a, b, c, &err);
  if (std::abs(det) > err) return det;
  return orient2d_exact(a, b, c);
}

// incircle: positive if d is inside the circumcircle of CCW (a,b,c).
inline double incircle_fast(const double* a, const double* b,
                            const double* c, const double* d,
                            double* errbound) {
  double adx = a[0] - d[0], ady = a[1] - d[1];
  double bdx = b[0] - d[0], bdy = b[1] - d[1];
  double cdx = c[0] - d[0], cdy = c[1] - d[1];
  double ad2 = adx * adx + ady * ady;
  double bd2 = bdx * bdx + bdy * bdy;
  double cd2 = cdx * cdx + cdy * cdy;
  double det = ad2 * (bdx * cdy - bdy * cdx)
             - bd2 * (adx * cdy - ady * cdx)
             + cd2 * (adx * bdy - ady * bdx);
  double perm = ad2 * (std::abs(bdx * cdy) + std::abs(bdy * cdx))
              + bd2 * (std::abs(adx * cdy) + std::abs(ady * cdx))
              + cd2 * (std::abs(adx * bdy) + std::abs(ady * bdx));
  *errbound = 1.1102e-15 * perm;
  return det;
}

double incircle_exact(const double* a, const double* b, const double* c,
                      const double* d) {
  dd adx = two_sum(a[0], -d[0]), ady = two_sum(a[1], -d[1]);
  dd bdx = two_sum(b[0], -d[0]), bdy = two_sum(b[1], -d[1]);
  dd cdx = two_sum(c[0], -d[0]), cdy = two_sum(c[1], -d[1]);
  dd ad2 = dd_add(dd_mul(adx, adx), dd_mul(ady, ady));
  dd bd2 = dd_add(dd_mul(bdx, bdx), dd_mul(bdy, bdy));
  dd cd2 = dd_add(dd_mul(cdx, cdx), dd_mul(cdy, cdy));
  dd t1 = dd_sub(dd_mul(bdx, cdy), dd_mul(bdy, cdx));
  dd t2 = dd_sub(dd_mul(adx, cdy), dd_mul(ady, cdx));
  dd t3 = dd_sub(dd_mul(adx, bdy), dd_mul(ady, bdx));
  dd det = dd_add(dd_sub(dd_mul(ad2, t1), dd_mul(bd2, t2)),
                  dd_mul(cd2, t3));
  return det.hi;
}

inline double incircle(const double* a, const double* b, const double* c,
                       const double* d) {
  double err;
  double det = incircle_fast(a, b, c, d, &err);
  if (std::abs(det) > err) return det;
  return incircle_exact(a, b, c, d);
}

// ----------------------------------------------------------------------
// Hilbert curve index (for insertion order locality)
// ----------------------------------------------------------------------

uint64_t hilbert_d2xy_index(uint32_t order, uint32_t x, uint32_t y) {
  uint64_t rx, ry, d = 0;
  for (uint64_t s = 1ULL << (order - 1); s > 0; s >>= 1) {
    rx = (x & s) > 0;
    ry = (y & s) > 0;
    d += s * s * ((3 * rx) ^ ry);
    // rotate
    if (ry == 0) {
      if (rx == 1) {
        x = (uint32_t)(s - 1 - x);
        y = (uint32_t)(s - 1 - y);
      }
      std::swap(x, y);
    }
  }
  return d;
}

// ----------------------------------------------------------------------
// Bowyer-Watson incremental Delaunay
// ----------------------------------------------------------------------

struct Tri {
  int64_t v[3];    // vertex indices (super vertices are n..n+2)
  int64_t nbr[3];  // neighbor triangle index across edge opposite v[k]
  bool alive;
};

class Delaunay {
 public:
  explicit Delaunay(const double* pts, int64_t n) : pts_(pts), n_(n) {
    // bounding super-triangle
    double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
    for (int64_t i = 0; i < n; ++i) {
      xmin = std::min(xmin, pts[2 * i]);
      xmax = std::max(xmax, pts[2 * i]);
      ymin = std::min(ymin, pts[2 * i + 1]);
      ymax = std::max(ymax, pts[2 * i + 1]);
    }
    double cx = 0.5 * (xmin + xmax), cy = 0.5 * (ymin + ymax);
    double r = std::max(xmax - xmin, ymax - ymin);
    if (r <= 0) r = 1.0;
    r *= 16.0;
    super_[0] = cx - 2.0 * r; super_[1] = cy - r;
    super_[2] = cx + 2.0 * r; super_[3] = cy - r;
    super_[4] = cx;           super_[5] = cy + 2.0 * r;
    tris_.push_back({{n, n + 1, n + 2}, {-1, -1, -1}, true});
    last_ = 0;
  }

  const double* coord(int64_t v) const {
    return v < n_ ? pts_ + 2 * v : super_ + 2 * (v - n_);
  }

  // orientation with super-point handling falls back to coordinates (the
  // super triangle is huge, plain predicates are fine).
  bool insert(int64_t p) {
    int64_t t = locate(p);
    if (t < 0) return false;
    // collect cavity via BFS over incircle-violating triangles
    cavity_.clear();
    cav_mark_.clear();
    stack_.clear();
    stack_.push_back(t);
    mark(t);
    while (!stack_.empty()) {
      int64_t cur = stack_.back();
      stack_.pop_back();
      cavity_.push_back(cur);
      for (int k = 0; k < 3; ++k) {
        int64_t nb = tris_[cur].nbr[k];
        if (nb < 0 || marked(nb)) continue;
        if (in_circum(nb, p)) {
          mark(nb);
          stack_.push_back(nb);
        }
      }
    }
    // boundary edges of the cavity -> fan from p
    boundary_.clear();
    for (int64_t ct : cavity_) {
      for (int k = 0; k < 3; ++k) {
        int64_t nb = tris_[ct].nbr[k];
        if (nb >= 0 && marked(nb)) continue;
        // edge opposite v[k] is (v[k+1], v[k+2])
        boundary_.push_back({tris_[ct].v[(k + 1) % 3],
                             tris_[ct].v[(k + 2) % 3], nb});
      }
    }
    for (int64_t ct : cavity_) tris_[ct].alive = false;
    // create new triangles
    int64_t first_new = (int64_t)tris_.size();
    int64_t m = (int64_t)boundary_.size();
    edge_map_.clear();
    for (int64_t i = 0; i < m; ++i) {
      auto& e = boundary_[i];
      Tri nt{{p, e.a, e.b}, {e.outer, -1, -1}, true};
      int64_t idx = (int64_t)tris_.size();
      tris_.push_back(nt);
      if (e.outer >= 0) {
        // fix the neighbor's back-pointer
        Tri& on = tris_[e.outer];
        for (int k = 0; k < 3; ++k) {
          int64_t va = on.v[(k + 1) % 3], vb = on.v[(k + 2) % 3];
          if ((va == e.b && vb == e.a) || (va == e.a && vb == e.b)) {
            on.nbr[k] = idx;
            break;
          }
        }
      }
      // link new triangles by shared edges (p, x)
      link_edge(p, e.a, idx, 2);  // edge (p, e.a) opposite v[2]=e.b? see below
      link_edge(p, e.b, idx, 1);
    }
    last_ = first_new;
    (void)m;
    return true;
  }

  void get_triangles(std::vector<int64_t>* out) const {
    out->clear();
    for (const Tri& t : tris_) {
      if (!t.alive) continue;
      if (t.v[0] >= n_ || t.v[1] >= n_ || t.v[2] >= n_) continue;
      out->push_back(t.v[0]);
      out->push_back(t.v[1]);
      out->push_back(t.v[2]);
    }
  }

 private:
  struct BEdge { int64_t a, b, outer; };

  bool in_circum(int64_t t, int64_t p) {
    const Tri& T = tris_[t];
    // super vertices are treated SYMBOLICALLY as points at infinity;
    // numeric incircle with finite-distance supers loses hull slivers
    // (their circumcircles are huge).
    int sc = 0, si = -1;
    for (int k = 0; k < 3; ++k)
      if (T.v[k] >= n_) { sc++; si = k; }
    const double* pp = coord(p);
    if (sc == 1) {
      // triangle (u, v, INF) CCW: conflict region = open half-plane left
      // of directed finite edge u->v; collinear points conflict iff they
      // fall within the closed segment (so hull edges split correctly and
      // collinear extensions create new hull edges, never degenerate
      // triangles).
      const double* u = coord(T.v[(si + 1) % 3]);
      const double* v = coord(T.v[(si + 2) % 3]);
      double det = orient2d(u, v, pp);
      if (det != 0.0) return det > 0.0;
      double dx = v[0] - u[0], dy = v[1] - u[1];
      double s = (pp[0] - u[0]) * dx + (pp[1] - u[1]) * dy;
      return s >= 0.0 && s <= dx * dx + dy * dy;
    }
    if (sc >= 2) {
      // wedge at infinity anchored at the finite vertex: only reachable
      // when p extends the hull past that vertex; numeric test on the
      // (huge) super coordinates approximates the wedge adequately.
      double det = incircle(coord(T.v[0]), coord(T.v[1]), coord(T.v[2]),
                            pp);
      return det > 0.0;
    }
    double det = incircle(coord(T.v[0]), coord(T.v[1]), coord(T.v[2]), pp);
    if (det != 0.0) return det > 0.0;
    // exactly cocircular: symbolic tie-break by max vertex index (ensures
    // a consistent, flip-free choice)
    int64_t mx = std::max({T.v[0], T.v[1], T.v[2]});
    return p < mx;
  }

  int64_t locate(int64_t p) {
    // walk from last_
    int64_t t = last_;
    if (t < 0 || !tris_[t].alive) {
      for (int64_t i = (int64_t)tris_.size() - 1; i >= 0; --i)
        if (tris_[i].alive) { t = i; break; }
    }
    const double* pp = coord(p);
    for (int64_t steps = 0; steps < (int64_t)tris_.size() + 8; ++steps) {
      const Tri& T = tris_[t];
      int64_t next = -1;
      for (int k = 0; k < 3; ++k) {
        const double* a = coord(T.v[(k + 1) % 3]);
        const double* b = coord(T.v[(k + 2) % 3]);
        if (orient2d(a, b, pp) < 0.0) {
          next = T.nbr[k];
          break;
        }
      }
      if (next < 0) return t;
      t = next;
    }
    return -1;  // walk failed (should not happen)
  }

  void link_edge(int64_t p, int64_t x, int64_t tri_idx, int opp_slot) {
    uint64_t key = (uint64_t)p * 0x9E3779B97F4A7C15ULL ^ (uint64_t)x;
    (void)key;
    auto it = std::find_if(edge_map_.begin(), edge_map_.end(),
                           [&](const EdgeEntry& e) {
                             return e.p == p && e.x == x;
                           });
    if (it == edge_map_.end()) {
      edge_map_.push_back({p, x, tri_idx, opp_slot});
    } else {
      tris_[tri_idx].nbr[opp_slot] = it->tri;
      tris_[it->tri].nbr[it->slot] = tri_idx;
    }
  }

  void mark(int64_t t) {
    if ((int64_t)mark_flags_.size() < (int64_t)tris_.size())
      mark_flags_.resize(tris_.size() * 2, 0);
    mark_flags_[t] = mark_epoch_;
    cav_mark_.push_back(t);
  }
  bool marked(int64_t t) {
    if ((int64_t)mark_flags_.size() <= t) return false;
    return mark_flags_[t] == mark_epoch_;
  }

 public:
  void next_epoch() { ++mark_epoch_; }

 private:
  struct EdgeEntry { int64_t p, x, tri; int slot; };

  const double* pts_;
  int64_t n_;
  double super_[6];
  std::vector<Tri> tris_;
  int64_t last_;
  std::vector<int64_t> cavity_, stack_, cav_mark_;
  std::vector<BEdge> boundary_;
  std::vector<EdgeEntry> edge_map_;
  std::vector<uint32_t> mark_flags_;
  uint32_t mark_epoch_ = 1;
};

int64_t triangulate_impl(const double* pts, int64_t n, int64_t* out,
                         int64_t max_tris) {
  if (n < 3) return 0;
  // Hilbert insertion order
  double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
  for (int64_t i = 0; i < n; ++i) {
    xmin = std::min(xmin, pts[2 * i]);
    xmax = std::max(xmax, pts[2 * i]);
    ymin = std::min(ymin, pts[2 * i + 1]);
    ymax = std::max(ymax, pts[2 * i + 1]);
  }
  double sx = (xmax > xmin) ? (1.0 / (xmax - xmin)) : 1.0;
  double sy = (ymax > ymin) ? (1.0 / (ymax - ymin)) : 1.0;
  std::vector<std::pair<uint64_t, int64_t>> order(n);
  const uint32_t ORDER = 16;
  const double scale = (double)((1u << ORDER) - 1);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t hx = (uint32_t)(scale * (pts[2 * i] - xmin) * sx);
    uint32_t hy = (uint32_t)(scale * (pts[2 * i + 1] - ymin) * sy);
    order[i] = {hilbert_d2xy_index(ORDER, hx, hy), i};
  }
  std::sort(order.begin(), order.end());

  Delaunay dt(pts, n);
  for (auto& pr : order) {
    dt.next_epoch();
    if (!dt.insert(pr.second)) return -1;
  }
  std::vector<int64_t> tris;
  dt.get_triangles(&tris);
  int64_t t = (int64_t)tris.size() / 3;
  if (t > max_tris) return -1;
  std::memcpy(out, tris.data(), sizeof(int64_t) * tris.size());
  return t;
}

// ---------------------------------------------------------------------------
// ASCII Gmsh MSH 2.x parser (native twin of meshing/msh_io.py:read_msh2).
// Line-based like the Python parser so unknown element types are skipped by
// consuming the remainder of their line; node ids are remapped to contiguous
// 0-based indices in ascending-id order (duplicate ids: last wins).
// ---------------------------------------------------------------------------

struct Msh2Data {
  std::vector<double> verts;       // 2 * n_nodes
  std::vector<int64_t> tris;       // 3 * n_tris
  std::vector<int64_t> tri_tags;   // n_tris
  std::vector<int64_t> lines;      // 2 * n_lines
  std::vector<int64_t> line_tags;  // n_lines
  int64_t version_x10 = 0;         // e.g. "2.2" -> 22
};

// Advance past the current line; *line/*len get the trimmed line contents.
static bool next_line(const char*& p, const char* end, const char** line,
                      size_t* len) {
  if (p >= end) return false;
  const char* nl = (const char*)std::memchr(p, '\n', (size_t)(end - p));
  const char* stop = nl ? nl : end;
  const char* a = p;
  while (a < stop && (*a == ' ' || *a == '\t' || *a == '\r')) ++a;
  const char* b = stop;
  while (b > a && (b[-1] == ' ' || b[-1] == '\t' || b[-1] == '\r')) --b;
  *line = a;
  *len = (size_t)(b - a);
  p = nl ? nl + 1 : end;
  return true;
}

static bool line_is(const char* line, size_t len, const char* kw) {
  size_t kl = std::strlen(kw);
  return len == kl && std::memcmp(line, kw, kl) == 0;
}

// Bounded field parsers: strtod/strtoll skip leading whitespace INCLUDING
// newlines, so an unchecked parse of a short/malformed line would silently
// consume the next line's bytes (and, unterminated, read past the buffer).
// Each parse must (a) convert something and (b) stay within [line, line+len];
// otherwise the whole parse fails and the caller falls back to the Python
// spec parser, which raises.
static bool parse_i64(const char** q, const char* line_end, int64_t* out) {
  char* e = nullptr;
  int64_t v = std::strtoll(*q, &e, 10);
  if (e == *q || e > line_end) return false;
  *q = e;
  *out = v;
  return true;
}

static bool parse_f64(const char** q, const char* line_end, double* out) {
  char* e = nullptr;
  double v = std::strtod(*q, &e);
  if (e == *q || e > line_end) return false;
  *q = e;
  *out = v;
  return true;
}

static Msh2Data* msh2_parse_impl(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // sz+1 NUL terminator: the buffer is parsed with C string functions and a
  // file ending in a numeric token must not read past the allocation
  std::vector<char> buf((size_t)(sz > 0 ? sz : 0) + 1, '\0');
  if (sz > 0 && std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  const char* p = buf.data();
  const char* end = p + (size_t)(sz > 0 ? sz : 0);
  const char* line;
  size_t len;

  std::unordered_map<int64_t, std::pair<double, double>> nodes;
  std::vector<int64_t> raw_tris, raw_tri_tags, raw_lines, raw_line_tags;
  int64_t version_x10 = 0;

  while (next_line(p, end, &line, &len)) {
    if (line_is(line, len, "$MeshFormat")) {
      if (!next_line(p, end, &line, &len)) return nullptr;
      // only accept the canonical "D.D ..." version token; anything else
      // (a bare "2", garbage) goes back to the Python spec parser, which
      // carries the raw token / raises (meshing/msh_io.py:51-57)
      if (len < 3 || line[0] != '2' || line[1] != '.' ||
          line[2] < '0' || line[2] > '9' ||
          (len > 3 && line[3] != ' ' && line[3] != '\t'))
        return nullptr;
      version_x10 = 20 + (int64_t)(line[2] - '0');
      next_line(p, end, &line, &len);  // $EndMeshFormat
    } else if (line_is(line, len, "$Nodes")) {
      if (!next_line(p, end, &line, &len)) return nullptr;
      const char* q = line;
      int64_t count = 0;
      if (!parse_i64(&q, line + len, &count) || count < 0) return nullptr;
      nodes.reserve((size_t)count * 2);
      for (int64_t k = 0; k < count; ++k) {
        if (!next_line(p, end, &line, &len)) return nullptr;
        const char* le = line + len;
        q = line;
        int64_t id;
        double x, y;
        if (!parse_i64(&q, le, &id) || !parse_f64(&q, le, &x) ||
            !parse_f64(&q, le, &y))  // z stripped (ref mesh.py:380-382)
          return nullptr;
        nodes[id] = {x, y};
      }
      next_line(p, end, &line, &len);  // $EndNodes
    } else if (line_is(line, len, "$Elements")) {
      if (!next_line(p, end, &line, &len)) return nullptr;
      const char* q = line;
      int64_t count = 0;
      if (!parse_i64(&q, line + len, &count) || count < 0) return nullptr;
      for (int64_t k = 0; k < count; ++k) {
        if (!next_line(p, end, &line, &len)) return nullptr;
        const char* le = line + len;
        q = line;
        int64_t eid, etype, ntags, tag0 = 0;
        if (!parse_i64(&q, le, &eid) || !parse_i64(&q, le, &etype) ||
            !parse_i64(&q, le, &ntags) || ntags < 0)
          return nullptr;
        for (int64_t t = 0; t < ntags; ++t) {
          int64_t tg;
          if (!parse_i64(&q, le, &tg)) return nullptr;
          if (t == 0) tag0 = tg;
        }
        if (etype == 2) {  // 3-node triangle
          int64_t v;
          for (int e = 0; e < 3; ++e) {
            if (!parse_i64(&q, le, &v)) return nullptr;
            raw_tris.push_back(v);
          }
          raw_tri_tags.push_back(tag0);
        } else if (etype == 1) {  // 2-node line
          int64_t v;
          for (int e = 0; e < 2; ++e) {
            if (!parse_i64(&q, le, &v)) return nullptr;
            raw_lines.push_back(v);
          }
          raw_line_tags.push_back(tag0);
        }  // other element types: line already consumed, skip
      }
      next_line(p, end, &line, &len);  // $EndElements
    }
  }
  // no $MeshFormat seen: the Python spec parser returns version=None --
  // refuse here so the fallback carries the declared behaviour
  if (version_x10 == 0) return nullptr;
  if (nodes.empty()) return nullptr;

  std::vector<int64_t> ids;
  ids.reserve(nodes.size());
  for (auto& kv : nodes) ids.push_back(kv.first);
  std::sort(ids.begin(), ids.end());
  std::unordered_map<int64_t, int64_t> remap;
  remap.reserve(ids.size() * 2);
  auto* out = new Msh2Data();
  out->version_x10 = version_x10;
  out->verts.reserve(ids.size() * 2);
  for (size_t j = 0; j < ids.size(); ++j) {
    remap[ids[j]] = (int64_t)j;
    auto& xy = nodes[ids[j]];
    out->verts.push_back(xy.first);
    out->verts.push_back(xy.second);
  }
  auto apply = [&](const std::vector<int64_t>& raw,
                   std::vector<int64_t>* dst) -> bool {
    dst->reserve(raw.size());
    for (int64_t v : raw) {
      auto it = remap.find(v);
      if (it == remap.end()) return false;  // dangling connectivity
      dst->push_back(it->second);
    }
    return true;
  };
  if (!apply(raw_tris, &out->tris) || !apply(raw_lines, &out->lines)) {
    delete out;
    return nullptr;
  }
  out->tri_tags = std::move(raw_tri_tags);
  out->line_tags = std::move(raw_line_tags);
  return out;
}

}  // namespace

extern "C" {

// Parse MSH 2.x ASCII. counts[0..3] = n_nodes, n_tris, n_lines, version*10.
// Returns an opaque handle (free with feu_msh2_free) or NULL on failure.
void* feu_msh2_parse(const char* path, int64_t* counts) {
  try {
    Msh2Data* d = msh2_parse_impl(path);
    if (!d) return nullptr;
    counts[0] = (int64_t)d->verts.size() / 2;
    counts[1] = (int64_t)d->tris.size() / 3;
    counts[2] = (int64_t)d->lines.size() / 2;
    counts[3] = d->version_x10;
    return d;
  } catch (...) {
    return nullptr;
  }
}

// Copy parsed arrays into caller-allocated buffers sized from counts.
int64_t feu_msh2_copy(void* handle, double* verts, int64_t* tris,
                      int64_t* tri_tags, int64_t* lines, int64_t* line_tags) {
  try {
    auto* d = (Msh2Data*)handle;
    std::memcpy(verts, d->verts.data(), d->verts.size() * sizeof(double));
    std::memcpy(tris, d->tris.data(), d->tris.size() * sizeof(int64_t));
    std::memcpy(tri_tags, d->tri_tags.data(),
                d->tri_tags.size() * sizeof(int64_t));
    std::memcpy(lines, d->lines.data(), d->lines.size() * sizeof(int64_t));
    std::memcpy(line_tags, d->line_tags.data(),
                d->line_tags.size() * sizeof(int64_t));
    return 0;
  } catch (...) {
    return -1;
  }
}

void feu_msh2_free(void* handle) { delete (Msh2Data*)handle; }

int64_t feu_triangulate(const double* pts, int64_t n, int64_t* out_tris,
                        int64_t max_tris) {
  try {
    return triangulate_impl(pts, n, out_tris, max_tris);
  } catch (...) {
    return -1;
  }
}

// Laplacian smoothing with re-triangulation: points [0, n_fixed) immovable.
int64_t feu_smooth(double* pts, int64_t n, int64_t n_fixed, int n_iters,
                   int64_t* out_tris, int64_t max_tris) {
  try {
    std::vector<int64_t> tris;
    std::vector<double> sums(2 * n);
    std::vector<int32_t> counts(n);
    int64_t t = 0;
    for (int it = 0; it <= n_iters; ++it) {
      t = triangulate_impl(pts, n, out_tris, max_tris);
      if (t < 0) return -1;
      if (it == n_iters) break;
      std::fill(sums.begin(), sums.end(), 0.0);
      std::fill(counts.begin(), counts.end(), 0);
      for (int64_t k = 0; k < t; ++k) {
        const int64_t* v = out_tris + 3 * k;
        for (int e = 0; e < 3; ++e) {
          int64_t a = v[e], b = v[(e + 1) % 3];
          sums[2 * a] += pts[2 * b];
          sums[2 * a + 1] += pts[2 * b + 1];
          counts[a]++;
          sums[2 * b] += pts[2 * a];
          sums[2 * b + 1] += pts[2 * a + 1];
          counts[b]++;
        }
      }
      for (int64_t i = n_fixed; i < n; ++i) {
        if (counts[i] > 0) {
          pts[2 * i] = sums[2 * i] / counts[i];
          pts[2 * i + 1] = sums[2 * i + 1] / counts[i];
        }
      }
    }
    return t;
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
