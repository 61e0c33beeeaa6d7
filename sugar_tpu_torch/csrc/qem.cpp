// Quadric-error-metric mesh decimation (Garland-Heckbert 1997).
//
// Copy of sugar_tpu/native/qem.cpp, host code (not a device kernel).
// Native replacement for Open3D's simplify_quadric_decimation
// (sugar_extractors/coarse_mesh.py:434-449) — the reference runs this on the
// CPU through Open3D's C++ core; here it is a self-contained C library,
// compiled with g++ by sugar_tpu_torch/native.py and bound via ctypes.
//
// Algorithm: per-vertex 4x4 error quadrics from incident face planes; edges
// keyed in a min-heap by the optimal-contraction error; contract until the
// vertex budget is met; skip contractions that flip face normals.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <unordered_set>
#include <unordered_map>
#include <functional>

namespace {

struct Quadric {
  // Symmetric 4x4, upper triangle: a..j
  double q[10] = {0};
  void add_plane(double a, double b, double c, double d) {
    q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
    q[4] += b * b; q[5] += b * c; q[6] += b * d;
    q[7] += c * c; q[8] += c * d;
    q[9] += d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; i++) q[i] += o.q[i]; }
  double eval(const double v[3]) const {
    double x = v[0], y = v[1], z = v[2];
    return q[0]*x*x + 2*q[1]*x*y + 2*q[2]*x*z + 2*q[3]*x
         + q[4]*y*y + 2*q[5]*y*z + 2*q[6]*y
         + q[7]*z*z + 2*q[8]*z
         + q[9];
  }
  // Solve for minimising point; returns false if singular.
  bool optimal(double out[3]) const {
    double m[9] = {q[0], q[1], q[2], q[1], q[4], q[5], q[2], q[5], q[7]};
    double rhs[3] = {-q[3], -q[6], -q[8]};
    double det = m[0]*(m[4]*m[8]-m[5]*m[7]) - m[1]*(m[3]*m[8]-m[5]*m[6])
               + m[2]*(m[3]*m[7]-m[4]*m[6]);
    if (std::fabs(det) < 1e-12) return false;
    double inv = 1.0 / det;
    out[0] = inv * (rhs[0]*(m[4]*m[8]-m[5]*m[7]) - m[1]*(rhs[1]*m[8]-m[5]*rhs[2])
                    + m[2]*(rhs[1]*m[7]-m[4]*rhs[2]));
    out[1] = inv * (m[0]*(rhs[1]*m[8]-m[5]*rhs[2]) - rhs[0]*(m[3]*m[8]-m[5]*m[6])
                    + m[2]*(m[3]*rhs[2]-rhs[1]*m[6]));
    out[2] = inv * (m[0]*(m[4]*rhs[2]-rhs[1]*m[7]) - m[1]*(m[3]*rhs[2]-rhs[1]*m[6])
                    + rhs[0]*(m[3]*m[7]-m[4]*m[6]));
    return std::isfinite(out[0]) && std::isfinite(out[1]) && std::isfinite(out[2]);
  }
};

struct EdgeItem {
  double cost;
  int u, v;
  uint64_t stamp;  // validity: sum of versions at push time
  double pos[3];
  bool operator<(const EdgeItem& o) const { return cost > o.cost; }  // min-heap
};

inline uint64_t ekey(int a, int b) {
  if (a > b) std::swap(a, b);
  return (uint64_t)a << 32 | (uint32_t)b;
}

}  // namespace

extern "C" {

// Returns 0 on success. Caller provides output buffers sized for the input;
// *out_nv / *out_nf receive the decimated counts.
int qem_decimate(const float* verts_in, int64_t nv,
                 const int64_t* faces_in, int64_t nf,
                 int64_t target_v,
                 float* verts_out, int64_t* out_nv,
                 int64_t* faces_out, int64_t* out_nf) {
  std::vector<double> V(nv * 3);
  for (int64_t i = 0; i < nv * 3; i++) V[i] = verts_in[i];
  std::vector<int> F(nf * 3);
  for (int64_t i = 0; i < nf * 3; i++) F[i] = (int)faces_in[i];

  std::vector<Quadric> Q(nv);
  std::vector<std::vector<int>> vfaces(nv);
  std::vector<char> fdead(nf, 0);

  for (int64_t f = 0; f < nf; f++) {
    int i0 = F[f*3], i1 = F[f*3+1], i2 = F[f*3+2];
    if (i0 == i1 || i1 == i2 || i0 == i2) { fdead[f] = 1; continue; }
    double* p0 = &V[i0*3]; double* p1 = &V[i1*3]; double* p2 = &V[i2*3];
    double ux = p1[0]-p0[0], uy = p1[1]-p0[1], uz = p1[2]-p0[2];
    double wx = p2[0]-p0[0], wy = p2[1]-p0[1], wz = p2[2]-p0[2];
    double a = uy*wz - uz*wy, b = uz*wx - ux*wz, c = ux*wy - uy*wx;
    double n = std::sqrt(a*a + b*b + c*c);
    if (n < 1e-14) { fdead[f] = 1; continue; }
    a /= n; b /= n; c /= n;
    double d = -(a*p0[0] + b*p0[1] + c*p0[2]);
    Q[i0].add_plane(a, b, c, d);
    Q[i1].add_plane(a, b, c, d);
    Q[i2].add_plane(a, b, c, d);
    vfaces[i0].push_back((int)f);
    vfaces[i1].push_back((int)f);
    vfaces[i2].push_back((int)f);
  }

  std::vector<uint64_t> version(nv, 0);
  std::vector<int> parent(nv);
  for (int64_t i = 0; i < nv; i++) parent[i] = (int)i;
  std::function<int(int)> find = [&](int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };

  std::priority_queue<EdgeItem> heap;
  std::unordered_set<uint64_t> in_edges;

  auto push_edge = [&](int u, int v) {
    u = find(u); v = find(v);
    if (u == v) return;
    Quadric q = Q[u]; q.add(Q[v]);
    double pos[3];
    if (!q.optimal(pos)) {
      // fall back to best of endpoints/midpoint
      double mid[3] = {(V[u*3]+V[v*3])/2, (V[u*3+1]+V[v*3+1])/2, (V[u*3+2]+V[v*3+2])/2};
      double eu = q.eval(&V[u*3]), ev = q.eval(&V[v*3]), em = q.eval(mid);
      if (eu <= ev && eu <= em) { pos[0]=V[u*3]; pos[1]=V[u*3+1]; pos[2]=V[u*3+2]; }
      else if (ev <= em) { pos[0]=V[v*3]; pos[1]=V[v*3+1]; pos[2]=V[v*3+2]; }
      else { pos[0]=mid[0]; pos[1]=mid[1]; pos[2]=mid[2]; }
    }
    EdgeItem it;
    it.cost = q.eval(pos);
    it.u = u; it.v = v;
    it.stamp = version[u] + version[v];
    it.pos[0] = pos[0]; it.pos[1] = pos[1]; it.pos[2] = pos[2];
    heap.push(it);
  };

  for (int64_t f = 0; f < nf; f++) {
    if (fdead[f]) continue;
    for (int e = 0; e < 3; e++) {
      int a = F[f*3 + e], b = F[f*3 + (e+1)%3];
      uint64_t k = ekey(a, b);
      if (in_edges.insert(k).second) push_edge(a, b);
    }
  }

  int64_t alive_v = 0;
  {
    std::vector<char> seen(nv, 0);
    for (int64_t f = 0; f < nf; f++) {
      if (fdead[f]) continue;
      for (int e = 0; e < 3; e++) seen[F[f*3+e]] = 1;
    }
    for (int64_t i = 0; i < nv; i++) alive_v += seen[i];
  }

  while (alive_v > target_v && !heap.empty()) {
    EdgeItem it = heap.top(); heap.pop();
    int u = find(it.u), v = find(it.v);
    if (u == v) continue;
    if (it.stamp != version[u] + version[v]) continue;  // stale

    // Normal-flip check: faces around u and v that survive must not invert.
    bool flip = false;
    for (int pass = 0; pass < 2 && !flip; pass++) {
      int w = pass == 0 ? u : v;
      for (int f : vfaces[w]) {
        if (fdead[f]) continue;
        int a = find(F[f*3]), b = find(F[f*3+1]), c = find(F[f*3+2]);
        // face collapses entirely -> will be removed, skip
        int cnt = (a==u||a==v) + (b==u||b==v) + (c==u||c==v);
        if (cnt >= 2) continue;
        double p[3][3];
        int ids[3] = {a, b, c};
        for (int k = 0; k < 3; k++) {
          if (ids[k] == u || ids[k] == v) {
            p[k][0]=it.pos[0]; p[k][1]=it.pos[1]; p[k][2]=it.pos[2];
          } else {
            p[k][0]=V[ids[k]*3]; p[k][1]=V[ids[k]*3+1]; p[k][2]=V[ids[k]*3+2];
          }
        }
        double u1[3] = {p[1][0]-p[0][0], p[1][1]-p[0][1], p[1][2]-p[0][2]};
        double u2[3] = {p[2][0]-p[0][0], p[2][1]-p[0][1], p[2][2]-p[0][2]};
        double nn[3] = {u1[1]*u2[2]-u1[2]*u2[1], u1[2]*u2[0]-u1[0]*u2[2], u1[0]*u2[1]-u1[1]*u2[0]};
        // original normal
        double q0[3] = {V[a*3], V[a*3+1], V[a*3+2]};
        double q1[3] = {V[b*3], V[b*3+1], V[b*3+2]};
        double q2[3] = {V[c*3], V[c*3+1], V[c*3+2]};
        double v1[3] = {q1[0]-q0[0], q1[1]-q0[1], q1[2]-q0[2]};
        double v2[3] = {q2[0]-q0[0], q2[1]-q0[1], q2[2]-q0[2]};
        double on[3] = {v1[1]*v2[2]-v1[2]*v2[1], v1[2]*v2[0]-v1[0]*v2[2], v1[0]*v2[1]-v1[1]*v2[0]};
        if (nn[0]*on[0] + nn[1]*on[1] + nn[2]*on[2] < 0) { flip = true; break; }
      }
    }
    if (flip) continue;

    // Contract v into u.
    parent[v] = u;
    V[u*3] = it.pos[0]; V[u*3+1] = it.pos[1]; V[u*3+2] = it.pos[2];
    Q[u].add(Q[v]);
    version[u]++;

    // Merge face lists; mark collapsed faces dead.
    std::vector<int>& fu = vfaces[u];
    for (int f : vfaces[v]) fu.push_back(f);
    vfaces[v].clear();
    std::unordered_set<uint64_t> neigh;
    std::vector<int> keep;
    keep.reserve(fu.size());
    for (int f : fu) {
      if (fdead[f]) continue;
      int a = find(F[f*3]), b = find(F[f*3+1]), c = find(F[f*3+2]);
      if (a == b || b == c || a == c) { fdead[f] = 1; continue; }
      keep.push_back(f);
      for (int e = 0; e < 3; e++) {
        int x = find(F[f*3+e]);
        if (x != u) neigh.insert((uint64_t)x);
      }
    }
    fu.swap(keep);
    alive_v--;
    for (uint64_t nb : neigh) push_edge(u, (int)nb);
  }

  // Emit compacted mesh.
  std::unordered_map<int, int64_t> remap;
  int64_t nv_out = 0, nf_out = 0;
  for (int64_t f = 0; f < nf; f++) {
    if (fdead[f]) continue;
    int a = find(F[f*3]), b = find(F[f*3+1]), c = find(F[f*3+2]);
    if (a == b || b == c || a == c) continue;
    int ids[3] = {a, b, c};
    for (int k = 0; k < 3; k++) {
      auto itn = remap.find(ids[k]);
      int64_t idx;
      if (itn == remap.end()) {
        idx = nv_out++;
        remap[ids[k]] = idx;
        verts_out[idx*3] = (float)V[ids[k]*3];
        verts_out[idx*3+1] = (float)V[ids[k]*3+1];
        verts_out[idx*3+2] = (float)V[ids[k]*3+2];
      } else {
        idx = itn->second;
      }
      faces_out[nf_out*3 + k] = idx;
    }
    nf_out++;
  }
  *out_nv = nv_out;
  *out_nf = nf_out;
  return 0;
}

}  // extern "C"
