// The port's own copy of morefusion_tpu/csrc/mapping.cpp, built by
// morefusion_tpu_torch/contrib/mapping_native.py into _build/libmfm.so.
//
// Multi-instance occupancy mapping backend (C++).
//
// Native equivalent of the reference's octomap-backed OctomapServer
// (ros/src/morefusion_ros/src/OctomapServer.cpp:1-842) without the
// octomap/PCL/ROS dependencies: per-instance sparse voxel hash maps with
// log-odds fusion, exact 3D-DDA ray carving (Amanatides & Woo traversal —
// the octree insertPointCloud equivalent), per-pixel raycast rendering of
// the fused maps to a predicted instance-label image (OctomapServer::render,
// OpenMP), and dense 32^3 grid extraction for the pose network
// (publishGrids). Exposed as a C ABI for ctypes; the Python twin
// (contrib/occupancy_mapping.py) implements identical semantics and serves
// as the correctness oracle in tests.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC mapping.cpp -o libmfm.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr float kHit = 0.85f;
constexpr float kMiss = -0.4f;
constexpr float kClampMin = -2.0f;
constexpr float kClampMax = 3.5f;
constexpr float kOccupiedLogOdds = 0.0f;  // p >= 0.5 <=> logodds >= 0

inline int64_t pack(int64_t i, int64_t j, int64_t k) {
  constexpr int64_t off = 1 << 20;
  return ((i + off) << 42) | ((j + off) << 21) | (k + off);
}

inline void unpack(int64_t key, int64_t* i, int64_t* j, int64_t* k) {
  constexpr int64_t off = 1 << 20;
  constexpr int64_t mask = (1 << 21) - 1;
  *i = ((key >> 42) & mask) - off;
  *j = ((key >> 21) & mask) - off;
  *k = (key & mask) - off;
}

struct VoxelMap {
  float pitch = 0.01f;
  std::unordered_map<int64_t, float> cells;
  // conservative (never-shrinking) AABB over cells that ever became
  // occupied, in voxel indices — rendering clips rays to it, which turns
  // the per-pixel x per-map DDA from O(max_range/pitch) steps into
  // O(object extent/pitch) and skips rays that miss the object entirely
  int64_t bmin[3] = {INT64_MAX, INT64_MAX, INT64_MAX};
  int64_t bmax[3] = {INT64_MIN, INT64_MIN, INT64_MIN};

  inline int64_t quantize1(double x) const {
    return (int64_t)std::floor(x / pitch);
  }

  void update_cell(int64_t key, float delta) {
    auto it = cells.find(key);
    float v = (it == cells.end()) ? 0.0f : it->second;
    v += delta;
    if (v < kClampMin) v = kClampMin;
    if (v > kClampMax) v = kClampMax;
    cells[key] = v;
    if (v >= kOccupiedLogOdds) {
      int64_t i, j, k;
      unpack(key, &i, &j, &k);
      if (i < bmin[0]) bmin[0] = i;
      if (j < bmin[1]) bmin[1] = j;
      if (k < bmin[2]) bmin[2] = k;
      if (i > bmax[0]) bmax[0] = i;
      if (j > bmax[1]) bmax[1] = j;
      if (k > bmax[2]) bmax[2] = k;
    }
  }

  // Clip the ray o + t*d (unit d) to the occupied AABB; returns false if
  // the map is empty or the ray misses. On true, [*t0, *t1] is the
  // in-bounds parameter range intersected with the incoming [*t0, *t1].
  bool clip_ray(const double o[3], const double d[3], double* t0,
                double* t1) const {
    if (bmin[0] > bmax[0]) return false;  // no occupied cells
    double lo = *t0, hi = *t1;
    for (int a = 0; a < 3; ++a) {
      double wmin = (double)bmin[a] * pitch;
      double wmax = ((double)bmax[a] + 1.0) * pitch;
      if (std::fabs(d[a]) < 1e-12) {
        if (o[a] < wmin || o[a] > wmax) return false;
        continue;
      }
      double ta = (wmin - o[a]) / d[a];
      double tb = (wmax - o[a]) / d[a];
      if (ta > tb) std::swap(ta, tb);
      if (ta > lo) lo = ta;
      if (tb < hi) hi = tb;
      if (lo > hi) return false;
    }
    *t0 = lo;
    *t1 = hi;
    return true;
  }

  // log-odds at world point; NaN if unknown
  float query(double x, double y, double z) const {
    auto it = cells.find(pack(quantize1(x), quantize1(y), quantize1(z)));
    if (it == cells.end()) return std::numeric_limits<float>::quiet_NaN();
    return it->second;
  }

  // Amanatides-Woo voxel traversal from origin to endpoint (exclusive).
  template <typename F>
  void walk_ray(const double o[3], const double e[3], F&& visit) const {
    double dir[3] = {e[0] - o[0], e[1] - o[1], e[2] - o[2]};
    double len = std::sqrt(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2]);
    if (len <= 0) return;

    int64_t cur[3] = {quantize1(o[0]), quantize1(o[1]), quantize1(o[2])};
    int64_t end[3] = {quantize1(e[0]), quantize1(e[1]), quantize1(e[2])};

    int step[3];
    double t_max[3], t_delta[3];
    for (int a = 0; a < 3; ++a) {
      if (dir[a] > 0) {
        step[a] = 1;
        double next = ((double)cur[a] + 1.0) * pitch;
        t_max[a] = (next - o[a]) / dir[a];
        t_delta[a] = pitch / dir[a];
      } else if (dir[a] < 0) {
        step[a] = -1;
        double next = (double)cur[a] * pitch;
        t_max[a] = (next - o[a]) / dir[a];
        t_delta[a] = -pitch / dir[a];
      } else {
        step[a] = 0;
        t_max[a] = std::numeric_limits<double>::infinity();
        t_delta[a] = std::numeric_limits<double>::infinity();
      }
    }

    int guard = 0;
    const int max_steps = 100000;
    while (guard++ < max_steps) {
      if (cur[0] == end[0] && cur[1] == end[1] && cur[2] == end[2]) break;
      if (!visit(cur[0], cur[1], cur[2])) break;
      int axis = 0;
      if (t_max[1] < t_max[axis]) axis = 1;
      if (t_max[2] < t_max[axis]) axis = 2;
      if (t_max[axis] > 1.0) break;  // passed the endpoint
      cur[axis] += step[axis];
      t_max[axis] += t_delta[axis];
    }
  }
};

struct MultiMap {
  std::map<int, VoxelMap> maps;
};

inline float prob_of(float logodds) {
  return 1.0f / (1.0f + std::exp(-logodds));
}

}  // namespace

extern "C" {

void* mfm_create() { return new MultiMap(); }

void mfm_destroy(void* h) { delete (MultiMap*)h; }

int mfm_initialize(void* h, int instance_id, double pitch) {
  auto* m = (MultiMap*)h;
  if (m->maps.count(instance_id)) return -1;
  m->maps[instance_id].pitch = (float)pitch;
  return 0;
}

int mfm_has_instance(void* h, int instance_id) {
  return ((MultiMap*)h)->maps.count(instance_id) ? 1 : 0;
}

int mfm_num_instances(void* h) { return (int)((MultiMap*)h)->maps.size(); }

void mfm_instance_ids(void* h, int* out) {
  auto* m = (MultiMap*)h;
  int k = 0;
  for (auto& kv : m->maps) out[k++] = kv.first;
}

int64_t mfm_num_voxels(void* h, int instance_id) {
  auto* m = (MultiMap*)h;
  auto it = m->maps.find(instance_id);
  if (it == m->maps.end()) return -1;
  return (int64_t)it->second.cells.size();
}

// Insert measured endpoints (hits) and carve free space along camera rays.
int mfm_integrate(void* h, int instance_id, const float* points, int64_t n,
                  const double origin[3], int carve) {
  auto* m = (MultiMap*)h;
  auto it = m->maps.find(instance_id);
  if (it == m->maps.end()) return -1;
  VoxelMap& vm = it->second;

  // endpoint voxels: one hit per unique voxel per scan (octomap discrete)
  std::unordered_map<int64_t, char> hits;
  hits.reserve(n * 2);
  for (int64_t p = 0; p < n; ++p) {
    const float* pt = points + 3 * p;
    if (std::isnan(pt[0]) || std::isnan(pt[1]) || std::isnan(pt[2])) continue;
    hits[pack(vm.quantize1(pt[0]), vm.quantize1(pt[1]), vm.quantize1(pt[2]))] = 1;
  }

  if (carve) {
    std::unordered_map<int64_t, char> misses;
    misses.reserve(n * 8);
    for (int64_t p = 0; p < n; ++p) {
      const float* pt = points + 3 * p;
      if (std::isnan(pt[0]) || std::isnan(pt[1]) || std::isnan(pt[2]))
        continue;
      double e[3] = {pt[0], pt[1], pt[2]};
      vm.walk_ray(origin, e, [&](int64_t i, int64_t j, int64_t k) {
        int64_t key = pack(i, j, k);
        if (!hits.count(key)) misses[key] = 1;
        return true;
      });
    }
    for (auto& kv : misses)
      if (!hits.count(kv.first)) vm.update_cell(kv.first, kMiss);
  }
  for (auto& kv : hits) vm.update_cell(kv.first, kHit);
  return 0;
}

// Force-mark points occupied (CAD injection; reference updateNodes).
int mfm_update(void* h, int instance_id, const float* points, int64_t n) {
  auto* m = (MultiMap*)h;
  auto it = m->maps.find(instance_id);
  if (it == m->maps.end()) return -1;
  VoxelMap& vm = it->second;
  for (int64_t p = 0; p < n; ++p) {
    const float* pt = points + 3 * p;
    vm.cells[pack(vm.quantize1(pt[0]), vm.quantize1(pt[1]),
                  vm.quantize1(pt[2]))] = kClampMax;
  }
  return 0;
}

// Occupancy probability at query points; -1 where unknown.
int mfm_query(void* h, int instance_id, const double* points, int64_t n,
              float* out_prob) {
  auto* m = (MultiMap*)h;
  auto it = m->maps.find(instance_id);
  if (it == m->maps.end()) return -1;
  const VoxelMap& vm = it->second;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t p = 0; p < n; ++p) {
    float lo = vm.query(points[3 * p], points[3 * p + 1], points[3 * p + 2]);
    out_prob[p] = std::isnan(lo) ? -1.0f : prob_of(lo);
  }
  return 0;
}

// Dense target/nontarget/empty probability grids at voxel centers
// (reference get_target_grids / publishGrids contract).
int mfm_get_target_grids(void* h, int target_id, const int64_t dims[3],
                         double pitch, const double origin[3],
                         float* grid_target, float* grid_nontarget,
                         float* grid_empty) {
  auto* m = (MultiMap*)h;
  int64_t X = dims[0], Y = dims[1], Z = dims[2];
  int64_t V = X * Y * Z;
  std::memset(grid_target, 0, sizeof(float) * V);
  std::memset(grid_nontarget, 0, sizeof(float) * V);
  std::memset(grid_empty, 0, sizeof(float) * V);

  for (auto& kv : m->maps) {
    const bool is_target = (kv.first == target_id);
    const VoxelMap& vm = kv.second;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t v = 0; v < V; ++v) {
      int64_t i = v / (Y * Z), j = (v / Z) % Y, k = v % Z;
      double x = origin[0] + i * pitch;
      double y = origin[1] + j * pitch;
      double z = origin[2] + k * pitch;
      float lo = vm.query(x, y, z);
      if (std::isnan(lo)) continue;
      float p = prob_of(lo);
      if (p >= 0.5f) {
        if (is_target) {
          if (p > grid_target[v]) grid_target[v] = p;
        } else {
          if (p > grid_nontarget[v]) grid_nontarget[v] = p;
        }
      } else {
        float e = 1.0f - p;
        if (e > grid_empty[v]) grid_empty[v] = e;
      }
    }
  }
  return 0;
}

// Batched grid extraction: one call for all live instances per frame.
// Each target n gets its own pitch/origin (class-specific voxel pitch,
// per-instance origin from the observed cloud). Equivalent to calling
// mfm_get_target_grids n_targets times but with one host call and the
// per-voxel world coordinates hoisted out of the per-map loop — the
// serving pipeline previously made ~2 extraction calls per instance per
// frame (no-entry grids for the pose CNN + target/no-entry pair for ICC;
// reference publishes both from one pass, OctomapServer.cpp:457-620).
int mfm_get_target_grids_batch(void* h, const int* target_ids,
                               int64_t n_targets, const int64_t dims[3],
                               const double* pitches, const double* origins,
                               float* grid_target, float* grid_nontarget,
                               float* grid_empty) {
  auto* m = (MultiMap*)h;
  int64_t X = dims[0], Y = dims[1], Z = dims[2];
  int64_t V = X * Y * Z;
  std::memset(grid_target, 0, sizeof(float) * V * n_targets);
  std::memset(grid_nontarget, 0, sizeof(float) * V * n_targets);
  std::memset(grid_empty, 0, sizeof(float) * V * n_targets);

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t n = 0; n < n_targets; ++n) {
    const int target_id = target_ids[n];
    const double pitch = pitches[n];
    const double* origin = origins + 3 * n;
    float* g_t = grid_target + V * n;
    float* g_n = grid_nontarget + V * n;
    float* g_e = grid_empty + V * n;
    for (auto& kv : m->maps) {
      const bool is_target = (kv.first == target_id);
      const VoxelMap& vm = kv.second;
      for (int64_t v = 0; v < V; ++v) {
        int64_t i = v / (Y * Z), j = (v / Z) % Y, k = v % Z;
        double x = origin[0] + i * pitch;
        double y = origin[1] + j * pitch;
        double z = origin[2] + k * pitch;
        float lo = vm.query(x, y, z);
        if (std::isnan(lo)) continue;
        float p = prob_of(lo);
        if (p >= 0.5f) {
          if (is_target) {
            if (p > g_t[v]) g_t[v] = p;
          } else {
            if (p > g_n[v]) g_n[v] = p;
          }
        } else {
          float e = 1.0f - p;
          if (e > g_e[v]) g_e[v] = e;
        }
      }
    }
  }
  return 0;
}

// Extract occupied / empty voxel-center clouds of one instance.
int64_t mfm_extract_points(void* h, int instance_id, int occupied,
                           double* out, int64_t max_n) {
  auto* m = (MultiMap*)h;
  auto it = m->maps.find(instance_id);
  if (it == m->maps.end()) return -1;
  const VoxelMap& vm = it->second;
  int64_t k = 0;
  for (auto& kv : vm.cells) {
    bool occ = kv.second >= kOccupiedLogOdds;
    if (occ != (occupied != 0)) continue;
    if (k >= max_n) break;
    int64_t i, j, l;
    unpack(kv.first, &i, &j, &l);
    out[3 * k] = (i + 0.5) * vm.pitch;
    out[3 * k + 1] = (j + 0.5) * vm.pitch;
    out[3 * k + 2] = (l + 0.5) * vm.pitch;
    ++k;
  }
  return k;
}

// Raycast-render all instance maps to a predicted instance-label image
// (OctomapServer::render equivalent; labels: -2 = no hit, else instance id;
// -1 is reserved for the background instance).
int mfm_render(void* h, const double K[9], const double T_cam2world[16],
               int height, int width, double max_range, int* out_label,
               float* out_depth) {
  auto* m = (MultiMap*)h;
  const double fx = K[0], fy = K[4], cx = K[2], cy = K[5];
  const double ox = T_cam2world[3], oy = T_cam2world[7], oz = T_cam2world[11];

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
  for (int v = 0; v < height; ++v) {
    for (int u = 0; u < width; ++u) {
      // camera-frame ray through the pixel
      double rx = (u - cx) / fx, ry = (v - cy) / fy, rz = 1.0;
      // to world frame
      double dx = T_cam2world[0] * rx + T_cam2world[1] * ry + T_cam2world[2] * rz;
      double dy = T_cam2world[4] * rx + T_cam2world[5] * ry + T_cam2world[6] * rz;
      double dz = T_cam2world[8] * rx + T_cam2world[9] * ry + T_cam2world[10] * rz;
      double norm = std::sqrt(dx * dx + dy * dy + dz * dz);
      dx /= norm; dy /= norm; dz /= norm;

      int best_id = -2;
      double best_t = max_range;
      const double orig[3] = {ox, oy, oz};
      const double dir[3] = {dx, dy, dz};
      for (auto& kv : m->maps) {
        const VoxelMap& vm = kv.second;
        double t0 = 0.0, t1 = best_t;
        if (!vm.clip_ray(orig, dir, &t0, &t1)) continue;
        double o[3] = {ox + dx * t0, oy + dy * t0, oz + dz * t0};
        double e[3] = {ox + dx * t1, oy + dy * t1, oz + dz * t1};
        double hit_t = -1.0;
        vm.walk_ray(o, e, [&](int64_t i, int64_t j, int64_t k) {
          auto it = vm.cells.find(pack(i, j, k));
          if (it != vm.cells.end() && it->second >= kOccupiedLogOdds) {
            // voxel center distance along the ray
            double cxw = (i + 0.5) * vm.pitch - ox;
            double cyw = (j + 0.5) * vm.pitch - oy;
            double czw = (k + 0.5) * vm.pitch - oz;
            hit_t = cxw * dx + cyw * dy + czw * dz;
            return false;  // stop at first occupied voxel
          }
          return true;
        });
        if (hit_t > 0 && hit_t < best_t) {
          best_t = hit_t;
          best_id = kv.first;
        }
      }
      out_label[v * width + u] = best_id;
      out_depth[v * width + u] =
          (best_id == -2) ? std::numeric_limits<float>::quiet_NaN()
                          : (float)best_t;
    }
  }
  return 0;
}

int mfm_reset(void* h) {
  ((MultiMap*)h)->maps.clear();
  return 0;
}

}  // extern "C"
