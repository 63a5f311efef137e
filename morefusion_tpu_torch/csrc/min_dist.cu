// Per-voxel nearest valid point: squared distance, winner index, winner payload.
//
// Replaces the TPU kernel morefusion_tpu/ops/min_dist_pallas.py::_kernel
// (reached through min_dist_voxels_pallas_payload). It computes what the
// exact XLA path computes (functions/tdf.py::_scan_core) plus the payload of
// the winner:
//   d2[b, v]  = min over valid, non-NaN points p of |c_v - p|^2 (inf if none)
//   arg[b, v] = index of that point, the lowest index on a tie (-1 if none)
//   pay[b, v] = payload[b, arg] (0 if none)
// with c_v = (i, j, k) the integer centre of voxel v = (i * Y + j) * Z + k and
// the points given in voxel units. d2 is (dx*dx + dy*dy) + dz*dz with every
// operation rounded (no FMA contraction), the plain PyTorch version's order,
// so the outputs equal ops/min_dist.py::min_dist_voxels_plain bit for bit. A
// valid point whose d2 overflows to inf never wins.
//
// What bounds it on an H100: instruction issue on the CUDA cores (132 SMs x
// 128 lanes x 1.98 GHz = 3.35e13 slots/s). Its inputs and outputs take ~1 us
// at 3.35 TB/s. The first version (one thread per voxel, the full sum of
// squares per voxel-point pair and a compare-and-branch on the running
// (d2, index, payload)) spent ~17 issue slots a pair. The separable sum
// below was predicted at 2-4 slots a pair and measured 4.3 at the train
// shape (16 x 3000 points, 32^3: 0.202 ms) and 6.0 at the ICC shape (8 x
// 2048: 0.087 ms), where the split merge and the argmin re-scan weigh more
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md section 6). At the
// ICC shape that is about the wrapper's host time a call, so calls made
// back to back can wait on the host. More resident warps (128-thread
// blocks of at most 128 registers) measured slower: 0.100 / 0.233 ms.
// Tensor cores do not help: the inner operation is a min over sums (a
// min-plus product), which they do not compute.
//
// Design:
// - Separable arithmetic on a register tile. Each thread owns a tile of
//   kTI x kTJ x kTK voxels that share their i and j rows. For each point it
//   forms dx^2 once per i, dy^2 once per j, dz^2 once per k and
//   sxy = dx^2 + dy^2 once per (i, j); each voxel then costs one add,
//   sxy + dz^2, and half a min. Every partial value is rounded exactly as
//   the plain version rounds it, so d2 is the same number.
// - The min on d2's bits. d2 >= 0 and is never NaN (masked and NaN points
//   are staged at +inf, and (c - inf)^2 = inf), so its bits order as
//   uint32, and Hopper's three-way integer min (VIMNMX3) folds two points
//   into a voxel's running min in one instruction (two fminf measured
//   0.101 / 0.235 ms).
// - The argmin off the per-pair path. After each sub-tile of kSub points a
//   thread records, per voxel, the sub-tile in which its min last dropped
//   strictly; after the loop it re-scans that one sub-tile in index order
//   for the first point whose d2 (same arithmetic) equals the min. That is
//   the lowest index on a tie. A compare and a predicated select of
//   (d2 bits, index) on every pair measured 0.342 ms at the train shape
//   against 0.202 for this record.
// - The point axis is split across blocks (grid (voxel tiles, splits,
//   lanes)), as many splits as fill one wave of resident blocks, so that
//   the small ICC grids fill the card. Each block stages its whole split,
//   at most kMaxSplitPoints, in shared memory once, by plain loads: a
//   block stages at most 2048 points against ~2 instructions for each of
//   its up to 2048 x 256 x 32 voxel-point pairs, so cp.async or TMA has
//   little to hide. Each split writes a 64-bit key (d2 bits << 32 | index)
//   per voxel, all-ones where its min is inf; the smallest key is the
//   smallest d2, then the lowest index. A second kernel takes the smallest
//   key over the splits (an order-independent, deterministic merge) and
//   writes d2, arg and pay.
// - The voxel tile's ragged edge on a grid it does not divide is computed
//   and not written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTI = 2, kTJ = 4, kTK = 4;  // voxels a thread: 32
constexpr int kThreads = 256;             // threads a block
constexpr int kSub = 8;                   // points a sub-tile of the argmin record
static_assert(kSub % 2 == 0, "the inner loop takes points in pairs");
constexpr int kMaxSplitPoints = 2048;     // staged a block: 32 KB of float4
constexpr int kMinSplitPoints = 64;
constexpr int kFinalizeThreads = 256;
constexpr unsigned long long kNoWinner = ~0ull;
constexpr unsigned int kInfBits = 0x7f800000u;  // +inf as uint32 bits

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// (c - p)^2, rounded after each operation
__device__ inline float sq_diff(float c, float p) {
  const float d = __fsub_rn(c, p);
  return __fmul_rn(d, d);
}

__global__ void __launch_bounds__(kThreads)
min_dist_split_kernel(const float* __restrict__ ip,       // (B, P, 3)
                      const uint8_t* __restrict__ valid,  // (B, P) bool
                      int B, int P, int X, int Y, int Z, int split_len,
                      unsigned long long* __restrict__ keys) {  // (S, B, V)
  extern __shared__ float4 s_pts[];  // round_up(split_len, kSub)

  const int b = blockIdx.z;
  const int p0 = blockIdx.y * split_len;
  const int n = min(split_len, P - p0);
  const int n_pad = ceil_div(n, kSub) * kSub;
  const float* lane_pts = ip + static_cast<size_t>(b) * P * 3;
  const uint8_t* lane_valid = valid + static_cast<size_t>(b) * P;
  for (int q = threadIdx.x; q < n_pad; q += kThreads) {
    float4 s = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    if (q < n) {
      const int p = p0 + q;
      const float* pt = lane_pts + 3 * static_cast<size_t>(p);
      const float x = pt[0];
      const float y = pt[1];
      const float z = pt[2];
      if (lane_valid[p] && !isnan(x) && !isnan(y) && !isnan(z)) {
        s = make_float4(x, y, z, 0.f);
      }
    }
    s_pts[q] = s;
  }
  __syncthreads();

  const int NI = ceil_div(X, kTI), NJ = ceil_div(Y, kTJ), NK = ceil_div(Z, kTK);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= NI * NJ * NK) return;  // no barrier follows
  const int i0 = (t / (NJ * NK)) * kTI;
  const int j0 = ((t / NK) % NJ) * kTJ;
  const int k0 = (t % NK) * kTK;

  float cx[kTI], cy[kTJ], cz[kTK];  // the tile's voxel centres
#pragma unroll
  for (int a = 0; a < kTI; ++a) cx[a] = static_cast<float>(i0 + a);
#pragma unroll
  for (int c = 0; c < kTJ; ++c) cy[c] = static_cast<float>(j0 + c);
#pragma unroll
  for (int e = 0; e < kTK; ++e) cz[e] = static_cast<float>(k0 + e);

  // d2 >= 0 and never NaN, so its bits order as uint32: the running min is
  // kept as bits and taken with Hopper's three-way integer min
  unsigned int best[kTI][kTJ][kTK];
  unsigned int prev[kTI][kTJ][kTK];
  int mark[kTI][kTJ][kTK];  // the sub-tile in which best last dropped
#pragma unroll
  for (int a = 0; a < kTI; ++a)
#pragma unroll
    for (int c = 0; c < kTJ; ++c)
#pragma unroll
      for (int e = 0; e < kTK; ++e) {
        best[a][c][e] = kInfBits;
        prev[a][c][e] = kInfBits;
        mark[a][c][e] = 0;
      }

  for (int base = 0; base < n_pad; base += kSub) {
#pragma unroll
    for (int u = 0; u < kSub; u += 2) {
      const float4 s0 = s_pts[base + u];
      const float4 s1 = s_pts[base + u + 1];
      float dx0[kTI], dy0[kTJ], dz0[kTK], dx1[kTI], dy1[kTJ], dz1[kTK];
#pragma unroll
      for (int a = 0; a < kTI; ++a) {
        dx0[a] = sq_diff(cx[a], s0.x);
        dx1[a] = sq_diff(cx[a], s1.x);
      }
#pragma unroll
      for (int c = 0; c < kTJ; ++c) {
        dy0[c] = sq_diff(cy[c], s0.y);
        dy1[c] = sq_diff(cy[c], s1.y);
      }
#pragma unroll
      for (int e = 0; e < kTK; ++e) {
        dz0[e] = sq_diff(cz[e], s0.z);
        dz1[e] = sq_diff(cz[e], s1.z);
      }
#pragma unroll
      for (int a = 0; a < kTI; ++a)
#pragma unroll
        for (int c = 0; c < kTJ; ++c) {
          const float sxy0 = __fadd_rn(dx0[a], dy0[c]);
          const float sxy1 = __fadd_rn(dx1[a], dy1[c]);
#pragma unroll
          for (int e = 0; e < kTK; ++e) {
            const float d0 = __fadd_rn(sxy0, dz0[e]);
            const float d1 = __fadd_rn(sxy1, dz1[e]);
            best[a][c][e] = __vimin3_u32(best[a][c][e], __float_as_uint(d0),
                                           __float_as_uint(d1));
          }
        }
    }
#pragma unroll
    for (int a = 0; a < kTI; ++a)
#pragma unroll
      for (int c = 0; c < kTJ; ++c)
#pragma unroll
        for (int e = 0; e < kTK; ++e)
          if (best[a][c][e] < prev[a][c][e]) {
            prev[a][c][e] = best[a][c][e];
            mark[a][c][e] = base;
          }
  }

  const int V = X * Y * Z;
  unsigned long long* lane_keys =
      keys + (static_cast<size_t>(blockIdx.y) * B + b) * V;
#pragma unroll
  for (int a = 0; a < kTI; ++a)
#pragma unroll
    for (int c = 0; c < kTJ; ++c)
#pragma unroll
      for (int e = 0; e < kTK; ++e) {
        const int i = i0 + a, j = j0 + c, k = k0 + e;
        if (i >= X || j >= Y || k >= Z) continue;
        const float m = __uint_as_float(best[a][c][e]);
        int q = mark[a][c][e];
        if (m < INFINITY) {
          for (int u = 0; u < kSub; ++u) {
            const float4 s = s_pts[q + u];
            const float d2 = __fadd_rn(
                __fadd_rn(sq_diff(cx[a], s.x), sq_diff(cy[c], s.y)),
                sq_diff(cz[e], s.z));
            if (d2 == m) {
              q += u;
              break;
            }
          }
        }
        lane_keys[(i * Y + j) * Z + k] =
            m < INFINITY ? (static_cast<unsigned long long>(__float_as_uint(m))
                                << 32) |
                               static_cast<unsigned int>(p0 + q)
                         : kNoWinner;
      }
}

__global__ void __launch_bounds__(kFinalizeThreads)
min_dist_finalize_kernel(const unsigned long long* __restrict__ keys,
                         const int32_t* __restrict__ payload,  // (B, P)
                         int S, int B, int P, int V,
                         float* __restrict__ d2_out,
                         int32_t* __restrict__ arg_out,
                         int32_t* __restrict__ pay_out) {
  const size_t BV = static_cast<size_t>(B) * V;
  const size_t o = static_cast<size_t>(blockIdx.x) * kFinalizeThreads +
                   threadIdx.x;
  if (o >= BV) return;
  unsigned long long key = kNoWinner;
  for (int s = 0; s < S; ++s) key = min(key, keys[s * BV + o]);
  if (key == kNoWinner) {
    d2_out[o] = INFINITY;
    arg_out[o] = -1;
    pay_out[o] = 0;
  } else {
    const int32_t arg = static_cast<int32_t>(key & 0xffffffffu);
    d2_out[o] = __uint_as_float(static_cast<unsigned int>(key >> 32));
    arg_out[o] = arg;
    pay_out[o] = payload[(o / V) * P + arg];
  }
}

// Blocks of min_dist_split_kernel resident on the whole card at once.
int resident_blocks(int device) {
  static int cache[64] = {0};
  if (device >= 0 && device < 64 && cache[device] > 0) return cache[device];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, min_dist_split_kernel, kThreads,
      kMaxSplitPoints * sizeof(float4));
  const int n = std::max(sms * per_sm, 1);
  if (device >= 0 && device < 64) cache[device] = n;
  return n;
}

// Splits of the point axis: as many as fill one wave of resident blocks,
// within [P / kMaxSplitPoints, P / kMinSplitPoints], none of them empty.
int splits_for(int B, int P, int X, int Y, int Z, int device) {
  if (P <= 0) return 1;
  const long long tiles = static_cast<long long>(ceil_div(X, kTI)) *
                          ceil_div(Y, kTJ) * ceil_div(Z, kTK);
  const long long blocks = (tiles + kThreads - 1) / kThreads * B;
  long long splits = resident_blocks(device) / blocks;
  splits = std::min<long long>(splits, ceil_div(P, kMinSplitPoints));
  splits = std::max<long long>(splits, ceil_div(P, kMaxSplitPoints));
  splits = std::max<long long>(splits, 1);
  return ceil_div(P, ceil_div(P, static_cast<int>(splits)));
}

}  // namespace

extern "C" {

// The number of point-axis splits to pass to mfk_min_dist for these
// shapes; the caller allocates its (splits, B, X*Y*Z) uint64 scratch.
// Returns 0 if the device cannot be queried.
int mfk_min_dist_splits(int B, int P, int X, int Y, int Z, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  return splits_for(B, P, X, Y, Z, device);
}

// Launches on `stream` of device `device` and returns cudaGetLastError()
// after the launches (0 = cudaSuccess). Does not synchronise. The device is
// set here because this library's CUDA runtime keeps its own current
// device, apart from PyTorch's. `keys` is a (splits, B, X*Y*Z) uint64
// scratch; each split takes at most kMaxSplitPoints points.
int mfk_min_dist(const void* ip, const void* valid, const void* payload,
                 int B, int P, int X, int Y, int Z, int splits, void* keys,
                 void* d2, void* arg, void* pay, int device, void* stream) {
  const int V = X * Y * Z;
  if (B <= 0 || V <= 0) return static_cast<int>(cudaSuccess);
  const int len = ceil_div(P, std::max(splits, 1));
  if (splits < 1 || len > kMaxSplitPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ceil_div(X, kTI) * ceil_div(Y, kTJ) * ceil_div(Z, kTK);
  const dim3 grid(ceil_div(tiles, kThreads), splits, B);
  const size_t smem = static_cast<size_t>(ceil_div(len, kSub)) * kSub *
                      sizeof(float4);
  auto* k = static_cast<unsigned long long*>(keys);
  min_dist_split_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(ip), static_cast<const uint8_t*>(valid),
      B, P, X, Y, Z, len, k);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const size_t BV = static_cast<size_t>(B) * V;
  const unsigned int blocks = static_cast<unsigned int>(
      (BV + kFinalizeThreads - 1) / kFinalizeThreads);
  min_dist_finalize_kernel<<<blocks, kFinalizeThreads, 0, s>>>(
      k, static_cast<const int32_t*>(payload), splits, B, P, V,
      static_cast<float*>(d2), static_cast<int32_t*>(arg),
      static_cast<int32_t*>(pay));
  return static_cast<int>(cudaGetLastError());
}

const char* mfk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
