// Nearest reference point of each query point: its index, the lowest on a tie.
//
// Replaces the TPU kernel morefusion_tpu/ops/knn_pallas.py::_kernel (reached
// through nn_pallas, which nothing in the JAX package calls: its ADD-S runs
// the XLA expansion of functions/knn.py::nn and its ICP pairwise_sq_dist,
// and this kernel takes their places in the port's train step and in every
// ICP iteration). It computes, for every lane b and query q,
//   out[b, q] = argmin over r of |query[b, q] - ref[b, r]|^2
// with d2 = (dx*dx + dy*dy) + dz*dz, every operation rounded (no FMA
// contraction), the lowest index winning a tie, a NaN distance counting as
// +inf, and 0 where no distance is finite: bit for bit the indices of
// ops/knn.py::nn_indices_plain. Where the caller passes d2_out, it also
// writes the winner's d2 there (+inf where no distance is finite), bit for
// bit the plain version's; ICP gates its correspondences and forms its RMSE
// from it. With a null d2_out nothing more is written, so ADD-S keeps its
// path. No gradient: the callers only gather the winners.
//
// What bounds it on an H100: instruction issue on the CUDA cores (132 SMs x
// 128 lanes x 1.98 GHz = 3.35e13 slots/s). At the training shape (B = 16
// lanes, Q = 1000 poses x 500 CAD points, R = 500) it visits 4.0e9
// query-reference pairs; its 128 MB of queries and indices take ~0.04 ms at
// 3.35 TB/s. Each pair needs 3 subtractions, 3 multiplications and 2
// additions, all rounded apart: nothing cheaper is bit-exact. The first
// version (one thread per query, a compare and branch on the running
// (d2, index) every pair, one shared-memory load a pair) spent ~15 issue
// slots a pair. This one was predicted at ~9 (a ceiling of ~1.1 ms)
// and measured 10.8 slots a pair, 1.29 ms (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py, PERF.md section 6). 4 queries a thread measured 1.31 ms.
//
// Design:
// - kQ queries a thread: each reference's float4 is read from shared memory
//   once for all of them (a broadcast load every kQ pairs).
// - The lane's reference set staged in shared memory, kTile at a time (the
//   whole set at R = 500).
// - The min on d2's bits: every d2 >= 0 orders as its uint32 bits and every
//   NaN (either sign) lies above +inf, so Hopper's three-way integer min
//   (VIMNMX3) folds two references into a query's running min in one
//   instruction and drops a NaN distance (two fminf measured 1.33 ms).
// - The argmin off the per-pair path. After each sub-tile of kSub
//   references a thread records, per query, the sub-tile in which its min
//   last dropped strictly; after the loop it re-scans that sub-tile from
//   device memory in index order for the first reference whose d2 (same
//   arithmetic) equals the min. That is the lowest index on a tie. A
//   compare and a predicated select of (d2 bits, index) on every pair
//   measured 1.54 ms.
// - Tensor cores are not used: an exact result would need a filter (the
//   expansion |r|^2 - 2 q.r on mma with K = 3 padded to 8, 3xTF32 for fp32
//   accuracy, ~48 flops a pair, ~0.39 ms a sweep at 495 TFLOP/s) and a
//   second, verifying sweep with a rigorous margin: no faster than this
//   design and far more code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kQ = 8;          // queries a thread
constexpr int kTile = 2048;    // reference points a shared-memory tile (32 KB)
constexpr int kSub = 8;        // references a sub-tile of the argmin record
static_assert(kSub % 2 == 0, "the inner loop takes references in pairs");
constexpr unsigned int kInfBits = 0x7f800000u;  // +inf as uint32 bits

__device__ inline float sq_dist(float qx, float qy, float qz, float rx,
                                float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ ref,    // (B, R, 3)
           const float* __restrict__ query,  // (B, Q, 3)
           int R, int Q,
           int32_t* __restrict__ out,        // (B, Q)
           float* __restrict__ d2_out) {     // (B, Q) or null
  __shared__ float4 s_ref[kTile];

  const int b = blockIdx.y;
  const long long q0 =
      static_cast<long long>(blockIdx.x) * kThreads * kQ + threadIdx.x;
  const float* lane_query = query + static_cast<size_t>(b) * Q * 3;
  const float* lane_ref = ref + static_cast<size_t>(b) * R * 3;

  // d2 as uint32 bits: every d2 >= 0 orders as its bits, every NaN (either
  // sign) lies above +inf, so a three-way integer min drops it
  float qx[kQ], qy[kQ], qz[kQ];
  unsigned int best[kQ], prev[kQ];
  int mark[kQ];  // the sub-tile in which best last dropped
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const long long q = q0 + static_cast<long long>(u) * kThreads;
    qx[u] = qy[u] = qz[u] = 0.f;
    if (q < Q) {
      qx[u] = lane_query[3 * q + 0];
      qy[u] = lane_query[3 * q + 1];
      qz[u] = lane_query[3 * q + 2];
    }
    best[u] = prev[u] = kInfBits;
    mark[u] = 0;
  }

  for (int base = 0; base < R; base += kTile) {
    const int n = min(kTile, R - base);
    const int n_pad = (n + kSub - 1) / kSub * kSub;
    for (int i = threadIdx.x; i < n_pad; i += kThreads) {
      float4 s = make_float4(NAN, NAN, NAN, 0.f);  // padding: d2 is NaN
      if (i < n) {
        const float* r = lane_ref + static_cast<size_t>(base + i) * 3;
        s = make_float4(r[0], r[1], r[2], 0.f);
      }
      s_ref[i] = s;
    }
    __syncthreads();
    for (int sub = 0; sub < n_pad; sub += kSub) {
#pragma unroll
      for (int e = 0; e < kSub; e += 2) {
        const float4 r0 = s_ref[sub + e];
        const float4 r1 = s_ref[sub + e + 1];
#pragma unroll
        for (int u = 0; u < kQ; ++u) {
          const float d0 = sq_dist(qx[u], qy[u], qz[u], r0.x, r0.y, r0.z);
          const float d1 = sq_dist(qx[u], qy[u], qz[u], r1.x, r1.y, r1.z);
          best[u] = __vimin3_u32(best[u], __float_as_uint(d0),
                                 __float_as_uint(d1));
        }
      }
#pragma unroll
      for (int u = 0; u < kQ; ++u)
        if (best[u] < prev[u]) {
          prev[u] = best[u];
          mark[u] = base + sub;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const long long q = q0 + static_cast<long long>(u) * kThreads;
    if (q >= Q) continue;
    int arg = 0;
    if (best[u] < kInfBits) {
      const float m = __uint_as_float(best[u]);
      const int end = min(mark[u] + kSub, R);
      for (int i = mark[u]; i < end; ++i) {
        const float* r = lane_ref + static_cast<size_t>(i) * 3;
        if (sq_dist(qx[u], qy[u], qz[u], r[0], r[1], r[2]) == m) {
          arg = i;
          break;
        }
      }
    }
    out[static_cast<size_t>(b) * Q + q] = arg;
    // best never rises above +inf's bits, so a query with no finite
    // distance reads +inf
    if (d2_out != nullptr)
      d2_out[static_cast<size_t>(b) * Q + q] = __uint_as_float(best[u]);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device` and returns cudaGetLastError()
// after the launch (0 = cudaSuccess). Does not synchronise. `d2_out` may be
// null.
int mfk_knn(const void* ref, const void* query, int B, int R, int Q,
            void* out, void* d2_out, int device, void* stream) {
  if (B <= 0 || Q <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long per_block = static_cast<long long>(kThreads) * kQ;
  const dim3 grid(static_cast<unsigned int>((Q + per_block - 1) / per_block),
                  B);
  knn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const float*>(query), R, Q,
      static_cast<int32_t*>(out), static_cast<float*>(d2_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
