// Nearest reference point of each query point: its index, the lowest on a tie.
//
// Replaces the TPU kernel morefusion_tpu/ops/knn_pallas.py::_kernel (reached
// through nn_pallas, which nothing in the JAX package calls: its ADD-S runs
// the XLA expansion of functions/knn.py::nn, and this kernel takes that
// function's place in the port's train step). It computes, for every lane b
// and query q,
//   out[b, q] = argmin over r of |query[b, q] - ref[b, r]|^2
// with the lowest index winning a tie, a NaN distance counting as +inf, and 0
// where no distance is finite. No gradient: the ADD-S loss only gathers the
// winners.
//
// What bounds it on an H100: fp32 arithmetic, not bytes. At the training
// shape (B = 16 lanes, Q = 1000 poses x 500 CAD points, R = 500) it visits
// 16 * 500000 * 500 = 4.0e9 query-reference pairs at 8 flops each, 3.2e10
// flops: about 0.48 ms at the 67 TFLOP/s fp32 (non-tensor-core) peak, while
// its 128 MB of queries and indices take about 0.04 ms at 3.35 TB/s.
//
// Design: one thread per query and one block row per lane (grid
// (ceil(Q / 256), B)). The lane's reference points stream through shared
// memory in tiles of kTile, each point one float4 so that a warp reads it in
// one broadcast load; the running (d2, index) stays in registers. d2 is
// dx*dx + dy*dy + dz*dz with explicitly rounded operations (no FMA
// contraction), so it equals the plain PyTorch version bit for bit, and the
// strict `<` over references in index order keeps the lowest index on a tie.
// The TPU kernel's composite key (which biases d2 low), its bf16 hi/lo MXU
// split and its R <= 16384 cap are TPU choices and are not carried over.
// Tensor cores, several queries per thread and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // queries per block
constexpr int kTile = 1024;    // reference points per shared-memory tile

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ ref,    // (B, R, 3)
           const float* __restrict__ query,  // (B, Q, 3)
           int R, int Q,
           int32_t* __restrict__ out) {      // (B, Q)
  __shared__ float4 s_ref[kTile];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < Q) {
    const float* p = query + (static_cast<size_t>(b) * Q + q) * 3;
    qx = p[0];
    qy = p[1];
    qz = p[2];
  }
  const float* lane_ref = ref + static_cast<size_t>(b) * R * 3;

  float best = INFINITY;
  int32_t best_arg = 0;

  for (int base = 0; base < R; base += kTile) {
    const int n = min(kTile, R - base);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* r = lane_ref + static_cast<size_t>(base + i) * 3;
      s_ref[i] = make_float4(r[0], r[1], r[2], 0.f);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 r = s_ref[i];
      const float dx = __fsub_rn(qx, r.x);
      const float dy = __fsub_rn(qy, r.y);
      const float dz = __fsub_rn(qz, r.z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_arg = base + i;
      }
    }
    __syncthreads();
  }

  if (q < Q) out[static_cast<size_t>(b) * Q + q] = best_arg;
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device` and returns cudaGetLastError()
// after the launch (0 = cudaSuccess). Does not synchronise.
int mfk_knn(const void* ref, const void* query, int B, int R, int Q,
            void* out, int device, void* stream) {
  if (B <= 0 || Q <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  knn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const float*>(query), R, Q,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
