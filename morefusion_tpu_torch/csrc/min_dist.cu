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
// the points given in voxel units.
//
// What bounds it on an H100: fp32 arithmetic, not bytes. At the ICC shapes
// (B = 8 lanes, P = 2048 points, V = 32^3 voxels) it visits
// 8 * 32768 * 2048 = 5.4e8 voxel-point pairs at about 8 flops each, 4.3 GFLOP:
// about 64 us at the 67 TFLOP/s fp32 (non-tensor-core) peak, while its
// 3.4 MB of inputs and outputs take about 1 us at 3.35 TB/s.
//
// Design: one thread per voxel and one block row per lane (grid
// (ceil(V / 256), B)). The lane's points stream through shared memory in
// tiles of kTile (x, y, z) plus payload; masked and NaN points are staged at
// +inf so their distance is +inf and, with the strict `<`, they never win.
// The running (d2, index, payload) stays in registers. d2 is
// dx*dx + dy*dy + dz*dz with explicitly rounded operations (no FMA
// contraction), so it equals the plain PyTorch version bit for bit; the
// TPU kernel's composite key, bf16 cross-term split and 16384-point cap are
// TPU choices and are not carried over. Making it fast (a tensor-core cross
// term, several voxels per thread) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // voxels per block
constexpr int kTile = 256;     // points per shared-memory tile

__global__ void __launch_bounds__(kThreads)
min_dist_kernel(const float* __restrict__ ip,         // (B, P, 3)
                const uint8_t* __restrict__ valid,    // (B, P) bool
                const int32_t* __restrict__ payload,  // (B, P)
                int P, int X, int Y, int Z,
                float* __restrict__ d2_out,           // (B, V)
                int32_t* __restrict__ arg_out,        // (B, V)
                int32_t* __restrict__ pay_out) {      // (B, V)
  __shared__ float4 s_pts[kTile];
  __shared__ int32_t s_pay[kTile];

  const int V = X * Y * Z;
  const int b = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int vc = v < V ? v : V - 1;  // out-of-range threads still stage points
  const float cx = static_cast<float>(vc / (Y * Z));
  const float cy = static_cast<float>((vc / Z) % Y);
  const float cz = static_cast<float>(vc % Z);

  const float* lane_pts = ip + static_cast<size_t>(b) * P * 3;
  const uint8_t* lane_valid = valid + static_cast<size_t>(b) * P;
  const int32_t* lane_pay = payload + static_cast<size_t>(b) * P;

  float best = INFINITY;
  int32_t best_arg = -1;
  int32_t best_pay = 0;

  for (int base = 0; base < P; base += kTile) {
    const int p = base + threadIdx.x;
    if (threadIdx.x < kTile) {
      float4 s = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      int32_t pay = 0;
      if (p < P) {
        const float x = lane_pts[3 * p + 0];
        const float y = lane_pts[3 * p + 1];
        const float z = lane_pts[3 * p + 2];
        if (lane_valid[p] && !isnan(x) && !isnan(y) && !isnan(z)) {
          s = make_float4(x, y, z, 0.f);
        }
        pay = lane_pay[p];
      }
      s_pts[threadIdx.x] = s;
      s_pay[threadIdx.x] = pay;
    }
    __syncthreads();
    const int n = min(kTile, P - base);
    for (int q = 0; q < n; ++q) {
      const float4 s = s_pts[q];
      const float dx = __fsub_rn(cx, s.x);
      const float dy = __fsub_rn(cy, s.y);
      const float dz = __fsub_rn(cz, s.z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_arg = base + q;
        best_pay = s_pay[q];
      }
    }
    __syncthreads();
  }

  if (v < V) {
    const size_t o = static_cast<size_t>(b) * V + v;
    d2_out[o] = best;
    arg_out[o] = best_arg;
    pay_out[o] = best_pay;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device` and returns cudaGetLastError()
// after the launch (0 = cudaSuccess). Does not synchronise. The device is
// set here because this library's CUDA runtime keeps its own current
// device, apart from PyTorch's.
int mfk_min_dist(const void* ip, const void* valid, const void* payload,
                 int B, int P, int X, int Y, int Z,
                 void* d2, void* arg, void* pay, int device, void* stream) {
  const int V = X * Y * Z;
  if (B <= 0 || V <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((V + kThreads - 1) / kThreads, B);
  min_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ip), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(payload), P, X, Y, Z,
      static_cast<float*>(d2), static_cast<int32_t*>(arg),
      static_cast<int32_t*>(pay));
  return static_cast<int>(cudaGetLastError());
}

const char* mfk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
