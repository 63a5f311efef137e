// Each instance's box and count of finite points, from the label image and
// the organized cloud of one frame, in one pass over the frame: the pose
// node's selection of the instances it poses (runtime/pose_estimation.py).
//
// Replaces no TPU kernel: the JAX package makes the selection on the host
// (a full-frame mask, a finite test and `masks_to_bboxes` an instance).
//
// The rule, for label (H, W) int32, cloud (H, W, 3) float32 and ids (K,)
// int32: for each k, the box (y1, x1, y2, x2) of the pixels where
// label == ids[k] (first row and column, last row and column + 1; all zero
// where there is none), as `geometry/bbox.py::masks_to_bboxes` gives it,
// and n_finite, how many of those pixels have a cloud point with no NaN
// component. Integers only, so the result is exact and the plain version
// (ops/instance_boxes.py) gives the same bits.
//
// What bounds it on an H100: bytes. A 480 x 640 frame is 4.9 MB of label
// and cloud, read once (~1.5 us at 3.35 TB/s); the launch and the host's
// read-back of the (K, 5) result take longer than the pass.
//
// Design:
// - A warp takes 32 consecutive pixels at a time (coalesced reads of the
//   label and of the cloud's 384 bytes), grid-stride. For each id it votes
//   (__ballot_sync) which lanes hold it; where any does, the rows come from
//   the vote's first and last lane, the columns from __reduce_min_sync /
//   __reduce_max_sync, the finite count from a second vote's popcount, and
//   lane 0 applies them to the block's min / max / count in shared memory.
// - Each block then applies its nonempty entries to a global accumulator
//   with atomics, once a block. The last block to finish (a ticket taken
//   after a __threadfence) writes the (K, 5) result from the accumulator.
// - The accumulator and the ticket are set on the stream by two memsets:
//   the minima to 0x7f7f7f7f (above any coordinate), the ends (the maxima
//   + 1), the counts and the ticket to 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 8;
constexpr int kMaxBlocks = 1024;
constexpr int kMaxIds = 1024;  // ids a launch (6 ints each in shared memory)
constexpr unsigned kFull = 0xffffffffu;

// acc: [y1 K | x1 K | y2 K | x2 K | n K | ticket 1]
__global__ void __launch_bounds__(kThreads)
instance_boxes_kernel(const int32_t* __restrict__ label,
                      const float* __restrict__ cloud,
                      const int32_t* __restrict__ ids, int K, int H, int W,
                      int* __restrict__ acc, int* __restrict__ out) {
  extern __shared__ int shared[];
  int* s_id = shared;
  int* s_y1 = s_id + K;
  int* s_x1 = s_y1 + K;
  int* s_y2 = s_x1 + K;
  int* s_x2 = s_y2 + K;
  int* s_n = s_x2 + K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_id[k] = ids[k];
    s_y1[k] = INT_MAX;
    s_x1[k] = INT_MAX;
    s_y2[k] = 0;
    s_x2[k] = 0;
    s_n[k] = 0;
  }
  __syncthreads();

  const int n = H * W;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  for (int base = warp * 32; base < n; base += warps * 32) {
    // every lane of the warp runs each step, so the votes see all 32
    const int p = base + lane;
    const bool in = p < n;
    int lab = 0;
    bool finite = false;
    if (in) {
      lab = label[p];
      const float a = cloud[3 * p], b = cloud[3 * p + 1],
                  c = cloud[3 * p + 2];
      finite = !(isnan(a) || isnan(b) || isnan(c));
    }
    const int x = p % W;
    for (int k = 0; k < K; ++k) {
      const bool hit = in && lab == s_id[k];
      const unsigned m = __ballot_sync(kFull, hit);
      if (m == 0) continue;
      const int x1 = __reduce_min_sync(kFull, hit ? x : INT_MAX);
      const int x2 = __reduce_max_sync(kFull, hit ? x : -1);
      const int nf = __popc(__ballot_sync(kFull, hit && finite));
      if (lane == 0) {
        atomicMin(&s_y1[k], (base + __ffs(m) - 1) / W);
        atomicMax(&s_y2[k], (base + 31 - __clz(m)) / W + 1);
        atomicMin(&s_x1[k], x1);
        atomicMax(&s_x2[k], x2 + 1);
        atomicAdd(&s_n[k], nf);
      }
    }
  }
  __syncthreads();

  int* y1 = acc;
  int* x1 = y1 + K;
  int* y2 = x1 + K;
  int* x2 = y2 + K;
  int* cnt = x2 + K;
  unsigned* ticket = reinterpret_cast<unsigned*>(cnt + K);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (s_y2[k] == 0) continue;  // no pixel of ids[k] in this block
    atomicMin(&y1[k], s_y1[k]);
    atomicMin(&x1[k], s_x1[k]);
    atomicMax(&y2[k], s_y2[k]);
    atomicMax(&x2[k], s_x2[k]);
    if (s_n[k]) atomicAdd(&cnt[k], s_n[k]);
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int end = __ldcg(&y2[k]);
    int* o = out + 5 * k;
    if (end == 0) {  // no pixel of ids[k] in the frame: an all-zero box
      o[0] = o[1] = o[2] = o[3] = o[4] = 0;
      continue;
    }
    o[0] = __ldcg(&y1[k]);
    o[1] = __ldcg(&x1[k]);
    o[2] = end;
    o[3] = __ldcg(&x2[k]);
    o[4] = __ldcg(&cnt[k]);
  }
}

}  // namespace

extern "C" {

// `label` (H, W) int32, `cloud` (H, W, 3) float32, `ids` (K,) int32, all on
// `device` and contiguous, 0 < K <= 1024, 0 < H * W < 2^31; `acc` scratch
// of 5 K + 1 int32 (set here); `out` (K, 5) int32 (y1, x1, y2, x2,
// n_finite). Enqueues two memsets and one launch on `stream` and returns
// the CUDA error after them (0 = cudaSuccess); does not synchronise.
int mfk_instance_boxes(const void* label, const void* cloud, const void* ids,
                       int K, int H, int W, void* acc, void* out, int device,
                       void* stream) {
  const long long n = static_cast<long long>(H) * W;
  if (K <= 0 || K > kMaxIds || H <= 0 || W <= 0 || n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* a = static_cast<int*>(acc);
  cudaError_t err = cudaMemsetAsync(a, 0x7f, sizeof(int) * 2 * K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(a + 2 * K, 0, sizeof(int) * (3 * K + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = kThreads * kPixelsPerThread;
  const long long want = (n + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t shared = sizeof(int) * 6 * static_cast<size_t>(K);
  instance_boxes_kernel<<<blocks, kThreads, shared, s>>>(
      static_cast<const int32_t*>(label), static_cast<const float*>(cloud),
      static_cast<const int32_t*>(ids), K, H, W, a, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
