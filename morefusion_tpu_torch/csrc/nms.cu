// Exact greedy non-maximum suppression on the device, for independent
// groups of boxes in one pair of launches: Mask R-CNN's proposals (NMS at
// 0.7 within each pyramid level) and its detections (NMS at 0.5 within each
// class), with no read-back to the host.
//
// Replaces no TPU kernel: the JAX package has no detector. It was added
// because the port has no NMS and imports no torchvision.
//
// The rule, within each group, over boxes pre-sorted by score (the caller
// sorts, ties to the lower index): walk the boxes in order; a box that is
// valid and not yet suppressed is kept and suppresses every later box of
// its group (and, where labels are given, of its label) whose IoU with it
// exceeds the threshold. IoU is inter / ((area_i + area_j) - inter), with
// area = (x2 - x1) * (y2 - y1), inter = max(min(x2) - max(x1), 0) *
// max(min(y2) - max(y1), 0), every operation rounded apart: bit for bit the
// plain versions' arithmetic (ops/nms.py), so that both keep the same boxes.
// An invalid box is neither kept nor suppresses; a NaN IoU suppresses none.
//
// What bounds it on an H100: latency. The IoU matrix of a group of 1000 is
// 0.5 M pairs at ~20 flops (a microsecond of the card's fp32 rate, 128 KB
// of bitmask), but the greedy walk is a chain of 1000 dependent decisions.
//
// Design:
// - Pass 1, nms_mask_kernel: one block of 64 threads for each (64 rows x
//   64 columns) tile of a group's upper triangle; each thread one row,
//   the tile's 64 column boxes staged in shared memory; one 64-bit word of
//   "row i suppresses column j" a thread. Tiles below the diagonal or past
//   the group's end exit at once and are never read.
// - Pass 2, nms_scan_kernel: one block a group, the groups in parallel.
//   The block stages 64 rows of the bitmask (the words from the diagonal
//   on) and their valid flags in shared memory; one warp then walks the 64
//   rows, each lane OR-ing its words of a kept row into the removed set in
//   shared memory, __syncwarp() between rows. Measured at the segmenter's
//   shapes (five groups of up to 1000; 1000 boxes of 21 labels): 0.24 ms a
//   call, both passes, on an H100 (NVIDIA H100 80GB HBM3, 700 W), against
//   well under a microsecond of work: the walk's dependent steps and its
//   chunks' loads set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;       // boxes a mask word
constexpr int kScanThreads = 256;
constexpr int kMaxGroups = 32;  // groups a launch

struct Groups {
  int start[kMaxGroups];
  int count[kMaxGroups];
};

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__device__ __forceinline__ float iou(const float4 a, const float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float sum = __fadd_rn(box_area(a.x, a.y, a.z, a.w),
                              box_area(b.x, b.y, b.z, b.w));
  return __fdiv_rn(inter, __fsub_rn(sum, inter));
}

__global__ void __launch_bounds__(kWord)
    nms_mask_kernel(const float4* __restrict__ boxes,
                    const int32_t* __restrict__ labels, Groups groups,
                    int words, float threshold, uint64_t* __restrict__ mask) {
  const int start = groups.start[blockIdx.z];
  const int n = groups.count[blockIdx.z];
  const int row_block = blockIdx.y, col_block = blockIdx.x;
  if (col_block < row_block || row_block * kWord >= n ||
      col_block * kWord >= n)
    return;
  __shared__ float4 cols[kWord];
  __shared__ int32_t col_labels[kWord];
  const int n_cols = min(kWord, n - col_block * kWord);
  const int t = threadIdx.x;
  if (t < n_cols) {
    cols[t] = boxes[start + col_block * kWord + t];
    col_labels[t] = labels ? labels[start + col_block * kWord + t] : 0;
  }
  __syncthreads();
  const int row = row_block * kWord + t;
  if (row >= n) return;
  const float4 box = boxes[start + row];
  const int32_t label = labels ? labels[start + row] : 0;
  uint64_t bits = 0;
  for (int j = row_block == col_block ? t + 1 : 0; j < n_cols; ++j) {
    if (col_labels[j] == label && iou(box, cols[j]) > threshold)
      bits |= 1ull << j;
  }
  mask[static_cast<long long>(start + row) * words + col_block] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const uint64_t* __restrict__ mask,
                    const uint8_t* __restrict__ valid, Groups groups,
                    int words, uint8_t* __restrict__ keep) {
  extern __shared__ uint64_t smem[];
  uint64_t* removed = smem;           // [words]
  uint64_t* rows = smem + words;      // [kWord][words]
  __shared__ uint8_t row_valid[kWord];
  const int start = groups.start[blockIdx.x];
  const int n = groups.count[blockIdx.x];
  const int nw = (n + kWord - 1) / kWord;
  const int t = threadIdx.x;
  for (int w = t; w < nw; w += kScanThreads) removed[w] = 0;
  for (int base = 0; base < n; base += kWord) {
    const int n_rows = min(kWord, n - base);
    const int cb = base / kWord;
    __syncthreads();  // the last chunk's walk is done with `rows`
    const int span = nw - cb;
    for (int e = t; e < n_rows * span; e += kScanThreads) {
      const int r = e / span, w = cb + e % span;
      rows[r * words + w] =
          mask[static_cast<long long>(start + base + r) * words + w];
    }
    if (t < n_rows) row_valid[t] = valid ? valid[start + base + t] : 1;
    __syncthreads();
    if (t < 32) {
      for (int r = 0; r < n_rows; ++r) {
        const bool live =
            row_valid[r] && !((removed[cb] >> r) & 1ull);
        if (t == 0) keep[start + base + r] = live ? 1 : 0;
        if (live) {
          for (int w = cb + t; w < nw; w += 32) removed[w] |= rows[r * words + w];
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

extern "C" {

// `boxes` (N, 4) float32 x1, y1, x2, y2, 16-byte aligned; `labels` (N,)
// int32 or null; `valid` (N,) uint8 or null (all valid); `n_groups` groups,
// group g the rows [starts[g], starts[g] + counts[g]) (host arrays), each
// sorted by score; `words` >= ceil(max count / 64), the row stride of
// `mask` (N x words uint64 scratch, no zeroing needed); `keep` (N,) uint8,
// written for every row of a group. Launches on `stream` of device `device`
// and returns the CUDA error after the launches (0 = cudaSuccess); does not
// synchronise.
int mfk_nms(const void* boxes, const void* labels, const void* valid,
            int n_groups, const int* starts, const int* counts, int words,
            float threshold, void* mask, void* keep, int device,
            void* stream) {
  if (n_groups <= 0) return static_cast<int>(cudaSuccess);
  if (n_groups > kMaxGroups || words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Groups groups;
  for (int g = 0; g < n_groups; ++g) {
    if (counts[g] < 0 || (counts[g] + kWord - 1) / kWord > words)
      return static_cast<int>(cudaErrorInvalidValue);
    groups.start[g] = starts[g];
    groups.count[g] = counts[g];
  }
  const size_t shared = sizeof(uint64_t) * static_cast<size_t>(words) *
                        (kWord + 1);
  if (shared > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(words, words, n_groups);
  nms_mask_kernel<<<grid, kWord, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const int32_t*>(labels),
      groups, words, threshold, static_cast<uint64_t*>(mask));
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  nms_scan_kernel<<<n_groups, kScanThreads, shared, s>>>(
      static_cast<const uint64_t*>(mask), static_cast<const uint8_t*>(valid),
      groups, words, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
