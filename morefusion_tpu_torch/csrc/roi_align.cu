// Multi-level RoIAlign of Mask R-CNN with an FPN (He et al., ICCV 2017;
// Lin et al., CVPR 2017), inference only: the box head's 7 x 7 and the mask
// head's 14 x 14 features of every RoI, over the pyramid levels P2-P5, in
// one launch.
//
// Replaces no TPU kernel: the JAX package has no detector (its segmenter is
// a UNet). It was added because no kernel of the port computes RoIAlign and
// the port imports no torchvision.
//
// The rule, for RoI (x1, y1, x2, y2) in input pixels (aligned=False, the
// original rule):
//   level  k = floor(4 + log2(sqrt((x2 - x1) * (y2 - y1)) * (1 / 224)
//          + 1e-6)),
//          clamped to [2, 5]; the RoI reads P_k at scale 2^-k;
//   start  x1 * scale, y1 * scale; extent max(x2 * scale - start, 1) a side;
//   bin    extent * (1 / P); in bin (ph, pw) a 2 x 2 grid of samples at
//          y = (start_h + ph * bin_h) + ((iy + 0.5) * bin_h) / 2 (x alike);
//   sample 0 where y < -1 or y > H (x alike); else y clamped at 0, y_low =
//          int(y), and where y_low >= H - 1 both taps on row H - 1;
//          bilinear ((w1 v1 + w2 v2) + w3 v3) + w4 v4 with w1 = hy * hx,
//          w2 = hy * lx, w3 = ly * hx, w4 = ly * lx;
//   output the four samples summed in order (iy outer), over 4.
// Every operation is rounded apart (__f*_rn, no contraction) and each
// division by a constant (224, P) is the product with its float32
// reciprocal, as PyTorch divides a tensor by a scalar on the card, so that
// ops/roi_align.py::roi_align_plain, written as the same tensor operations,
// gives the same bits on the card and on the CPU; the level uses sqrtf and
// log2f, as torch.sqrt and torch.log2 do on the card.
//
// What bounds it on an H100: bytes. The box call of a 800 x 1088 frame
// writes 1000 RoIs x 256 channels x 49 bins (50 MB) and reads each RoI's
// footprint on its level (its bins' taps, 256 channels); each output
// element costs ~49 flops, far under the card's fp32 rate. At 3.35 TB/s the
// writes alone take ~15 us. The mask call (5-8 RoIs x 196 bins) is a few
// microseconds of launch. Measured on an H100 (NVIDIA H100 80GB HBM3,
// 700 W): 0.32 ms for 1000 random RoIs of 2-700 px against a 0.053 ms byte
// bound; 26-32% of the bound over the segmenter's frames (PERF.md).
//
// Design:
// - One thread an output element, (RoI, channel, row, column) with the
//   column fastest, so that a warp's stores are contiguous and its taps lie
//   on a few neighbouring rows of one channel plane (L1 and L2 serve the
//   reuse between neighbouring bins and RoIs).
// - Each thread recomputes its RoI's level and geometry (a dozen flops)
//   rather than staging them: no second kernel and no scratch.
// - Features in NCHW as the convolutions leave them (batch 1): no layout
//   copy of the 56 MB P2 a call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevels = 4;  // P2-P5
constexpr int kSampling = 2;

struct Pyramid {
  const float* feat[kLevels];
  int H[kLevels];
  int W[kLevels];
};

// The RoI's level, 0..3 for P2..P5.
__device__ __forceinline__ int roi_level(float x1, float y1, float x2,
                                         float y2) {
  const float area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
  const float s = __fadd_rn(__fmul_rn(sqrtf(area), 1.f / 224.f), 1e-6f);
  const float k = floorf(__fadd_rn(4.f, log2f(s)));
  const float c = fminf(fmaxf(k, 2.f), 5.f);
  return static_cast<int>(c) - 2;
}

__device__ __forceinline__ float bilinear(const float* __restrict__ f, int H,
                                          int W, float y, float x) {
  if (y < -1.f || y > static_cast<float>(H) || x < -1.f ||
      x > static_cast<float>(W))
    return 0.f;
  y = y <= 0.f ? 0.f : y;
  x = x <= 0.f ? 0.f : x;
  int y_low = static_cast<int>(y);
  int x_low = static_cast<int>(x);
  int y_high, x_high;
  if (y_low >= H - 1) {
    y_high = y_low = H - 1;
    y = static_cast<float>(y_low);
  } else {
    y_high = y_low + 1;
  }
  if (x_low >= W - 1) {
    x_high = x_low = W - 1;
    x = static_cast<float>(x_low);
  } else {
    x_high = x_low + 1;
  }
  const float ly = __fsub_rn(y, static_cast<float>(y_low));
  const float lx = __fsub_rn(x, static_cast<float>(x_low));
  const float hy = __fsub_rn(1.f, ly);
  const float hx = __fsub_rn(1.f, lx);
  const float v1 = __ldg(f + y_low * W + x_low);
  const float v2 = __ldg(f + y_low * W + x_high);
  const float v3 = __ldg(f + y_high * W + x_low);
  const float v4 = __ldg(f + y_high * W + x_high);
  float v = __fmul_rn(__fmul_rn(hy, hx), v1);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(hy, lx), v2));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(ly, hx), v3));
  return __fadd_rn(v, __fmul_rn(__fmul_rn(ly, lx), v4));
}

__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(Pyramid pyr, const float* __restrict__ rois, int R,
                     int C, int P, float* __restrict__ out) {
  const long long total = static_cast<long long>(R) * C * P * P;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int pw = static_cast<int>(i % P);
  const int ph = static_cast<int>((i / P) % P);
  const int c = static_cast<int>((i / (P * P)) % C);
  const int r = static_cast<int>(i / (static_cast<long long>(P) * P * C));

  const float x1 = __ldg(rois + 4 * r), y1 = __ldg(rois + 4 * r + 1);
  const float x2 = __ldg(rois + 4 * r + 2), y2 = __ldg(rois + 4 * r + 3);
  const int l = roi_level(x1, y1, x2, y2);
  // scales 1/4 .. 1/32 are exact: the products round only as the inputs do
  const float scale = 1.f / static_cast<float>(4 << l);
  const int H = pyr.H[l], W = pyr.W[l];
  const float* f = pyr.feat[l] + static_cast<long long>(c) * H * W;

  const float start_w = __fmul_rn(x1, scale);
  const float start_h = __fmul_rn(y1, scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(x2, scale), start_w), 1.f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(y2, scale), start_h), 1.f);
  const float inv_p = 1.f / static_cast<float>(P);
  const float bin_w = __fmul_rn(roi_w, inv_p);
  const float bin_h = __fmul_rn(roi_h, inv_p);
  const float base_h =
      __fadd_rn(start_h, __fmul_rn(static_cast<float>(ph), bin_h));
  const float base_w =
      __fadd_rn(start_w, __fmul_rn(static_cast<float>(pw), bin_w));

  float sum = 0.f;
#pragma unroll
  for (int iy = 0; iy < kSampling; ++iy) {
    const float y = __fadd_rn(
        base_h, __fdiv_rn(__fmul_rn(iy + 0.5f, bin_h),
                          static_cast<float>(kSampling)));
#pragma unroll
    for (int ix = 0; ix < kSampling; ++ix) {
      const float x = __fadd_rn(
          base_w, __fdiv_rn(__fmul_rn(ix + 0.5f, bin_w),
                            static_cast<float>(kSampling)));
      sum = __fadd_rn(sum, bilinear(f, H, W, y, x));
    }
  }
  out[i] = __fdiv_rn(sum, static_cast<float>(kSampling * kSampling));
}

}  // namespace

extern "C" {

// `feats`: the four levels' (C, H, W) float32 planes (batch 1), contiguous;
// `hw`: their H0, W0, .., H3, W3; `rois` (R, 4) float32 x1, y1, x2, y2 in
// input pixels; `out` (R, C, P, P) float32, every element written. Launches
// on `stream` of device `device` and returns the CUDA error after the
// launch (0 = cudaSuccess); does not synchronise.
int mfk_roi_align(const void* const* feats, const int* hw, int C,
                  const void* rois, int R, int P, void* out, int device,
                  void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (C <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Pyramid pyr;
  for (int l = 0; l < kLevels; ++l) {
    pyr.feat[l] = static_cast<const float*>(feats[l]);
    pyr.H[l] = hw[2 * l];
    pyr.W[l] = hw[2 * l + 1];
    if (pyr.H[l] <= 0 || pyr.W[l] <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(R) * C * P * P;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  roi_align_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      pyr, static_cast<const float*>(rois), R, C, P,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
