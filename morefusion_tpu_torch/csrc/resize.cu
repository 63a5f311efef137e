// Bilinear upsampling of NCHW planes with align_corners=False, forward and
// backward: PSPNet's resize (its pyramid and its three x2 stages) and the
// UNet segmenter's x2 skip stages.
//
// Replaces no TPU kernel: the JAX package resizes with jax.image.resize,
// which XLA lowers by itself. It takes the place of F.interpolate's CUDA
// kernels, which give one thread to each output pixel of a plane and loop
// it over N x C (a 32^2 output runs 1024 threads, each over 8192 planes at
// B = 16), and whose backward zero-fills the input gradient and then adds
// four atomics an output element (a 1^2 input takes all 1024 outputs of its
// plane into one address).
//
// The rule is F.interpolate's: for output index o of an axis that grows
// from n_in to n_out, scale = float(n_in) / float(n_out),
//   src = max(scale * (o + 0.5) - 0.5, 0),  i0 = int(src),
//   i1 = i0 + (i0 < n_in - 1),  l1 = src - i0,  l0 = 1 - l1,
// and out = l0h * (l0w * x[i0h][i0w] + l1w * x[i0h][i1w])
//         + l1h * (l0w * x[i1h][i0w] + l1w * x[i1h][i1w]),
// in fp32 whatever the storage type (fp32 or bf16), with the fused
// multiply-adds that PyTorch's build of that expression makes, written out
// (the compiler's own contraction of it matched only where the weights are
// exact): the fp32 forward is bit for bit F.interpolate's on the card.
//
// What bounds it on an H100: bytes. At B = 16 the forward writes 1.07 GB
// (the pyramid's four 512 x 32^2 planes a crop, the x2 stages' 1024 x 64^2,
// 256 x 128^2 and 64 x 256^2) and reads 0.07 GB; the backward reads the
// 1.07 GB of output gradient and writes 0.07 GB: ~0.34 ms each at 3.35
// TB/s. The work is 7-10 flops an output element.
//
// Design:
// - Parallel over every element of N x C x H x W, never a loop over planes.
// - Exact x2 in both axes (the stencil path): each input pixel anchors the
//   2 x 2 output quad (2k..2k+1, 2j..2j+1), whose taps are fixed: row 2k
//   reads (k-1, k) at (1/4, 3/4), row 2k+1 reads (k, k+1) at (3/4, 1/4),
//   clamped at the edges as the rule clamps (row 0 reads (0, 1) at (1, 0);
//   the last row's k+1 is k). One thread a quad, its 3 x 3 input
//   neighbourhood from L1, each quad row stored as one 2-element vector.
//   The general kernel below gives the same bits at x2 but runs 6% slower
//   there: 0.1945-0.1953 ms against 0.1833-0.1839 ms at each of PSPNet's
//   three x2 stages (B = 16, fp32, H100 80GB HBM3 at 700 W).
// - Any other upsize (the pyramid's 1, 2, 3, 6 -> 32): the rule itself, one
//   thread for 4 consecutive outputs of a row (one 4-element vector store)
//   where the width allows, else one output (a small model's 80^2 crops
//   give a 10^2 pyramid).
// - The backward gathers, with no atomics and no zero fill: each input
//   element sums (wh * ww) * g over the outputs that read it. Along an axis
//   those are the outputs o with i0(o) in {i - 1, i}, a contiguous range
//   since i0 grows with o; w(o, i) is l0 where i0 == i plus l1 where
//   i1 == i, by the same rule (so a zero weight, as row 0's on input row 1,
//   is a term too). Rows outer, columns inner, in a fixed order: the
//   result is the same on every run.
//   - x2: one thread an input element over its at most 5 x 5 window, the
//     taps from the fixed table (ops/resize.py::x2_weights mirrors it).
//   - Otherwise one warp an input element: the lanes split its window
//     (a 32^2 plane for a 1^2 input), each sums its part in order, then a
//     shuffle tree in a fixed order.
// - Equal sizes in both axes (PSPNet's 6-bin level where the feature map is
//   6-11 wide, whose pooling keeps its size): the forward copies, as
//   F.interpolate's does.
// - A downsize is refused (cudaErrorInvalidValue): no caller sends one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements stored as one vector
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The two input indices an output reads along one axis, and their weights
struct Tap {
  int i0, i1;
  float l0, l1;
};

// F.interpolate's source index for output o (align_corners=False), with
// the fused multiply-add its build makes of scale * (o + 0.5) - 0.5
__device__ __forceinline__ Tap tap(int o, int n_in, float scale) {
  float src = __fmaf_rn(scale, o + 0.5f, -0.5f);
  src = src < 0.f ? 0.f : src;
  Tap t;
  t.i0 = static_cast<int>(src);
  t.i1 = t.i0 + (t.i0 < n_in - 1 ? 1 : 0);
  t.l1 = src - t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

// The x2 rule, exact: output 2k reads (k-1, k) at (1/4, 3/4), 2k+1 reads
// (k, k+1) at (3/4, 1/4), clamped as tap() clamps.
__device__ __forceinline__ Tap tap_x2(int o, int n_in) {
  const int k = o >> 1;
  Tap t;
  if (o & 1) {
    t.i0 = k;
    t.i1 = k + (k < n_in - 1 ? 1 : 0);
    t.l0 = 0.75f;
    t.l1 = 0.25f;
  } else if (k == 0) {
    t.i0 = 0;
    t.i1 = n_in > 1 ? 1 : 0;
    t.l0 = 1.f;
    t.l1 = 0.f;
  } else {
    t.i0 = k - 1;
    t.i1 = k;
    t.l0 = 0.25f;
    t.l1 = 0.75f;
  }
  return t;
}

// The weight with which output o (tap t) reads input i
__device__ __forceinline__ float weight(const Tap& t, int i) {
  return (t.i0 == i ? t.l0 : 0.f) + (t.i1 == i ? t.l1 : 0.f);
}

// F.interpolate's expression, l0h * (l0w * a + l1w * b) + l1h * (l0w * c +
// l1w * d), rounded as its build rounds it: each sum a fused multiply-add
// of its first product onto the rounded second
template <typename T>
__device__ __forceinline__ float blend(const T* __restrict__ x, int W,
                                       const Tap& r, const Tap& c) {
  const float top = __fmaf_rn(c.l0, to_f(x[r.i0 * W + c.i0]),
                              __fmul_rn(c.l1, to_f(x[r.i0 * W + c.i1])));
  const float bottom = __fmaf_rn(c.l0, to_f(x[r.i1 * W + c.i0]),
                                 __fmul_rn(c.l1, to_f(x[r.i1 * W + c.i1])));
  return __fmaf_rn(r.l0, top, __fmul_rn(r.l1, bottom));
}

// x2 forward: one thread an input pixel, its 2 x 2 output quad
template <typename T>
__global__ void __launch_bounds__(kThreads)
up2_forward(const T* __restrict__ x, T* __restrict__ y, long long n, int H,
            int W) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx % W);
  const long long t = idx / W;
  const int k = static_cast<int>(t % H);
  const long long plane = t / H;
  const T* xp = x + plane * H * W;
  const int Wo = 2 * W;
  T* yp = y + plane * 4 * H * W;
  const Tap c0 = tap_x2(2 * j, W), c1 = tap_x2(2 * j + 1, W);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const Tap r = tap_x2(2 * k + u, H);
    Vec<T, 2> out;
    out.v[0] = from_f<T>(blend(xp, W, r, c0));
    out.v[1] = from_f<T>(blend(xp, W, r, c1));
    *reinterpret_cast<Vec<T, 2>*>(yp + (2 * k + u) * Wo + 2 * j) = out;
  }
}

// General forward: one thread V consecutive outputs of a row (Wo % V == 0)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
resize_forward(const T* __restrict__ x, T* __restrict__ y, long long n,
               int H, int W, int Ho, int Wo, float sh, float sw) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n) return;  // n = planes * Ho * Wo / V
  const int wv = Wo / V;
  const int q = static_cast<int>(idx % wv);
  const long long t = idx / wv;
  const int ho = static_cast<int>(t % Ho);
  const long long plane = t / Ho;
  const T* xp = x + plane * H * W;
  const Tap r = tap(ho, H, sh);
  Vec<T, V> out;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    out.v[u] = from_f<T>(blend(xp, W, r, tap(q * V + u, W, sw)));
  }
  *reinterpret_cast<Vec<T, V>*>(y + (plane * Ho + ho) * Wo + q * V) = out;
}

// x2 backward: one thread an input element over its at most 5 x 5 window.
// Along an axis of n inputs, input i is read by outputs 2i-2 .. 2i+2: 2i-2
// only where i == 1 (output 0's zero weight), 2i-1 where i >= 1, 2i and
// 2i+1 always, 2i+2 where i <= n-2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
up2_backward(const T* __restrict__ g, T* __restrict__ gx, long long n, int H,
             int W) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx % W);
  const long long t = idx / W;
  const int i = static_cast<int>(t % H);
  const long long plane = t / H;
  const int Wo = 2 * W;
  const T* gp = g + plane * 4 * H * W;
  const int r_lo = i == 1 ? 0 : (i >= 1 ? 2 * i - 1 : 0);
  const int r_hi = i <= H - 2 ? 2 * i + 2 : 2 * i + 1;
  const int c_lo = j == 1 ? 0 : (j >= 1 ? 2 * j - 1 : 0);
  const int c_hi = j <= W - 2 ? 2 * j + 2 : 2 * j + 1;
  float wc[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int o = c_lo + s;
    wc[s] = o <= c_hi ? weight(tap_x2(o, W), j) : 0.f;
  }
  float acc = 0.f;
  for (int o = r_lo; o <= r_hi; ++o) {
    const float wr = weight(tap_x2(o, H), i);
    const T* row = gp + o * Wo;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (c_lo + s <= c_hi) acc += (wr * wc[s]) * to_f(row[c_lo + s]);
    }
  }
  gx[idx] = from_f<T>(acc);
}

// The outputs along an axis that read input i: [lo, hi], those with
// i0 in {i - 1, i}; empty where hi < lo
__device__ __forceinline__ void readers(int i, int n_in, int n_out,
                                        float scale, int& lo, int& hi) {
  lo = static_cast<int>((i - 0.5f) / scale - 0.5f) - 1;
  lo = lo < 0 ? 0 : (lo > n_out - 1 ? n_out - 1 : lo);
  while (lo > 0 && tap(lo - 1, n_in, scale).i0 >= i - 1) --lo;
  while (lo < n_out && tap(lo, n_in, scale).i0 < i - 1) ++lo;
  hi = static_cast<int>((i + 1.5f) / scale - 0.5f) + 1;
  hi = hi < 0 ? 0 : (hi > n_out - 1 ? n_out - 1 : hi);
  while (hi + 1 < n_out && tap(hi + 1, n_in, scale).i0 <= i) ++hi;
  while (hi >= 0 && tap(hi, n_in, scale).i0 > i) --hi;
}

// General backward: one warp an input element. With a window nw wide the
// lanes take 32 / nw of its rows a pass (lane: row lane / nw, column
// lane % nw); with nw >= 32, columns lane, lane + 32, ... of every row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resize_backward(const T* __restrict__ g, T* __restrict__ gx, long long n,
                int H, int W, int Ho, int Wo, float sh, float sw) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;  // n = planes * H * W, one warp each
  const int j = static_cast<int>(warp % W);
  const long long t = warp / W;
  const int i = static_cast<int>(t % H);
  const long long plane = t / H;
  const T* gp = g + plane * Ho * Wo;
  int r_lo, r_hi, c_lo, c_hi;
  readers(i, H, Ho, sh, r_lo, r_hi);
  readers(j, W, Wo, sw, c_lo, c_hi);
  const int nh = r_hi - r_lo + 1, nw = c_hi - c_lo + 1;
  float acc = 0.f;
  if (nh > 0 && nw > 0) {
    const int rows = nw >= 32 ? 1 : 32 / nw;
    const int r0 = nw >= 32 ? 0 : lane / nw;
    if (r0 < rows) {
      for (int c = nw >= 32 ? lane : lane % nw; c < nw; c += 32) {
        const int wo = c_lo + c;
        const float wc = weight(tap(wo, W, sw), j);
        for (int r = r0; r < nh; r += rows) {
          const int ho = r_lo + r;
          const float wr = weight(tap(ho, H, sh), i);
          acc += (wr * wc) * to_f(gp[ho * Wo + wo]);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) gx[warp] = from_f<T>(acc);
}

unsigned int blocks_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

bool is_x2(int H, int W, int Ho, int Wo) { return Ho == 2 * H && Wo == 2 * W; }

// The sizes the kernels take: no axis shrinks
bool takes(int H, int W, int Ho, int Wo) {
  return H > 0 && W > 0 && Ho >= H && Wo >= W;
}

template <typename T>
cudaError_t forward(const T* x, T* y, long long planes, int H, int W, int Ho,
                    int Wo, cudaStream_t s) {
  if (Ho == H && Wo == W) {
    return cudaMemcpyAsync(y, x, sizeof(T) * planes * H * W,
                           cudaMemcpyDeviceToDevice, s);
  }
  if (is_x2(H, W, Ho, Wo)) {
    const long long n = planes * H * W;
    up2_forward<T><<<blocks_for(n), kThreads, 0, s>>>(x, y, n, H, W);
  } else {
    const float sh = static_cast<float>(H) / static_cast<float>(Ho);
    const float sw = static_cast<float>(W) / static_cast<float>(Wo);
    if (Wo % 4 == 0) {
      const long long n = planes * Ho * Wo / 4;
      resize_forward<T, 4><<<blocks_for(n), kThreads, 0, s>>>(
          x, y, n, H, W, Ho, Wo, sh, sw);
    } else {
      const long long n = planes * Ho * Wo;
      resize_forward<T, 1><<<blocks_for(n), kThreads, 0, s>>>(
          x, y, n, H, W, Ho, Wo, sh, sw);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const T* g, T* gx, long long planes, int H, int W,
                     int Ho, int Wo, cudaStream_t s) {
  const long long n = planes * H * W;
  if (is_x2(H, W, Ho, Wo)) {
    up2_backward<T><<<blocks_for(n), kThreads, 0, s>>>(g, gx, n, H, W);
  } else {
    const float sh = static_cast<float>(H) / static_cast<float>(Ho);
    const float sw = static_cast<float>(W) / static_cast<float>(Wo);
    resize_backward<T><<<blocks_for(n * 32), kThreads, 0, s>>>(
        g, gx, n, H, W, Ho, Wo, sh, sw);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `planes` NCHW planes of H x W (input) and Ho x Wo (output), sizes that
// takes() accepts; `bf16` 0 for float32, 1 for bfloat16. Launch on `stream` of
// device `device` and return the CUDA error after the launch (0 =
// cudaSuccess). Do not synchronise. The forward writes every element of
// `y`, the backward every element of `gx`: neither needs a zeroed output.
int mfk_resize_forward(const void* x, void* y, int bf16, long long planes,
                       int H, int W, int Ho, int Wo, int device,
                       void* stream) {
  if (!takes(H, W, Ho, Wo)) return static_cast<int>(cudaErrorInvalidValue);
  if (planes <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? forward(static_cast<const __nv_bfloat16*>(x),
                     static_cast<__nv_bfloat16*>(y), planes, H, W, Ho, Wo, s)
           : forward(static_cast<const float*>(x), static_cast<float*>(y),
                     planes, H, W, Ho, Wo, s);
  return static_cast<int>(err);
}

int mfk_resize_backward(const void* g, void* gx, int bf16, long long planes,
                        int H, int W, int Ho, int Wo, int device,
                        void* stream) {
  if (!takes(H, W, Ho, Wo)) return static_cast<int>(cudaErrorInvalidValue);
  if (planes <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? backward(static_cast<const __nv_bfloat16*>(g),
                      static_cast<__nv_bfloat16*>(gx), planes, H, W, Ho, Wo,
                      s)
           : backward(static_cast<const float*>(g), static_cast<float*>(gx),
                      planes, H, W, Ho, Wo, s);
  return static_cast<int>(err);
}

}  // extern "C"
