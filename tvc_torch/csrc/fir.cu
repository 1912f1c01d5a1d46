// 2x FIR resampling of an NHWC tensor with a separable 4-tap kernel, float32
// or bf16, for sm_90a, in one pass.
//
// Replaces no TPU kernel: it is the polyphase shift-and-add form of
// tvc_torch/ops/resample.py (upsample_2d and downsample_2d with factor 2, a
// separable 4-tap kernel and TVC_POLYPHASE=1), which the port ran as a pad,
// two products and a sum per phase and a stack per axis, a launch each: on a
// channels-last UNet activation (the bf16 UNet on the card) about 2.5 ms of
// a 15-ms call at B = 8. It is the polyphase form's only route on the card:
// an NCHW-contiguous tensor (the float32 UNet) arrives as the NHWC tensor of
// its N * C planes with one channel. This kernel computes, per output pixel
// and channel, exactly what those ops compute. With TVC_FUSED_FIR=0, along H
// first, then along W,
//
//   up:   out[2m]   = k3 v[m-1] + k1 v[m]
//         out[2m+1] = k2 v[m]   + k0 v[m+1]
//   down: out[m]    = ((k3 v[2m-1] + k2 v[2m]) + k1 v[2m+1]) + k0 v[2m+2]
//
// the H pass's result rounded to the dtype before the W pass, as the ops'
// intermediate tensor is. With TVC_FUSED_FIR=1 (FUSED), both axes at once:
// each term is (ka kb) v, the tap product rounded to the dtype first, and
// the terms are summed in the ops' order, the H tap outermost (2 x 2 terms a
// phase up, 4 x 4 down). v is zero outside the image (the ops' zero
// padding), and each product and each sum is rounded to the dtype in float32
// (__fmul_rn, __fadd_rn: the ops run one at a time, so nothing is fused). So
// its output equals theirs bit for bit. The taps arrive as the ops multiply
// by them: rounded to the dtype, as float32. An odd size halves as the ops
// halve it, to its floor.
//
// Design: one thread per output pixel and vector of channels (16 bytes where
// the channels and the pointers allow, else one element), the tensors NHWC
// so that a warp reads and writes consecutive vectors of a pixel's channels,
// then of the next pixel's. An output pixel reads 2 x 2 (up) or 4 x 4 (down)
// input pixels, which neighbouring threads share through L1 and L2: the
// device memory sees x read once and y written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Taps {
  float k0, k1, k2, k3;
};

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V elements of x at pixel (r, c) of an (h, w) image whose channel vector
// starts at `base`, as float32; zeros outside the image.
template <typename T, int V>
__device__ __forceinline__ void load_px(float (&v)[V], const T* base, int r, int c, int h, int w,
                                        int ch) {
  if (r < 0 || r >= h || c < 0 || c >= w) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = 0.f;
    return;
  }
  const T* p = base + ((long long)r * w + c) * ch;
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_f<T>(t[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_f<T>(p[e]);
  }
}

// o = rnd(rnd(ka a) + rnd(kb b)): a two-tap phase.
template <typename T, int V>
__device__ __forceinline__ void taps2(float (&o)[V], float ka, const float (&a)[V], float kb,
                                      const float (&b)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e)
    o[e] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ka, a[e])), rnd<T>(__fmul_rn(kb, b[e]))));
}

// o = rnd(rnd(rnd(rnd(k3 a) + rnd(k2 b)) + rnd(k1 c)) + rnd(k0 d)): the
// downsample's window, summed left to right.
template <typename T, int V>
__device__ __forceinline__ void taps4(float (&o)[V], const Taps& k, const float (&a)[V],
                                      const float (&b)[V], const float (&c)[V],
                                      const float (&d)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float s = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(k.k3, a[e])), rnd<T>(__fmul_rn(k.k2, b[e]))));
    s = rnd<T>(__fadd_rn(s, rnd<T>(__fmul_rn(k.k1, c[e]))));
    o[e] = rnd<T>(__fadd_rn(s, rnd<T>(__fmul_rn(k.k0, d[e]))));
  }
}

// o += rnd(ka kb) v in float32, rounded to the dtype (o = the term where
// `first`): one term of the fused form.
template <typename T, int V>
__device__ __forceinline__ void term(float (&o)[V], bool first, float ka, float kb,
                                     const float (&v)[V]) {
  const float kk = rnd<T>(__fmul_rn(ka, kb));
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = rnd<T>(__fmul_rn(kk, v[e]));
    o[e] = first ? t : rnd<T>(__fadd_rn(o[e], t));
  }
}

template <typename T, int V, bool UP, bool FUSED>
__global__ void __launch_bounds__(THREADS)
    fir2x(const T* __restrict__ x, T* __restrict__ y, int n, int h, int w, int ch, Taps k) {
  const int ho = UP ? 2 * h : h / 2, wo = UP ? 2 * w : w / 2;
  const int cv = ch / V;
  const long long total = (long long)n * ho * wo * cv;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int c0 = (int)(i % cv) * V;
    long long pix = i / cv;
    const int ox = (int)(pix % wo);
    pix /= wo;
    const int oy = (int)(pix % ho);
    const long long b = pix / ho;
    const T* base = x + b * h * w * ch + c0;
    float out[V];
    if constexpr (UP) {
      // the H phase's two rows and taps, then the W phase's two columns
      const int m = oy >> 1, q = ox >> 1;
      const int r0 = (oy & 1) ? m : m - 1, col0 = (ox & 1) ? q : q - 1;
      const float kr0 = (oy & 1) ? k.k2 : k.k3, kr1 = (oy & 1) ? k.k0 : k.k1;
      const float kc0 = (ox & 1) ? k.k2 : k.k3, kc1 = (ox & 1) ? k.k0 : k.k1;
      if constexpr (FUSED) {
        const float kr[2] = {kr0, kr1}, kc[2] = {kc0, kc1};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[V];
            load_px<T, V>(v, base, r0 + i, col0 + j, h, w, ch);
            term<T, V>(out, i == 0 && j == 0, kr[i], kc[j], v);
          }
      } else {
        float t[2][V];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a[V], bv[V];
          load_px<T, V>(a, base, r0, col0 + j, h, w, ch);
          load_px<T, V>(bv, base, r0 + 1, col0 + j, h, w, ch);
          taps2<T, V>(t[j], kr0, a, kr1, bv);
        }
        taps2<T, V>(out, kc0, t[0], kc1, t[1]);
      }
    } else if constexpr (FUSED) {
      const int r0 = 2 * oy - 1, col0 = 2 * ox - 1;
      const float kw[4] = {k.k3, k.k2, k.k1, k.k0};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[V];
          load_px<T, V>(v, base, r0 + i, col0 + j, h, w, ch);
          term<T, V>(out, i == 0 && j == 0, kw[i], kw[j], v);
        }
    } else {
      const int r0 = 2 * oy - 1, col0 = 2 * ox - 1;
      float t[4][V];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a[V], bv[V], cc[V], d[V];
        load_px<T, V>(a, base, r0, col0 + j, h, w, ch);
        load_px<T, V>(bv, base, r0 + 1, col0 + j, h, w, ch);
        load_px<T, V>(cc, base, r0 + 2, col0 + j, h, w, ch);
        load_px<T, V>(d, base, r0 + 3, col0 + j, h, w, ch);
        taps4<T, V>(t[j], k, a, bv, cc, d);
      }
      taps4<T, V>(out, k, t[0], t[1], t[2], t[3]);
    }
    T* dst = y + ((b * ho + oy) * wo + ox) * ch + c0;
    if constexpr (V * sizeof(T) == 16) {
      uint4 raw;
      T* r = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) r[e] = static_cast<T>(out[e]);
      *reinterpret_cast<uint4*>(dst) = raw;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = static_cast<T>(out[e]);
    }
  }
}

template <typename T, int V, bool UP, bool FUSED>
void launch_k(unsigned grid, const void* x, void* y, int n, int h, int w, int ch, Taps k,
              cudaStream_t stream) {
  fir2x<T, V, UP, FUSED><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(y), n, h, w, ch, k);
}

template <typename T, int V>
cudaError_t launch_t(bool up, bool fused, const void* x, void* y, int n, int h, int w, int ch,
                     Taps k, cudaStream_t stream) {
  const long long ho = up ? 2ll * h : h / 2, wo = up ? 2ll * w : w / 2;
  const long long total = (long long)n * ho * wo * (ch / V);
  const long long blocks = (total + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
  if (up && fused) launch_k<T, V, true, true>(grid, x, y, n, h, w, ch, k, stream);
  else if (up) launch_k<T, V, true, false>(grid, x, y, n, h, w, ch, k, stream);
  else if (fused) launch_k<T, V, false, true>(grid, x, y, n, h, w, ch, k, stream);
  else launch_k<T, V, false, false>(grid, x, y, n, h, w, ch, k, stream);
  return cudaGetLastError();
}

}  // namespace

// x: an (n, h, w, ch) NHWC array of the dtype (0 float32, 1 bf16), contiguous;
// y: the contiguous (n, 2h, 2w, ch) array (up 1) or (n, h / 2, w / 2, ch)
// (up 0, h and w at least 2) of the dtype, not aliasing x. k0..k3: the taps
// as the dtype holds them. fused: the one-pass form (TVC_FUSED_FIR=1). vec:
// elements a load and store, 16 bytes' worth (ch a multiple of it, x and y
// 16-byte aligned) or 1. Launches on `stream` of `device` (the current
// device) and does not synchronise. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int tvc_fir2x(const void* x, void* y, int n, int h, int w, int ch, int up, int fused,
                         float k0, float k1, float k2, float k3, int dtype, int vec, int device,
                         void* stream) {
  if (n < 1 || h < 1 || w < 1 || ch < 1 || (!up && (h < 2 || w < 2)) || vec < 1 ||
      ch % vec != 0 || (long long)n * h * w * ch * (up ? 4 : 1) >= (1ll << 62))
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Taps k{k0, k1, k2, k3};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const bool u = up != 0, f = fused != 0;
  if (dtype == 0 && vec == 4 && aligned) err = launch_t<float, 4>(u, f, x, y, n, h, w, ch, k, s);
  else if (dtype == 0 && vec == 1) err = launch_t<float, 1>(u, f, x, y, n, h, w, ch, k, s);
  else if (dtype == 1 && vec == 8 && aligned)
    err = launch_t<__nv_bfloat16, 8>(u, f, x, y, n, h, w, ch, k, s);
  else if (dtype == 1 && vec == 1)
    err = launch_t<__nv_bfloat16, 1>(u, f, x, y, n, h, w, ch, k, s);
  else err = cudaErrorInvalidValue;
  if (prev >= 0 && prev != device) cudaSetDevice(prev);
  return (int)err;
}
