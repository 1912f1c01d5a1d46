// GroupNorm + scale/shift + SiLU in one pass, float32 or bf16, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it, and the port ran it as up to seven ATen launches (a cast to
// float32, the moments, the normalisation, a cast back, the broadcast multiply
// and add of the time embedding, SiLU). This kernel computes, for an
// (N, C, *spatial) input x with G groups, contiguous or channels-last (as the
// UNet's residual stream lies after its channels-last input), into a
// contiguous y of the same shape,
//
//   y0 = GroupNorm(x)      float32 statistics; with an affine weight and bias
//                          as a * x + b (a = rstd * w, b = -a * mean + bias),
//                          else (x - mean) * rstd; rounded to the dtype
//   y1 = y0 * (1 + scale) + shift      optional, scale and shift per (n, c)
//   y  = silu(y1)                      optional
//
// and a second entry, groupnorm_spade_fwd, for the SPADE NCSN++'s modulated
// norms (models/diffusion/spade.py): the affine-free GroupNorm y0, then
// y0 * (1 + gamma) + beta with gamma and beta of x's shape (contiguous), then
// the optional scale/shift and SiLU above. Both entries share every step but
// the apply's modulation (groupnorm_body), and so the statistics, the plan and
// the rounding; the SPADE entry reads gamma and beta once more in the apply,
// rounds 1 + gamma, the product and the sum as the composition does, and
// adds two reads of x's size to the bound below.
//
// rounding wherever the plain PyTorch composition rounds (tvc_torch/ops/
// groupnorm.py, group_norm_plain): in bf16 the normalised value, 1 + scale,
// the product, the sum and SiLU's result are each rounded to bf16, every step
// between them is float32 with the same operations (__fmul_rn, __fadd_rn and
// the fused multiply-adds ATen's kernels compile to), and SiLU is
// x / (1 + expf(-x)) as ATen computes it. With io (TVC_GN_BF16_IO=1) the
// statistics are rounded to bf16 as ATen's bf16 group norm stores them, and
// eps arrives rounded by the wrapper. So the kernel differs from the plain
// composition only in the order of the statistics' sums.
//
// The bound on an H100 SXM: normalisation does a few operations a byte, far
// below the ridge, so the least time is one read of x and one write of y at
// 3.35 TB/s: 2.46 GB and 0.74 ms for the 81 norms of a bf16 NCSN++ call at
// B = 8, 0.62 GB and 0.18 ms for a float32 call at B = 1.
//
// Design, point by point (the choices timed on an H100, PERF.md):
// 1. Read once. A slice (n, g) is Cg channel runs of HW pixels. A block loads
//    its part of a slice into shared memory, four 16-byte loads in flight a
//    thread (channels-last: 16 loads of an element, or of two channels in
//    bf16, consecutive threads on consecutive channels and pixels), summing
//    as it goes; takes the centred second moment from shared memory; turns
//    each channel's weights, scale and shift (read while the part loads)
//    into coefficients in shared memory; then applies the chain from shared
//    memory, two vectors a thread at a time, rounding to bf16 two values a
//    conversion, and writes y with 16-byte stores: one pass over device
//    memory.
// 2. Fill the card at B = 1. A slice is split along its pixels over a
//    thread-block cluster of `splits` <= 16 blocks (each keeps Cg runs of
//    `pix` pixels); the partial sums are joined through distributed shared
//    memory, every block reading ranks 0 .. splits - 1 in order, as
//    attention.cu joins its key splits. At B = 8 the slices alone fill the
//    card and a slice is split only as far as its size needs: the joins cost
//    more than they give there.
// 3. Slices too large for 16 blocks' shared memory (the widest 3-D volumes)
//    take the same kernel with RESIDENT false: the statistics and the apply
//    read x again from device memory.
// 4. Deterministic. The plan (splits, pix, vector width, residency, two
//    channels a load) is `groupnorm_plan`'s, a function of the shape, dtype and layout alone;
//    every sum runs in a fixed order (a thread's elements in index order, a
//    fixed shuffle tree, the block's warps in order, the cluster's ranks in
//    order) and nothing is accumulated with atomics, so a rerun and a
//    receiver get the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLITS = 16;  // the largest cluster an H100 schedules (8 is portable)
constexpr int UNROLL = 4;      // loads a thread keeps in flight, 16 bytes each
constexpr int UNROLL_CL = 16;  // the same for a channels-last input, one element each
constexpr int SMEM_LIMIT = 200 * 1024;  // dynamic shared memory a block may ask for

enum Flag { AFFINE = 1, EMB = 2, SILU = 4, IO = 8, PARAMS_BF16 = 16, CL_PAIRS = 32 };

// n / d for 0 <= n < 2^31 by a multiply and a shift (d fixed per launch).
struct FastDiv {
  unsigned m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{(unsigned)m, s};
}

__device__ __forceinline__ unsigned fdiv(const FastDiv& f, unsigned n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct Params {
  const void* x;
  void* y;
  const void* weight;  // (C,) float32 or bf16 (PARAMS_BF16), with bias; null without AFFINE
  const void* bias;
  const void* gamma;   // SPADE: x's shape, contiguous, in the dtype; null otherwise
  const void* beta;
  const void* scale;   // (N, C) in the dtype, row strides ss0 and ss1; null without EMB
  const void* shift;
  long long ss0, ss1;
  long long hw;        // pixels of a channel run (the product of the spatial dims)
  long long slices;    // N * G
  int c, groups, cg;   // channels, groups, channels a group
  int splits;          // blocks a slice, one cluster
  int pix;             // pixels a split (a multiple of the vector width); the last may be shorter
  int ldb;             // elements between two channel runs of a part in shared memory
  int coef_off;        // bytes from the start of shared memory to the channels' coefficients
  int flags;
  float eps;
  FastDiv vpr_div;     // vectors a channel run of a full split
  FastDiv vpr_last;    // the same for the last split
  FastDiv cg_div;      // channels a group
  FastDiv half_div;    // half the channels a group
};

// V consecutive elements of T as one load or store (16 bytes where V > 1).
template <typename T, int V>
struct Pack;

template <>
struct Pack<float, 4> {
  float4 r;
  __device__ void ldg(const float* p) { r = __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ void ld(const float* p) { r = *reinterpret_cast<const float4*>(p); }
  __device__ void st(float* p) const { *reinterpret_cast<float4*>(p) = r; }
  __device__ float get(int e) const { return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w; }
  __device__ void set(int e, float v) {
    if (e == 0) r.x = v;
    else if (e == 1) r.y = v;
    else if (e == 2) r.z = v;
    else r.w = v;
  }
};

template <>
struct Pack<float, 1> {
  float r;
  __device__ void ldg(const float* p) { r = __ldg(p); }
  __device__ void ld(const float* p) { r = *p; }
  __device__ void st(float* p) const { *p = r; }
  __device__ float get(int) const { return r; }
  __device__ void set(int, float v) { r = v; }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  uint4 r;
  __device__ void ldg(const __nv_bfloat16* p) { r = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ void ld(const __nv_bfloat16* p) { r = *reinterpret_cast<const uint4*>(p); }
  __device__ void st(__nv_bfloat16* p) const { *reinterpret_cast<uint4*>(p) = r; }
  __device__ unsigned word(int i) const { return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w; }
  __device__ float get(int e) const {
    const unsigned w = word(e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  // v is a bf16 value already (rnd_vec): its top 16 bits
  __device__ void set(int e, float v) {
    const unsigned b = __float_as_uint(v) >> 16;
    unsigned w = word(e >> 1);
    w = (e & 1) ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
    if ((e >> 1) == 0) r.x = w;
    else if ((e >> 1) == 1) r.y = w;
    else if ((e >> 1) == 2) r.z = w;
    else r.w = w;
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  unsigned short r;
  __device__ void ldg(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ void ld(const __nv_bfloat16* p) { r = *reinterpret_cast<const unsigned short*>(p); }
  __device__ void st(__nv_bfloat16* p) const { *reinterpret_cast<unsigned short*>(p) = r; }
  __device__ float get(int) const { return __uint_as_float((unsigned)r << 16); }
  __device__ void set(int, float v) { r = (unsigned short)(__float_as_uint(v) >> 16); }
};

// The dtype's rounding of a float32 value: none for float32, to nearest even for bf16.
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

__device__ __forceinline__ float bf16_round(float v) { return rnd<__nv_bfloat16>(v); }

// The dtype's rounding of each of v[0 .. V): for bf16 two values a
// conversion (cvt.rn.bf16x2.f32, which runs at the full rate where the
// single conversion does not).
template <typename T, int V>
__device__ __forceinline__ void rnd_vec(float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    return;
  } else if constexpr (V % 2 == 1) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = bf16_round(v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[e], v[e + 1]);
      const unsigned u = *reinterpret_cast<const unsigned*>(&h);
      v[e] = __uint_as_float(u << 16);
      v[e + 1] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ float load_f(const void* p, long long i) {
  return static_cast<float>(reinterpret_cast<const T*>(p)[i]);
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const void* p, long long i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

// Sum of v over the block: a fixed shuffle tree in each warp, then the warps
// in order. Every thread of the block calls it (it holds two __syncthreads).
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Sum of every cluster block's s, ranks in order, the same in each block.
__device__ __forceinline__ float cluster_sum(float s, float* part, cg::cluster_group& cluster,
                                             int splits) {
  if (threadIdx.x == 0) *part = s;
  cluster.sync();
  float t = 0.f;
  for (int r = 0; r < splits; ++r) t += *cluster.map_shared_rank(part, r);
  return t;
}

// x / (1 + expf(-x)) as ATen's SiLU computes it, the IEEE quotient.
__device__ __forceinline__ float silu_of(float x) { return __fdiv_rn(x, __fadd_rn(1.f, expf(-x))); }

// The float32 values of the V elements of vector i of a part (channel run
// j, vector q of the run), from shared memory where the part is resident,
// else from x: in NCHW a 16-byte load, channels-last one element a pixel.
template <typename T, int V, bool RESIDENT, bool CL>
__device__ __forceinline__ void read_vec(float (&v)[V], const T* buf, int ldb, const T* xs,
                                         const Params& p, int j, int q) {
  Pack<T, V> pk;
  if (RESIDENT) {
    pk.ld(buf + (size_t)j * ldb + q * V);
  } else if (!CL) {
    pk.ldg(xs + (long long)j * p.hw + (long long)q * V);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      Pack<T, 1> one;
      one.ldg(xs + (long long)(q * V + e) * p.c + j);
      v[e] = one.get(0);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = pk.get(e);
}

// The body of both entries. grid (splits * slices), cluster (splits) where
// splits > 1: block b works on split b % splits of slice b / splits.
// CL: x is channels-last (channels innermost); y is always (N, C, *spatial).
// SPADE: the normalised value is modulated by gamma and beta before the
// scale/shift (no affine weights).
template <typename T, int V, bool RESIDENT, bool CL, bool SPADE>
__device__ __forceinline__ void groupnorm_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  __shared__ float part[2];

  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.splits;  // == the cluster rank
  const long long s = blockIdx.x / p.splits;  // the slice (n, g)
  const long long n = s / p.groups;
  const int g = (int)(s - n * p.groups);
  const int p0 = split * p.pix;
  const int np = (int)min((long long)p.pix, p.hw - p0);  // pixels of this split
  const FastDiv vdiv = split == p.splits - 1 ? p.vpr_last : p.vpr_div;
  const int vpr = np / V;                 // vectors a channel run
  const int nv = p.cg * vpr;              // vectors of this block's part
  const long long xbase = CL ? (n * p.hw + p0) * p.c + (long long)g * p.cg
                             : (n * p.c + (long long)g * p.cg) * p.hw + p0;
  const T* xs = reinterpret_cast<const T*>(p.x) + xbase;
  T* ys = reinterpret_cast<T*>(p.y) + (n * p.c + (long long)g * p.cg) * p.hw + p0;
  T* buf = reinterpret_cast<T*>(smem);
  float4* coef = reinterpret_cast<float4*>(smem + p.coef_off);
  const bool affine = p.flags & AFFINE, emb = p.flags & EMB, silu = p.flags & SILU;

  // each channel's weight, bias, scale and shift as stored, read while the
  // part loads; turned into coefficients once the statistics are known
  for (int t = tid; t < p.cg; t += THREADS) {
    const int c = g * p.cg + t;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (affine) {
      const bool pb = p.flags & PARAMS_BF16;
      raw.x = pb ? load_f<__nv_bfloat16>(p.weight, c) : load_f<float>(p.weight, c);
      raw.y = pb ? load_f<__nv_bfloat16>(p.bias, c) : load_f<float>(p.bias, c);
    }
    if (emb) {
      raw.z = load_f<T>(p.scale, n * p.ss0 + c);
      raw.w = load_f<T>(p.shift, n * p.ss1 + c);
    }
    coef[t] = raw;
  }

  // 1. load (and keep) the part, summing as it goes
  float acc = 0.f;
  if (!CL) {
    for (int i0 = tid; i0 < nv; i0 += UNROLL * THREADS) {
      Pack<T, V> pk[UNROLL];
      int off[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < nv) {
          const int j = (int)fdiv(vdiv, (unsigned)i);
          const int q = i - j * vpr;
          off[u] = j * p.ldb + q * V;
          pk[u].ldg(xs + (long long)j * p.hw + (long long)q * V);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i0 + u * THREADS < nv) {
          if (RESIDENT) pk[u].st(buf + off[u]);
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) t += pk[u].get(e);
          acc += t;
        }
      }
    }
  } else if (sizeof(T) == 2 && (p.flags & CL_PAIRS)) {
    // channels-last bf16, an even number of channels a group: two channels a
    // 4-byte load; element pair k of the part is pixel k / (Cg / 2)
    const int half = p.cg / 2;
    const int ne = half * np;
    const unsigned* xw = reinterpret_cast<const unsigned*>(xs);
    for (int k0 = tid; k0 < ne; k0 += UNROLL_CL * THREADS) {
      unsigned w[UNROLL_CL];
      int off[UNROLL_CL];
#pragma unroll
      for (int u = 0; u < UNROLL_CL; ++u) {
        const int k = k0 + u * THREADS;
        if (k < ne) {
          const int q = (int)fdiv(p.half_div, (unsigned)k);
          const int j2 = k - q * half;
          off[u] = 2 * j2 * p.ldb + q;
          w[u] = __ldg(xw + ((long long)q * p.c) / 2 + j2);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL_CL; ++u) {
        if (k0 + u * THREADS < ne) {
          unsigned short* b16 = reinterpret_cast<unsigned short*>(buf);
          if (RESIDENT) {
            b16[off[u]] = (unsigned short)(w[u] & 0xffffu);
            b16[off[u] + p.ldb] = (unsigned short)(w[u] >> 16);
          }
          acc += __uint_as_float(w[u] << 16);
          acc += __uint_as_float(w[u] & 0xffff0000u);
        }
      }
    }
  } else {  // channels-last: element k of the part is pixel k / Cg, channel k % Cg
    const int ne = p.cg * np;
    for (int k0 = tid; k0 < ne; k0 += UNROLL_CL * THREADS) {
      Pack<T, 1> pk[UNROLL_CL];
      int off[UNROLL_CL];
#pragma unroll
      for (int u = 0; u < UNROLL_CL; ++u) {
        const int k = k0 + u * THREADS;
        if (k < ne) {
          const int q = (int)fdiv(p.cg_div, (unsigned)k);
          const int j = k - q * p.cg;
          off[u] = j * p.ldb + q;
          pk[u].ldg(xs + (long long)q * p.c + j);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL_CL; ++u) {
        if (k0 + u * THREADS < ne) {
          if (RESIDENT) pk[u].st(buf + off[u]);
          acc += pk[u].get(0);
        }
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  const float count = (float)p.cg * (float)p.hw;
  float total = block_sum(acc, red);
  if (p.splits > 1) total = cluster_sum(total, &part[0], cluster, p.splits);
  float mu = total / count;

  // 2. the centred second moment
  float acc2 = 0.f;
  for (int i0 = tid; i0 < nv; i0 += UNROLL * THREADS) {
    float t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      t[u] = 0.f;
      if (i < nv) {
        const int j = (int)fdiv(vdiv, (unsigned)i);
        float v[V];
        read_vec<T, V, RESIDENT, CL>(v, buf, p.ldb, xs, p, j, i - j * vpr);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = __fsub_rn(v[e], mu);
          t[u] = __fmaf_rn(d, d, t[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc2 += t[u];
  }
  float total2 = block_sum(acc2, red);
  if (p.splits > 1) {
    total2 = cluster_sum(total2, &part[1], cluster, p.splits);
    cluster.sync();  // keep this block's partials until the cluster has read them
  }
  float rstd = rsqrtf(total2 / count + p.eps);
  if (p.flags & IO) {  // ATen's bf16 group norm stores its statistics in bf16
    mu = bf16_round(mu);
    rstd = bf16_round(rstd);
  }

  // 3. each channel's coefficients: (a, b) of a * x + b with the affine
  // weights (ATen's fused parameters, the weights rounded to the dtype), else
  // (rstd, mean) of (x - mean) * rstd; then 1 + scale rounded, and shift
  for (int t = tid; t < p.cg; t += THREADS) {
    const float4 raw = coef[t];
    float4 cf = make_float4(rstd, mu, 0.f, 0.f);
    if (affine) {
      cf.x = __fmul_rn(rstd, rnd<T>(raw.x));
      cf.y = __fmaf_rn(-cf.x, mu, rnd<T>(raw.y));
    }
    if (emb) {
      cf.z = rnd<T>(__fadd_rn(1.f, raw.z));
      cf.w = raw.w;
    }
    coef[t] = cf;
  }
  __syncthreads();

  // 4. apply, two vectors a thread at a time
  const long long ybase = (n * p.c + (long long)g * p.cg) * p.hw + p0;
  for (int i0 = tid; i0 < nv; i0 += 2 * THREADS) {
    float v[2][V];
    float4 cf[2];
    long long off[2];
    Pack<T, V> ga[2], be[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nv) {
        const int j = (int)fdiv(vdiv, (unsigned)i);
        const int q = i - j * vpr;
        off[u] = (long long)j * p.hw + (long long)q * V;
        if constexpr (SPADE) {
          ga[u].ldg(reinterpret_cast<const T*>(p.gamma) + ybase + off[u]);
          be[u].ldg(reinterpret_cast<const T*>(p.beta) + ybase + off[u]);
        }
        read_vec<T, V, RESIDENT, CL>(v[u], buf, p.ldb, xs, p, j, q);
        cf[u] = coef[j];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (i0 + u * THREADS < nv) {
        float y[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          y[e] = affine ? __fmaf_rn(cf[u].x, v[u][e], cf[u].y)
                        : __fmul_rn(__fsub_rn(v[u][e], cf[u].y), cf[u].x);
        rnd_vec<T, V>(y);
        if constexpr (SPADE) {  // y * (1 + gamma) + beta, each step rounded
          float t[V];
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] = __fadd_rn(1.f, ga[u].get(e));
          rnd_vec<T, V>(t);
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = __fmul_rn(y[e], t[e]);
          rnd_vec<T, V>(y);
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = __fadd_rn(y[e], be[u].get(e));
          rnd_vec<T, V>(y);
        }
        if (emb) {
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = __fmul_rn(y[e], cf[u].z);
          rnd_vec<T, V>(y);
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = __fadd_rn(y[e], cf[u].w);
          rnd_vec<T, V>(y);
        }
        if (silu) {
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = silu_of(y[e]);
          rnd_vec<T, V>(y);
        }
        Pack<T, V> out;
#pragma unroll
        for (int e = 0; e < V; ++e) out.set(e, y[e]);
        out.st(ys + off[u]);
      }
    }
  }
}

template <typename T, int V, bool RESIDENT, bool CL>
__global__ void __launch_bounds__(THREADS) groupnorm_fwd(const Params p) {
  groupnorm_body<T, V, RESIDENT, CL, false>(p);
}

template <typename T, int V, bool RESIDENT, bool CL>
__global__ void __launch_bounds__(THREADS) groupnorm_spade_fwd(const Params p) {
  groupnorm_body<T, V, RESIDENT, CL, true>(p);
}

template <typename T, int V, bool SPADE>
const void* pick_v(bool resident, bool cl) {
  if constexpr (SPADE) {
    if (resident)
      return cl ? reinterpret_cast<const void*>(groupnorm_spade_fwd<T, V, true, true>)
                : reinterpret_cast<const void*>(groupnorm_spade_fwd<T, V, true, false>);
    return cl ? reinterpret_cast<const void*>(groupnorm_spade_fwd<T, V, false, true>)
              : reinterpret_cast<const void*>(groupnorm_spade_fwd<T, V, false, false>);
  } else {
    if (resident)
      return cl ? reinterpret_cast<const void*>(groupnorm_fwd<T, V, true, true>)
                : reinterpret_cast<const void*>(groupnorm_fwd<T, V, true, false>);
    return cl ? reinterpret_cast<const void*>(groupnorm_fwd<T, V, false, true>)
              : reinterpret_cast<const void*>(groupnorm_fwd<T, V, false, false>);
  }
}

template <typename T, bool SPADE>
const void* pick_t(int vec, bool resident, bool cl) {
  constexpr int VW = 16 / sizeof(T);
  if (vec == VW) return pick_v<T, VW, SPADE>(resident, cl);
  if (vec == 1) return pick_v<T, 1, SPADE>(resident, cl);
  return nullptr;
}

// The instantiation for the entry, dtype (0 float32, 1 bf16), vector width,
// residency and layout, or null.
const void* pick(bool spade, int dtype, int vec, bool resident, bool cl) {
  if (dtype == 0)
    return spade ? pick_t<float, true>(vec, resident, cl) : pick_t<float, false>(vec, resident, cl);
  if (dtype == 1)
    return spade ? pick_t<__nv_bfloat16, true>(vec, resident, cl)
                 : pick_t<__nv_bfloat16, false>(vec, resident, cl);
  return nullptr;
}

// Raise the dynamic shared memory limit of `fn` on device `dev`, once.
cudaError_t allow_smem(const void* fn, int dev) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, dev})) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.insert({fn, dev});
  return err;
}

// Makes `device` the current device for its lifetime, as PyTorch's device
// guard does, so that a launch on a stream of that device is valid.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
    } else {
      prev = -1;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Both entries' checks and launch; gamma and beta non-null for the SPADE entry.
int forward(bool spade, const void* x, void* y, const void* weight, const void* bias,
            const void* gamma, const void* beta, const void* scale, const void* shift,
            long long ss0, long long ss1, int n, int c, long long hw, int groups, float eps,
            int dtype, int flags, int cl, int splits, int pix, int vec, int resident, int ldb,
            int device, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const void* fn = pick(spade, dtype, vec, resident != 0, cl != 0);
  if (fn == nullptr || n < 1 || c < 1 || hw < 1 || groups < 1 || c % groups != 0 ||
      splits < 1 || splits > MAX_SPLITS || pix < 1 || pix % vec != 0 || hw % vec != 0 ||
      (long long)(splits - 1) * pix >= hw || (long long)splits * pix < hw ||
      (resident && (ldb < pix || ldb % vec != 0)) ||
      (long long)(c / groups) * hw >= (1ll << 31) ||
      (vec > 1 && !(aligned16(y) && (cl || aligned16(x)))) ||
      ((flags & AFFINE) && !(weight && bias)) || ((flags & EMB) && !(scale && shift)) ||
      ((flags & CL_PAIRS) && !(cl && dtype == 1 && (c / groups) % 2 == 0 && c % 2 == 0 &&
                               (reinterpret_cast<uintptr_t>(x) & 3) == 0)) ||
      (spade && (!gamma || !beta || (flags & AFFINE) ||
                 (vec > 1 && !(aligned16(gamma) && aligned16(beta))))))
    return (int)cudaErrorInvalidValue;
  const int cg = c / groups;
  const long long slices = (long long)n * groups;
  const long long blocks = (long long)splits * slices;
  const size_t data = resident ? (((size_t)cg * ldb * esize + 15) & ~(size_t)15) : 0;
  const size_t smem = data + (size_t)cg * sizeof(float4);
  if (blocks > 0x7fffffffll || smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.y = y;
  p.weight = weight;
  p.bias = bias;
  p.gamma = gamma;
  p.beta = beta;
  p.scale = scale;
  p.shift = shift;
  p.ss0 = ss0;
  p.ss1 = ss1;
  p.hw = hw;
  p.slices = slices;
  p.c = c;
  p.groups = groups;
  p.cg = cg;
  p.splits = splits;
  p.pix = pix;
  p.ldb = resident ? ldb : 0;
  p.coef_off = (int)data;
  p.flags = flags;
  p.eps = eps;
  p.vpr_div = make_div((unsigned)(pix / vec));
  p.vpr_last = make_div((unsigned)((hw - (long long)(splits - 1) * pix) / vec));
  p.cg_div = make_div((unsigned)cg);
  p.half_div = make_div((unsigned)max(1, cg / 2));

  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = allow_smem(fn, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // a lone block needs no cluster
  void* args[] = {&p};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: an (n, c, hw) array of the dtype (0 float32, 1 bf16) on `device`,
// contiguous, or with cl (n, hw, c) (channels innermost); y: a contiguous
// (n, c, hw) array of the dtype, not aliasing x. weight, bias: (c,) float32
// or bf16 (flag 16) with flag 1, else null; scale, shift: (n, c) of the dtype
// with row strides ss0, ss1 and unit column stride with flag 2, else null.
// Flags: 1 affine, 2 scale and shift, 4 SiLU, 8 bf16 statistics
// (TVC_GN_BF16_IO), 16 bf16 weights, 32 two channels a 4-byte load (the
// plan's `pairs`: cl bf16, channels even a group and in all, x 4-byte
// aligned; anything else is refused). The plan: `splits` (1..16) blocks a
// slice in one cluster, each `pix` pixels of every channel of the group (the
// last fewer, none empty), `vec` elements a load and store of y (1, or 16 bytes' worth:
// hw and pix multiples of it, y and, without cl, x 16-byte aligned),
// `resident` 1 to keep the part in shared memory with `ldb` elements between
// its channel runs (at least pix, a multiple of vec). Launches on `stream`, a
// stream of `device`, and does not synchronise. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int tvc_groupnorm_forward(const void* x, void* y, const void* weight, const void* bias,
                                     const void* scale, const void* shift, long long ss0,
                                     long long ss1, int n, int c, long long hw, int groups,
                                     float eps, int dtype, int flags, int cl, int splits, int pix,
                                     int vec, int resident, int ldb, int device, void* stream) {
  return forward(false, x, y, weight, bias, nullptr, nullptr, scale, shift, ss0, ss1, n, c, hw,
                 groups, eps, dtype, flags, cl, splits, pix, vec, resident, ldb, device, stream);
}

// The SPADE entry: as tvc_groupnorm_forward without the affine weights
// (flag 1 is refused), with gamma and beta, contiguous (n, c, hw) arrays of
// the dtype (16-byte aligned where vec > 1), modulating the normalised value
// as y0 * (1 + gamma) + beta before the scale/shift and SiLU.
extern "C" int tvc_groupnorm_spade_forward(const void* x, void* y, const void* gamma,
                                           const void* beta, const void* scale,
                                           const void* shift, long long ss0, long long ss1,
                                           int n, int c, long long hw, int groups, float eps,
                                           int dtype, int flags, int cl, int splits, int pix,
                                           int vec, int resident, int ldb, int device,
                                           void* stream) {
  return forward(true, x, y, nullptr, nullptr, gamma, beta, scale, shift, ss0, ss1, n, c, hw,
                 groups, eps, dtype, flags, cl, splits, pix, vec, resident, ldb, device, stream);
}
