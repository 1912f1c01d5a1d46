// GroupNorm + scale/shift + SiLU in one pass, float32 or bf16, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it, and the port ran it as up to seven ATen launches (a cast to
// float32, the moments, the normalisation, a cast back, the broadcast multiply
// and add of the time embedding, SiLU). This kernel computes, for an
// (N, C, *spatial) input x with G groups, contiguous or channels-last (the
// bf16 UNet's activations on the card), into a y of the same shape laid out
// as x (or, on request, a contiguous y from a channels-last x),
//
//   y0 = GroupNorm(x)      float32 statistics; with an affine weight and bias
//                          as a * x + b (a = rstd * w, b = -a * mean + bias),
//                          else (x - mean) * rstd; rounded to the dtype
//   y1 = y0 * (1 + scale) + shift      optional, scale and shift per (n, c)
//   y  = silu(y1)                      optional
//
// and a second entry, groupnorm_spade_fwd, for the SPADE NCSN++'s modulated
// norms (models/diffusion/spade.py): the affine-free GroupNorm y0, then
// y0 * (1 + gamma) + beta with gamma and beta of x's shape (laid out as y), then
// the optional scale/shift and SiLU above. Both entries share every step but
// the apply's modulation (groupnorm_nchw, groupnorm_cl_body), and so the
// statistics, the plan and the rounding; the SPADE entry reads gamma and beta once more in the apply,
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
//    thread, summing as it goes; takes the centred second moment from shared
//    memory; turns each channel's weights, scale and shift (read while the
//    part loads) into coefficients in shared memory; then applies the chain
//    from shared memory, two vectors a thread at a time, rounding to bf16 two
//    values a conversion, and writes y with 16-byte stores: one pass over
//    device memory.
//    A channels-last x (the bf16 UNet's activations) is read and written as
//    it lies. A batch of small slices takes one block a slice
//    (groupnorm_cl_slice), the slice kept in shared memory in runs of a
//    pixel's group. Larger slices, where one block a slice would take
//    clusters of blocks or leave the card idle, take two streaming kernels
//    (groupnorm_cl_stats, groupnorm_cl_fwd): a pixel holds its channels
//    together, so a block takes a chunk of pixels and every channel, and a
//    warp reads and writes whole runs of consecutive pixels, 16 bytes a
//    thread where the channels allow; the first writes each group's shifted
//    sums of its chunk, the second joins them and applies the chain (x read
//    twice, y written once, no cluster). Every element takes the same
//    operations into a channels-last y as into a contiguous one (which a
//    channels-last x may also ask for), so the two layouts of y hold the
//    same bits.
// 2. Fill the card at B = 1 (contiguous x). A slice is split along its
//    pixels over a thread-block cluster of `splits` <= 16 blocks (each keeps
//    Cg runs of `pix` pixels); the partial sums are joined through
//    distributed shared memory, every block reading ranks 0 .. splits - 1 in
//    order, as attention.cu joins its key splits. At B = 8 the slices alone
//    fill the card and a slice is split only as far as its size needs: the
//    joins cost more than they give there.
// 3. Slices too large for 16 blocks' shared memory (the widest 3-D volumes)
//    take the same kernel with RESIDENT false: the statistics and the apply
//    read x again from device memory.
// 4. Deterministic. The plan (splits, pix, vector width, residency; for a
//    channels-last x its run width and chunk) is `groupnorm_plan`'s, a
//    function of the shape, dtype and layout alone;
//    every sum runs in a fixed order (a thread's elements in index order, a
//    fixed shuffle tree, the block's warps in order, the cluster's ranks in
//    order, a channels-last chunk's rows, channels and chunks in order) and
//    nothing is accumulated with atomics, so a rerun and a receiver get the
//    same bits.

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
constexpr int SMEM_LIMIT = 200 * 1024;  // dynamic shared memory a block may ask for

enum Flag { AFFINE = 1, EMB = 2, SILU = 4, IO = 8, PARAMS_BF16 = 16, OUT_CL = 64 };

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
  const void* gamma;   // SPADE: x's shape, laid out as y, in the dtype; null otherwise
  const void* beta;
  const void* scale;   // (N, C) in the dtype, row strides ss0 and ss1; null without EMB
  const void* shift;
  long long ss0, ss1;
  long long hw;        // pixels of a channel run (the product of the spatial dims)
  long long slices;    // N * G
  int c, groups, cg;   // channels, groups, channels a group
  int splits;          // contiguous x: blocks a slice, one cluster
  int pix;             // contiguous x: pixels a split (a multiple of the vector width); the
                       // last may be shorter
  int coef_off;        // contiguous x: bytes from the start of shared memory to the
                       // channels' coefficients
  int flags;
  int chunk;           // channels-last x: pixels a block (0: a block a slice)
  int chunks;          // channels-last x: blocks a sample
  void* work;          // channels-last x: (N, chunks, G) float2 sums of a chunk's groups
  FastDiv runs_div;    // channels-last x, a block a slice: runs of a pixel's group
  float eps;
  FastDiv vpr_div;     // contiguous x: vectors a channel run of a full split
  FastDiv vpr_last;    // the same for the last split
};

// V consecutive elements of T as one load or store of V * sizeof(T) bytes.
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

template <>
struct Pack<float, 2> {
  float2 r;
  __device__ void ldg(const float* p) { r = __ldg(reinterpret_cast<const float2*>(p)); }
  __device__ void ld(const float* p) { r = *reinterpret_cast<const float2*>(p); }
  __device__ void st(float* p) const { *reinterpret_cast<float2*>(p) = r; }
  __device__ float get(int e) const { return e == 0 ? r.x : r.y; }
  __device__ void set(int e, float v) {
    if (e == 0) r.x = v;
    else r.y = v;
  }
};

// bf16 pairs and quads as 4- and 8-byte words; v in set is a bf16 value already
template <>
struct Pack<__nv_bfloat16, 4> {
  uint2 r;
  __device__ void ldg(const __nv_bfloat16* p) { r = __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ void ld(const __nv_bfloat16* p) { r = *reinterpret_cast<const uint2*>(p); }
  __device__ void st(__nv_bfloat16* p) const { *reinterpret_cast<uint2*>(p) = r; }
  __device__ float get(int e) const {
    const unsigned w = (e >> 1) == 0 ? r.x : r.y;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ void set(int e, float v) {
    const unsigned b = __float_as_uint(v) >> 16;
    unsigned& w = (e >> 1) == 0 ? r.x : r.y;
    w = (e & 1) ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
  }
};

template <>
struct Pack<__nv_bfloat16, 2> {
  unsigned r;
  __device__ void ldg(const __nv_bfloat16* p) { r = __ldg(reinterpret_cast<const unsigned*>(p)); }
  __device__ void ld(const __nv_bfloat16* p) { r = *reinterpret_cast<const unsigned*>(p); }
  __device__ void st(__nv_bfloat16* p) const { *reinterpret_cast<unsigned*>(p) = r; }
  __device__ float get(int e) const { return __uint_as_float((e & 1) ? (r & 0xffff0000u) : (r << 16)); }
  __device__ void set(int e, float v) {
    const unsigned b = __float_as_uint(v) >> 16;
    r = (e & 1) ? ((r & 0xffffu) | (b << 16)) : ((r & 0xffff0000u) | b);
  }
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

// The slice's mean from each thread's partial sum: over the block, then the
// cluster's blocks in rank order.
__device__ __forceinline__ float slice_mean(const Params& p, float acc, float* red, float* part,
                                            cg::cluster_group& cluster) {
  float total = block_sum(acc, red);
  if (p.splits > 1) total = cluster_sum(total, &part[0], cluster, p.splits);
  return total / ((float)p.cg * (float)p.hw);
}

// The slice's rstd from each thread's partial centred second moment; the
// cluster's blocks keep their partials until every block has read them.
__device__ __forceinline__ float slice_rstd(const Params& p, float acc2, float* red, float* part,
                                            cg::cluster_group& cluster) {
  float total2 = block_sum(acc2, red);
  if (p.splits > 1) {
    total2 = cluster_sum(total2, &part[1], cluster, p.splits);
    cluster.sync();  // keep this block's partials until the cluster has read them
  }
  return rsqrtf(total2 / ((float)p.cg * (float)p.hw) + p.eps);
}

// The weight, bias, scale and shift of `count` channels from channel c0 on,
// as stored, read while the part loads; turned into coefficients once the
// statistics are known.
template <typename T>
__device__ __forceinline__ void load_raw_coefs(const Params& p, float4* coef, long long n, int c0,
                                               int count) {
  const bool affine = p.flags & AFFINE, emb = p.flags & EMB;
  for (int t = threadIdx.x; t < count; t += THREADS) {
    const int c = c0 + t;
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
}

// 3. each channel's coefficients from its group's (mean, rstd) = stat(t):
// (a, b) of a * x + b with the affine weights (ATen's fused parameters, the
// weights rounded to the dtype), else (rstd, mean) of (x - mean) * rstd; then
// 1 + scale rounded, and shift. Ends in a __syncthreads.
template <typename T, typename Stat>
__device__ __forceinline__ void make_coefs(const Params& p, float4* coef, int count, Stat stat) {
  const bool affine = p.flags & AFFINE, emb = p.flags & EMB;
  for (int t = threadIdx.x; t < count; t += THREADS) {
    const float4 raw = coef[t];
    const float2 st = stat(t);
    const float mu = st.x, rstd = st.y;
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
}

// x / (1 + expf(-x)) as ATen's SiLU computes it, the IEEE quotient.
__device__ __forceinline__ float silu_of(float x) { return __fdiv_rn(x, __fadd_rn(1.f, expf(-x))); }

// The chain after the statistics on N values of the part, in place: element e
// takes the coefficients cf(e) (a float4 of step 3) and, for SPADE, gamma ga(e)
// and beta be(e); the normalisation, the modulation, the time term and SiLU,
// rounded where the composition rounds. Both layouts' apply steps run it.
template <typename T, int N, bool SPADE, typename Coef, typename Gamma, typename Beta>
__device__ __forceinline__ void chain(float (&y)[N], Coef cf, Gamma ga, Beta be, bool affine,
                                      bool emb, bool silu) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float4 c = cf(e);
    y[e] = affine ? __fmaf_rn(c.x, y[e], c.y) : __fmul_rn(__fsub_rn(y[e], c.y), c.x);
  }
  rnd_vec<T, N>(y);
  if constexpr (SPADE) {  // y * (1 + gamma) + beta, each step rounded
    float t[N];
#pragma unroll
    for (int e = 0; e < N; ++e) t[e] = __fadd_rn(1.f, ga(e));
    rnd_vec<T, N>(t);
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = __fmul_rn(y[e], t[e]);
    rnd_vec<T, N>(y);
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = __fadd_rn(y[e], be(e));
    rnd_vec<T, N>(y);
  }
  if (emb) {
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = __fmul_rn(y[e], cf(e).z);
    rnd_vec<T, N>(y);
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = __fadd_rn(y[e], cf(e).w);
    rnd_vec<T, N>(y);
  }
  if (silu) {
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = silu_of(y[e]);
    rnd_vec<T, N>(y);
  }
}

// The float32 values of the V elements of vector q of channel run j of an
// NCHW part, from shared memory where the part is resident, else from x.
template <typename T, int V, bool RESIDENT>
__device__ __forceinline__ void read_vec(float (&v)[V], const T* buf, const T* xs,
                                         const Params& p, int j, int q) {
  Pack<T, V> pk;
  if (RESIDENT) {
    pk.ld(buf + (size_t)j * p.pix + q * V);
  } else {
    pk.ldg(xs + (long long)j * p.hw + (long long)q * V);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = pk.get(e);
}

// The body of both entries for a contiguous x and y. grid (splits * slices),
// cluster (splits) where splits > 1: block b works on split b % splits of
// slice b / splits. A part is Cg channel runs of `np` pixels, vectors of V.
// SPADE: the normalised value is modulated by gamma and beta (contiguous, as
// y) before the scale/shift (no affine weights).
template <typename T, int V, bool RESIDENT, bool SPADE>
__device__ __forceinline__ void groupnorm_nchw(const Params& p) {
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
  const long long xbase = (n * p.c + (long long)g * p.cg) * p.hw + p0;  // x's, y's, gamma's
  const T* xs = reinterpret_cast<const T*>(p.x) + xbase;
  T* ys = reinterpret_cast<T*>(p.y) + xbase;
  T* buf = reinterpret_cast<T*>(smem);
  float4* coef = reinterpret_cast<float4*>(smem + p.coef_off);
  const bool affine = p.flags & AFFINE, emb = p.flags & EMB, silu = p.flags & SILU;
  load_raw_coefs<T>(p, coef, n, g * p.cg, p.cg);

  // 1. load (and keep) the part, summing as it goes
  float acc = 0.f;
  for (int i0 = tid; i0 < nv; i0 += UNROLL * THREADS) {
    Pack<T, V> pk[UNROLL];
    int off[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nv) {
        const int j = (int)fdiv(vdiv, (unsigned)i);
        const int q = i - j * vpr;
        off[u] = j * p.pix + q * V;
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
  cg::cluster_group cluster = cg::this_cluster();
  float mu = slice_mean(p, acc, red, part, cluster);

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
        read_vec<T, V, RESIDENT>(v, buf, xs, p, j, i - j * vpr);
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
  float rstd = slice_rstd(p, acc2, red, part, cluster);
  if (p.flags & IO) {  // ATen's bf16 group norm stores its statistics in bf16
    mu = bf16_round(mu);
    rstd = bf16_round(rstd);
  }
  make_coefs<T>(p, coef, p.cg, [&](int) { return make_float2(mu, rstd); });

  // 4. apply, two vectors a thread at a time
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
          ga[u].ldg(reinterpret_cast<const T*>(p.gamma) + xbase + off[u]);
          be[u].ldg(reinterpret_cast<const T*>(p.beta) + xbase + off[u]);
        }
        read_vec<T, V, RESIDENT>(v[u], buf, xs, p, j, q);
        cf[u] = coef[j];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (i0 + u * THREADS < nv) {
        const float4 c = cf[u];
        const Pack<T, V>& gu = ga[u];
        const Pack<T, V>& bu = be[u];
        chain<T, V, SPADE>(
            v[u], [&](int) { return c; }, [&](int e) { return gu.get(e); },
            [&](int e) { return bu.get(e); }, affine, emb, silu);
        Pack<T, V> out;
#pragma unroll
        for (int e = 0; e < V; ++e) out.set(e, v[u][e]);
        out.st(ys + off[u]);
      }
    }
  }
}

// The channels-last path (cl): two kernels that stream x as it lies, a
// pixel's channels together. Block b takes `chunk` pixels of sample b /
// chunks, every channel; thread t keeps column t % cols (W channels,
// cols = C / W, W: 16 bytes' worth halved until it divides C) of the pixels
// t / cols + k * rows, so a warp reads and writes whole runs of consecutive
// pixels, one W-element load or store a run. groupnorm_cl_stats sums, per
// channel, x - K and (x - K)^2 (K the group's shift: its first channel at the
// sample's first pixel, so the sums keep their precision where the mean is
// far from 0), joins them over the rows in order and then over the group's
// channels in order, and writes each group's pair for its chunk to `work`.
// groupnorm_cl_fwd (and groupnorm_cl_spade_fwd) joins the sample's chunks in
// order (a warp a group: lanes over chunks, then a fixed shuffle tree), takes
// mean = K + S1 / N and var = S2 / N - (S1 / N)^2, turns each channel's
// weights, scale and shift into coefficients in shared memory, and applies
// the chain with its column's coefficients in registers, into a channels-last
// y one W-element store a run, or element by element into a contiguous y
// (out_channels_last=False): the same operations either way, so the two
// layouts of y hold the same bits. x is read twice and y written once.
template <typename T, int W>
__device__ __forceinline__ void cl_place(const Params& p, long long& n, int& p0, int& np,
                                         int& cols, int& rows, int& row, int& j0) {
  n = blockIdx.x / p.chunks;
  p0 = (int)(blockIdx.x - n * p.chunks) * p.chunk;
  np = (int)min((long long)p.chunk, p.hw - p0);
  cols = p.c / W;
  rows = THREADS / cols;
  row = threadIdx.x / cols;
  j0 = (threadIdx.x - row * cols) * W;
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) groupnorm_cl_stats(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int IN_FLIGHT = 64 / (W * (int)sizeof(T)) > 16 ? 16
                            : 64 / (W * (int)sizeof(T));  // 64 bytes of loads a thread
  long long n;
  int p0, np, cols, rows, row, j0;
  cl_place<T, W>(p, n, p0, np, cols, rows, row, j0);
  float* shift = reinterpret_cast<float*>(smem);  // each channel's group's K
  float* red1 = shift + p.c;                        // rows x C partial sums
  float* red2 = red1 + (size_t)rows * p.c;
  const T* x0 = reinterpret_cast<const T*>(p.x) + n * p.hw * p.c;  // the sample's first pixel
  const T* xs = x0 + (long long)p0 * p.c + j0;
  Pack<T, W> pk[IN_FLIGHT];
  const auto fetch = [&](int qb) {
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int q = qb + u * rows;
      if (q < np) pk[u].ldg(xs + (long long)q * p.c);
    }
  };
  if (row < rows) fetch(row);  // in flight while the shifts are read
  for (int j = threadIdx.x; j < p.c; j += THREADS) shift[j] = load_f<T>(x0, (j / p.cg) * p.cg);
  __syncthreads();
  if (row < rows) {
    float k[W], s1[W], s2[W];
#pragma unroll
    for (int e = 0; e < W; ++e) k[e] = shift[j0 + e], s1[e] = 0.f, s2[e] = 0.f;
    for (int qb = row; qb < np; qb += IN_FLIGHT * rows) {
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (qb + u * rows < np) {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            const float d = __fsub_rn(pk[u].get(e), k[e]);
            s1[e] = __fadd_rn(s1[e], d);
            s2[e] = __fmaf_rn(d, d, s2[e]);
          }
        }
      }
      if (qb + IN_FLIGHT * rows < np) fetch(qb + IN_FLIGHT * rows);
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      red1[(size_t)row * p.c + j0 + e] = s1[e];
      red2[(size_t)row * p.c + j0 + e] = s2[e];
    }
  }
  __syncthreads();
  // each group's pair: a warp a group, lanes over its (channel, row) entries
  // in order, then a fixed shuffle tree
  float2* work = reinterpret_cast<float2*>(p.work) + (long long)blockIdx.x * p.groups;
  const int lane = threadIdx.x & 31;
  const int entries = p.cg * rows;
  for (int g = threadIdx.x >> 5; g < p.groups; g += WARPS) {
    float a = 0.f, b = 0.f;
    for (int e = lane; e < entries; e += 32) {
      const int j = g * p.cg + e / rows;
      const int r = e - (e / rows) * rows;
      a += red1[(size_t)r * p.c + j];
      b += red2[(size_t)r * p.c + j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(FULL, a, o);
      b += __shfl_xor_sync(FULL, b, o);
    }
    if (lane == 0) work[g] = make_float2(a, b);
  }
}

template <typename T, int W, bool SPADE>
__device__ __forceinline__ void groupnorm_cl_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PIX = W >= 8 ? 1 : 2;  // pixels a thread applies at a time
  long long n;
  int p0, np, cols, rows, row, j0;
  cl_place<T, W>(p, n, p0, np, cols, rows, row, j0);
  float4* coef = reinterpret_cast<float4*>(smem);                // C
  float2* stat = reinterpret_cast<float2*>(coef + p.c);          // G: (mean, rstd)
  const T* x0 = reinterpret_cast<const T*>(p.x) + n * p.hw * p.c;
  const bool out_cl = p.flags & OUT_CL;
  // the run's element e of pixel q: at cl + q * C + e in x, gamma, beta and a
  // channels-last y; at nchw + e * hw + q in a contiguous y (and its gamma, beta)
  const long long cl = (n * p.hw + p0) * p.c + j0;
  const long long nchw = (n * p.c + j0) * p.hw + p0;
  const T* x = reinterpret_cast<const T*>(p.x);
  T* y = reinterpret_cast<T*>(p.y);
  const T* gamma = reinterpret_cast<const T*>(p.gamma);
  const T* beta = reinterpret_cast<const T*>(p.beta);
  Pack<T, W> v[PIX], ga[PIX], be[PIX];
  const auto fetch = [&](int q1) {
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
      const int q = q1 + u * rows;
      if (q < np) {
        v[u].ldg(x + cl + (long long)q * p.c);
        if constexpr (SPADE) {
          if (out_cl) {
            ga[u].ldg(gamma + cl + (long long)q * p.c);
            be[u].ldg(beta + cl + (long long)q * p.c);
          } else {
#pragma unroll
            for (int e = 0; e < W; ++e) {
              ga[u].set(e, load_f<T>(gamma, nchw + (long long)e * p.hw + q));
              be[u].set(e, load_f<T>(beta, nchw + (long long)e * p.hw + q));
            }
          }
        }
      }
    }
  };
  if (row < rows) fetch(row);  // in flight while the statistics are joined
  load_raw_coefs<T>(p, coef, n, 0, p.c);
  // each group's statistics: a warp a group, lanes over the sample's chunks
  const float count = (float)p.cg * (float)p.hw;
  const float2* work = reinterpret_cast<const float2*>(p.work) + n * p.chunks * p.groups;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < p.groups; g += WARPS) {
    float a = 0.f, b = 0.f;
    for (int k = lane; k < p.chunks; k += 32) {
      const float2 w = work[(long long)k * p.groups + g];
      a += w.x;
      b += w.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(FULL, a, o);
      b += __shfl_xor_sync(FULL, b, o);
    }
    if (lane == 0) {
      const float m1 = a / count;
      float mu = __fadd_rn(load_f<T>(x0, (long long)g * p.cg), m1);
      float rstd = rsqrtf(fmaxf(__fsub_rn(b / count, __fmul_rn(m1, m1)), 0.f) + p.eps);
      if (p.flags & IO) {  // ATen's bf16 group norm stores its statistics in bf16
        mu = bf16_round(mu);
        rstd = bf16_round(rstd);
      }
      stat[g] = make_float2(mu, rstd);
    }
  }
  __syncthreads();
  make_coefs<T>(p, coef, p.c, [&](int t) { return stat[t / p.cg]; });
  if (row >= rows) return;

  const bool affine = p.flags & AFFINE, emb = p.flags & EMB, silu = p.flags & SILU;
  float4 cf[W];
#pragma unroll
  for (int e = 0; e < W; ++e) cf[e] = coef[j0 + e];
  for (int q1 = row; q1 < np; q1 += PIX * rows) {
    float yv[PIX][W];
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
      if (q1 + u * rows < np) {
#pragma unroll
        for (int e = 0; e < W; ++e) yv[u][e] = v[u].get(e);
        const Pack<T, W>& gu = ga[u];
        const Pack<T, W>& bu = be[u];
        chain<T, W, SPADE>(
            yv[u], [&](int e) { return cf[e]; }, [&](int e) { return gu.get(e); },
            [&](int e) { return bu.get(e); }, affine, emb, silu);
      }
    }
    if (q1 + PIX * rows < np) fetch(q1 + PIX * rows);  // the next pixels while these store
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
      const int q = q1 + u * rows;
      if (q < np) {
        if (out_cl) {
          Pack<T, W> out;
#pragma unroll
          for (int e = 0; e < W; ++e) out.set(e, yv[u][e]);
          out.st(y + cl + (long long)q * p.c);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            Pack<T, 1> out;
            out.set(0, yv[u][e]);
            out.st(y + nchw + (long long)e * p.hw + q);
          }
        }
      }
    }
  }
}

// A channels-last x whose slices (n, group) are small (chunk 0, the plan's
// choice for a batch of small slices): one block a slice, which it keeps in
// shared memory as it lies, runs of W channels of a pixel (W dividing Cg),
// consecutive threads on consecutive runs; the statistics from shared memory
// as the contiguous path takes them (a block's shuffle tree, the centred
// second moment), then the chain run by run, into y channels-last one store
// a run or contiguous element by element: one launch, x read once.
template <typename T, int W, bool SPADE>
__device__ __forceinline__ void groupnorm_cl_slice(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  constexpr int IN_FLIGHT = 64 / (W * (int)sizeof(T)) > 16 ? 16
                            : 64 / (W * (int)sizeof(T));  // 64 bytes of loads a thread
  const int tid = threadIdx.x;
  const long long n = blockIdx.x / p.groups;
  const int g = (int)(blockIdx.x - n * p.groups);
  const int runs = p.cg / W;               // runs a pixel
  const int nr = runs * (int)p.hw;         // runs of the slice
  const long long xy = n * p.hw * p.c + (long long)g * p.cg;  // in x, gamma, beta, y
  const long long nchw = (n * p.c + (long long)g * p.cg) * p.hw;  // in a contiguous y
  const T* xs = reinterpret_cast<const T*>(p.x) + xy;
  T* buf = reinterpret_cast<T*>(smem);
  float4* coef = reinterpret_cast<float4*>(smem + p.coef_off);
  load_raw_coefs<T>(p, coef, n, g * p.cg, p.cg);

  // 1. load (and keep) the slice, summing as it goes
  float acc = 0.f;
  for (int r0 = tid; r0 < nr; r0 += IN_FLIGHT * THREADS) {
    Pack<T, W> pk[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int r = r0 + u * THREADS;
      if (r < nr) {
        const int q = (int)fdiv(p.runs_div, (unsigned)r);
        pk[u].ldg(xs + (long long)q * p.c + (r - q * runs) * W);
      }
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int r = r0 + u * THREADS;
      if (r < nr) {
        pk[u].st(buf + (size_t)r * W);
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) t += pk[u].get(e);
        acc += t;
      }
    }
  }
  const float count = (float)p.cg * (float)p.hw;
  float mu = block_sum(acc, red) / count;

  // 2. the centred second moment
  float acc2 = 0.f;
  for (int r0 = tid; r0 < nr; r0 += UNROLL * THREADS) {
    float t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * THREADS;
      t[u] = 0.f;
      if (r < nr) {
        Pack<T, W> pk;
        pk.ld(buf + (size_t)r * W);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float d = __fsub_rn(pk.get(e), mu);
          t[u] = __fmaf_rn(d, d, t[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc2 += t[u];
  }
  float rstd = rsqrtf(block_sum(acc2, red) / count + p.eps);
  if (p.flags & IO) {  // ATen's bf16 group norm stores its statistics in bf16
    mu = bf16_round(mu);
    rstd = bf16_round(rstd);
  }
  make_coefs<T>(p, coef, p.cg, [&](int) { return make_float2(mu, rstd); });

  // 4. apply, two runs a thread at a time
  const bool affine = p.flags & AFFINE, emb = p.flags & EMB, silu = p.flags & SILU;
  const bool out_cl = p.flags & OUT_CL;
  T* y = reinterpret_cast<T*>(p.y);
  const T* gamma = reinterpret_cast<const T*>(p.gamma);
  const T* beta = reinterpret_cast<const T*>(p.beta);
  for (int r0 = tid; r0 < nr; r0 += 2 * THREADS) {
    Pack<T, W> v[2], ga[2], be[2];
    int q[2], j0[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * THREADS;
      if (r < nr) {
        q[u] = (int)fdiv(p.runs_div, (unsigned)r);
        j0[u] = (r - q[u] * runs) * W;
        v[u].ld(buf + (size_t)r * W);
        if constexpr (SPADE) {
          if (out_cl) {
            ga[u].ldg(gamma + xy + (long long)q[u] * p.c + j0[u]);
            be[u].ldg(beta + xy + (long long)q[u] * p.c + j0[u]);
          } else {
#pragma unroll
            for (int e = 0; e < W; ++e) {
              ga[u].set(e, load_f<T>(gamma, nchw + (long long)(j0[u] + e) * p.hw + q[u]));
              be[u].set(e, load_f<T>(beta, nchw + (long long)(j0[u] + e) * p.hw + q[u]));
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (r0 + u * THREADS < nr) {
        float yv[W];
#pragma unroll
        for (int e = 0; e < W; ++e) yv[e] = v[u].get(e);
        const float4* cj = coef + j0[u];
        const Pack<T, W>& gu = ga[u];
        const Pack<T, W>& bu = be[u];
        chain<T, W, SPADE>(
            yv, [&](int e) { return cj[e]; }, [&](int e) { return gu.get(e); },
            [&](int e) { return bu.get(e); }, affine, emb, silu);
        if (out_cl) {
          Pack<T, W> out;
#pragma unroll
          for (int e = 0; e < W; ++e) out.set(e, yv[e]);
          out.st(y + xy + (long long)q[u] * p.c + j0[u]);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            Pack<T, 1> out;
            out.set(0, yv[e]);
            out.st(y + nchw + (long long)(j0[u] + e) * p.hw + q[u]);
          }
        }
      }
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) groupnorm_cl_slice_fwd(const Params p) {
  groupnorm_cl_slice<T, W, false>(p);
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) groupnorm_cl_slice_spade_fwd(const Params p) {
  groupnorm_cl_slice<T, W, true>(p);
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) groupnorm_cl_fwd(const Params p) {
  groupnorm_cl_body<T, W, false>(p);
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) groupnorm_cl_spade_fwd(const Params p) {
  groupnorm_cl_body<T, W, true>(p);
}

template <typename T, int V, bool RESIDENT>
__global__ void __launch_bounds__(THREADS) groupnorm_fwd(const Params p) {
  groupnorm_nchw<T, V, RESIDENT, false>(p);
}

template <typename T, int V, bool RESIDENT>
__global__ void __launch_bounds__(THREADS) groupnorm_spade_fwd(const Params p) {
  groupnorm_nchw<T, V, RESIDENT, true>(p);
}

// The NCHW instantiation for the entry, dtype (0 float32, 1 bf16), vector
// width and residency, or null.
template <typename T, bool SPADE>
const void* pick_nchw_t(int vec, bool resident) {
  constexpr int VW = 16 / sizeof(T);
  if (vec != VW && vec != 1) return nullptr;
  if constexpr (SPADE) {
    if (vec == VW)
      return resident ? reinterpret_cast<const void*>(groupnorm_spade_fwd<T, VW, true>)
                      : reinterpret_cast<const void*>(groupnorm_spade_fwd<T, VW, false>);
    return resident ? reinterpret_cast<const void*>(groupnorm_spade_fwd<T, 1, true>)
                    : reinterpret_cast<const void*>(groupnorm_spade_fwd<T, 1, false>);
  } else {
    if (vec == VW)
      return resident ? reinterpret_cast<const void*>(groupnorm_fwd<T, VW, true>)
                      : reinterpret_cast<const void*>(groupnorm_fwd<T, VW, false>);
    return resident ? reinterpret_cast<const void*>(groupnorm_fwd<T, 1, true>)
                    : reinterpret_cast<const void*>(groupnorm_fwd<T, 1, false>);
  }
}

const void* pick_nchw(bool spade, int dtype, int vec, bool resident) {
  if (dtype == 0)
    return spade ? pick_nchw_t<float, true>(vec, resident) : pick_nchw_t<float, false>(vec, resident);
  if (dtype == 1)
    return spade ? pick_nchw_t<__nv_bfloat16, true>(vec, resident)
                 : pick_nchw_t<__nv_bfloat16, false>(vec, resident);
  return nullptr;
}

// The channels-last kernels for the entry, dtype and run width W: the
// statistics and apply kernels, and the one-block-a-slice kernel; nulls for
// another W.
struct ClKernels {
  const void* stats = nullptr;
  const void* apply = nullptr;
  const void* slice = nullptr;
};

template <typename T, int W>
ClKernels pick_cl_w(bool spade) {
  ClKernels k;
  k.stats = reinterpret_cast<const void*>(groupnorm_cl_stats<T, W>);
  k.apply = spade ? reinterpret_cast<const void*>(groupnorm_cl_spade_fwd<T, W>)
                  : reinterpret_cast<const void*>(groupnorm_cl_fwd<T, W>);
  k.slice = spade ? reinterpret_cast<const void*>(groupnorm_cl_slice_spade_fwd<T, W>)
                  : reinterpret_cast<const void*>(groupnorm_cl_slice_fwd<T, W>);
  return k;
}

template <typename T>
ClKernels pick_cl_t(bool spade, int run) {
  constexpr int VW = 16 / sizeof(T);
  if (run == VW) return pick_cl_w<T, VW>(spade);
  if (run == VW / 2) return pick_cl_w<T, VW / 2>(spade);
  if constexpr (VW == 8) {
    if (run == 2) return pick_cl_w<T, 2>(spade);
  }
  if (run == 1) return pick_cl_w<T, 1>(spade);
  return ClKernels{};
}

ClKernels pick_cl(bool spade, int dtype, int run) {
  if (dtype == 0) return pick_cl_t<float>(spade, run);
  if (dtype == 1) return pick_cl_t<__nv_bfloat16>(spade, run);
  return ClKernels{};
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
// Launch `fn` over `blocks` blocks with `smem` bytes of dynamic shared
// memory, in clusters of `cluster` blocks where that is more than one.
cudaError_t launch_on(const void* fn, long long blocks, size_t smem, int cluster, Params& p,
                      int device, void* stream) {
  cudaError_t err = allow_smem(fn, device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a lone block needs no cluster
  void* args[] = {&p};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Both entries' checks and launches; gamma and beta non-null for the SPADE entry.
int forward(bool spade, const void* x, void* y, const void* weight, const void* bias,
            const void* gamma, const void* beta, const void* scale, const void* shift,
            long long ss0, long long ss1, int n, int c, long long hw, int groups, float eps,
            int dtype, int flags, int cl, int run, int chunk, int splits, int pix, int vec,
            int resident, void* work, int device, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const int cg = groups > 0 ? c / groups : 0;
  if (n < 1 || c < 1 || hw < 1 || groups < 1 || c % groups != 0 ||
      (long long)cg * hw >= (1ll << 31) ||
      (flags & ~(AFFINE | EMB | SILU | IO | PARAMS_BF16 | OUT_CL)) != 0 ||
      ((flags & AFFINE) && !(weight && bias)) || ((flags & EMB) && !(scale && shift)) ||
      (spade && (!gamma || !beta || (flags & AFFINE))) || ((flags & OUT_CL) && !cl))
    return (int)cudaErrorInvalidValue;
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
  p.slices = (long long)n * groups;
  p.c = c;
  p.groups = groups;
  p.cg = cg;
  p.flags = flags;
  p.eps = eps;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;

  if (cl) {
    const uintptr_t align = (uintptr_t)(run * esize) - 1;
    const auto aligned = [&](const void* q) { return (reinterpret_cast<uintptr_t>(q) & align) == 0; };
    const ClKernels k = pick_cl(spade, dtype, run);
    if (k.stats == nullptr || chunk < 0 || !aligned(x) || ((flags & OUT_CL) && !aligned(y)) ||
        (spade && (flags & OUT_CL) && !(aligned(gamma) && aligned(beta))))
      return (int)cudaErrorInvalidValue;
    if (chunk == 0) {  // a block a slice, kept in shared memory
      const size_t data = (((size_t)cg * hw * esize + 15) & ~(size_t)15);
      const size_t smem = data + (size_t)cg * sizeof(float4);
      if (cg % run != 0 || smem > (size_t)SMEM_LIMIT || p.slices > 0x7fffffffll)
        return (int)cudaErrorInvalidValue;
      p.coef_off = (int)data;
      p.runs_div = make_div((unsigned)(cg / run));
      return (int)launch_on(k.slice, p.slices, smem, 1, p, device, stream);
    }
    const long long chunks = (hw + chunk - 1) / chunk;
    if (c % run != 0 || c / run > THREADS || (long long)n * chunks > 0x7fffffffll ||
        work == nullptr)
      return (int)cudaErrorInvalidValue;
    p.chunk = chunk;
    p.chunks = (int)chunks;
    p.work = work;
    const int rows = THREADS / (c / run);
    const size_t stats_smem = ((size_t)c + 2 * (size_t)rows * c) * sizeof(float);
    const size_t apply_smem = (size_t)c * sizeof(float4) + (size_t)groups * sizeof(float2);
    if (stats_smem > (size_t)SMEM_LIMIT || apply_smem > (size_t)SMEM_LIMIT)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = launch_on(k.stats, n * chunks, stats_smem, 1, p, device, stream);
    if (err == cudaSuccess) err = launch_on(k.apply, n * chunks, apply_smem, 1, p, device, stream);
    return (int)err;
  }

  const void* fn = pick_nchw(spade, dtype, vec, resident != 0);
  if (fn == nullptr || splits < 1 || splits > MAX_SPLITS || pix < 1 || pix % vec != 0 ||
      hw % vec != 0 || (long long)(splits - 1) * pix >= hw || (long long)splits * pix < hw ||
      (vec > 1 && !(aligned16(y) && aligned16(x))) ||
      (spade && vec > 1 && !(aligned16(gamma) && aligned16(beta))))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)splits * p.slices;
  const size_t data = resident ? (((size_t)cg * pix * esize + 15) & ~(size_t)15) : 0;
  const size_t smem = data + (size_t)cg * sizeof(float4);
  if (blocks > 0x7fffffffll || smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  p.splits = splits;
  p.pix = pix;
  p.coef_off = (int)data;
  p.vpr_div = make_div((unsigned)(pix / vec));
  p.vpr_last = make_div((unsigned)((hw - (long long)(splits - 1) * pix) / vec));
  return (int)launch_on(fn, blocks, smem, splits, p, device, stream);
}

}  // namespace

// x: an (n, c, hw) array of the dtype (0 float32, 1 bf16) on `device`,
// contiguous, or with cl (n, hw, c) (channels innermost); y: an array of the
// dtype not aliasing x, contiguous (n, c, hw), or with flag 64 (cl only)
// laid out as x. weight, bias: (c,) float32 or bf16 (flag 16) with flag 1,
// else null; scale, shift: (n, c) of the dtype with row strides ss0, ss1 and
// unit column stride with flag 2, else null. Flags: 1 affine, 2 scale and
// shift, 4 SiLU, 8 bf16 statistics (TVC_GN_BF16_IO), 16 bf16 weights, 64 y
// channels-last; any other is refused. The plan: with cl, `run` channels a
// load and store (a power of two of at most 16 bytes; x, and y with flag 64,
// aligned to it) and either `chunk` 0, one block a slice (n, group) kept in
// shared memory (run dividing c / groups), or `chunk` pixels a block of two
// kernels (run dividing c, at most 256 runs a pixel) and `work` a float32
// scratch array of 2 * n * ceil(hw / chunk) * groups; without cl, `splits`
// (1..16) blocks a slice (n, group) in one
// cluster, each `pix` pixels of every channel of the group (the last fewer,
// none empty), `vec` elements a load and store (1, or 16 bytes' worth: hw and
// pix multiples of it, x and y 16-byte aligned), `resident` 1 to keep the
// part in shared memory. Launches on `stream`, a stream of `device`, and
// does not synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int tvc_groupnorm_forward(const void* x, void* y, const void* weight, const void* bias,
                                     const void* scale, const void* shift, long long ss0,
                                     long long ss1, int n, int c, long long hw, int groups,
                                     float eps, int dtype, int flags, int cl, int run, int chunk,
                                     int splits, int pix, int vec, int resident, void* work,
                                     int device, void* stream) {
  return forward(false, x, y, weight, bias, nullptr, nullptr, scale, shift, ss0, ss1, n, c, hw,
                 groups, eps, dtype, flags, cl, run, chunk, splits, pix, vec, resident, work,
                 device, stream);
}

// The SPADE entry: as tvc_groupnorm_forward without the affine weights
// (flag 1 is refused), with gamma and beta, arrays of the dtype laid out as y
// (aligned as y's loads and stores), modulating the normalised value as
// y0 * (1 + gamma) + beta before the scale/shift and SiLU.
extern "C" int tvc_groupnorm_spade_forward(const void* x, void* y, const void* gamma,
                                           const void* beta, const void* scale,
                                           const void* shift, long long ss0, long long ss1,
                                           int n, int c, long long hw, int groups, float eps,
                                           int dtype, int flags, int cl, int run, int chunk,
                                           int splits, int pix, int vec, int resident,
                                           void* work, int device, void* stream) {
  return forward(true, x, y, nullptr, nullptr, gamma, beta, scale, shift, ss0, ss1, n, c, hw,
                 groups, eps, dtype, flags, cl, run, chunk, splits, pix, vec, resident, work,
                 device, stream);
}
