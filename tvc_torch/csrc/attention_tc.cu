// Fused multi-head attention in bf16 on Hopper's tensor cores (wgmma), for sm_90a.
//
// Replaces the TPU kernel `attention_pallas` (tvc/ops/pallas_attention.py:47,
// body `_attn_kernel` :34-44) for bf16 inputs: per (batch, head),
// o = softmax(q k^T d^-1/2) v, no mask, not causal; both products on the
// tensor cores with f32 accumulation, the softmax statistics in f32, the
// output stored in bf16. The float32 inputs take attention.cu (CUDA cores:
// the bitstream keeps TF32 off).
//
// The bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s), per launch at the
// flagship UNet's levels (d = 192, B = 1; 4 T^2 d H FLOP against 8 T d H
// bytes): 32x32 (T = 1024, H = 2) 1.61 GFLOP, 1.63 us, compute-bound; 16x16
// (T = 256, H = 3) 1.18 MB, 0.352 us, and 8x8 (T = 64, H = 4) 0.39 MB,
// 0.117 us, memory-bound; 6.41 us over one UNet call's 10 launches. At these
// sizes a launch is bound by its latency chain (the loads, two dependent
// products with the softmax between them, the join) on few SMs, not by the
// tensor cores' rate or the bytes.
//
// Design, point by point:
// 1. One warpgroup (128 threads) per block of BQ = 64 query rows: the M of
//    wgmma. S = Q K^T is wgmma.m64n64k16 from shared memory, Q (64 x dp) and
//    the key tile (64 x dp) both K-major in the 128-byte-swizzled layout the
//    descriptors name (64-column blocks of 64 rows x 128 B; 16-byte chunk c
//    of row r at c ^ (r % 8)); dp is d rounded up to 64, zero past d. A
//    bf16 x bf16 product is exact in f32, so only the order of the sums
//    differs from the float32 kernel.
// 2. The online softmax runs in the S accumulator: a thread holds 16 scores
//    of each of two rows; the row max and sum go through the quad's
//    shuffles; exp2f on log2-scaled scores; the output accumulator is
//    rescaled in registers.
// 3. O += P V is wgmma.m64n64k16 with A = P from registers (the f32
//    accumulator layout of step 1 is the A-fragment layout) and B = the V
//    tile, stored [keys][d] like the key tile, read MN-major through the
//    transpose bit; one product per 64 output columns. P keeps about 16
//    bits: it is split into hi = bf16(P) and lo = bf16(P - hi), two products
//    into the same accumulator (the float32 kernel and attention_pallas keep
//    P in f32; one rounding would move the output by up to a bf16 ulp).
//    TERMS = 1 is the one-rounding variant, built only to time it.
// 4. Tiles of 64 keys copied by cp.async 16-byte copies, zero-filled past
//    the split's last key and past d: key tiles in a 2-stage ring (key tile
//    j + 1 is copied while tile j is computed), value tiles in one buffer
//    (value tile j + 1 is copied while key tile j + 1's S and softmax run).
//    The wrapper hands in rows whose 16-byte chunks are aligned (it copies a
//    view that is not, and pads d to a multiple of 8), so every load is a
//    16-byte copy.
// 5. Key splits inside a thread-block cluster, as in attention.cu: each
//    block keeps (m, l, acc) for its key range in its own shared memory;
//    after cluster.sync() rank r joins rows [r BQ / S, (r + 1) BQ / S) over
//    the ranks' partials through distributed shared memory, in rank order.
//    No atomics, no workspace. The plan (`attention_plan`,
//    tvc_torch/ops/attention.py) is a function of the shape and dtype alone.
// 6. Shared memory at d = 192: Q 24 KB, the key ring 48 KB, the value tile
//    24 KB: two blocks an SM, so that one block's products run while the
//    other waits on its softmax, loads or barriers. The output's f32
//    partials reuse the key ring and value tile after the last tile.
//
// Reruns are bit-identical: the split of the keys, the order of the
// products (ascending d in S, ascending keys and hi before lo in P V, each
// wgmma's own fixed order), the quad's shuffle sums and the join's rank
// order depend on the shape alone.

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
constexpr int THREADS = 128;      // one warpgroup
constexpr int BQ = 64;            // query rows per block: the M of wgmma
constexpr int BK = 64;            // keys per shared-memory tile: the N of S
constexpr int MAX_SPLITS = 8;     // the portable cluster size
constexpr int BLOCK_BYTES = 64 * 128;  // 64 rows x 64 bf16 columns, one swizzle block

struct Strides {
  long long b[4], h[4], r[4];  // batch, head and row strides (elements) of q, k, v, o
};

// Bytes a 64-row tile of nb 64-column blocks takes, and the shared memory of
// a block: 1 KB to align the tiles to the swizzle's 1024 bytes, Q, the two
// key tiles, the value tile, then m, l and the join weights.
__host__ __device__ constexpr int tile_bytes(int nb) { return nb * BLOCK_BYTES; }
size_t smem_bytes(int nb) {
  return 1024 + 4 * (size_t)tile_bytes(nb) + sizeof(float) * (2 + MAX_SPLITS) * BQ;
}

// Offset of the 16-byte chunk (row r, columns 8c .. 8c + 7) in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)((c >> 3) * BLOCK_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Copies written through the generic proxy, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of a (rows, dq) bf16 matrix with row stride rs into the
// swizzled tile at dst; rows at or past rlim and columns at or past dq are zero.
template <int NB>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long rs,
                                          int r0, int rlim, int dq) {
  constexpr int CPR = 8 * NB;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = threadIdx.x; i < 64 * CPR; i += THREADS) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r0 + r < rlim && 8 * c < dq;
    cp_async16(dst + swizzled(r, c), ok ? src + (r0 + r) * rs + 8 * c : src, ok);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching accumulator registers across the
// asynchronous products: reads come after the wait, writes before the fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

#define TVC_ACC32(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TVC_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TVC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TVC_ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TVC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TVC_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Store the first n (<= 8) of the 8 values (x, y) at p as bf16; vec: all 8,
// one 16-byte store.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float4& x, const float4& y, int n,
                                       bool vec) {
  const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  if (vec) {
    uint4 u;
    u.x = bf16x2_bits(__floats2bfloat162_rn(f[0], f[1]));
    u.y = bf16x2_bits(__floats2bfloat162_rn(f[2], f[3]));
    u.z = bf16x2_bits(__floats2bfloat162_rn(f[4], f[5]));
    u.w = bf16x2_bits(__floats2bfloat162_rn(f[6], f[7]));
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) p[e] = __float2bfloat16(f[e]);
  }
}

// grid (S, ceil(t / BQ), b * h), cluster (S, 1, 1): block x of the cluster
// takes keys [x * kps, min(t, (x + 1) * kps)) of query tile y of head z.
// Warp w owns query rows 16w + lane / 4 and 16w + lane / 4 + 8 of the tile.
// NB: 64-column blocks of the padded head dim; TERMS: products a P V step (2:
// P as bf16 hi + lo, 1: P rounded once).
template <int NB, int TERMS>
__global__ void __launch_bounds__(THREADS, 2)
attention_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides st,
             int h, int t, int d, int kps, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int TILE = tile_bytes(NB);
  constexpr int ACC_LD = 64 * NB + 4;  // row stride (floats) of the f32 partial output
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t qa = smem_addr(smem);  // Q tile
  const uint32_t ka = qa + TILE;        // 2 key tiles
  const uint32_t va = ka + 2 * TILE;    // the value tile
  float* accs = reinterpret_cast<float*>(smem + TILE);  // after the loop, over K and V
  float* ms = reinterpret_cast<float*>(smem + 4 * TILE);
  float* ls = ms + BQ;
  float* ws = ls + BQ;  // MAX_SPLITS x BQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.x;  // == cluster.block_rank()
  const int nsplit = gridDim.x;  // == cluster.num_blocks()
  const int q0 = blockIdx.y * BQ;
  const int bi = blockIdx.z / h, hi = blockIdx.z - bi * h;
  q += bi * st.b[0] + hi * st.h[0];
  k += bi * st.b[1] + hi * st.h[1];
  v += bi * st.b[2] + hi * st.h[2];
  o += bi * st.b[3] + hi * st.h[3];
  const int kbeg = split * kps;
  const int kend = min(t, kbeg + kps);
  const int ntiles = (kend - kbeg + BK - 1) / BK;
  const int dq = (d + 7) & ~7;  // columns of the q, k and v rows (zero past d)
  const float scale_log2 = scale * 1.4426950408889634f;  // scores in log2 units: exp2 below

  // copy groups, in commit order: (Q, K 0), V 0, then K j + 1 and V j + 1 in iteration j
  load_tile<NB>(qa, q, st.r[0], q0, t, dq);
  load_tile<NB>(ka, k, st.r[1], kbeg, kend, dq);
  cp_async_commit();
  load_tile<NB>(va, v, st.r[2], kbeg, kend, dq);
  cp_async_commit();

  // accumulator element i of this thread: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (lane % 4) + i % 2 of its 64-column block
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.0f, 0.0f};
  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < ntiles;
    cp_async_wait<1>();  // key tile `it` has landed (value tile `it` may not have)
    fence_proxy_async();
    __syncthreads();  // ... for every thread; every warp is done with key tile it - 1
    if (more) {
      load_tile<NB>(ka + (buf ^ 1) * TILE, k, st.r[1], kbeg + (it + 1) * BK, kend, dq);
      cp_async_commit();
    }

    // S = Q K^T, 16 columns of d a product: within a 64-column block the
    // descriptor steps 32 bytes, between blocks a whole block.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk / 4) * BLOCK_BYTES + (kk % 4) * 32;
      wgmma_ss(s, descriptor(qa + off, 16, 1024), descriptor(ka + buf * TILE + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Online softmax of this thread's two rows over the tile's keys; keys
    // past the split's end (zero-filled rows) are masked.
    const int key0 = kbeg + it * BK + 2 * (lane % 4);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = (key0 + 8 * (i / 4) + i % 2 < kend) ? s[i] * scale_log2 : -INFINITY;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);  // finite: every tile has a key before kend
      alpha[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
      l_row[r] *= alpha[r];
    }
    // P = exp2(s - m) in f32, as bf16 hi (+ lo) pairs in the A-fragment
    // layout: register 4 kk + e of the k-step over keys 16 kk .. 16 kk + 15
    // holds accumulator elements 8 kk + 2 e and 8 kk + 2 e + 1.
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      const float p0 = exp2f(s[i] - m_row[r]);
      const float p1 = exp2f(s[i + 1] - m_row[r]);
      l_row[r] += p0;
      l_row[r] += p1;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
      p_hi[i / 2] = bf16x2_bits(h2);
      p_lo[i / 2] = bf16x2_bits(
          __floats2bfloat162_rn(p0 - __low2float(h2), p1 - __high2float(h2)));
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i / 2) % 2];

    // O += P V: B is the V tile read MN-major, 16 keys (two 8-row groups,
    // 1024 bytes apart) a product, 64 output columns (one block) a product.
    if (more) {
      cp_async_wait<1>();  // value tile `it` has landed (key tile it + 1 may not have)
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint64_t dv = descriptor(va + j * BLOCK_BYTES + kk * 2048, BLOCK_BYTES, 1024);
        wgmma_rs(acc[j], p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3], dv);
        if (TERMS == 2)
          wgmma_rs(acc[j], p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3],
                   dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
    if (more) {
      __syncthreads();  // every warp is done with value tile `it`
      load_tile<NB>(va, v, st.r[2], kbeg + (it + 1) * BK, kend, dq);
      cp_async_commit();
    }
  }

  // Leave this split's partials in shared memory: acc (BQ x dp f32) over the
  // key and value tiles, m and l of each row (l summed over the quad).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(FULL, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(FULL, l_row[r], 2);
  }
  __syncthreads();  // every warp is done with the key and value tiles
  const int row0 = 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(accs + (row0 + 8 * ((i / 2) % 2)) * ACC_LD + 64 * j +
                                 8 * (i / 4) + 2 * (lane % 4)) =
          make_float2(acc[j][i], acc[j][i + 1]);
  if (lane % 4 == 0) {
    ms[row0] = m_row[0];
    ms[row0 + 8] = m_row[1];
    ls[row0] = l_row[0];
    ls[row0 + 8] = l_row[1];
  }
  cluster.sync();

  // Join rows [lo, hi) of the query tile over the splits, in rank order.
  const int lo = split * BQ / nsplit, hi_row = (split + 1) * BQ / nsplit;
  if ((int)threadIdx.x < hi_row - lo) {
    const int r = lo + threadIdx.x;
    float m[MAX_SPLITS], l[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < nsplit) {
        m[sp] = cluster.map_shared_rank(ms, sp)[r];
        l[sp] = cluster.map_shared_rank(ls, sp)[r];
      }
    }
    float mmax = -INFINITY;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < nsplit) mmax = fmaxf(mmax, m[sp]);
    float lsum = 0.0f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < nsplit) {
        m[sp] = exp2f(m[sp] - mmax);
        lsum += m[sp] * l[sp];
      }
    }
    const float inv = 1.0f / lsum;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < nsplit) ws[sp * BQ + r] = m[sp] * inv;
  }
  __syncthreads();
  const int nc = (d + 7) / 8;  // 8-column chunks of an output row
  const bool vec = d % 8 == 0;
  for (int idx = threadIdx.x; idx < (hi_row - lo) * nc; idx += THREADS) {
    const int r = lo + idx / nc;
    const int c = idx - (r - lo) * nc;
    float4 a[MAX_SPLITS][2];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < nsplit) {
        const float4* p = reinterpret_cast<const float4*>(cluster.map_shared_rank(accs, sp) +
                                                          r * ACC_LD + 8 * c);
        a[sp][0] = p[0];
        a[sp][1] = p[1];
      }
    }
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < nsplit) {
        const float w = ws[sp * BQ + r];
        fma4(s0, w, a[sp][0]);
        fma4(s1, w, a[sp][1]);
      }
    }
    const int row = q0 + r;
    if (row < t) store8(o + row * st.r[3] + 8 * c, s0, s1, min(8, d - 8 * c), vec);
  }
  cluster.sync();  // keep this block's shared memory until the cluster has read it
}

// The instantiation for head dim d (and TERMS products a P V step), or null.
const void* pick(int d, int terms) {
  if (d <= 0 || d > 256) return nullptr;
  const int nb = (d + 63) / 64;
  if (terms == 1) return nb == 3 ? reinterpret_cast<const void*>(attention_tc<3, 1>) : nullptr;
  if (terms != 2) return nullptr;
  switch (nb) {
    case 1: return reinterpret_cast<const void*>(attention_tc<1, 2>);
    case 2: return reinterpret_cast<const void*>(attention_tc<2, 2>);
    case 3: return reinterpret_cast<const void*>(attention_tc<3, 2>);
    default: return reinterpret_cast<const void*>(attention_tc<4, 2>);
  }
}

// Raise the dynamic shared memory limit of `fn` on device `dev`, once.
cudaError_t allow_smem(const void* fn, int d, int dev) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, dev})) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes((d + 63) / 64));
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

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int b, int h, int t, int d,
                   int splits, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(splits, (t + BQ - 1) / BQ, b * h);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem_bytes((d + 63) / 64);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Whether `splits` ranges of `kps` keys cover [0, t) with none empty.
bool valid_splits(int t, int splits, int kps) {
  return splits >= 1 && splits <= MAX_SPLITS && kps > 0 && kps % BK == 0 &&
         (long long)(splits - 1) * kps < t && (long long)splits * kps >= t;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q, k, v: bf16 (b, h, t, ceil8(d)) arrays on `device` with unit last
// stride, 16-byte-aligned bases and batch, head and row strides that are
// multiples of 8, zero in the columns past d; o: bf16 (b, h, t, d), under
// the same rule when d is a multiple of 8. strides[0..11] are the batch,
// head and row strides (in elements) of q, k, v and o, in that order. The
// keys are cut into `splits` (1..8) ranges of kps keys (a multiple of 64),
// none empty, one cluster block each. terms: 2 (P as bf16 hi + lo), or 1 (P
// rounded once; d in 129..192 only). Launches on `stream`, a stream of
// `device`, and does not synchronise. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int tvc_attention_tc_forward(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int b, int h, int t, int d,
                                        float scale, int splits, int kps, int terms, int device,
                                        void* stream) {
  const void* fn = pick(d, terms);
  if (fn == nullptr || t <= 0 || !valid_splits(t, splits, kps) || b <= 0 || h <= 0 ||
      (long long)b * h > 65535 || (t + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st;
  bool ok = aligned16(q) && aligned16(k) && aligned16(v) && (d % 8 != 0 || aligned16(o));
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[3 * i];
    st.h[i] = strides[3 * i + 1];
    st.r[i] = strides[3 * i + 2];
    if (i < 3 || d % 8 == 0) ok = ok && st.b[i] % 8 == 0 && st.h[i] % 8 == 0 && st.r[i] % 8 == 0;
  }
  if (!ok) return (int)cudaErrorMisalignedAddress;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = allow_smem(fn, d, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, b, h, t, d, splits, static_cast<cudaStream_t>(stream));
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, &o, &st, &h, &t, &d, &kps, &scale};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What a launch at head dim d takes, for reports: info[0] dynamic shared
// memory bytes a block, info[1] how many clusters of `splits` blocks the
// current device can hold at once.
extern "C" int tvc_attention_tc_kernel_info(int d, int splits, int* info) {
  const void* fn = pick(d, 2);
  if (fn == nullptr || splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_smem(fn, d, dev);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, 1, 1, BQ, d, splits, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)cfg.dynamicSmemBytes;
  info[1] = clusters;
  return 0;
}
