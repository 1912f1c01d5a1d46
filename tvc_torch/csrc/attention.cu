// Fused multi-head attention for the NCSN++ attention blocks in float32, for sm_90a.
//
// Replaces the TPU kernel `attention_pallas` (tvc/ops/pallas_attention.py:47,
// body `_attn_kernel` :34-44) for float32 inputs: per (batch, head),
// o = softmax(q k^T d^-1/2) v, no mask, not causal; all arithmetic is f32
// FMAs on the CUDA cores (no TF32: the bitstream needs full f32). bf16 inputs
// take the tensor-core kernel of attention_tc.cu.
//
// The bound on an H100 SXM (67 TFLOP/s f32, 3.35 TB/s), per launch at the
// flagship UNet's levels (d = 192, B = 1, f32; 4 T^2 d H FLOP against 16 T d H
// bytes): 32x32 (T = 1024, H = 2) 1.61 GFLOP, 24.0 us, compute-bound; 16x16
// (T = 256, H = 3) 0.151 GFLOP, 2.25 us, compute-bound; 8x8 (T = 64, H = 4)
// 0.79 MB, 0.235 us, memory-bound. Summed over one UNet call (3 + 3 + 4
// launches) 79.6 us. What bounds this kernel is the SM, not memory: every FMA
// takes an operand from shared memory, so a 64 x 32 tile of scores and its
// p.v step run at the rate the SM can dispatch FMAs and serve 16-byte shared
// loads (both about two thirds busy, PERF.md), and the small levels run on
// few SMs and pay the fixed cost of a launch, the first loads and the join.
//
// Design, point by point:
// 1. Register-tiled micro-tiles fed by 16-byte shared loads. A block is 8
//    warps on BQ = 64 query rows; warp w owns rows 8w .. 8w + 7 in both
//    products. q.k: lane (kb, g) sums the 8 rows x 8 keys (key block kb) over
//    its slice g of d (float4 chunks g, g + 8, ...): 16 LDS.128 per 256 FMAs;
//    a tree of shuffles over the 8 slices (lanes g ^ 4, ^ 2, ^ 1) leaves lane
//    g with row g's 8 scores. p.v: lane (rh, cx) owns rows 4 rh .. 4 rh + 3 x
//    the float4 column chunks cx + 16 c (48 accumulators at d = 192): 16
//    LDS.128 per 192 FMAs. The Q and K rows are whole groups of 8 float4s, so
//    the 8 lanes of a slice read 8 distinct banks; the P rows are 9 float4s.
//    ptxas: about 240 registers a thread at d = 192, no spills.
// 2. Asynchronous, double-buffered K/V tiles of 32 keys. Q is loaded once per
//    block; key tile j + 1 is copied with cp.async (16 B a thread,
//    zero-filled past the split's last key, which masks the ragged tile)
//    while tile j is computed. One __syncthreads a tile; a warp reads only
//    the P rows it wrote, so P needs only __syncwarp. Unaligned inputs take
//    the same kernel with plain loads, one element at a time. Q, K, V and P
//    take 155 KB of shared memory at d = 192: one block an SM.
// 3. Key splits inside a thread-block cluster. The S <= 8 blocks of a query
//    tile form a cluster along the keys; each runs the online softmax (f32
//    running max and sum, rescaled accumulator) over its key range and leaves
//    (m, l, acc) in its own shared memory. After cluster.sync(), rank r joins
//    rows [r BQ / S, (r + 1) BQ / S): it reads the partials of ranks
//    0 .. S - 1 through distributed shared memory, always in rank order,
//    scales each by exp(m_s - M) / L and writes the output. One launch, no
//    workspace in device memory, no atomics. S comes from `attention_plan`
//    (tvc_torch/ops/attention.py), a function of the shape and dtype alone,
//    never of the SM count: at 32x32 and B = 1, 16 query tiles x 2 heads x
//    S = 3 = 96 blocks of 352 keys, which fit on the card in one wave.
// 4. Strided heads in, strided heads out. The kernel takes the batch, head
//    and row strides of q, k, v and o (unit last stride), so the attention
//    block passes views of its (B, T, C) projections and gets its (B, T, C)
//    output back as a view: no copy kernels around the launch.
// 5. Host side. The dynamic shared memory limit is raised once per kernel
//    instantiation and device, not per launch.
//
// Reruns are bit-identical: the split of the keys, the order of every sum
// inside a block (ascending d within a slice, a fixed shuffle tree over the
// slices and over the 4 lanes of a row, ascending keys in p.v) and the order
// of the join (rank 0 first) depend on the shape alone, and nothing is
// accumulated with atomics. A sender and a receiver that run the same plan on
// the same inputs get the same bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;      // 8 warps
constexpr int BQ = 64;            // query rows per block: 8 rows a warp
constexpr int BK = 32;            // keys per shared-memory tile
constexpr int TX = 16;            // p.v: column lanes of a half-warp
constexpr int LDP = BK + 4;       // P row stride: 9 float4s, odd
constexpr int MAX_SPLITS = 8;     // the portable cluster size

struct Strides {
  long long b[4], h[4], r[4];  // batch, head and row strides (elements) of q, k, v, o
};

__host__ __device__ inline int padded_dim(int d) { return (d + 3) & ~3; }
// Row stride of the Q and K tiles: whole groups of 8 float4s (the 8 lanes
// that split d), zero past d. A multiple of 8 float4s: the 8 lanes of a d
// split read 8 consecutive float4s, which fall in distinct banks.
__host__ __device__ inline int qk_stride(int d) { return 32 * ((d + 31) / 32); }
// Row stride of the V tile: whole chunks of 16 float4s, so that the p.v loop
// reads every chunk a lane owns without a bounds test (columns past d are
// never stored).
__host__ __device__ inline int v_stride(int d) { return 4 * TX * ((d + 4 * TX - 1) / (4 * TX)); }

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * qk_stride(d) + 2 * (size_t)BK * v_stride(d) +
                          (size_t)BQ * LDP);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [r0, r0 + NROWS) of a (rows, d) matrix with row stride rs into
// shared memory, row stride ld. Rows at or past rlim and columns in [d, dp)
// are zero. vec: d, the strides and the pointer allow 16-byte loads (then
// d == dp); a half-warp copies 16 consecutive 16-byte chunks of a row, at
// most NC4 chunks a lane, through cp.async. Otherwise one element at a time.
template <int NROWS, int NC4>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, long long rs,
                                           int r0, int rlim, int d, int dp, bool vec) {
  if (vec) {
    constexpr int E = 4;  // elements per 16 bytes
    const int c0 = (threadIdx.x % TX) * E;
#pragma unroll
    for (int n = 0; n < NROWS / (THREADS / TX); ++n) {
      const int r = threadIdx.x / TX + (THREADS / TX) * n;
      const bool ok = r0 + r < rlim;
      const float* g = src + (ok ? (r0 + r) * rs : 0);
      float* s = dst + r * ld;
#pragma unroll
      for (int m = 0; m < (NC4 * 4 + E - 1) / E; ++m) {
        const int c = c0 + TX * E * m;
        if (c >= d) break;
        cp_async16(s + c, g + c, ok);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < NROWS * dp; idx += THREADS) {
      const int r = idx / dp;
      const int c = idx - r * dp;
      dst[r * ld + c] = (r0 + r < rlim && c < d) ? src[(r0 + r) * rs + c] : 0.0f;
    }
  }
}

// Store the first n (<= 4) values of x at p; vec: all 4, as one 16-byte store.
__device__ __forceinline__ void store4(float* p, float4 x, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    p[0] = x.x;
    if (n > 1) p[1] = x.y;
    if (n > 2) p[2] = x.z;
    if (n > 3) p[3] = x.w;
  }
}

__device__ __forceinline__ float comp(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// grid (S, ceil(t / BQ), b * h), cluster (S, 1, 1): block x of the cluster
// takes keys [x * kps, min(t, (x + 1) * kps)) of query tile y of head z.
// Warp w owns query rows 8w .. 8w + 7 of the tile in both products.
template <int NC4>
__global__ void __launch_bounds__(THREADS, 1)
attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides st, int h, int t, int d,
              int kps, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int dp = padded_dim(d), dp4 = dp / 4;
  const int ld = qk_stride(d), ld4 = ld / 4;
  constexpr int VLD = 4 * TX * NC4, VLD4 = VLD / 4;
  float* qs = smem;               // BQ x ld
  float* ks = qs + BQ * ld;       // 2 x BK x ld
  float* vs = ks + 2 * BK * ld;   // 2 x BK x VLD
  float* ps = vs + 2 * BK * VLD;  // BQ x LDP

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0w = 8 * warp;  // the warp's first query row
  // q.k: lane = (key block kb of 8 keys, slice g of d: float4 chunks g, g + 8, ...)
  const int kb = lane / 8, g = lane % 8;
  // p.v: lane = (row half rh: rows r0w + 4 rh + i, column lane cx: chunks cx + 16 c)
  const int rh = lane / TX, cx = lane % TX;

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
  const bool vc = vec != 0;
  const float scale_log2 = scale * 1.4426950408889634f;  // scores in log2 units: exp2 below

  // Columns [dp, ld) of the Q and K tiles stay zero; the copies below never write them.
  for (int idx = threadIdx.x; idx < (BQ + 2 * BK) * (ld - dp); idx += THREADS) {
    const int r = idx / (ld - dp);
    qs[r * ld + dp + idx - r * (ld - dp)] = 0.0f;
  }
  stage_rows<BQ, NC4>(qs, ld, q, st.r[0], q0, t, d, dp, vc);
  stage_rows<BK, NC4>(ks, ld, k, st.r[1], kbeg, kend, d, dp, vc);
  stage_rows<BK, NC4>(vs, VLD, v, st.r[2], kbeg, kend, d, dp, vc);
  cp_async_commit();

  float m_row = -INFINITY, l_row = 0.0f;  // row r0w + g, over this lane's keys
  float4 acc[4][NC4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c) acc[i][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    if (it + 1 < ntiles) {
      const int k1 = kbeg + (it + 1) * BK;
      stage_rows<BK, NC4>(ks + (buf ^ 1) * BK * ld, ld, k, st.r[1], k1, kend, d, dp, vc);
      stage_rows<BK, NC4>(vs + (buf ^ 1) * BK * VLD, VLD, v, st.r[2], k1, kend, d, dp, vc);
      cp_async_commit();
    }

    // S = Q K^T: each lane sums an 8 x 8 block (the warp's rows x key block kb)
    // over its slice of d, 16 LDS.128 per 256 FMAs. Lane g keeps row i ^ g in
    // s[i], so that the sum over the slices below needs no selects.
    const float4* q4 = reinterpret_cast<const float4*>(qs) + r0w * ld4 + g;
    const float4* k4 = reinterpret_cast<const float4*>(ks + buf * BK * ld) + 8 * kb * ld4 + g;
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < ld / 32; ++kk) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = q4[(i ^ g) * ld4 + 8 * kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = k4[j * ld4 + 8 * kk];
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = dot4(a[i], b, s[i][j]);
      }
    }

    // Add the 8 slices (lanes g ^ 4, g ^ 2, g ^ 1) and scatter the rows: lane g
    // keeps rows i ^ g for i < 4, 2, 1 and receives the same rows from its
    // partner, which holds them at i + 4, 2, 1. Lane g ends with row r0w + g,
    // keys 8 kb .. 8 kb + 7, each summed in a fixed tree.
    float s4[4][8], s2[2][8], row[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s4[i][j] = s[i][j] + __shfl_xor_sync(FULL, s[i + 4][j], 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s2[i][j] = s4[i][j] + __shfl_xor_sync(FULL, s4[i + 2][j], 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) row[j] = s2[0][j] + __shfl_xor_sync(FULL, s2[1][j], 1);

    // Online softmax of row r0w + g: its 32 keys lie in lanes g, g + 8, g + 16,
    // g + 24. l_row keeps this lane's partial sum; the four are added once,
    // after the last tile.
    const int key0 = kbeg + it * BK + 8 * kb;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row[j] = (key0 + j < kend) ? row[j] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, row[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
    const float m_new = fmaxf(m_row, mx);  // finite: key it * BK < kend is in every tile
    const float alpha = exp2f(m_row - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row[j] = exp2f(row[j] - m_new);
      rs += row[j];
    }
    float4* prow = reinterpret_cast<float4*>(ps + (r0w + g) * LDP + 8 * kb);
    prow[0] = make_float4(row[0], row[1], row[2], row[3]);
    prow[1] = make_float4(row[4], row[5], row[6], row[7]);
    l_row = l_row * alpha + rs;
    m_row = m_new;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = __shfl_sync(FULL, alpha, 4 * rh + i);  // alpha of row r0w + 4 rh + i
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        acc[i][c].x *= al;
        acc[i][c].y *= al;
        acc[i][c].z *= al;
        acc[i][c].w *= al;
      }
    }
    __syncwarp();  // a warp reads only the P rows it wrote

    // O += P V: keys past the split's end have p = 0 and zero-filled V rows.
    const float4* p4 = reinterpret_cast<const float4*>(ps) + (r0w + 4 * rh) * (LDP / 4);
    const float4* v4 = reinterpret_cast<const float4*>(vs + buf * BK * VLD) + cx;
#pragma unroll
    for (int n4 = 0; n4 < BK / 4; ++n4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p4[i * (LDP / 4) + n4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vv[NC4];
#pragma unroll
        for (int c = 0; c < NC4; ++c) vv[c] = v4[(4 * n4 + e) * VLD4 + TX * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = comp(pv[i], e);
#pragma unroll
          for (int c = 0; c < NC4; ++c) fma4(acc[i][c], pe, vv[c]);
        }
      }
    }
  }

  // Leave this split's partials in shared memory: acc (BQ x dp) over the K/V
  // tiles, m and l of each row and the join weights over the P tile.
  l_row += __shfl_xor_sync(FULL, l_row, 8);
  l_row += __shfl_xor_sync(FULL, l_row, 16);
  __syncthreads();  // every warp is done with the K/V and P tiles
  float* accs = ks;
  float* ms = ps;
  float* ls = ps + BQ;
  float* ws = ps + 2 * BQ;  // MAX_SPLITS x BQ
  if (kb == 0) {
    ms[r0w + g] = m_row;
    ls[r0w + g] = l_row;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c)
      if (cx + TX * c < dp4)
        reinterpret_cast<float4*>(accs + (r0w + 4 * rh + i) * dp)[cx + TX * c] = acc[i][c];
  cluster.sync();

  // Join rows [lo, hi) of the query tile over the splits, in rank order. The
  // remote reads of all splits are started before the sums use them, so their
  // latencies overlap.
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
  for (int idx = threadIdx.x; idx < (hi_row - lo) * dp4; idx += THREADS) {
    const int r = lo + idx / dp4;
    const int c4 = idx - (r - lo) * dp4;
    float4 a[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < nsplit)
        a[sp] = reinterpret_cast<const float4*>(cluster.map_shared_rank(accs, sp) + r * dp)[c4];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < nsplit) fma4(sum, ws[sp * BQ + r], a[sp]);
    const int row = q0 + r;
    if (row < t) store4(o + row * st.r[3] + 4 * c4, sum, min(4, d - 4 * c4), vc);
  }
  cluster.sync();  // keep this block's shared memory until the cluster has read it
}

// The instantiation for head dim d, or null if there is none.
const void* pick(int d) {
  if (d <= 0 || d > 4 * 4 * TX) return nullptr;
  switch (v_stride(d) / (4 * TX)) {
    case 1: return reinterpret_cast<const void*>(attention_fwd<1>);
    case 2: return reinterpret_cast<const void*>(attention_fwd<2>);
    case 3: return reinterpret_cast<const void*>(attention_fwd<3>);
    default: return reinterpret_cast<const void*>(attention_fwd<4>);
  }
}

// Raise the dynamic shared memory limit of `fn` on the current device `dev`
// to what its largest head dim needs, once per device.
cudaError_t allow_smem(const void* fn, int d, int dev) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, dev})) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes(v_stride(d)));
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
  cfg->dynamicSmemBytes = smem_bytes(d);
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

// q, k, v, o: float32 (b, h, t, d) arrays on `device` with unit last stride;
// strides[0..11] are the batch, head and row strides (in elements) of q, k, v
// and o, in that order. The keys are cut into `splits` (1..8) ranges of kps keys (a multiple of 32), none empty,
// one cluster block each. Launches on `stream`, a stream of `device`, and
// does not synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int tvc_attention_forward(const void* q, const void* k, const void* v, void* o,
                                     const long long* strides, int b, int h, int t, int d,
                                     float scale, int splits, int kps, int device, void* stream) {
  const void* fn = pick(d);
  if (fn == nullptr || t <= 0 || !valid_splits(t, splits, kps) || b <= 0 || h <= 0 ||
      (long long)b * h > 65535 || (t + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st;
  const int e = 4;  // elements per 16 bytes
  bool vec = d % e == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[3 * i];
    st.h[i] = strides[3 * i + 1];
    st.r[i] = strides[3 * i + 2];
    vec = vec && st.b[i] % e == 0 && st.h[i] % e == 0 && st.r[i] % e == 0;
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = allow_smem(fn, d, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, b, h, t, d, splits, static_cast<cudaStream_t>(stream));
  int ivec = vec ? 1 : 0;
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, &o, &st, &h, &t, &d, &kps, &scale, &ivec};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What a launch of the instantiation for d takes, for reports:
// info[0] dynamic shared memory bytes a block, info[1] how many clusters of
// `splits` blocks the current device can hold at once.
extern "C" int tvc_attention_kernel_info(int d, int splits, int* info) {
  const void* fn = pick(d);
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
