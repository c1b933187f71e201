// Paired self-attention kernels for Hopper (sm_90a), plain C interface.
//
// paired_attention replaces `_paired_attn_kernel` via `paired_attention`
// (lattice_tpu/ops/attention.py:42, :71). For batch row b, head h and
// query i, over q/k/v [B, L, H*64] in their native layout (head h in
// columns [64h, 64h + 64); each operand with its own row and batch
// strides, so that the three column slices of a fused [B, L, 3W] QKV
// projection come in without a copy):
//   s[i, j] = f32 dot(q[b, i, h], k[b, j, h]) * sm_scale + neg[b, j]
//   neg = 0 where mask > 0, else -1e9 (additive, as the reference)
//   ctx[b, i, h] = (round_T(p) @ v[b, :, h]) / sum_j p,  p = exp(s - max s)
// written as f32 [B, L, H*64] in the same layout. A row whose keys are all
// masked sees equal scores (-1e9 absorbs a unit-scale score in f32) and
// comes out as the mean of V, finite, as in the reference.
//
// What bounds the bf16 kernel (the serving path) on the H100, at the
// encoder's shape (B=128, L=512, H=12, every key live):
// - bytes: bf16 q/k/v and the int32 mask read once, the f32 context
//   written once: 0.50 GB, 0.1503 ms at 3.35 TB/s;
// - operations: 4*B*H*L^2*64 = 103 GFLOP, 0.1042 ms at 989 TFLOP/s;
// - exps: B*H*L^2 = 402.7 M, ~0.11 ms at 16 a clock on each of 132 SMs,
//   as much as the products, so the softmax must hide behind them.
// What the design does about each:
// - one block per (128-query tile, head, batch row): K/V cross L2 L/128
//   times, and the [L, L] scores never leave registers;
// - K/V tiles of 64 keys come by TMA (3-D maps over (W, L, B) with the
//   operand's row and batch strides, boxes of 64 columns x 64 rows,
//   128-byte swizzle, which is the layout a 128-byte
//   swizzled wgmma descriptor reads; rows past L read as zeros) into a
//   ring of STAGES slots with full and empty mbarriers. Thread 0 issues
//   every load: the first STAGES tiles at the start, then each tile into
//   the slot that the tile STAGES before it leaves, once every consumer
//   warp has released it, so loads run STAGES - 1 tiles ahead. A separate
//   producer warp would only add a ninth warp to the block;
// - two consumer warpgroups of 64 queries run both products on wgmma
//   (bf16 in, f32 accumulate): S = Q K^T as m64n64k16 from shared memory,
//   both K-major; O += P V as m64n64k16 with P from registers (the S
//   accumulator's layout is the A fragment's, so it converts in place) and
//   V, stored [key][d], read through the descriptor's transpose bit;
// - the softmax costs one FFMA and one ex2 a score: s2 = dot *
//   (sm_scale * log2 e) + neg * log2 e, p = 2^(s2 - max s2), with each
//   row's running max and sum in f32 registers. Tile j's QK^T and tile
//   j - 1's PV are issued as two groups and waited together; the softmax
//   overlaps the products of the SM's other warpgroups (two blocks of two
//   at <= 128 registers). Waiting one group apart, so that tile j's
//   softmax ran beside tile j - 1's PV in the same warpgroup, made ptxas
//   serialize the wgmmas (C7513) and measured slower on the H100;
// - key tiles whose 64 keys are all masked are skipped when the batch row
//   has a live key. That is exact: the row max is then at least the live
//   key's score, a masked score sits near -1.44e9 in log2 units, so its
//   2^(s2 - max) is 0 in f32, and the tile would add zeros to O and the
//   sum and leave the max as it is. A row with no live key skips nothing:
//   its answer is the mean of V over every key. The mask need not be a
//   prefix; all threads read it once per block, and a ballot per warp marks
//   the live tiles.
// Rounding points: f32 scores, max, exps and sums; p rounded to bf16 for
// the PV product (the reference's point) while the sum adds the f32 p;
// the context divided once by the sum and stored as f32, 16-byte rows
// through shared memory. The TPU kernel's full-row softmax held an [L, L]
// tile in VMEM, which does not fit here; the online softmax differs from
// it only in rounding. Keys past L are excluded outright (a -inf bias on
// zero-filled rows).
// The f32 entry (the dtype="float32" configuration, not the serving path)
// is a plain FMA kernel: one thread per query row, K and V tiles in shared
// memory, f32 throughout.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int D = 64;                 // head dim (ops/attention.py HEAD_DIM)
constexpr int BM = 64;                // f32 kernel: queries per block
constexpr int BN = 64;                // keys per tile
constexpr int MAX_L = 512;            // ops/attention.py MAX_LEN
constexpr float MASKED = -1e9f;

// Row and batch strides of q, k and v, in elements: element (b, l, c) of q
// is q[b * bq + l * lq + c]. The context is written [B, L, W] contiguous.
struct Strides {
  long long lq, lk, lv, bq, bk, bv;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float key_bias(const int* mask_row, int key, int L) {
  return key < L ? (mask_row[key] > 0 ? 0.f : MASKED) : neg_inf();
}

// ---- bf16: wgmma products, a TMA-fed K/V ring --------------------------------

constexpr int WG_ROWS = 64;                    // queries of a consumer warpgroup
constexpr int CONSUMERS = 2;                   // consumer warpgroups a block
constexpr int QT = CONSUMERS * WG_ROWS;        // queries a block
constexpr int THREADS = 128 * CONSUMERS;
constexpr int STAGES = 4;                      // K/V ring slots
constexpr int MAX_TILES = MAX_L / BN;
constexpr int TILE = BN * D * 2;               // bytes of one 64 x 64 bf16 tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED2 = MASKED * LOG2E;      // the masked bias in log2 units
constexpr unsigned FULL = 0xffffffffu;

// shared memory from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes)
constexpr int SM_Q = 0;                                   // [CONSUMERS] tiles
constexpr int SM_K = SM_Q + CONSUMERS * TILE;             // [STAGES] tiles
constexpr int SM_V = SM_K + STAGES * TILE;                // [STAGES] tiles
constexpr int SM_NEG = SM_V + STAGES * TILE;              // [MAX_L] f32
constexpr int SM_LIVE = SM_NEG + MAX_L * 4;               // [MAX_TILES] flags
constexpr int SM_LIST = SM_LIVE + MAX_TILES * 4;          // tiles run, count
constexpr int SM_BAR = SM_LIST + (MAX_TILES + 2) * 4;     // q, full[], empty[]
constexpr int SMEM = SM_BAR + (1 + 2 * STAGES) * 8 + 1024;  // + alignment

// K and V rows [r0, r0 + 64) of head h, batch row b, into ring slot st
__device__ __forceinline__ void load_kv(uint32_t base, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int h, int r0,
                                        int b, int st, uint32_t bar_full) {
  mbar_expect_tx(bar_full + 8 * st, 2 * TILE);
  tma_load(base + SM_K + st * TILE, tk, h * D, r0, b, bar_full + 8 * st);
  tma_load(base + SM_V + st * TILE, tv, h * D, r0, b, bar_full + 8 * st);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// V [key][d] as the B operand of P V (N-major): a k16 step is 16 rows on.
// N = 64 is one swizzle atom, so only the 8-row stride (1024) is read;
// both offsets carry it.
__device__ __forceinline__ uint64_t nmajor_desc(uint32_t addr) {
  return smem_desc(addr, 1024, 1024);
}

// Pins accumulator registers at this point of the program, so that no
// access to them moves across the asynchronous wgmma that owns them.
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void hold(uint32_t (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(p[i / 4][i % 4])::"memory");
}

#define ACC32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory;
// acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 64] += A[64 x 16] (bf16 pairs in registers) . B[16 x 64], B
// N-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S of this warpgroup's 64 queries against one K tile: four k16 steps
__device__ __forceinline__ void issue_qk(float (&s)[32], uint64_t dq,
                                         uint32_t kt) {
  const uint64_t dk = kmajor_desc(kt);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
  wg_commit();
}

// O += P . V over one tile: P's k16 step kk is keys [16kk, 16kk + 16)
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&p)[4][4],
                                         uint32_t vt) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, p[kk], nmajor_desc(vt + kk * 2048));
  wg_commit();
}

// Accumulator layout (PTX ISA, wgmma .m64nNk16 D): in warp w of the
// warpgroup, lane 4g + t holds d[4i + r] at row 16w + g + 8 (r >> 1),
// column 8i + 2t + (r & 1). One tile's scores become probabilities in
// place: s2 = dot * scale2 + nb (log2 units), the running max m and the
// per-lane partial sum l of rows g and g + 8 updated, a0 and a1 the factors
// that rescale what came before.
__device__ __forceinline__ void softmax_tile(float (&s)[32], const float* nb,
                                             float scale2, int t4, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 n = *reinterpret_cast<const float2*>(nb + 8 * i + 2 * t4);
    s[4 * i] = fmaf(s[4 * i], scale2, n.x);
    s[4 * i + 1] = fmaf(s[4 * i + 1], scale2, n.y);
    s[4 * i + 2] = fmaf(s[4 * i + 2], scale2, n.x);
    s[4 * i + 3] = fmaf(s[4 * i + 3], scale2, n.y);
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
  // the first tile run holds a key < L, so the max is finite from there on
  // and 2^(-inf - max) = 0 clears the empty start
  a0 = ex2(m0 - mx0);
  a1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[4 * i] = ex2(s[4 * i] - m0);
    s[4 * i + 1] = ex2(s[4 * i + 1] - m0);
    s[4 * i + 2] = ex2(s[4 * i + 2] - m1);
    s[4 * i + 3] = ex2(s[4 * i + 3] - m1);
    ps0 += s[4 * i] + s[4 * i + 1];
    ps1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

__global__ void __launch_bounds__(THREADS, 2)
paired_attn_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const int* __restrict__ mask, int L, int W,
                        float scale2, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* neg2 = reinterpret_cast<float*>(sm + SM_NEG);
  int* live = reinterpret_cast<int*>(sm + SM_LIVE);
  int* list = reinterpret_cast<int*>(sm + SM_LIST);  // list[MAX_TILES] = count
  const uint32_t bar_q = base + SM_BAR;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (L + BN - 1) / BN;
  // consumer warpgroups with a query row < L
  const int active = min(CONSUMERS, (L - q0 + WG_ROWS - 1) / WG_ROWS);

  if (tid < MAX_TILES) live[tid] = 0;
  __syncthreads();
  // each key's bias in log2 units and each tile's liveness; the 32 keys of
  // a warp lie in one tile
  const int* mrow = mask + (size_t)b * L;
  for (int j = tid; j < n_tiles * BN; j += THREADS) {
    const bool on = j < L && mrow[j] > 0;
    neg2[j] = j < L ? (on ? 0.f : MASKED2) : neg_inf();
    if (__ballot_sync(FULL, on) && lane == 0) live[j / BN] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    // the tiles to run: the live ones, or every one for a row without a
    // live key
    int any = 0, n = 0;
    for (int t = 0; t < n_tiles; ++t) any |= live[t];
    for (int t = 0; t < n_tiles; ++t)
      if (live[t] || !any) list[n++] = t;
    list[MAX_TILES] = n;
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * active);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int count = list[MAX_TILES];

  // thread 0 issues every TMA load: Q and the ring's first STAGES tiles
  // here, each later tile into the slot that the tile STAGES before it
  // leaves (below)
  if (tid == 0) {
    mbar_expect_tx(bar_q, active * TILE);
    for (int w = 0; w < active; ++w)
      tma_load(base + SM_Q + w * TILE, &tq, h * D, q0 + w * WG_ROWS, b, bar_q);
    for (int n = 0; n < min(count, STAGES); ++n)
      load_kv(base, &tk, &tv, h, list[n] * BN, b, n, bar_full);
  }
  const int wg = warp >> 2;
  if (wg >= active) return;
  const int g = lane >> 2, t4 = lane & 3;
  const uint64_t dq = kmajor_desc(base + SM_Q + wg * TILE);
  float s[32], o[32];
  uint32_t p[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i / 4][i % 4] = 0u;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);

  for (int n = 0; n < count; ++n) {
    const int st = n % STAGES, prev = (n + STAGES - 1) % STAGES;
    mbar_wait(bar_full + 8 * st, (n / STAGES) & 1);
    // o and p are final before the first wgmma of the group: an access
    // between the two issues would serialize them
    hold(s);
    hold(o);
    hold(p);
    issue_qk(s, dq, base + SM_K + st * TILE);
    if (n > 0) issue_pv(o, p, base + SM_V + prev * TILE);  // the last tile's PV
    wg_wait();
    hold(s);
    hold(o);
    hold(p);
    if (n > 0) {  // the last tile's slot is read: refill it
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
      if (tid == 0 && n - 1 + STAGES < count) {
        mbar_wait(bar_empty + 8 * prev, ((n - 1) / STAGES) & 1);
        load_kv(base, &tk, &tv, h, list[n - 1 + STAGES] * BN, b, prev,
                bar_full);
      }
      __syncwarp();
    }
    float a0, a1;
    softmax_tile(s, neg2 + list[n] * BN, scale2, t4, m0, m1, l0, l1, a0, a1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
  const int last = (count - 1) % STAGES;
  hold(o);
  issue_pv(o, p, base + SM_V + last * TILE);
  wg_wait();
  hold(o);

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  // the context through this warpgroup's Q slot, 32 columns at a time; the
  // 16-byte chunks of row r sit at chunk ^ (r & 7), so neither the
  // fragment writes nor the row reads conflict
  float* stg = reinterpret_cast<float*>(sm + SM_Q + wg * TILE);
  const int r0 = 16 * (warp & 3) + g, wt = tid & 127;  // r0 & 7 == g
  float* ob = out + (size_t)b * L * W + h * D;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    named_sync(1 + wg);
#pragma unroll
    for (int i = 4 * half; i < 4 * half + 4; ++i) {
      const int c = 8 * i + 2 * t4 - 32 * half;
      const int at = (((c >> 2) ^ g) << 2) | (c & 3);
      *reinterpret_cast<float2*>(stg + r0 * 32 + at) =
          make_float2(o[4 * i] * i0, o[4 * i + 1] * i0);
      *reinterpret_cast<float2*>(stg + (r0 + 8) * 32 + at) =
          make_float2(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
    }
    named_sync(1 + wg);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = it * 128 + wt, r = idx >> 3, c = idx & 7;
      const int row = q0 + wg * WG_ROWS + r;
      if (row < L)
        *reinterpret_cast<float4*>(ob + (size_t)row * W + 32 * half + 4 * c) =
            *reinterpret_cast<const float4*>(stg + r * 32 + ((c ^ (r & 7)) << 2));
    }
  }
}

// ---- f32: CUDA-core FMAs -----------------------------------------------------

constexpr int F32_THREADS = BM;       // one thread per query row

__global__ void __launch_bounds__(F32_THREADS)
paired_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ mask, int L, int W, Strides st,
                       float scale, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* kt = reinterpret_cast<float*>(smem);  // [BN][D]
  float* vt = kt + BN * D;                     // [BN][D]
  float* sc = vt + BN * D;                     // [BN][BM]: column per thread
  float* neg = sc + BN * BM;                   // [BN]
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + threadIdx.x;
  const float* qh = q + (size_t)b * st.bq + (size_t)h * D;
  const float* kh = k + (size_t)b * st.bk + (size_t)h * D;
  const float* vh = v + (size_t)b * st.bv + (size_t)h * D;
  const int n_tiles = (L + BN - 1) / BN;

  float qr[D], o[D];
  {
    const float4* src = reinterpret_cast<const float4*>(
        qh + (size_t)min(row, L - 1) * st.lq);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 x = src[d4];
      qr[4 * d4] = x.x;
      qr[4 * d4 + 1] = x.y;
      qr[4 * d4 + 2] = x.z;
      qr[4 * d4 + 3] = x.w;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  float m = neg_inf(), l = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                  // the last tile's readers are done
    for (int i = threadIdx.x; i < BN * D / 4; i += F32_THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4, key = t * BN + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < L) {
        kv = *reinterpret_cast<const float4*>(kh + (size_t)key * st.lk + c);
        vv = *reinterpret_cast<const float4*>(vh + (size_t)key * st.lv + c);
      }
      *reinterpret_cast<float4*>(kt + r * D + c) = kv;
      *reinterpret_cast<float4*>(vt + r * D + c) = vv;
    }
    if (threadIdx.x < BN)
      neg[threadIdx.x] = key_bias(mask + (size_t)b * L, t * BN + threadIdx.x, L);
    __syncthreads();

    float mx = m;
    for (int j = 0; j < BN; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(kt + j * D);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 x = kr[d4];
        acc = fmaf(qr[4 * d4], x.x, acc);
        acc = fmaf(qr[4 * d4 + 1], x.y, acc);
        acc = fmaf(qr[4 * d4 + 2], x.z, acc);
        acc = fmaf(qr[4 * d4 + 3], x.w, acc);
      }
      const float s = acc * scale + neg[j];
      sc[j * BM + threadIdx.x] = s;
      mx = fmaxf(mx, s);
    }
    const float alpha = expf(m - mx);
    m = mx;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
    float ps = 0.f;
    for (int j = 0; j < BN; ++j) {
      const float p = expf(sc[j * BM + threadIdx.x] - m);
      ps += p;
      const float4* vr = reinterpret_cast<const float4*>(vt + j * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 x = vr[d4];
        o[4 * d4] = fmaf(p, x.x, o[4 * d4]);
        o[4 * d4 + 1] = fmaf(p, x.y, o[4 * d4 + 1]);
        o[4 * d4 + 2] = fmaf(p, x.z, o[4 * d4 + 2]);
        o[4 * d4 + 3] = fmaf(p, x.w, o[4 * d4 + 3]);
      }
    }
    l = l * alpha + ps;
  }

  if (row < L) {
    float4* dst = reinterpret_cast<float4*>(
        out + (size_t)b * L * W + (size_t)h * D + (size_t)row * W);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4)
      dst[d4] = make_float4(o[4 * d4] / l, o[4 * d4 + 1] / l,
                            o[4 * d4 + 2] / l, o[4 * d4 + 3] / l);
  }
}

// ---- launch ------------------------------------------------------------------

bool bad_shape(int B, int L, int H) {
  return B < 1 || B > 65535 || L < 1 || L > MAX_L || H < 2 || H % 2 != 0 ||
         H > 65535;
}

// A 3-D map over one of q/k/v [B, L, W] bf16 (innermost first: W, L, B)
// with row stride ld and batch stride bs (elements; 16-byte multiples, as
// TMA requires), in boxes of 64 columns x 64 rows of one batch row,
// 128-byte swizzled; rows past L read as zeros, which a 2-D map over B * L
// rows would not give.
bool head_map(CUtensorMap* map, const void* x, int B, int L, int W,
              long long ld, long long bs) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[3] = {D, BN, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch (0 = success).

// ldq / ldk / ldv and bsq / bsk / bsv: the row and batch strides of q, k
// and v in elements (W and L * W for contiguous operands).
int lt_paired_attention_bf16(const void* q, const void* k, const void* v,
                             const void* mask, int B, int L, int H,
                             long long ldq, long long ldk, long long ldv,
                             long long bsq, long long bsk, long long bsv,
                             float scale, void* out, void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const int W = H * D;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B, L, W, ldq, bsq) ||
      !head_map(&tk, k, B, L, W, ldk, bsk) ||
      !head_map(&tv, v, B, L, W, ldv, bsv))
    return (int)cudaErrorInvalidValue;
  auto kern = paired_attn_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + QT - 1) / QT, H, B);
  kern<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const int*>(mask), L, W, scale * LOG2E,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int lt_paired_attention_f32(const void* q, const void* k, const void* v,
                            const void* mask, int B, int L, int H,
                            long long ldq, long long ldk, long long ldv,
                            long long bsq, long long bsk, long long bsv,
                            float scale, void* out, void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * BN * D + BN * BM + BN) * sizeof(float);
  auto kern = paired_attn_f32_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BM - 1) / BM, H, B);
  kern<<<grid, F32_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(mask), L, H * D,
      Strides{ldq, ldk, ldv, bsq, bsk, bsv}, scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
