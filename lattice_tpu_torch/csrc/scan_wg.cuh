// The main loop of kernels A (bf16) and C (int8) in scan_topk.cu and of
// their score-floor probes (score_probe.cu) on Hopper: queries [B, d]
// against rows [n, d] of one operand type, both row-major with 16-byte
// rows (d % 8 == 0 in bf16, d % 16 == 0 in int8) and 16-byte aligned. The
// type is a template argument (`WgBf16`, `WgS8` below); the loop, the ring,
// the warps and the score tile's layout are the same for both.
//
// A block owns BQ_ queries and a contiguous run of rows [row_lo, row_hi),
// which it walks in row tiles of WG_BN = 64. Its warps have three roles:
// - one producer warp (the block's last) brings the operands by TMA: a
//   tile's product is a run of k slabs (the last one partial), each slab
//   WG_BK = 128 bytes of each of the tile's 64 rows and of each MMA
//   warpgroup's 64 queries (64 bf16 or 128 int8 dims), from 2-D tensor maps
//   with a 128-byte swizzle (out-of-bounds rows, queries and columns read
//   as 0, which adds nothing to a sum), into a ring of STAGES slots with
//   full and empty mbarriers; it keeps up to STAGES slabs in flight and
//   refills a slot once every MMA warp has released it;
// - one MMA warpgroup per 64 queries runs a slab as four `wgmma.mma_async`
//   k steps of 32 bytes (m64n64k16 .f32.bf16.bf16, f32 sums; or m64n64k32
//   .s32.s8.s8, exact i32 sums; both operands K-major in shared memory),
//   keeps one slab's group in flight while it waits for the next slab, and
//   releases a slot as soon as the group that read it is done. After a
//   tile's last slab each of its warps stores its accumulators (the raw
//   sums of its 16 queries against the tile's 64 rows) into its 16 rows of
//   the score tile and hands them to its epilogue warps through a pair of
//   mbarriers (full, empty), then runs the next tile's products into its
//   registers while they work: it waits only to store, when they are still
//   on the tile before;
// - 16 epilogue warps (two per MMA warp, 8 queries each, at 128 queries a
//   block; four, 4 queries each, at 64) take each stored tile: the scan's
//   selection (`offer` into their queries' lists), or the probe's bin max.
//   The tensor cores and the ring go on through it.
// The MMA and producer warps run the same code for the scan and the probe;
// only the epilogue differs.
//
// Why 64-row tiles: the selection bounds the scan, and each of its warps
// waits on shared memory at every `offer`, so the more epilogue warps the
// better. A block's registers bound its warps (SCAN_REGS_WG, scan_tile.cuh:
// 25 warps leave 72 a thread), and an m64n128 wgmma's 64 accumulators
// need 90 under that cap, an m64n64's 32 need fewer than 72 (f32 or i32
// alike). The price is query traffic: each 64-row slab brings 64 x 128
// bytes of each warpgroup's queries from L2, as many bytes as its rows.
//
// The rows' slab is the B operand of both MMA warpgroups, so one row tile
// feeds 128 queries; the queries are streamed beside the rows from L2
// (shared memory does not hold 128 x d of them next to the score tile and
// the lists at d = 768). An MMA warpgroup whose 64 queries all lie past B
// takes no slab and runs no product; a warp whose 16 do stores nothing.
// So what bounds the loop is the operand traffic, not HBM: the rows cross
// L2 once per query tile and the queries once per 64-row slab, and every
// slab lands in shared memory, where each m64n64 wgmma reads both of its
// operands again. A row in bf16 is twice the bytes of int8, so kernel A's
// floor moves twice kernel C's bytes for the same rows. Halving the query
// traffic through L2 (a multicast to two chunks' blocks) barely moved
// either floor, so shared memory is the likelier limit (PERF.md
// section 6).
//
// Accumulator layout (PTX ISA, wgmma .m64nNk16 / .m64nNk32 D with .f32 or
// .s32): in warp w of the warpgroup, lane 4g + t holds acc[4i + r] at query
// 16w + g + 8 (r >> 1) of the warpgroup and column (row of the tile)
// 8i + 2t + (r & 1). So each warp's accumulators are the scores of its own
// 16 queries.

#pragma once

#include "hopper_async.cuh"
#include "scan_tile.cuh"
#include "topk_select.cuh"

namespace {

constexpr int WG_BK = 128;                // bytes of each row in a k slab
constexpr int WG_BN = 64;                 // rows of a tile
constexpr int WG_Q = 64;                  // queries of an MMA warpgroup
constexpr int WG_RSLAB = WG_BN * WG_BK;   // bytes of a row slab
constexpr int WG_QSLAB = WG_Q * WG_BK;    // bytes of a warpgroup's query slab
constexpr int WG_SC_LD = WG_BN + 8;       // score-tile row stride (f32, i32)
constexpr int WG_BAR_BYTES = 256;         // the block's mbarriers

// The two instances: 128 queries a block for lists up to K1_WIDE, 64
// queries for longer lists (up to MAX_K1) and for B <= 64, in bf16 and int8
// alike. Every smem size here is mirrored by `wg_smem_bytes` in
// ops/scan_topk.py.
constexpr int BQ_WIDE = 128;
constexpr int K1_WIDE = 32;

template <int BQ_>
struct WgCfg {
  static constexpr int CONSUMERS = BQ_ / WG_Q;          // MMA warpgroups
  static constexpr int MMA_WARPS = 4 * CONSUMERS;
  // queries of an epilogue warp: two epilogue warps per MMA warp at 128
  // queries a block (25 warps, 72 registers a thread), four at 64 (21
  // warps, 80), so both have 16 epilogue warps
  static constexpr int EPI_Q = BQ_ == BQ_WIDE ? 8 : 4;
  static constexpr int EPI_PER = 16 / EPI_Q;            // per MMA warp
  static constexpr int EPI_WARPS = MMA_WARPS * EPI_PER;
  static constexpr int PRODUCER = MMA_WARPS + EPI_WARPS;  // its warp index
  static constexpr int THREADS = 32 * (PRODUCER + 1);
  static constexpr int STAGES = BQ_ == BQ_WIDE ? 6 : 8;
  static constexpr int STAGE_BYTES = WG_RSLAB + CONSUMERS * WG_QSLAB;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int KMAX = BQ_ == BQ_WIDE ? K1_WIDE : MAX_K1;
  static constexpr int REGS = SCAN_REGS_WG<THREADS / 32>;
  static_assert(BQ_ == 64 || BQ_ == BQ_WIDE, "64 or 128 queries a block");
  static_assert((2 * STAGES + 2 * MMA_WARPS) * 8 <= WG_BAR_BYTES, "bars");
};

// Rows of the queries' TMA box: 64, or B rounded up to 8 when B < 64 (one
// query tile, one MMA warpgroup). The rows of a query slab past the box
// hold whatever the slot held before; they only feed accumulator rows of
// queries past B, which nothing reads, and a small batch no longer pays
// for 64 rows of each slab.
__host__ __device__ constexpr int wg_qbox(int B) {
  return B < WG_Q ? (B + 7) / 8 * 8 : WG_Q;
}

// Dynamic shared memory of a block: 1024 bytes of slack to align the ring
// (the 128-byte swizzle repeats every 8 rows of 128 bytes), the ring, the
// mbarriers, the score tile, then `epi_bytes` for the epilogue.
template <int BQ_>
constexpr size_t wg_smem_bytes(size_t epi_bytes) {
  return 1024 + WgCfg<BQ_>::RING + WG_BAR_BYTES +
         round_up((size_t)BQ_ * WG_SC_LD * 4) + epi_bytes;
}

// Pins accumulator registers at this point of the program, so that no
// access to them moves across the asynchronous wgmma that owns them.
__device__ __forceinline__ void hold(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC32(d, c)                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),   \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),   \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]),           \
      c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]),           \
      c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define WG_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// The two operand types of wg_scan. A k slab is WG_BK bytes of each row
// (K dims), run as four wgmma k steps of 32 bytes: each step is +2 on the
// K-major descriptors (kmajor_desc), whatever the type.
// int8 (kernel C): acc[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T, s8 -> s32.
struct WgS8 {
  using T = signed char;
  using Acc = int;
  using Pair = int2;
  static constexpr int K = WG_BK;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // acc_in = 0 overwrites acc
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_REGS32
        ", %32, %33, p;\n}\n"
        : WG_ACC32(d, "+r")
        : "l"(a), "l"(b), "r"(acc_in));
  }
};

// bf16 (kernel A): acc[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, f32 sums;
// scale-a = scale-b = 1, neither operand transposed (both K-major).
struct WgBf16 {
  using T = __nv_bfloat16;
  using Acc = float;
  using Pair = float2;
  static constexpr int K = WG_BK / 2;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(d, "+f")
        : "l"(a), "l"(b), "r"(acc_in));
  }
};

// The main loop over rows [row_lo, row_hi) for queries [q0, q0 + BQ_),
// operands of type Op. Every thread of the block calls it. Epilogue warp e
// (warp MMA_WARPS + e) owns the block's queries [EPI_Q e, EPI_Q (e + 1)),
// of MMA warp e / EPI_PER's, and takes tile t (rows row_lo + t * WG_BN ...)
// as `epi.tile(S, row0)`, S its EPI_Q rows of the score tile (Op::Acc sums,
// row stride WG_SC_LD), then `epi.finish()` after the last tile; it calls
// neither when none of its queries is < B.
// `sm` is the 1024-aligned start of the ring; the score tile follows the
// mbarriers.
template <int BQ_, typename Op, typename Epi>
__device__ __forceinline__ void wg_scan(const CUtensorMap* rmap,
                                        const CUtensorMap* qmap,
                                        unsigned char* sm, int q0, int B,
                                        int row_lo, int row_hi, int d,
                                        Epi& epi) {
  using C = WgCfg<BQ_>;
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_full = base + C::RING;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;
  const uint32_t sc_full = bar_empty + 8 * C::STAGES;  // [MMA_WARPS]
  const uint32_t sc_empty = sc_full + 8 * C::MMA_WARPS;
  using Acc = typename Op::Acc;
  Acc* Sc = reinterpret_cast<Acc*>(sm + C::RING + WG_BAR_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // MMA warpgroups with a query < B (q0 < B, so at least one)
  const int active = min(C::CONSUMERS, (B - q0 + WG_Q - 1) / WG_Q);
  const int slabs = (d + Op::K - 1) / Op::K;
  const int tiles = (row_hi - row_lo + WG_BN - 1) / WG_BN;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * active);  // one arrival an MMA warp
    }
    for (int w = 0; w < C::MMA_WARPS; ++w) {
      mbar_init(sc_full + 8 * w, 32);
      mbar_init(sc_empty + 8 * w, 32 * C::EPI_PER);  // every epilogue lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::PRODUCER) {
    if (lane == 0) {
      const unsigned bytes = WG_RSLAB + active * wg_qbox(B) * WG_BK;
      const int total = tiles * slabs;
      for (int it = 0; it < total; ++it) {
        const int st = it % C::STAGES;
        if (it >= C::STAGES)  // the slab STAGES before this one has left
          mbar_wait(bar_empty + 8 * st, (it / C::STAGES - 1) & 1);
        const int k0 = it % slabs * Op::K;
        const int row0 = row_lo + it / slabs * WG_BN;
        const uint32_t slot = base + st * C::STAGE_BYTES;
        mbar_expect_tx(bar_full + 8 * st, bytes);
        tma_load_2d(slot, rmap, k0, row0, bar_full + 8 * st);
        for (int w = 0; w < active; ++w)
          tma_load_2d(slot + WG_RSLAB + w * WG_QSLAB, qmap, k0, q0 + w * WG_Q,
                      bar_full + 8 * st);
      }
    }
    return;
  }
  if (warp >= C::MMA_WARPS) {  // an epilogue warp
    const int e = warp - C::MMA_WARPS, w = e / C::EPI_PER;
    if (w / 4 >= active || q0 + 16 * w >= B) return;
    const bool live = q0 + C::EPI_Q * e < B;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(sc_full + 8 * w, t & 1);
      if (live) epi.tile(Sc + C::EPI_Q * e * WG_SC_LD, row_lo + t * WG_BN);
      mbar_arrive(sc_empty + 8 * w);
    }
    if (live) epi.finish();
    return;
  }
  const int w = warp;  // an MMA warp: queries [16 w, 16 w + 16)
  if (w / 4 >= active) return;
  Acc* S = Sc + 16 * w * WG_SC_LD;
  const bool live = q0 + 16 * w < B;

  Acc acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  const uint32_t qslab = WG_RSLAB + (w / 4) * WG_QSLAB;
  const int g = lane >> 2, t4 = lane & 3;
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int s = 0; s < slabs; ++s, ++it) {
      const int st = it % C::STAGES;
      mbar_wait(bar_full + 8 * st, (it / C::STAGES) & 1);
      const uint32_t slot = base + st * C::STAGE_BYTES;
      const uint64_t da = kmajor_desc(slot + qslab), db = kmajor_desc(slot);
      hold(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Op::mma(acc, da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
      wg_commit();
      if (s > 0) {  // the last slab's products are done: release its slot
        wg_wait_one();
        hold(acc);
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % C::STAGES));
      }
    }
    wg_wait();
    hold(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % C::STAGES));
    if (!live) continue;
    if (t > 0) mbar_wait(sc_empty + 8 * w, (t - 1) & 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      using P = typename Op::Pair;
      *reinterpret_cast<P*>(S + g * WG_SC_LD + 8 * i + 2 * t4) =
          P{acc[4 * i], acc[4 * i + 1]};
      *reinterpret_cast<P*>(S + (g + 8) * WG_SC_LD + 8 * i + 2 * t4) =
          P{acc[4 * i + 2], acc[4 * i + 3]};
    }
    mbar_arrive(sc_full + 8 * w);
  }
}

// A 2-D map over a row-major matrix [rows, d] of Op::T (innermost first: d,
// rows) in boxes of WG_BK bytes x `box_rows` rows, 128-byte swizzled;
// elements past either edge read as 0.
template <typename Op>
bool wg_map(CUtensorMap* map, const void* x, int rows, int d, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(typename Op::T)};
  const cuuint32_t box[2] = {Op::K, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, Op::TMA, 2, const_cast<void*>(x), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of queries [B, d] and rows [n, d] of Op::T; false where the shape
// or the pointers do not suit TMA (rows of a multiple of 16 bytes: d % 16
// in int8, d % 8 in bf16; 16-byte alignment) or the driver has no encoder.
template <typename Op>
bool wg_maps(CUtensorMap* qmap, CUtensorMap* rmap, const void* q,
             const void* e, int B, int n, int d) {
  if (d < 1 || d * sizeof(typename Op::T) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(e) % 16 != 0)
    return false;
  return wg_map<Op>(qmap, q, B, d, wg_qbox(B)) &&
         wg_map<Op>(rmap, e, n, d, WG_BN);
}

// The 1024-aligned start of a block's dynamic shared memory.
__device__ __forceinline__ unsigned char* wg_smem_base(unsigned char* raw) {
  const uint32_t r = smem_u32(raw);
  return raw + (((r + 1023) & ~1023u) - r);
}

}  // namespace
