// The per-tile product of the flat scans' wmma routes: kernels A, C and D
// where their shape (or D's list length) keeps them off the wgmma main
// loop (scan_wg.cuh), and the score-floor probe of each (score_probe.cu).
//
// `score_tile` computes one [BQ_, BN] block of scores: the queries
// [q0, q0 + BQ_) against the rows [row0, row0 + BN) (rows at or past r_end
// score 0). The tiles of each k step land in shared memory k-block-major
// and go through the tensor cores (wmma m16n16k16, bf16 -> f32 and
// s8 -> s32; f32 rows on CUDA-core FMA). The loads set the time at short
// lists, so each thread issues all of its 16-byte loads of a k step's
// query and row tiles before it stores any. The caller names the epilogue
// of each 16 x 16 fragment of scores: the scans store it into the
// shared-memory tile Sc and fold Sc into running top-k1 lists; the probe
// maxes it into a running bin max that it keeps in Sc.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int BQ = 64;          // queries per block
constexpr int BN = 128;         // rows per tile
constexpr int THREADS = 128;    // 4 warps
constexpr int SC_LD = BN + 4;   // score tile row stride (floats)

constexpr int MODE_BF16 = 0;
constexpr int MODE_F32 = 1;
constexpr int MODE_I8 = 2;
constexpr int MODE_I4 = 3;

// Registers per thread of a scan kernel (`__maxnreg__`) and of its
// score-floor probe, in one place: how many registers a thread holds decides
// how many of its loads stay in flight and how the compiler schedules them,
// so the probe must run at its scan's budget for scan ms minus probe ms to be
// the selection's cost. 128 for A and C's scalar route and 144 for D at 64
// queries a block are what nvcc 12.8 gives the scans uncapped (`cuobjdump
// --dump-resource-usage`; D takes 140 under its cap); a redesign that wants
// more raises them here, for the scan and its probe at once. The f32 scan
// and kernel D's 32-query instance have no probe and no cap (255).
template <int MODE, int BQ_>
constexpr int SCAN_REGS = BQ_ != BQ || MODE == MODE_F32 ? 255
                          : MODE == MODE_I4             ? 144
                                                        : 128;

// Kernel C on wgmma and its int8 probe (scan_wg.cuh): one budget for every
// warp of a block of WARPS warps (the producer, MMA and epilogue warps of
// the same instance alike; no `setmaxnreg` split, which would not lift
// the cap ptxas compiles a wgmma under). An SM's registers are four files
// of 16,384, one per scheduler, and a block's warps are dealt out to them
// in turn, so ceil(WARPS / 4) warps share one: a thread may hold at most
// 16,384 / (32 ceil(WARPS / 4)), rounded down to the allocation unit of 8,
// or the block does not launch. That is 72 for the 128-query instance's
// 25 warps and 80 for the 64-query instance's 21. The loads are TMA's and
// hold no registers, so the budget does not set the load schedule.
template <int WARPS>
constexpr int SCAN_REGS_WG = 16384 / (32 * ((WARPS + 3) / 4)) / 8 * 8;

// How a packed int4 byte's low nibble reads. NIB_BIASED: v + 8, the layout
// `quantize_rows_int4` writes ((b & 0xF) - 8). NIB_SIGNED: two's
// complement (((b & 0xF) ^ 8) - 8), what the round-2 int4 probe scripts
// computed on those same bytes. The high nibble is b >> 4 in both.
constexpr int NIB_BIASED = 0;
constexpr int NIB_SIGNED = 1;

template <int MODE> struct Cfg;
template <> struct Cfg<MODE_BF16> {
  using T = __nv_bfloat16; using Q = float; using Acc = float;
  static constexpr int BK = 64;
};
template <> struct Cfg<MODE_F32> {
  using T = float; using Q = float; using Acc = float;
  static constexpr int BK = 32;
};
template <> struct Cfg<MODE_I8> {
  using T = signed char; using Q = signed char; using Acc = int;
  static constexpr int BK = 64;
};
// int4: E holds packed bytes; the tiles in shared memory hold the unpacked
// int8 values, 64 dims (32 packed bytes of each row) per k step
template <> struct Cfg<MODE_I4> {
  using T = signed char; using Q = signed char; using Acc = int;
  static constexpr int BK = 64;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
template <> __device__ __forceinline__ signed char zero<signed char>() {
  return 0;
}

// Tiles land in shared memory k-block-major, dst[BK/16][R][16]: each
// 16-wide k block of 16 rows is one contiguous, 32-byte aligned wmma
// operand. Out-of-range elements are 0, which adds nothing to a dot
// product.
__device__ __forceinline__ int kmajor(int R, int r, int kk) {
  return ((kk >> 4) * R + r) * 16 + (kk & 15);
}

// Rows [r0, r0 + R) x columns [k0, k0 + BK) of a row-major [*, d] matrix
// of S, in 16-byte units U held in registers: `fetch` issues every load
// of a thread's units before any is used, so each thread keeps PER loads
// in flight. Needs d % (16 / sizeof(S)) == 0 and 16-byte alignment.
template <typename S, typename U, int R, int BK>
struct TileRegs {
  static constexpr int VE = sizeof(U) / sizeof(S);  // elements per unit
  static constexpr int UPR = BK / VE;               // units per tile row
  static constexpr int PER = R * UPR / THREADS;     // units per thread
  static_assert(R * UPR % THREADS == 0, "tile must split over the block");
  U v[PER];

  __device__ __forceinline__ int row(int j) const {
    return (threadIdx.x + j * THREADS) / UPR;
  }
  __device__ __forceinline__ int kk(int j) const {
    return (threadIdx.x + j * THREADS) % UPR * VE;
  }
  __device__ __forceinline__ void fetch(const S* src, int r0, int r_end,
                                        int k0, int d) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int r = r0 + row(j), k = k0 + kk(j);
      v[j] = U{};
      if (r < r_end && k < d)
        v[j] = __ldg(reinterpret_cast<const U*>(src + (size_t)r * d + k));
    }
  }
  // 16-byte units stored as they are (rows of the row type, int8 queries)
  template <typename T>
  __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      *reinterpret_cast<U*>(dst + kmajor(R, row(j), kk(j))) = v[j];
  }
  // f32 queries cast to bf16 (round to nearest even, as torch and XLA
  // cast), four elements per unit
  __device__ __forceinline__ void store_bf16(__nv_bfloat16* dst) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      __nv_bfloat162* out =
          reinterpret_cast<__nv_bfloat162*>(dst + kmajor(R, row(j), kk(j)));
      out[0] = __floats2bfloat162_rn(v[j].x, v[j].y);
      out[1] = __floats2bfloat162_rn(v[j].z, v[j].w);
    }
  }
};

// The same tile one element at a time, for widths no vector unit divides.
template <typename T, int R, int BK>
__device__ void load_kmajor_scalar(T* dst, const T* src, int r0, int r_end,
                                   int k0, int d) {
  for (int e = threadIdx.x; e < R * BK; e += THREADS) {
    int r = e / BK, kk = e % BK, k = k0 + kk;
    dst[kmajor(R, r, kk)] =
        (r0 + r < r_end && k < d) ? src[(size_t)(r0 + r) * d + k] : zero<T>();
  }
}

template <int BQ_, int BK>
__device__ void load_q_bf16_scalar(__nv_bfloat16* dst, const float* q, int q0,
                                   int B, int k0, int d) {
  for (int e = threadIdx.x; e < BQ_ * BK; e += THREADS) {
    int r = e / BK, kk = e % BK, k = k0 + kk;
    float v = (q0 + r < B && k < d) ? q[(size_t)(q0 + r) * d + k] : 0.f;
    dst[kmajor(BQ_, r, kk)] = __float2bfloat16_rn(v);
  }
}

// Row-major [R][BK + 1] f32 tile for the FMA path.
template <int R, int BK>
__device__ void load_rowmajor_f32(float* dst, const float* src, int r0,
                                  int r_end, int k0, int d) {
  for (int e = threadIdx.x; e < R * BK; e += THREADS) {
    int r = e / BK, kk = e % BK, k = k0 + kk;
    dst[r * (BK + 1) + kk] =
        (r0 + r < r_end && k < d) ? src[(size_t)(r0 + r) * d + k] : 0.f;
  }
}

// Four packed int4 bytes -> their low-nibble values (read as NIB says) and
// high-nibble values (b >> 4, sign-extended), four int8 per word each.
template <int NIB>
__device__ __forceinline__ void unpack4(unsigned w, unsigned& lo,
                                        unsigned& hi) {
  if constexpr (NIB == NIB_BIASED)
    lo = __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  else
    lo = __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  hi = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <int NIB>
__device__ __forceinline__ signed char low_nibble(int b) {
  return (signed char)(NIB == NIB_BIASED ? (b & 0xF) - 8
                                         : ((b & 0xF) ^ 8) - 8);
}

// One k step of the int4 product: packed columns [c0, c0 + 32) of rows
// [r0, r_end) of E [*, dh] unpacked into the k-major int8 tile dst[BN
// rows][64]: low nibbles at kk in [0, 32), high nibbles at [32, 64); and
// the matching query columns [c0, c0 + 32) and [dh + c0, dh + c0 + 32) of
// q [*, 2 dh] into Qs. Out-of-range values are 0 (not the unpacked 0 byte,
// which is -8). `vec`: 16-byte units, needs dh % 16 == 0 and 16-byte
// alignment; every thread starts all of its loads before it stores any.
template <int BQ_, int NIB>
__device__ __forceinline__ void load_int4_step(
    signed char* Qs, signed char* Es, const signed char* q,
    const signed char* e, int q0, int B, int r0, int r_end, int c0, int dh,
    int vec) {
  const int d = 2 * dh;
  if (vec) {
    constexpr int QU = BQ_ * 4 / THREADS;   // query units per thread
    constexpr int EU = BN * 2 / THREADS;    // packed row units per thread
    uint4 qv[QU], ev[EU];
#pragma unroll
    for (int j = 0; j < QU; ++j) {
      const int u = threadIdx.x + j * THREADS, r = u >> 2, part = u & 3;
      const int c = c0 + 16 * (part & 1);
      qv[j] = uint4{};
      if (q0 + r < B && c < dh)
        qv[j] = __ldg(reinterpret_cast<const uint4*>(
            q + (size_t)(q0 + r) * d + (part >> 1) * dh + c));
    }
#pragma unroll
    for (int j = 0; j < EU; ++j) {
      const int u = threadIdx.x + j * THREADS, r = u >> 1, part = u & 1;
      const int c = c0 + 16 * part;
      ev[j] = uint4{};
      if (r0 + r < r_end && c < dh)
        ev[j] = __ldg(reinterpret_cast<const uint4*>(
            e + (size_t)(r0 + r) * dh + c));
    }
#pragma unroll
    for (int j = 0; j < QU; ++j) {
      const int u = threadIdx.x + j * THREADS, r = u >> 2, part = u & 3;
      *reinterpret_cast<uint4*>(Qs + kmajor(BQ_, r, 16 * part)) = qv[j];
    }
#pragma unroll
    for (int j = 0; j < EU; ++j) {
      const int u = threadIdx.x + j * THREADS, r = u >> 1, part = u & 1;
      const bool in = r0 + r < r_end && c0 + 16 * part < dh;
      uint4 lo, hi;
      unpack4<NIB>(ev[j].x, lo.x, hi.x);
      unpack4<NIB>(ev[j].y, lo.y, hi.y);
      unpack4<NIB>(ev[j].z, lo.z, hi.z);
      unpack4<NIB>(ev[j].w, lo.w, hi.w);
      if (!in) lo = hi = uint4{};
      *reinterpret_cast<uint4*>(Es + kmajor(BN, r, 16 * part)) = lo;
      *reinterpret_cast<uint4*>(Es + kmajor(BN, r, 32 + 16 * part)) = hi;
    }
  } else {
    for (int i = threadIdx.x; i < BQ_ * 64; i += THREADS) {
      const int r = i / 64, kk = i % 64, c = c0 + (kk & 31);
      Qs[kmajor(BQ_, r, kk)] =
          (q0 + r < B && c < dh)
              ? q[(size_t)(q0 + r) * d + (kk >> 5) * dh + c]
              : (signed char)0;
    }
    for (int i = threadIdx.x; i < BN * 32; i += THREADS) {
      const int r = i / 32, j = i % 32, c = c0 + j;
      signed char lo = 0, hi = 0;
      if (r0 + r < r_end && c < dh) {
        const int b = e[(size_t)(r0 + r) * dh + c];
        lo = low_nibble<NIB>(b);
        hi = (signed char)(b >> 4);
      }
      Es[kmajor(BN, r, j)] = lo;
      Es[kmajor(BN, r, 32 + j)] = hi;
    }
  }
}

__host__ __device__ constexpr size_t round_up(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared memory of the query and row tiles of one k step.
template <int MODE, int BQ_>
__host__ __device__ constexpr size_t tile_bytes() {
  using C = Cfg<MODE>;
  return MODE == MODE_F32
             ? round_up(BQ_ * (C::BK + 1) * 4) + round_up(BN * (C::BK + 1) * 4)
             : round_up(BQ_ * C::BK * sizeof(typename C::T)) +
                   round_up(BN * C::BK * sizeof(typename C::T));
}

using FragF = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragI = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// The scans' epilogue of a tile's product: each 16 x 16 fragment of
// scores lands in Sc as it is (f32, or i32 sums).
struct StoreScores {
  __device__ __forceinline__ void operator()(const FragF& acc, float* Sc,
                                             int off) const {
    wmma::store_matrix_sync(Sc + off, acc, SC_LD, wmma::mem_row_major);
  }
  __device__ __forceinline__ void operator()(const FragI& acc, float* Sc,
                                             int off) const {
    wmma::store_matrix_sync(reinterpret_cast<int*>(Sc) + off, acc, SC_LD,
                            wmma::mem_row_major);
  }
};

// Qs and Es lie at the start of a block's shared memory, tile_bytes() in
// all (Es at round_up of the query tile). Every thread of the block calls
// it. The tensor-core modes hand each warp's 16 x 16 fragments of the
// [BQ_, BN] scores (i32 sums for the integer modes) to `epi` with their
// offset in Sc (row stride SC_LD); the f32 FMA path stores its scores
// into Sc. The caller syncs before another warp reads Sc.
template <int MODE, int BQ_, int NIB = NIB_BIASED, typename Epi = StoreScores>
__device__ __forceinline__ void score_tile(
    const typename Cfg<MODE>::Q* __restrict__ q,
    const typename Cfg<MODE>::T* __restrict__ e, typename Cfg<MODE>::T* Qs,
    typename Cfg<MODE>::T* Es, float* Sc, int q0, int B, int row0, int r_end,
    int d, int vec, const Epi& epi = Epi{}) {
  using C = Cfg<MODE>;
  using T = typename C::T;
  constexpr int BK = C::BK;
  constexpr int BQ = BQ_;
  const int warp = threadIdx.x >> 5;
  static_assert(MODE != MODE_F32 || std::is_same_v<Epi, StoreScores>,
                "the f32 FMA path only stores its scores");
  if constexpr (MODE == MODE_F32) {
    // CUDA-core FMA: thread (ty, tx) owns queries ty + 8i, rows tx + 16j
    float* Qf = Qs;
    float* Ef = Es;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_rowmajor_f32<BQ, BK>(Qf, q, q0, B, k0, d);
      load_rowmajor_f32<BN, BK>(Ef, e, row0, r_end, k0, d);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = Qf[(ty + 8 * i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Ef[(tx + 16 * j) * (BK + 1) + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Sc[(ty + 8 * i) * SC_LD + tx + 16 * j] = acc[i][j];
  } else {
    // tensor cores: warp w owns queries [WQ*(w>>1), +WQ) x rows
    // [64*(w&1), +64) of the tile, WQ/16 x 4 fragments of 16 x 16
    using FA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
    using FB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
    using FC = wmma::fragment<wmma::accumulator, 16, 16, 16, typename C::Acc>;
    // 16-byte unit of the query rows: four f32 (cast to bf16 in shared
    // memory) or sixteen int8
    using QUnit = std::conditional_t<MODE == MODE_BF16, float4, uint4>;
    constexpr int WQ = BQ / 2, FQ = WQ / 16;
    const int wq = (warp >> 1) * WQ, wn = (warp & 1) * 64;
    FC acc[FQ][4];
#pragma unroll
    for (int i = 0; i < FQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);
    for (int k0 = 0; k0 < d; k0 += BK) {
      if constexpr (MODE == MODE_I4) {
        load_int4_step<BQ, NIB>(Qs, Es, q, e, q0, B, row0, r_end, k0 / 2,
                                d / 2, vec);
      } else if (vec) {  // both tiles' loads in flight before either is stored
        TileRegs<typename C::Q, QUnit, BQ, BK> qt;
        TileRegs<T, uint4, BN, BK> et;
        qt.fetch(q, q0, B, k0, d);
        et.fetch(e, row0, r_end, k0, d);
        if constexpr (MODE == MODE_BF16)
          qt.store_bf16(Qs);
        else
          qt.store(Qs);
        et.store(Es);
      } else {
        if constexpr (MODE == MODE_BF16)
          load_q_bf16_scalar<BQ, BK>(Qs, q, q0, B, k0, d);
        else
          load_kmajor_scalar<T, BQ, BK>(Qs, q, q0, B, k0, d);
        load_kmajor_scalar<T, BN, BK>(Es, e, row0, r_end, k0, d);
      }
      __syncthreads();
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb) {
        FA a[FQ];
#pragma unroll
        for (int i = 0; i < FQ; ++i)
          wmma::load_matrix_sync(a[i], Qs + (kb * BQ + wq + 16 * i) * 16, 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FB b;
          wmma::load_matrix_sync(b, Es + (kb * BN + wn + 16 * j) * 16, 16);
#pragma unroll
          for (int i = 0; i < FQ; ++i)
            wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        epi(acc[i][j], Sc, (wq + 16 * i) * SC_LD + wn + 16 * j);
  }
}

}  // namespace
