// Flat-scan score + select kernels for Hopper (sm_90a), plain C interface.
//
// Kernel A, scan_topk (bf16 rows, and f32 rows as a second instance):
//   replaces `_binned_kernel` + `_binned_candidates`
//   (lattice_tpu/ops/pallas_topk.py). Q [B, d] f32 (normalized) is cast to
//   the row type inside the kernel; E [N, d]; valid [N] (1 byte per row).
// Kernel C, scan_topk_int8: replaces `_binned_kernel_int8` (same file):
//   q int8 [B, d], q-scales f32 [B], E int8 [N, d], e-scales f32 [N].
//   score = (f32(i32 dot) * qs) * es, the plain version's order, so the
//   scores agree bit for bit.
// Kernel D, scan_topk_int4: replaces `_binned_kernel_int4_hoistq` and its
//   sibling bodies (same file) via `binned_topk_int4`: q int8 [B, d],
//   q-scales f32 [B], packed rows int8 [N, d/2] (low nibble + 8 = dims
//   [0, d/2), high nibble = dims [d/2, d), values in [-8, 7]), e-scales f32
//   [N]. Kernel C's tensor-core path with the unpack in registers between
//   each thread's 16-byte load of packed bytes and its store of the two
//   int8 halves into the k-major tile: a packed k step of 32 bytes gives
//   low-nibble dims [c0, c0 + 32) and high-nibble dims [d/2 + c0, ...),
//   and the query tile loads the two matching column blocks. Every partial
//   sum is an integer below 127 * 8 * d, so scores equal the plain
//   version's bit for bit, as kernel C's do.
// Kernel B, merge_candidates: replaces the `approx_max_k` finish of
//   `_binned_candidates`: the exact top-k1 over every block's candidates.
//   It also merges the lists of ivf_probe (ivf_probe.cu).
//
// Lists of kernels D and B reach k1 = MAX_K1_LONG = 512 (the int4 view
// widens to 8k candidates, 512 at k = 64). A block keeps two lists of k1
// f32 + i32 per query in shared memory: at 64 queries and k1 = 512 that is
// 256 KB, over the 227 KB a block may have. So past k1 = 128 a block of
// kernel D owns 32 queries: lists 2 * 32 * 512 * 4 = 128 KB, score tile
// 32 * 132 * 4 = 16.5 KB, tiles 2 + 8 KB, scales and validity < 1 KB:
// ~155 KB. At k1 <= 128 it keeps kernel C's 64 queries (~110 KB). The
// wrapper (`scan_blocks_int4`) makes that choice and passes it as `bq`, and
// sizes its row chunks for it; each instance refuses another count. Kernel B
// keeps one list per warp: 4 * 2 * 512 * 4 = 16 KB.
//
// Selection (topk_select.cuh, shared with ivf_probe.cu) is exact at the
// precision of the scores: each block keeps one
// sorted running top-k1 list per query in shared memory, ordered by
// (score descending, row id ascending), which is the order `lax.top_k`
// gives. Invalid rows score NEG_INF (-1e30) and still take part, so that
// with fewer live rows than k1 the padded slots carry NEG_INF and the
// lowest invalid row ids, exactly as the plain version's stable sort does.
//
// What bounds it on the H100: one pass over E. At 1M x 768 that is
// 1.61 GB of bf16 (~0.48 ms at 3.35 TB/s), 0.81 GB of int8 or 0.40 GB of
// packed int4; at B=256 the 403 G products ask for tensor cores (int8 and
// int4 at 1,979 TOP/s: ~0.21 ms, which bounds kernel D; at 4M x 768,
// B=1024, its 6.6 TOP take 3.33 ms against 0.48 ms of bytes). Design: a block
// owns 64 queries and a contiguous run of rows (the TPU's sequential grid
// becomes the loop over row tiles inside the block); row tiles of 128 go
// through the tensor cores (wmma m16n16k16, bf16 -> f32 and s8 -> s32;
// f32 rows on CUDA-core FMA), the [64, 128] score tile lands in shared
// memory, and one warp per query folds it into the running list. After
// the first tiles, a tile rarely beats a list's k1-th entry, so selection
// costs one ballot per 32 scores. Each block writes its lists once; kernel
// B merges the n_chunks lists of each query. The loads set the time, so
// each thread issues all of its 16-byte loads of a k step's query and row
// tiles before it stores any of them (6-15% faster than one load at a
// time on an H100). Even so the scans read rows at about half the card's
// bandwidth at B=1. No double buffering, TMA or wgmma yet: simple and
// exact first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "topk_select.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BQ_LONG = 32;     // queries per block of kernel D past MAX_K1
constexpr int BN = 128;         // rows per tile
constexpr int THREADS = 128;    // 4 warps
constexpr int SC_LD = BN + 4;   // score tile row stride (floats)

constexpr int MODE_BF16 = 0;
constexpr int MODE_F32 = 1;
constexpr int MODE_I8 = 2;
constexpr int MODE_I4 = 3;

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

// Four packed int4 bytes -> their low-nibble values ((b & 0xF) - 8) and
// high-nibble values (b >> 4, sign-extended), four int8 per word each.
__device__ __forceinline__ void unpack4(unsigned w, unsigned& lo,
                                        unsigned& hi) {
  lo = __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  hi = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// One k step of kernel D: packed columns [c0, c0 + 32) of rows [r0, r_end)
// of E [*, dh] unpacked into the k-major int8 tile dst[BN rows][64]: low
// nibbles at kk in [0, 32), high nibbles at [32, 64); and the matching
// query columns [c0, c0 + 32) and [dh + c0, dh + c0 + 32) of q [*, 2 dh]
// into Qs. Out-of-range values are 0 (not the unpacked 0 byte, which is
// -8). `vec`: 16-byte units, needs dh % 16 == 0 and 16-byte alignment;
// every thread starts all of its loads before it stores any.
template <int BQ_>
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
      unpack4(ev[j].x, lo.x, hi.x);
      unpack4(ev[j].y, lo.y, hi.y);
      unpack4(ev[j].z, lo.z, hi.z);
      unpack4(ev[j].w, lo.w, hi.w);
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
        lo = (signed char)((b & 0xF) - 8);
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

template <int MODE, int BQ_>
__host__ __device__ constexpr size_t tile_bytes() {
  using C = Cfg<MODE>;
  return MODE == MODE_F32
             ? round_up(BQ_ * (C::BK + 1) * 4) + round_up(BN * (C::BK + 1) * 4)
             : round_up(BQ_ * C::BK * sizeof(typename C::T)) +
                   round_up(BN * C::BK * sizeof(typename C::T));
}

template <int MODE, int BQ_>
size_t scan_smem_bytes(int k1) {
  return tile_bytes<MODE, BQ_>() + round_up(BQ_ * SC_LD * 4)  // score tile
         + round_up(BN * 4) + round_up(BQ_ * 4)  // row / query scales
         + 2 * round_up((size_t)BQ_ * k1 * 4)    // lists
         + round_up(BN);                         // row validity
}

// BQ_ queries per block; lists of at most KMAX entries
template <int MODE, int BQ_, int KMAX>
__global__ void __launch_bounds__(THREADS)
scan_topk_kernel(const typename Cfg<MODE>::Q* __restrict__ q,
                 const float* __restrict__ qs,
                 const typename Cfg<MODE>::T* __restrict__ e,
                 const float* __restrict__ es,
                 const uint8_t* __restrict__ valid, int B, int n, int d,
                 int k1, int rows_per_chunk, int n_chunks, int vec,
                 float* __restrict__ cand_s, int* __restrict__ cand_i) {
  using C = Cfg<MODE>;
  using T = typename C::T;
  constexpr int BK = C::BK;
  constexpr int BQ = BQ_;
  constexpr bool INT = MODE == MODE_I8 || MODE == MODE_I4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x, q0 = blockIdx.y * BQ;
  const int chunk_lo = chunk * rows_per_chunk;
  const int chunk_hi = min(chunk_lo + rows_per_chunk, n);

  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);
  float* Qf = reinterpret_cast<float*>(p);
  p += MODE == MODE_F32 ? round_up(BQ * (BK + 1) * 4)
                        : round_up(BQ * BK * sizeof(T));
  T* Es = reinterpret_cast<T*>(p);
  float* Ef = reinterpret_cast<float*>(p);
  p += MODE == MODE_F32 ? round_up(BN * (BK + 1) * 4)
                        : round_up(BN * BK * sizeof(T));
  float* Sc = reinterpret_cast<float*>(p);
  int* Sci = reinterpret_cast<int*>(p);
  p += round_up(BQ * SC_LD * 4);
  float* esc = reinterpret_cast<float*>(p);
  p += round_up(BN * 4);
  float* qsc = reinterpret_cast<float*>(p);
  p += round_up(BQ * 4);
  float* Ls = reinterpret_cast<float*>(p);
  p += round_up((size_t)BQ * k1 * 4);
  int* Li = reinterpret_cast<int*>(p);
  p += round_up((size_t)BQ * k1 * 4);
  uint8_t* Vs = reinterpret_cast<uint8_t*>(p);

  for (int i = threadIdx.x; i < BQ * k1; i += THREADS) {
    Ls[i] = neg_infinity();
    Li[i] = EMPTY_ID;
  }
  if (INT)
    for (int i = threadIdx.x; i < BQ; i += THREADS)
      qsc[i] = q0 + i < B ? qs[q0 + i] : 0.f;

  for (int row0 = chunk_lo; row0 < chunk_hi; row0 += BN) {
    for (int c = threadIdx.x; c < BN; c += THREADS) {
      int row = row0 + c;
      Vs[c] = row < chunk_hi ? valid[row] : 0;
      if (INT) esc[c] = row < chunk_hi ? es[row] : 0.f;
    }

    if constexpr (MODE == MODE_F32) {
      // CUDA-core FMA: thread (ty, tx) owns queries ty + 8i, rows tx + 16j
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < d; k0 += BK) {
        load_rowmajor_f32<BQ, BK>(Qf, q, q0, B, k0, d);
        load_rowmajor_f32<BN, BK>(Ef, e, row0, chunk_hi, k0, d);
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
          load_int4_step<BQ>(Qs, Es, q, e, q0, B, row0, chunk_hi, k0 / 2,
                             d / 2, vec);
        } else if (vec) {  // both tiles' loads in flight before either is stored
          TileRegs<typename C::Q, QUnit, BQ, BK> qt;
          TileRegs<T, uint4, BN, BK> et;
          qt.fetch(q, q0, B, k0, d);
          et.fetch(e, row0, chunk_hi, k0, d);
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
          load_kmajor_scalar<T, BN, BK>(Es, e, row0, chunk_hi, k0, d);
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
        for (int j = 0; j < 4; ++j) {
          if constexpr (INT)
            wmma::store_matrix_sync(Sci + (wq + 16 * i) * SC_LD + wn + 16 * j,
                                    acc[i][j], SC_LD, wmma::mem_row_major);
          else
            wmma::store_matrix_sync(Sc + (wq + 16 * i) * SC_LD + wn + 16 * j,
                                    acc[i][j], SC_LD, wmma::mem_row_major);
        }
    }
    __syncthreads();

    // selection: warp w folds queries [w BQ/4, (w + 1) BQ/4) of the tile
    for (int qq = 0; qq < BQ / 4; ++qq) {
      const int qi = warp * (BQ / 4) + qq;
      if (q0 + qi >= B) break;
      float* ls = Ls + qi * k1;
      int* li = Li + qi * k1;
#pragma unroll
      for (int c0 = 0; c0 < BN; c0 += 32) {
        const int c = c0 + lane, row = row0 + c;
        const bool in = row < chunk_hi;
        float s = NEG_INF;
        if (in && Vs[c]) {
          if constexpr (INT)
            s = __fmul_rn(__fmul_rn((float)Sci[qi * SC_LD + c], qsc[qi]),
                          esc[c]);
          else
            s = Sc[qi * SC_LD + c];
        }
        offer<KMAX>(ls, li, k1, s, row, in, lane);
      }
    }
    __syncthreads();
  }

  for (int qq = 0; qq < BQ / 4; ++qq) {
    const int qi = warp * (BQ / 4) + qq;
    if (q0 + qi >= B) break;
    const size_t base = ((size_t)(q0 + qi) * n_chunks + chunk) * k1;
    for (int j = lane; j < k1; j += 32) {
      cand_s[base + j] = Ls[qi * k1 + j];
      cand_i[base + j] = Li[qi * k1 + j];
    }
  }
}

// One warp per query: the exact top-k1 (k1 <= KMAX) over its m candidates.
template <int KMAX>
__global__ void __launch_bounds__(THREADS)
merge_candidates_kernel(const float* __restrict__ cs,
                        const int* __restrict__ ci, int B, int m, int k1,
                        float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * (THREADS / 32) + warp;
  float* ls = reinterpret_cast<float*>(smem) + warp * k1;
  int* li = reinterpret_cast<int*>(smem) + (THREADS / 32) * k1 + warp * k1;
  if (q >= B) return;
  for (int j = lane; j < k1; j += 32) {
    ls[j] = neg_infinity();
    li[j] = EMPTY_ID;
  }
  __syncwarp();
  const float* s_row = cs + (size_t)q * m;
  const int* i_row = ci + (size_t)q * m;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < m;
    offer<KMAX>(ls, li, k1, in ? s_row[j] : neg_infinity(),
          in ? i_row[j] : EMPTY_ID, in, lane);
  }
  for (int j = lane; j < k1; j += 32) {
    out_s[(size_t)q * k1 + j] = ls[j];
    out_i[(size_t)q * k1 + j] = li[j];
  }
}

// `bq` is the caller's queries per block, which its row chunking assumed:
// an instance refuses any other count, so the two sides cannot drift apart.
template <int MODE, int BQ_ = BQ, int KMAX = MAX_K1>
int launch_scan(const void* q, const void* qs, const void* e, const void* es,
                const void* valid, int B, int n, int d, int k1, int bq,
                int rows_per_chunk, int n_chunks, int vec, void* cand_s,
                void* cand_i, void* stream) {
  if (B < 1 || n < 1 || d < 1 || k1 < 1 || k1 > KMAX || bq != BQ_ ||
      (MODE == MODE_I4 && d % 2 != 0) ||
      rows_per_chunk < BN || rows_per_chunk % BN != 0 || n_chunks < 1 ||
      (size_t)(n_chunks - 1) * rows_per_chunk >= (size_t)n ||
      (size_t)n_chunks * rows_per_chunk < (size_t)n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem_bytes<MODE, BQ_>(k1);
  auto kern = scan_topk_kernel<MODE, BQ_, KMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (B + BQ_ - 1) / BQ_);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Cfg<MODE>::Q*>(q),
      static_cast<const float*>(qs),
      static_cast<const typename Cfg<MODE>::T*>(e),
      static_cast<const float*>(es), static_cast<const uint8_t*>(valid), B, n,
      d, k1, rows_per_chunk, n_chunks, vec, static_cast<float*>(cand_s),
      static_cast<int*>(cand_i));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch (0 = success).

int lt_scan_topk_bf16(const void* q, const void* e, const void* valid, int B,
                      int n, int d, int k1, int bq, int rows_per_chunk,
                      int n_chunks, int vec, void* cand_s, void* cand_i,
                      void* stream) {
  return launch_scan<MODE_BF16>(q, nullptr, e, nullptr, valid, B, n, d, k1, bq,
                                rows_per_chunk, n_chunks, vec, cand_s, cand_i,
                                stream);
}

int lt_scan_topk_f32(const void* q, const void* e, const void* valid, int B,
                     int n, int d, int k1, int bq, int rows_per_chunk,
                     int n_chunks, int vec, void* cand_s, void* cand_i,
                     void* stream) {
  return launch_scan<MODE_F32>(q, nullptr, e, nullptr, valid, B, n, d, k1, bq,
                               rows_per_chunk, n_chunks, vec, cand_s, cand_i,
                               stream);
}

int lt_scan_topk_int8(const void* q, const void* qs, const void* e,
                      const void* es, const void* valid, int B, int n, int d,
                      int k1, int bq, int rows_per_chunk, int n_chunks,
                      int vec, void* cand_s, void* cand_i, void* stream) {
  return launch_scan<MODE_I8>(q, qs, e, es, valid, B, n, d, k1, bq,
                              rows_per_chunk, n_chunks, vec, cand_s, cand_i,
                              stream);
}

// bq = BQ takes lists up to MAX_K1, bq = BQ_LONG up to MAX_K1_LONG
int lt_scan_topk_int4(const void* q, const void* qs, const void* e,
                      const void* es, const void* valid, int B, int n, int d,
                      int k1, int bq, int rows_per_chunk, int n_chunks,
                      int vec, void* cand_s, void* cand_i, void* stream) {
  if (bq == BQ)
    return launch_scan<MODE_I4>(q, qs, e, es, valid, B, n, d, k1, bq,
                                rows_per_chunk, n_chunks, vec, cand_s, cand_i,
                                stream);
  return launch_scan<MODE_I4, BQ_LONG, MAX_K1_LONG>(
      q, qs, e, es, valid, B, n, d, k1, bq, rows_per_chunk, n_chunks, vec,
      cand_s, cand_i, stream);
}

int lt_merge_candidates(const void* cs, const void* ci, int B, int m, int k1,
                        void* out_s, void* out_i, void* stream) {
  if (B < 1 || m < k1 || k1 < 1 || k1 > MAX_K1_LONG)
    return (int)cudaErrorInvalidValue;
  const int warps = THREADS / 32;
  const size_t smem = (size_t)2 * warps * k1 * 4;
  auto kern = k1 <= MAX_K1 ? merge_candidates_kernel<MAX_K1>
                           : merge_candidates_kernel<MAX_K1_LONG>;
  kern<<<(B + warps - 1) / warps, THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cs), static_cast<const int*>(ci), B, m, k1,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* lt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
