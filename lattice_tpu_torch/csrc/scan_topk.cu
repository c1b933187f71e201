// Flat-scan score + select kernels for Hopper (sm_90a), plain C interface.
//
// Kernel A, scan_topk (bf16 rows, and f32 rows as a second instance):
//   replaces `_binned_kernel` + `_binned_candidates`
//   (lattice_tpu/ops/pallas_topk.py). Q [B, d] f32 (normalized) cast to
//   the row type; E [N, d]; valid [N] (1 byte per row); the score is the
//   f32 sum of bf16(q) * e. Two routes for bf16 rows, chosen by shape alone
//   (ops/scan_topk.py `bf16_route`): where d % 8 == 0 and Q and E are
//   16-byte aligned (every store's rows), `scan_topk_bf16_wg_kernel` below
//   on scan_wg.cuh's wgmma main loop, from a bf16 copy of Q the wrapper
//   makes (rounded to nearest even, as JAX's astype); any other shape, and
//   f32 rows, scan_topk_kernel's wmma tile loop, which casts Q inside
//   (`lt_scan_topk_bf16_scalar`, `lt_scan_topk_f32`).
// Kernel C, scan_topk_int8: replaces `_binned_kernel_int8` (same file):
//   q int8 [B, d], q-scales f32 [B], E int8 [N, d], e-scales f32 [N].
//   score = (f32(i32 dot) * qs) * es, the plain version's order, so the
//   scores agree bit for bit. Two routes, chosen by shape alone (ops/
//   scan_topk.py `int8_route`): where d % 16 == 0 and q and E are 16-byte
//   aligned (every store's view), `scan_topk_int8_wg_kernel` below, on
//   scan_wg.cuh's wgmma main loop; any other shape, scan_topk_kernel's
//   wmma tile loop (`lt_scan_topk_int8_scalar`).
// Kernel D, scan_topk_int4: replaces `_binned_kernel_int4_hoistq` and its
//   sibling bodies (same file) via `binned_topk_int4`: q int8 [B, d],
//   q-scales f32 [B], packed rows int8 [N, d/2] (low nibble + 8 = dims
//   [0, d/2), high nibble = dims [d/2, d), values in [-8, 7]), e-scales f32
//   [N]. score = (f32(i32 dot) * qs) * es, as kernel C's. Two routes,
//   chosen by shape and list length alone (ops/scan_topk.py `int4_route`):
//   where d/2 % 16 == 0, q and the packed rows are 16-byte aligned and
//   k1 <= MAX_K1 (every store's view at the plans' widths),
//   `scan_topk_int4_wg_kernel` below on scan_wg.cuh's wgmma main loop,
//   which unpacks each packed slab in shared memory for the s8 tensor-core
//   products (`WgS4`); any other shape, and lists past MAX_K1, the wmma
//   tile loop (`lt_scan_topk_int4_scalar`), which unpacks in registers
//   between each thread's 16-byte load of packed bytes and its store of
//   the two int8 halves into the k-major tile. Every partial sum is an
//   integer below 127 * 8 * d, so scores equal the plain version's bit
//   for bit on either route, as kernel C's do.
// Kernel B, merge_candidates (merge_candidates.cu), merges the lists these
//   kernels write: the exact top-k1 over every block's candidates.
//
// Kernel D on wgmma keeps the ring, warps and plan of A and C (design (a)
// of two): the slot carries the packed row slab and the two query slabs
// it meets, and the MMA warps unpack the packed slab into an s8 pair
// before the products (scan_wg.cuh). It was kept because the unpack
// barely slows the loop: D's floor at 128 queries a block is within 10%
// of C's on the same loop (1M x 768, B=256; PERF.md section 6). The other
// design, the rows unpacked straight into register A operands against
// queries resident in shared memory, would save the pair's round trip
// through shared memory and the query traffic, but transposes the
// accumulators and so the score-tile handoff. The ring has fewer, larger
// slots (3 at 128 queries, 4 at 64: as many dims in flight as C's 6 and
// 8) and two s8 pairs, which leaves room for the lists up to K1_WIDE at
// 128 queries and MAX_K1 at 64 (mirrored in
// tests/test_torch_port_scan_int4.py).
//
// Lists of kernels D and B reach k1 = MAX_K1_LONG = 512 (the int4 view
// widens to 8k candidates, 512 at k = 64). A block keeps two lists of k1
// f32 + i32 per query in shared memory: at 64 queries and k1 = 512 that is
// 256 KB, over the 227 KB a block may have. So past k1 = 128 a block of
// kernel D's wmma route owns 32 queries: lists 2 * 32 * 512 * 4 = 128 KB,
// score tile 32 * 132 * 4 = 16.5 KB, tiles 2 + 8 KB, scales and validity
// < 1 KB: ~155 KB. At k1 <= 128 it keeps 64 queries (~110 KB). The wrapper
// (`scan_blocks_int4`) makes that choice and passes it as `bq`, and sizes
// its row chunks for it; each instance refuses another count. That route
// also stages up to 32 candidates per query (8 bytes each) beside its
// list, fewer where 32 would cost a block an SM (`staging_cap`); the
// wgmma route, one block an SM, stages 32 or as many as fit beside its
// ring (`int4_wg_cap`).
//
// Selection is exact at the precision of the scores: each block keeps one
// sorted running top-k1 list per query in shared memory, ordered by
// (score descending, row id ascending), which is the order `lax.top_k`
// gives. Invalid rows score NEG_INF (-1e30) and still take part, so that
// with fewer live rows than k1 the padded slots carry NEG_INF and the
// lowest invalid row ids, exactly as the plain version's stable sort does.
// Kernels A and C fold each 32 scores with `offer` (topk_select.cuh,
// shared with ivf_probe.cu): one ballot against the list's k1-th entry,
// then one serial insertion (ceil(k1 / 32) ballots to place it, a shift of
// the tail) per candidate that beats it. Past k1 = SERIAL_K1 (wmma) or
// WG_SERIAL_K1 (wgmma), kernel D stages the candidates that beat it and
// merges a sorted batch of up to 32 at a time (batch_select.cuh), so that
// it costs one ballot per 32 scores plus about one merge per 32 kept
// candidates; up to there it uses `offer` too.
//
// What bounds it on the H100: one pass over E. At 1M x 768 that is
// 1.61 GB of bf16 (~0.48 ms at 3.35 TB/s, which bounds kernel A), 0.81 GB
// of int8 or 0.40 GB of packed int4; at B=256 the 403 G products ask for
// tensor cores (bf16 at 989 TFLOP/s: ~0.41 ms; int8 and int4 at 1,979
// TOP/s: ~0.21 ms, which bounds kernel D; at 4M x 768, B=1024, its 6.6
// TOP take 3.33 ms against 0.48 ms of bytes).
//
// The wmma routes (A's, C's and D's other shapes): a block owns 64
// queries and a contiguous run of rows (the TPU's sequential grid becomes
// the loop over row tiles inside the block), about four blocks an SM; row
// tiles of 128 go through the tensor cores (wmma m16n16k16, bf16 -> f32
// and s8 -> s32; f32 rows on CUDA-core FMA), the [64, 128] score tile
// lands in shared memory, and each warp folds a quarter of the queries
// into their running lists while the block's tensor cores wait. The loads
// and products of a row tile are `score_tile` (scan_tile.cuh): each
// thread issues all of its 16-byte loads of a k step's query and row
// tiles before it stores any, then the block syncs, runs the products and
// syncs again, so no load is in flight while the products run, and the
// queries are loaded again for every row tile. That serial tile bounded
// kernel D until it moved to wgmma: its floor at 1M x 768, B=256 was 7.4%
// of its bound (PERF.md section 5).
//
// Kernels A, C and D on wgmma (scan_wg.cuh) take that loop apart for
// Hopper: one block an SM (128 queries a block past B = 64 at k1 <= 32,
// else 64, so at B=256 a chunk is read by two blocks instead of four), a
// producer warp that keeps TMA loads of the rows and queries in flight in
// a ring, MMA warpgroups on wgmma (m64n64k16 bf16 -> f32 for A, m64n64k32
// s8 -> s32 for C and D) that store each 64-row tile's sums and go on to
// the next tile, and the selection in 16 epilogue warps of their own, so
// that the tensor cores and the loads run through it. A's and C's floors
// (the probes on the same main loop) are set by the operands' traffic
// through L2 and shared memory (scan_wg.cuh), and a bf16 row is twice the
// bytes of an int8 one. At 1M x 768, B=256, k1=16, A's floor is 38% of
// its bound and its selection 9% of the scan; C's floor is 38% of its
// bound and its selection, `offer` in the epilogue warps, whose every
// step waits on a shared-memory read of the list's tail, 27% (PERF.md
// section 6).

// The number of candidates that beat a full list is not small: for rows
// in random order a top-k1 over a chunk of R rows takes about
// k1 (1 + ln(R / k1)) of them per query (~450 at k1 = 80 and R = 8,064,
// corpus A at B=256). Inserted one at a time, they set kernel D's time at
// k1 = 80 (71% of it over its probe on the wmma route); in batches, the
// loads and products do, and on the wmma route the staging code costs the
// tile loop cycles of its own (see score_tile_int4), which is why short
// lists keep `offer`. Each block writes its lists once; kernel B merges
// the n_chunks lists of each query. A scan's time minus its probe's
// (score_probe.cu, the same loads and products with a bin max in place of
// the lists) is what its selection costs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "scan_tile.cuh"
#include "scan_wg.cuh"
#include "batch_select.cuh"
#include "topk_select.cuh"

namespace {

constexpr int BQ_LONG = 32;     // queries per block of kernel D past MAX_K1
// Kernel D keeps serial insertion (`offer`, the scan_topk_kernel instance)
// up to this list length and stages and merges in batches past it. At
// k1 = 16 the batched kernel was 2% slower on corpus A at B=256 and 17%
// slower at B=1 and at 4M x 768, B=1024; at k1 = 24 it was 4% faster at
// B=256 (tools/kernel_ab.py; PERF.md section 6).
constexpr int SERIAL_K1 = 16;
// The same for kernel D on wgmma (scan_topk_int4_wg_kernel) at 64 queries
// a block: serial `offer` in the epilogue warps up to this list length,
// batches past it. At 128 queries a block (lists up to K1_WIDE) it always
// folds serially: its ring and lists leave room for 5-20 staged entries a
// query, and serial `offer` took 1-27% less time than those batches at k1
// in {16, 24, 32} (1M x 768, B=256; 4M x 768, B=1024). At 64 queries,
// batches took 28% less at k1 = 80 and B=256, 2-4% less at k1 in {24, 32}
// and B=1, as much at k1 = 16, and 8% more at k1 = 80 on 4M x 768 rows,
// B=1024, whose chunks of 524,288 rows beat a full list rarely
// (tools/kernel_ab.py; PERF.md section 6).
constexpr int WG_SERIAL_K1 = 16;
constexpr size_t WG_SMEM_MAX = 232448;  // shared memory a block may have

template <int MODE, int BQ_>
size_t scan_smem_bytes(int k1) {
  return tile_bytes<MODE, BQ_>() + round_up(BQ_ * SC_LD * 4)  // score tile
         + round_up(BN * 4) + round_up(BQ_ * 4)  // row / query scales
         + 2 * round_up((size_t)BQ_ * k1 * 4)    // lists
         + round_up(BN);                         // row validity
}

// BQ_ queries per block; lists of at most KMAX entries
template <int MODE, int BQ_, int KMAX>
__global__ void __maxnreg__((SCAN_REGS<MODE, BQ_>))
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
  p += MODE == MODE_F32 ? round_up(BQ * (BK + 1) * 4)
                        : round_up(BQ * BK * sizeof(T));
  T* Es = reinterpret_cast<T*>(p);
  p += MODE == MODE_F32 ? round_up(BN * (BK + 1) * 4)
                        : round_up(BN * BK * sizeof(T));
  float* Sc = reinterpret_cast<float*>(p);
  const int* Sci = reinterpret_cast<const int*>(p);
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

    score_tile<MODE, BQ>(q, e, Qs, Es, Sc, q0, B, row0, chunk_hi, d, vec);
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

// Kernel D: the same tile loop as scan_topk_kernel over packed int4 rows,
// with the batched selection of batch_select.cuh: each query has a
// staging buffer of `cap` entries (Bs, Bi; its fill in Bn) beside its list.
template <int BQ_>
size_t scan_int4_smem_bytes(int k1, int cap) {
  return scan_smem_bytes<MODE_I4, BQ_>(k1) +
         2 * round_up((size_t)BQ_ * cap * 4) + round_up(BQ_ * 4);
}

// Kernel D's call of score_tile, out of line. Inlined beside the staging
// code, the same loads and products took more cycles a tile on an H100
// (PERF.md section 6); out of line, with merge_buffer out of line
// too, the batched kernel came within 2% of the serial one at k1 = 16 on
// corpus A at B=256. It runs under the kernel's register cap, as the int4
// probe does, and finds the tiles where the kernel lays them out.
template <int BQ_>
__device__ __noinline__ void score_tile_int4(const signed char* q,
                                             const signed char* e, int q0,
                                             int B, int row0, int r_end,
                                             int d, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* Qs = reinterpret_cast<signed char*>(smem);
  signed char* Es = Qs + round_up(BQ_ * Cfg<MODE_I4>::BK);
  float* Sc = reinterpret_cast<float*>(smem + tile_bytes<MODE_I4, BQ_>());
  score_tile<MODE_I4, BQ_>(q, e, Qs, Es, Sc, q0, B, row0, r_end, d, vec);
}

template <int BQ_, int KMAX>
__global__ void __maxnreg__((SCAN_REGS<MODE_I4, BQ_>))
scan_topk_int4_kernel(const signed char* __restrict__ q,
                      const float* __restrict__ qs,
                      const signed char* __restrict__ e,
                      const float* __restrict__ es,
                      const uint8_t* __restrict__ valid, int B, int n, int d,
                      int k1, int cap, int rows_per_chunk, int n_chunks,
                      int vec, float* __restrict__ cand_s,
                      int* __restrict__ cand_i) {
  constexpr int BQ = BQ_;
  constexpr int QW = BQ / 4;  // queries each warp selects for
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x, q0 = blockIdx.y * BQ;
  const int chunk_lo = chunk * rows_per_chunk;
  const int chunk_hi = min(chunk_lo + rows_per_chunk, n);

  unsigned char* p = smem + tile_bytes<MODE_I4, BQ>();  // score_tile's
  const int* Sci = reinterpret_cast<const int*>(p);
  p += round_up(BQ * SC_LD * 4);
  float* esc = reinterpret_cast<float*>(p);
  p += round_up(BN * 4);
  float* qsc = reinterpret_cast<float*>(p);
  p += round_up(BQ * 4);
  float* Ls = reinterpret_cast<float*>(p);
  p += round_up((size_t)BQ * k1 * 4);
  int* Li = reinterpret_cast<int*>(p);
  p += round_up((size_t)BQ * k1 * 4);
  float* Bs = reinterpret_cast<float*>(p);
  p += round_up((size_t)BQ * cap * 4);
  int* Bi = reinterpret_cast<int*>(p);
  p += round_up((size_t)BQ * cap * 4);
  int* Bn = reinterpret_cast<int*>(p);
  p += round_up(BQ * 4);
  uint8_t* Vs = reinterpret_cast<uint8_t*>(p);

  for (int i = threadIdx.x; i < BQ * k1; i += THREADS) {
    Ls[i] = neg_infinity();
    Li[i] = EMPTY_ID;
  }
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    qsc[i] = q0 + i < B ? qs[q0 + i] : 0.f;
    Bn[i] = 0;
  }

  for (int row0 = chunk_lo; row0 < chunk_hi; row0 += BN) {
    for (int c = threadIdx.x; c < BN; c += THREADS) {
      int row = row0 + c;
      Vs[c] = row < chunk_hi ? valid[row] : 0;
      esc[c] = row < chunk_hi ? es[row] : 0.f;
    }

    score_tile_int4<BQ>(q, e, q0, B, row0, chunk_hi, d, vec);
    __syncthreads();

    // selection: warp w stages queries [w QW, (w + 1) QW) of the tile
    for (int qq = 0; qq < QW; ++qq) {
      const int qi = warp * QW + qq;
      if (q0 + qi >= B) break;
      float* ls = Ls + qi * k1;
      int* li = Li + qi * k1;
      float* bs = Bs + qi * cap;
      int* bi = Bi + qi * cap;
      int cnt = Bn[qi];
      float ts = ls[k1 - 1];
      int ti = li[k1 - 1];
#pragma unroll
      for (int c0 = 0; c0 < BN; c0 += 32) {
        const int c = c0 + lane, row = row0 + c;
        const bool in = row < chunk_hi;
        float s = NEG_INF;
        if (in && Vs[c])
          s = __fmul_rn(__fmul_rn((float)Sci[qi * SC_LD + c], qsc[qi]),
                        esc[c]);
        stage<KMAX>(ls, li, k1, bs, bi, cap, cnt, ts, ti, s, row, in, lane);
      }
      if (lane == 0) Bn[qi] = cnt;
    }
    __syncthreads();
  }

  for (int qq = 0; qq < QW; ++qq) {
    const int qi = warp * QW + qq;
    if (q0 + qi >= B) break;
    if (Bn[qi] > 0)
      merge_buffer<KMAX>(Ls + qi * k1, Li + qi * k1, k1, Bs + qi * cap,
                         Bi + qi * cap, Bn[qi], lane);
    const size_t base = ((size_t)(q0 + qi) * n_chunks + chunk) * k1;
    for (int j = lane; j < k1; j += 32) {
      cand_s[base + j] = Ls[qi * k1 + j];
      cand_i[base + j] = Li[qi * k1 + j];
    }
  }
}

// Staging entries per query at list length k1: SEL_CAP, or the most that
// keeps as many blocks on an SM as the lists alone allow (at 64 queries a
// block, 32 entries keep two blocks an SM up to k1 of about 100; at
// k1 = 128 only a few entries do). Known per (device, k1) after its first
// launch on that device: the shared-memory opt-in and the occupancy it
// measures are the current device's (devices past CAP_DEVICES measure at
// every launch).
constexpr int CAP_DEVICES = 64;

template <int BQ_, int KMAX>
cudaError_t staging_cap(int k1, int* cap) {
  static int known[CAP_DEVICES][KMAX + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* slot = dev < CAP_DEVICES ? &known[dev][k1] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *cap = *slot;
    return cudaSuccess;
  }
  auto kern = scan_topk_int4_kernel<BQ_, KMAX>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scan_int4_smem_bytes<BQ_>(k1, SEL_CAP));
  if (err != cudaSuccess) return err;
  int lists_only = 0, c = SEL_CAP;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &lists_only, kern, THREADS, scan_int4_smem_bytes<BQ_>(k1, 0));
  for (; err == cudaSuccess && c > 1; --c) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, THREADS, scan_int4_smem_bytes<BQ_>(k1, c));
    if (blocks >= lists_only) break;
  }
  if (err != cudaSuccess) return err;
  *cap = c;
  if (slot != nullptr) *slot = c;
  return cudaSuccess;
}

template <int BQ_, int KMAX>
int launch_scan_int4(const void* q, const void* qs, const void* e,
                     const void* es, const void* valid, int B, int n, int d,
                     int k1, int bq, int rows_per_chunk, int n_chunks,
                     int vec, void* cand_s, void* cand_i, void* stream) {
  if (B < 1 || n < 1 || d < 1 || d % 2 != 0 || k1 < 1 || k1 > KMAX ||
      bq != BQ_ || rows_per_chunk < BN || rows_per_chunk % BN != 0 ||
      n_chunks < 1 || (size_t)(n_chunks - 1) * rows_per_chunk >= (size_t)n ||
      (size_t)n_chunks * rows_per_chunk < (size_t)n)
    return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err = staging_cap<BQ_, KMAX>(k1, &cap);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = scan_int4_smem_bytes<BQ_>(k1, cap);
  auto kern = scan_topk_int4_kernel<BQ_, KMAX>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (B + BQ_ - 1) / BQ_);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(qs),
      static_cast<const signed char*>(e), static_cast<const float*>(es),
      static_cast<const uint8_t*>(valid), B, n, d, k1, cap, rows_per_chunk,
      n_chunks, vec, static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  return (int)cudaGetLastError();
}

// ---- kernels A and C on wgmma: the selection epilogue of wg_scan ----------

// Shared memory of the selection epilogue past wg_scan's score tile: two
// lists of k1 entries per query.
template <int BQ_>
__host__ __device__ size_t select_epi_bytes(int k1) {
  return 2 * round_up((size_t)BQ_ * k1 * 4);
}

// An epilogue warp of kernel A or C folds each stored tile (its NQ queries
// x 64 rows of raw sums, Acc) into its queries' lists with `offer`, exactly
// as scan_topk_kernel does: the score is the f32 sum itself (A), or
// (f32(sum) * qs) * es (C); NEG_INF where the row is invalid, rows past
// the chunk not offered; each query's two scores are made before its two
// offers. Each lane keeps the validity (and C's row scales) of its 2
// columns of the tile, loaded one tile ahead, and C's scale of one of the
// warp's NQ queries.
//
// With BATCHED (kernel D past WG_SERIAL_K1) the scores are staged and
// merged in batches instead (batch_select.cuh, as scan_topk_int4_kernel
// does): each query has a staging buffer of `cap` entries (Bs, Bi; its
// fill in Bn, which every lane writes alike) past the block's lists, and
// `finish` merges what is left in it.
template <int KMAX, int NQ, typename Acc, bool BATCHED = false>
struct SelectEpi {
  static constexpr bool SCALED = std::is_same<Acc, int>::value;
  float* Ls;               // this warp's NQ lists (k1 entries each)
  int* Li;
  float* Bs;               // BATCHED: this warp's NQ staging buffers
  int* Bi;
  int* Bn;
  int cap;
  const float* es;         // C only
  const uint8_t* valid;
  float* cand_s;           // this warp's first query's lists of this chunk
  int* cand_i;
  size_t ld;               // between two queries' lists: n_chunks * k1
  int k1, row_hi, live, lane;  // live: this warp's queries < B (<= NQ)
  float qsr;                   // C: scale of query lane % NQ of the warp
  bool ahead = false;          // esn / vn hold the tile about to come
  float esn[2];
  int vn[2];

  // Epilogue warp e's lists (queries q0 + NQ e ...) in the shared memory
  // `lists` past the score tile, set to empty, and where they are written.
  __device__ __forceinline__ void init(unsigned char* lists, int bq, int e,
                                       int q0, int B, int k1_, int chunk,
                                       int n_chunks, int chunk_hi,
                                       const uint8_t* valid_, float* cs,
                                       int* ci, int lane_) {
    const int qe = q0 + NQ * e;
    Ls = reinterpret_cast<float*>(lists) + NQ * e * k1_;
    Li = reinterpret_cast<int*>(lists + round_up((size_t)bq * k1_ * 4)) +
         NQ * e * k1_;
    for (int i = lane_; i < NQ * k1_; i += 32) {
      Ls[i] = neg_infinity();
      Li[i] = EMPTY_ID;
    }
    valid = valid_;
    ld = (size_t)n_chunks * k1_;
    cand_s = cs + ((size_t)qe * n_chunks + chunk) * k1_;
    cand_i = ci + ((size_t)qe * n_chunks + chunk) * k1_;
    k1 = k1_;
    row_hi = chunk_hi;
    live = max(0, min(NQ, B - qe));
    lane = lane_;
  }

  // BATCHED: epilogue warp e's staging buffers in the shared memory
  // `staging` past the lists, empty.
  __device__ __forceinline__ void init_staging(unsigned char* staging, int bq,
                                               int e, int cap_) {
    cap = cap_;
    const size_t bytes = round_up((size_t)bq * cap * 4);
    Bs = reinterpret_cast<float*>(staging) + NQ * e * cap;
    Bi = reinterpret_cast<int*>(staging + bytes) + NQ * e * cap;
    Bn = reinterpret_cast<int*>(staging + 2 * bytes) + NQ * e;
    if (lane < NQ) Bn[lane] = 0;
    __syncwarp();
  }

  __device__ __forceinline__ void fetch(int row0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + 32 * j + lane;
      const bool in = row < row_hi;
      if constexpr (SCALED) esn[j] = in ? __ldg(es + row) : 0.f;
      vn[j] = in ? valid[row] : 0;
    }
  }

  __device__ __forceinline__ void tile(const Acc* S, int row0) {
    if (!ahead) fetch(row0);
    float esr[2];
    int vr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      esr[j] = esn[j];
      vr[j] = vn[j];
    }
    fetch(row0 + WG_BN);  // the next tile's, while this one is folded
    ahead = true;
    for (int qq = 0; qq < live; ++qq) {
      float qsv = 0.f;
      if constexpr (SCALED) qsv = __shfl_sync(FULL, qsr, qq);
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 32 * j + lane;
        s[j] = NEG_INF;
        if (row0 + c < row_hi && vr[j]) {
          if constexpr (SCALED)
            s[j] = __fmul_rn(__fmul_rn((float)S[qq * WG_SC_LD + c], qsv),
                             esr[j]);
          else
            s[j] = S[qq * WG_SC_LD + c];
        }
      }
      float* ls = Ls + qq * k1;
      int* li = Li + qq * k1;
      if constexpr (BATCHED) {
        int cnt = Bn[qq];
        float ts = ls[k1 - 1];  // the gate: the list's k1-th entry
        int ti = li[k1 - 1];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = row0 + 32 * j + lane;
          stage<KMAX>(ls, li, k1, Bs + qq * cap, Bi + qq * cap, cap, cnt, ts,
                      ti, s[j], row, row < row_hi, lane);
        }
        Bn[qq] = cnt;
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = row0 + 32 * j + lane;
          offer<KMAX>(ls, li, k1, s[j], row, row < row_hi, lane);
        }
      }
    }
  }

  __device__ __forceinline__ void finish() {
    for (int qq = 0; qq < live; ++qq) {
      if constexpr (BATCHED)
        if (Bn[qq] > 0)
          merge_buffer<KMAX>(Ls + qq * k1, Li + qq * k1, k1, Bs + qq * cap,
                             Bi + qq * cap, Bn[qq], lane);
      for (int j = lane; j < k1; j += 32) {
        cand_s[qq * ld + j] = Ls[qq * k1 + j];
        cand_i[qq * ld + j] = Li[qq * k1 + j];
      }
    }
  }
};

// The shared memory of a block's lists: past wg_scan's ring, mbarriers and
// score tile.
template <int BQ_, typename Op = WgS8>
__device__ __forceinline__ unsigned char* wg_lists(unsigned char* sm) {
  return sm + WgRing<BQ_, Op>::BYTES + WG_BAR_BYTES +
         round_up((size_t)BQ_ * WG_SC_LD * 4);
}

// Kernel C: BQ_ queries [q0, q0 + BQ_) against the rows of one chunk,
// loads and products by wg_scan (int8), the selection in its epilogue
// warps.
template <int BQ_>
__global__ void __maxnreg__((WgCfg<BQ_>::REGS))
scan_topk_int8_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap rmap,
                         const float* __restrict__ qs,
                         const float* __restrict__ es,
                         const uint8_t* __restrict__ valid, int B, int n,
                         int d, int k1, int rows_per_chunk, int n_chunks,
                         float* __restrict__ cand_s,
                         int* __restrict__ cand_i) {
  using C = WgCfg<BQ_>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg_smem_base(smem_raw);
  const int chunk = blockIdx.x, q0 = blockIdx.y * BQ_;
  const int chunk_lo = chunk * rows_per_chunk;
  const int chunk_hi = min(chunk_lo + rows_per_chunk, n);
  const int lane = threadIdx.x & 31, e = (threadIdx.x >> 5) - C::MMA_WARPS;
  constexpr int NQ = C::EPI_Q;
  SelectEpi<C::KMAX, NQ, int> epi;
  if (e >= 0 && e < C::EPI_WARPS) {  // an epilogue warp: queries NQ e ...
    epi.init(wg_lists<BQ_>(sm), BQ_, e, q0, B, k1, chunk, n_chunks,
             chunk_hi, valid, cand_s, cand_i, lane);
    const int qe = q0 + NQ * e;
    epi.es = es;
    epi.qsr = qe + lane % NQ < B ? qs[qe + lane % NQ] : 0.f;
  }
  wg_scan<BQ_, WgS8>(&rmap, &qmap, sm, q0, B, chunk_lo, chunk_hi, d, epi);
}

// Kernel A: the same blocks over bf16 queries and rows (f32 sums), the
// score the sum itself.
template <int BQ_>
__global__ void __maxnreg__((WgCfg<BQ_>::REGS))
scan_topk_bf16_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap rmap,
                         const uint8_t* __restrict__ valid, int B, int n,
                         int d, int k1, int rows_per_chunk, int n_chunks,
                         float* __restrict__ cand_s,
                         int* __restrict__ cand_i) {
  using C = WgCfg<BQ_>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg_smem_base(smem_raw);
  const int chunk = blockIdx.x, q0 = blockIdx.y * BQ_;
  const int chunk_lo = chunk * rows_per_chunk;
  const int chunk_hi = min(chunk_lo + rows_per_chunk, n);
  const int lane = threadIdx.x & 31, e = (threadIdx.x >> 5) - C::MMA_WARPS;
  SelectEpi<C::KMAX, C::EPI_Q, float> epi;
  if (e >= 0 && e < C::EPI_WARPS)
    epi.init(wg_lists<BQ_>(sm), BQ_, e, q0, B, k1, chunk, n_chunks,
             chunk_hi, valid, cand_s, cand_i, lane);
  wg_scan<BQ_, WgBf16>(&rmap, &qmap, sm, q0, B, chunk_lo, chunk_hi, d, epi);
}

// Kernel D on wgmma: the same blocks over int8 queries and packed int4
// rows (wg_scan over WgS4, which unpacks each slab for the tensor cores),
// the score (f32(sum) * qs) * es as kernel C's; serial `offer`, or staged
// batches (BATCHED: 64 queries a block past WG_SERIAL_K1).
template <int BQ_, bool BATCHED>
__global__ void __maxnreg__((WgCfg<BQ_>::REGS))
scan_topk_int4_wg_kernel(const __grid_constant__ WgQMaps2 qmaps,
                         const __grid_constant__ CUtensorMap rmap,
                         const float* __restrict__ qs,
                         const float* __restrict__ es,
                         const uint8_t* __restrict__ valid, int B, int n,
                         int dh, int k1, int cap, int rows_per_chunk,
                         int n_chunks, float* __restrict__ cand_s,
                         int* __restrict__ cand_i) {
  using C = WgCfg<BQ_>;
  using Op = WgS4<NIB_BIASED>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg_smem_base(smem_raw);
  const int chunk = blockIdx.x, q0 = blockIdx.y * BQ_;
  const int chunk_lo = chunk * rows_per_chunk;
  const int chunk_hi = min(chunk_lo + rows_per_chunk, n);
  const int lane = threadIdx.x & 31, e = (threadIdx.x >> 5) - C::MMA_WARPS;
  constexpr int NQ = C::EPI_Q;
  SelectEpi<C::KMAX, NQ, int, BATCHED> epi;
  if (e >= 0 && e < C::EPI_WARPS) {
    unsigned char* lists = wg_lists<BQ_, Op>(sm);
    epi.init(lists, BQ_, e, q0, B, k1, chunk, n_chunks, chunk_hi, valid,
             cand_s, cand_i, lane);
    const int qe = q0 + NQ * e;
    epi.es = es;
    epi.qsr = qe + lane % NQ < B ? qs[qe + lane % NQ] : 0.f;
    if constexpr (BATCHED)
      epi.init_staging(lists + select_epi_bytes<BQ_>(k1), BQ_, e, cap);
  }
  wg_scan<BQ_, Op>(&rmap, qmaps.m, sm, q0, B, chunk_lo, chunk_hi, dh, epi);
}

// Kernel D's wgmma block: the selection epilogue's lists and `cap` staging
// entries a query (cap = 0: serial).
template <int BQ_>
size_t int4_wg_smem_bytes(int k1, int cap) {
  return wg_smem_bytes<BQ_, WgS4<NIB_BIASED>>(
      select_epi_bytes<BQ_>(k1) +
      (cap > 0 ? 2 * round_up((size_t)BQ_ * cap * 4) + round_up(BQ_ * 4)
               : 0));
}

// Staging entries a query of kernel D's wgmma block: 0 (serial) at 128
// queries or up to WG_SERIAL_K1, else SEL_CAP or the most that fit beside
// its ring and lists (one block an SM whatever the cap, so only the
// block's limit counts). Mirrored by `int4_staging_cap` in
// tests/test_torch_port_scan_int4.py.
template <int BQ_>
int int4_wg_cap(int k1) {
  if (BQ_ == BQ_WIDE || k1 <= WG_SERIAL_K1) return 0;
  int c = SEL_CAP;
  while (c > 1 && int4_wg_smem_bytes<BQ_>(k1, c) > WG_SMEM_MAX) --c;
  return c;
}

// The arguments both wgmma routes refuse: `vec` must be 1 (16-byte rows and
// pointers; the wrappers send other shapes to the wmma tile loop), `bq`
// names the instance, and the chunks must cover the rows, none empty.
template <int BQ_>
bool wg_args_ok(int B, int n, int k1, int bq, int rows_per_chunk,
                int n_chunks, int vec) {
  return B >= 1 && n >= 1 && k1 >= 1 && k1 <= WgCfg<BQ_>::KMAX && bq == BQ_ &&
         vec == 1 && rows_per_chunk >= BN && rows_per_chunk % BN == 0 &&
         n_chunks >= 1 && (size_t)(n_chunks - 1) * rows_per_chunk < (size_t)n &&
         (size_t)n_chunks * rows_per_chunk >= (size_t)n;
}

template <int BQ_>
int launch_scan_int8_wg(const void* q, const void* qs, const void* e,
                        const void* es, const void* valid, int B, int n,
                        int d, int k1, int bq, int rows_per_chunk,
                        int n_chunks, int vec, void* cand_s, void* cand_i,
                        void* stream) {
  CUtensorMap qmap, rmap;
  if (!wg_args_ok<BQ_>(B, n, k1, bq, rows_per_chunk, n_chunks, vec) ||
      !wg_maps<WgS8>(&qmap, &rmap, q, e, B, n, d))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes<BQ_>(select_epi_bytes<BQ_>(k1));
  auto kern = scan_topk_int8_wg_kernel<BQ_>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (B + BQ_ - 1) / BQ_);
  kern<<<grid, WgCfg<BQ_>::THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      qmap, rmap, static_cast<const float*>(qs), static_cast<const float*>(es),
      static_cast<const uint8_t*>(valid), B, n, d, k1, rows_per_chunk,
      n_chunks, static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  return (int)cudaGetLastError();
}

template <int BQ_>
int launch_scan_bf16_wg(const void* q, const void* e, const void* valid,
                        int B, int n, int d, int k1, int bq,
                        int rows_per_chunk, int n_chunks, int vec,
                        void* cand_s, void* cand_i, void* stream) {
  CUtensorMap qmap, rmap;
  if (!wg_args_ok<BQ_>(B, n, k1, bq, rows_per_chunk, n_chunks, vec) ||
      !wg_maps<WgBf16>(&qmap, &rmap, q, e, B, n, d))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes<BQ_>(select_epi_bytes<BQ_>(k1));
  auto kern = scan_topk_bf16_wg_kernel<BQ_>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (B + BQ_ - 1) / BQ_);
  kern<<<grid, WgCfg<BQ_>::THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      qmap, rmap, static_cast<const uint8_t*>(valid), B, n, d, k1,
      rows_per_chunk, n_chunks, static_cast<float*>(cand_s),
      static_cast<int*>(cand_i));
  return (int)cudaGetLastError();
}

template <int BQ_>
int launch_scan_int4_wg(const void* q, const void* qs, const void* e,
                        const void* es, const void* valid, int B, int n,
                        int d, int k1, int bq, int rows_per_chunk,
                        int n_chunks, int vec, void* cand_s, void* cand_i,
                        void* stream) {
  WgQMaps2 qmaps;
  CUtensorMap rmap;
  if (!wg_args_ok<BQ_>(B, n, k1, bq, rows_per_chunk, n_chunks, vec) ||
      !wg_maps_int4(&qmaps, &rmap, q, e, B, n, d))
    return (int)cudaErrorInvalidValue;
  const int cap = int4_wg_cap<BQ_>(k1);
  const size_t smem = int4_wg_smem_bytes<BQ_>(k1, cap);
  auto kern = scan_topk_int4_wg_kernel<BQ_, false>;
  if constexpr (BQ_ != BQ_WIDE)
    if (cap > 0) kern = scan_topk_int4_wg_kernel<BQ_, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (B + BQ_ - 1) / BQ_);
  kern<<<grid, WgCfg<BQ_>::THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      qmaps, rmap, static_cast<const float*>(qs),
      static_cast<const float*>(es), static_cast<const uint8_t*>(valid), B,
      n, d / 2, k1, cap, rows_per_chunk, n_chunks,
      static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch (0 = success).

// kernel A: bf16 queries and rows, d % 8 == 0, 16-byte aligned (vec = 1);
// bq = BQ_WIDE takes lists up to K1_WIDE, bq = 64 up to MAX_K1
int lt_scan_topk_bf16(const void* q, const void* e, const void* valid, int B,
                      int n, int d, int k1, int bq, int rows_per_chunk,
                      int n_chunks, int vec, void* cand_s, void* cand_i,
                      void* stream) {
  if (bq == BQ_WIDE)
    return launch_scan_bf16_wg<BQ_WIDE>(q, e, valid, B, n, d, k1, bq,
                                        rows_per_chunk, n_chunks, vec, cand_s,
                                        cand_i, stream);
  return launch_scan_bf16_wg<64>(q, e, valid, B, n, d, k1, bq, rows_per_chunk,
                                 n_chunks, vec, cand_s, cand_i, stream);
}

// kernel A for every other shape: f32 queries cast to bf16 in the wmma
// tile loop of scan_topk_kernel
int lt_scan_topk_bf16_scalar(const void* q, const void* e, const void* valid,
                             int B, int n, int d, int k1, int bq,
                             int rows_per_chunk, int n_chunks, int vec,
                             void* cand_s, void* cand_i, void* stream) {
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

// kernel C: bq = BQ_WIDE takes lists up to K1_WIDE, bq = 64 up to MAX_K1;
// d % 16 == 0 and 16-byte aligned q and e (vec = 1)
int lt_scan_topk_int8(const void* q, const void* qs, const void* e,
                      const void* es, const void* valid, int B, int n, int d,
                      int k1, int bq, int rows_per_chunk, int n_chunks,
                      int vec, void* cand_s, void* cand_i, void* stream) {
  if (bq == BQ_WIDE)
    return launch_scan_int8_wg<BQ_WIDE>(q, qs, e, es, valid, B, n, d, k1, bq,
                                        rows_per_chunk, n_chunks, vec, cand_s,
                                        cand_i, stream);
  return launch_scan_int8_wg<64>(q, qs, e, es, valid, B, n, d, k1, bq,
                                 rows_per_chunk, n_chunks, vec, cand_s,
                                 cand_i, stream);
}

// kernel C for every other shape: the wmma tile loop of scan_topk_kernel
int lt_scan_topk_int8_scalar(const void* q, const void* qs, const void* e,
                             const void* es, const void* valid, int B, int n,
                             int d, int k1, int bq, int rows_per_chunk,
                             int n_chunks, int vec, void* cand_s,
                             void* cand_i, void* stream) {
  return launch_scan<MODE_I8>(q, qs, e, es, valid, B, n, d, k1, bq,
                              rows_per_chunk, n_chunks, vec, cand_s, cand_i,
                              stream);
}

// kernel D: bq = BQ_WIDE takes lists up to K1_WIDE, bq = 64 up to MAX_K1;
// d/2 % 16 == 0 and 16-byte aligned q and packed rows (vec = 1)
int lt_scan_topk_int4(const void* q, const void* qs, const void* e,
                      const void* es, const void* valid, int B, int n, int d,
                      int k1, int bq, int rows_per_chunk, int n_chunks,
                      int vec, void* cand_s, void* cand_i, void* stream) {
  if (bq == BQ_WIDE)
    return launch_scan_int4_wg<BQ_WIDE>(q, qs, e, es, valid, B, n, d, k1, bq,
                                        rows_per_chunk, n_chunks, vec, cand_s,
                                        cand_i, stream);
  return launch_scan_int4_wg<64>(q, qs, e, es, valid, B, n, d, k1, bq,
                                 rows_per_chunk, n_chunks, vec, cand_s,
                                 cand_i, stream);
}

// kernel D for every other shape and for lists past MAX_K1: the wmma tile
// loop; bq = BQ takes lists up to MAX_K1, bq = BQ_LONG up to MAX_K1_LONG
int lt_scan_topk_int4_scalar(const void* q, const void* qs, const void* e,
                             const void* es, const void* valid, int B, int n,
                             int d, int k1, int bq, int rows_per_chunk,
                             int n_chunks, int vec, void* cand_s,
                             void* cand_i, void* stream) {
  if (bq == BQ && k1 <= SERIAL_K1)
    return launch_scan<MODE_I4>(q, qs, e, es, valid, B, n, d, k1, bq,
                                rows_per_chunk, n_chunks, vec, cand_s, cand_i,
                                stream);
  if (bq == BQ)
    return launch_scan_int4<BQ, MAX_K1>(q, qs, e, es, valid, B, n, d, k1, bq,
                                        rows_per_chunk, n_chunks, vec, cand_s,
                                        cand_i, stream);
  return launch_scan_int4<BQ_LONG, MAX_K1_LONG>(
      q, qs, e, es, valid, B, n, d, k1, bq, rows_per_chunk, n_chunks, vec,
      cand_s, cand_i, stream);
}

const char* lt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
