// Score-floor probe for Hopper (sm_90a), plain C interface.
//
// score_probe replaces the dissection kernels of the round-2 scripts:
// `make_probe.kern` (scripts/r2_tpu_experiments3.py:106, bf16),
// `make_int4_probe.kern` (r2_tpu_experiments4.py:121) and
// `make_probe.kern_bf16` / `kern_int8` / `kern_int4`
// (r2_tpu_experiments6.py:109, :120, :132). Each computes a scan's product
// and then only a max over 128 strided bins of each row tile, with no
// running top-k: its time is the floor of a scan kernel with the selection
// taken out. For queries [B, d] and rows [N, d] (packed [N, d/2] for int4),
// tiles of `tile` rows and t < N / tile (trailing rows dropped),
//   out[b, t*128 + j] = max over i < tile/128 of v(b, t*tile + i*128 + j)
// where v is, by type and mode:
// - bf16 rows, f32 queries cast to bf16, f32 sums: the score ("rawmax"),
//   or the packed key (bits(s + 2.0f) & ~0xFFF) | (i*128 + j) ("pack",
//   `pallas_topk._pack_keys_fast` at its default shift 12, also at tile
//   8192 where the column reaches bit 12, as the scripts ran it);
// - int8 rows and queries: the i32 sum as f32 with no scales, or its key;
// - int4: q[:, :d/2] . lo + q[:, d/2:] . hi in i32 with the scripts'
//   unpack lo = ((b & 0xF) ^ 8) - 8, hi = b >> 4. `quantize_rows_int4`
//   stores lo + 8, so on its bytes this is not the view's dot product: a
//   quirk of the reference, kept so that the floor does the scripts' work.
// Keys and i32 sums are maxed as i32 and written as f32 rounded to nearest
// (`.astype(f32)`), rawmax scores as they are.
//
// What bounds it on the H100 is what bounds the scan of its type: one pass
// over the rows (1.61 GB of bf16, 0.81 GB of int8, 0.40 GB of packed int4
// at 1M x 768) and, at B=256, 403 G products (0.41 ms at 989 TFLOP/s in
// bf16, 0.20 ms at 1,979 TOP/s in int8); the [B, N/tile * 128] f32 output
// adds 67 MB at tile 2048. Design: the loads and products of its scan, so
// that a scan's time minus its probe's is what its selection costs.
// - int4, and bf16 and int8 on kernels A's and C's wmma routes: the same
//   blocks, loads and wmma products as kernel D and those routes
//   (`score_tile`, scan_tile.cuh). A block owns 64 queries and a run of
//   whole probe tiles; each warp maxes its own fragments of a row tile's
//   scores into the running bin max it keeps in the shared score tile (a
//   wmma load, an element-wise max, a store: the accumulator layout is the
//   same on both sides, so no element needs its position), and the block
//   writes [64, 128] once per probe tile.
// - bf16 and int8 where kernels A and C run on wgmma (rows of a multiple
//   of 16 bytes, 16-byte aligned): their main loop itself (scan_wg.cuh:
//   the instance the scan takes at the caller's k1, one block an SM, the
//   TMA producer, the MMA warps that store each tile's f32 or i32 sums,
//   the register budget; bf16 from the wrapper's bf16 copy of the
//   queries, as kernel A), with the epilogue warps folding the stored
//   tiles into a running bin max in registers instead of selecting. That
//   loop is not serial: what bounds the floor is the operands' traffic
//   through L2 and shared memory, twice the bytes in bf16 as in int8
//   (scan_wg.cuh; PERF.md section 6).
// In pack mode a fragment element only knows its row tile i, so the
// running max holds (key bits) | (i << 7) and the column j joins at the
// write: max over i of (a_i | j) = (max over i of a_i) | j when no a_i has
// a bit below 7.

#include <climits>
#include <type_traits>

#include "scan_tile.cuh"
#include "scan_wg.cuh"

namespace {

// (bits(s + 2) with the low 12 bits cleared) | (i << 7): a packed key
// without its column j
__device__ __forceinline__ int key_of(float s, int i) {
  return (__float_as_int(__fadd_rn(s, 2.f)) & ~0xFFF) | (i << 7);
}

// The probe's epilogue: fold row tile i's fragments into the running max
// held in Sc (f32 scores, or i32 keys and sums; bf16 keys as f32 bits).
template <bool PACK>
struct FoldMax {
  int i;
  __device__ __forceinline__ void operator()(const FragF& acc, float* Sc,
                                             int off) const {
    FragF mx;
    wmma::load_matrix_sync(mx, Sc + off, SC_LD, wmma::mem_row_major);
#pragma unroll
    for (int t = 0; t < mx.num_elements; ++t)
      mx.x[t] = PACK ? __int_as_float(max(__float_as_int(mx.x[t]),
                                          key_of(acc.x[t], i)))
                     : fmaxf(mx.x[t], acc.x[t]);
    wmma::store_matrix_sync(Sc + off, mx, SC_LD, wmma::mem_row_major);
  }
  __device__ __forceinline__ void operator()(const FragI& acc, float* Sc,
                                             int off) const {
    int* S = reinterpret_cast<int*>(Sc) + off;
    FragI mx;
    wmma::load_matrix_sync(mx, S, SC_LD, wmma::mem_row_major);
#pragma unroll
    for (int t = 0; t < mx.num_elements; ++t)
      mx.x[t] = max(mx.x[t], PACK ? key_of(__int2float_rn(acc.x[t]), i)
                                  : acc.x[t]);
    wmma::store_matrix_sync(S, mx, SC_LD, wmma::mem_row_major);
  }
};

template <int MODE>
size_t probe_smem_bytes() {
  return tile_bytes<MODE, BQ>() + round_up(BQ * SC_LD * 4);
}

// The probe's blocks: each owns 64 queries and the probe tiles
// [tiles_per_chunk * blockIdx.x, ...) of n_tiles.
template <int MODE, bool PACK>
__device__ __forceinline__ void probe_tiles(
    const typename Cfg<MODE>::Q* __restrict__ q,
    const typename Cfg<MODE>::T* __restrict__ e, int B, int d, int tile,
    int n_tiles, int tiles_per_chunk, int vec, float* __restrict__ out) {
  using T = typename Cfg<MODE>::T;
  // the running max is i32 (keys, integer sums) or f32 (bf16 rawmax)
  constexpr bool IMAX = PACK || MODE != MODE_BF16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Es =
      reinterpret_cast<T*>(smem + round_up(BQ * Cfg<MODE>::BK * sizeof(T)));
  float* Sc = reinterpret_cast<float*>(smem + tile_bytes<MODE, BQ>());
  int* Sci = reinterpret_cast<int*>(Sc);
  const int q0 = blockIdx.y * BQ;
  const int t_lo = blockIdx.x * tiles_per_chunk;
  const int t_hi = min(t_lo + tiles_per_chunk, n_tiles);
  const size_t out_ld = (size_t)n_tiles * BN;

  for (int t = t_lo; t < t_hi; ++t) {
    for (int x = threadIdx.x; x < BQ * BN; x += THREADS) {
      const int at = x / BN * SC_LD + x % BN;
      if (IMAX)
        Sci[at] = INT_MIN;
      else
        Sc[at] = __int_as_float(0xff800000);   // -inf
    }
    // score_tile syncs after its first loads, before any fold reads Sc;
    // each warp then reads and writes only its own fragments
    for (int i = 0; i < tile / BN; ++i) {
      const int row0 = t * tile + i * BN;
      score_tile<MODE, BQ, NIB_SIGNED>(q, e, Qs, Es, Sc, q0, B, row0,
                                       row0 + BN, d, vec, FoldMax<PACK>{i});
    }
    __syncthreads();
    for (int x = threadIdx.x; x < BQ * BN; x += THREADS) {
      const int qi = x / BN, j = x % BN;
      if (q0 + qi >= B) continue;
      const int at = qi * SC_LD + j;
      float v;
      if constexpr (MODE == MODE_BF16 && PACK)
        v = __int2float_rn(__float_as_int(Sc[at]) | j);
      else if constexpr (PACK)
        v = __int2float_rn(Sci[at] | j);
      else if constexpr (IMAX)
        v = __int2float_rn(Sci[at]);
      else
        v = Sc[at];
      out[(size_t)(q0 + qi) * out_ld + (size_t)t * BN + j] = v;
    }
    __syncthreads();   // the next tile resets Sc
  }
}

// At its scan's register budget (SCAN_REGS, scan_tile.cuh), so that the
// two run the same load schedule; the lighter epilogue then spills up to
// 112 bytes to the stack (nvcc 12.8), which makes scan minus probe a lower
// bound on the selection's cost.
template <int MODE, bool PACK>
__global__ void __maxnreg__((SCAN_REGS<MODE, BQ>))
score_probe_kernel(const typename Cfg<MODE>::Q* __restrict__ q,
                   const typename Cfg<MODE>::T* __restrict__ e, int B, int d,
                   int tile, int n_tiles, int tiles_per_chunk, int vec,
                   float* __restrict__ out) {
  probe_tiles<MODE, PACK>(q, e, B, d, tile, n_tiles, tiles_per_chunk, vec,
                          out);
}

// n rows in tiles of `tile`; the caller's chunking gives each of n_chunks
// blocks (per 64 queries) tiles_per_chunk whole tiles, the last one fewer.
template <int MODE, bool PACK>
int launch_probe(const void* q, const void* e, int B, int n, int d, int tile,
                 int tiles_per_chunk, int n_chunks, int bq, int vec, void* out,
                 void* stream) {
  const int n_tiles = tile >= BN ? n / tile : 0;
  if (B < 1 || d < 1 || tile < BN || tile % BN != 0 || n_tiles < 1 ||
      bq != BQ || (MODE == MODE_I4 && d % 2 != 0) || tiles_per_chunk < 1 ||
      n_chunks < 1 || (n_chunks - 1) * tiles_per_chunk >= n_tiles ||
      n_chunks * tiles_per_chunk < n_tiles)
    return (int)cudaErrorInvalidValue;
  const size_t smem = probe_smem_bytes<MODE>();
  auto kern = score_probe_kernel<MODE, PACK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (B + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Cfg<MODE>::Q*>(q),
      static_cast<const typename Cfg<MODE>::T*>(e), B, d, tile, n_tiles,
      tiles_per_chunk, vec, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ---- bf16 and int8 on wgmma: the main loop of kernels A and C with a
// bin-max epilogue -----------------------------------------------------------

__device__ __forceinline__ float as_score(int x) { return __int2float_rn(x); }
__device__ __forceinline__ float as_score(float x) { return x; }

// An epilogue warp of the probe folds each stored tile (its NQ queries x
// 64 rows of raw sums, Acc) into the running max over the 128-row tiles i
// of the current probe tile: bin j of 128 takes row j of each 128-row
// tile, so the 64-row tile of parity p holds bins 64 p + c. Each lane
// holds bins 64 p + 32 h + lane (h < 2) of the NQ queries in registers and
// writes them when the probe tile ends: the i32 sum (int8) or the f32
// score (bf16) as it is, or its key without the column (maxed as i32),
// with the bin j or'd in at the write, as FoldMax does.
template <bool PACK, int NQ, typename Acc>
struct FoldMaxWg {
  // the running max: keys and i32 sums as i32, bf16 rawmax scores as f32
  using M = std::conditional_t<PACK, int, Acc>;
  float* out;  // this warp's first query's row of the output
  size_t out_ld;
  int ptile, row_lo, live, lane;  // ptile: rows of a probe tile
  M mx[NQ][4];                    // [query][2 p + h]

  __device__ __forceinline__ void tile(const Acc* S, int row0) {
    const int r = row0 - row_lo, per = ptile / BN;
    const int i = r / BN % per, p = r / WG_BN % 2;
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      if (qq >= live) break;
#pragma unroll
      for (int b = 0; b < 4; ++b) {  // b = 2 p + h: this tile's two
        if (b / 2 != p) continue;
        const Acc x = S[qq * WG_SC_LD + 32 * (b % 2) + lane];
        M v;
        if constexpr (PACK)
          v = key_of(as_score(x), i);
        else
          v = x;
        mx[qq][b] = i > 0 ? max(mx[qq][b], v) : v;
      }
    }
    if (i != per - 1 || p != 1) return;
    float* o = out + (size_t)(row0 / ptile) * BN;
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      if (qq >= live) break;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 32 * b + lane;  // 64 p + 32 h + lane, b = 2 p + h
        if constexpr (PACK)
          o[qq * out_ld + j] = __int2float_rn(mx[qq][b] | j);
        else
          o[qq * out_ld + j] = as_score(mx[qq][b]);
      }
    }
  }

  __device__ __forceinline__ void finish() const {}
};

// The probe runs its scan's instance, chunking, register budget, MMA and
// producer warps (wg_scan over Op) and reserves the shared memory of that
// scan at k1 = 16, so that it too runs one block an SM; only the epilogue
// warps' work differs.
template <int BQ_, typename Op, bool PACK>
__device__ __forceinline__ void probe_wg(const CUtensorMap* qmap,
                                         const CUtensorMap* rmap, int B,
                                         int d, int tile, int n_tiles,
                                         int tiles_per_chunk, float* out) {
  using C = WgCfg<BQ_>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg_smem_base(smem_raw);
  const int q0 = blockIdx.y * BQ_;
  const int t_lo = blockIdx.x * tiles_per_chunk;
  const int t_hi = min(t_lo + tiles_per_chunk, n_tiles);
  const int e = (threadIdx.x >> 5) - C::MMA_WARPS;  // epilogue warp index
  constexpr int NQ = C::EPI_Q;
  FoldMaxWg<PACK, NQ, typename Op::Acc> epi;
  epi.out_ld = (size_t)n_tiles * BN;
  epi.out = out + (size_t)(q0 + NQ * max(e, 0)) * epi.out_ld;
  epi.ptile = tile;
  epi.row_lo = t_lo * tile;
  epi.live = max(0, min(NQ, B - q0 - NQ * max(e, 0)));
  epi.lane = threadIdx.x & 31;
  wg_scan<BQ_, Op>(rmap, qmap, sm, q0, B, t_lo * tile, t_hi * tile, d, epi);
}

// kernel C's floor
template <int BQ_, bool PACK>
__global__ void __maxnreg__((WgCfg<BQ_>::REGS))
score_probe_int8_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap rmap, int B,
                           int d, int tile, int n_tiles, int tiles_per_chunk,
                           float* __restrict__ out) {
  probe_wg<BQ_, WgS8, PACK>(&qmap, &rmap, B, d, tile, n_tiles,
                            tiles_per_chunk, out);
}

// kernel A's floor
template <int BQ_, bool PACK>
__global__ void __maxnreg__((WgCfg<BQ_>::REGS))
score_probe_bf16_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap rmap, int B,
                           int d, int tile, int n_tiles, int tiles_per_chunk,
                           float* __restrict__ out) {
  probe_wg<BQ_, WgBf16, PACK>(&qmap, &rmap, B, d, tile, n_tiles,
                              tiles_per_chunk, out);
}

constexpr int PROBE_K1 = 16;   // the list length whose smem the probe reserves

template <typename Op, int BQ_, bool PACK>
int launch_probe_wg(const void* q, const void* e, int B, int n, int d,
                    int tile, int tiles_per_chunk, int n_chunks, int bq,
                    int vec, void* out, void* stream) {
  const int n_tiles = tile >= BN ? n / tile : 0;
  if (B < 1 || tile < BN || tile % BN != 0 || n_tiles < 1 || bq != BQ_ ||
      vec != 1 || tiles_per_chunk < 1 || n_chunks < 1 ||
      (n_chunks - 1) * tiles_per_chunk >= n_tiles ||
      n_chunks * tiles_per_chunk < n_tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, rmap;
  if (!wg_maps<Op>(&qmap, &rmap, q, e, B, n, d))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      wg_smem_bytes<BQ_>(2 * round_up((size_t)BQ_ * PROBE_K1 * 4));
  auto kern = std::is_same<Op, WgS8>::value
                  ? score_probe_int8_wg_kernel<BQ_, PACK>
                  : score_probe_bf16_wg_kernel<BQ_, PACK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (B + BQ_ - 1) / BQ_);
  kern<<<grid, WgCfg<BQ_>::THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(qmap, rmap, B, d, tile, n_tiles,
                                              tiles_per_chunk,
                                              static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The wgmma probe of Op: bq = BQ_WIDE or 64, as its scan chose
template <typename Op>
int probe_wg_entry(const void* q, const void* e, int B, int n, int d,
                   int tile, int tiles_per_chunk, int n_chunks, int bq,
                   int pack, int vec, void* out, void* stream) {
  if (bq == BQ_WIDE)
    return pack ? launch_probe_wg<Op, BQ_WIDE, true>(
                      q, e, B, n, d, tile, tiles_per_chunk, n_chunks, bq, vec,
                      out, stream)
                : launch_probe_wg<Op, BQ_WIDE, false>(
                      q, e, B, n, d, tile, tiles_per_chunk, n_chunks, bq, vec,
                      out, stream);
  return pack ? launch_probe_wg<Op, 64, true>(q, e, B, n, d, tile,
                                              tiles_per_chunk, n_chunks, bq,
                                              vec, out, stream)
              : launch_probe_wg<Op, 64, false>(q, e, B, n, d, tile,
                                               tiles_per_chunk, n_chunks, bq,
                                               vec, out, stream);
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch (0 = success).
// q bf16 [B, d], rows bf16 [n, d], d % 8 == 0 and 16-byte aligned (vec =
// 1): kernel A's main loop; bq = BQ_WIDE or 64, as kernel A chose
int lt_score_probe_bf16(const void* q, const void* e, int B, int n, int d,
                        int tile, int tiles_per_chunk, int n_chunks, int bq,
                        int pack, int vec, void* out, void* stream) {
  return probe_wg_entry<WgBf16>(q, e, B, n, d, tile, tiles_per_chunk,
                                n_chunks, bq, pack, vec, out, stream);
}

// every other bf16 shape: q f32 [B, d] cast to bf16 in the score_tile of
// kernel A's wmma route
int lt_score_probe_bf16_scalar(const void* q, const void* e, int B, int n,
                               int d, int tile, int tiles_per_chunk,
                               int n_chunks, int bq, int pack, int vec,
                               void* out, void* stream) {
  return pack ? launch_probe<MODE_BF16, true>(q, e, B, n, d, tile,
                                              tiles_per_chunk, n_chunks, bq,
                                              vec, out, stream)
              : launch_probe<MODE_BF16, false>(q, e, B, n, d, tile,
                                               tiles_per_chunk, n_chunks, bq,
                                               vec, out, stream);
}

// q int8 [B, d], rows int8 [n, d], d % 16 == 0 and 16-byte aligned (vec =
// 1): kernel C's main loop; bq = BQ_WIDE or 64, as kernel C chose
int lt_score_probe_int8(const void* q, const void* e, int B, int n, int d,
                        int tile, int tiles_per_chunk, int n_chunks, int bq,
                        int pack, int vec, void* out, void* stream) {
  return probe_wg_entry<WgS8>(q, e, B, n, d, tile, tiles_per_chunk, n_chunks,
                              bq, pack, vec, out, stream);
}

// every other int8 shape: kernel C's scalar route's score_tile
int lt_score_probe_int8_scalar(const void* q, const void* e, int B, int n,
                               int d, int tile, int tiles_per_chunk,
                               int n_chunks, int bq, int pack, int vec,
                               void* out, void* stream) {
  return pack ? launch_probe<MODE_I8, true>(q, e, B, n, d, tile,
                                            tiles_per_chunk, n_chunks, bq,
                                            vec, out, stream)
              : launch_probe<MODE_I8, false>(q, e, B, n, d, tile,
                                             tiles_per_chunk, n_chunks, bq,
                                             vec, out, stream);
}

// q int8 [B, d], packed rows int8 [n, d/2]; the int4 probe has no pack mode
int lt_score_probe_int4(const void* q, const void* e, int B, int n, int d,
                        int tile, int tiles_per_chunk, int n_chunks, int bq,
                        int pack, int vec, void* out, void* stream) {
  if (pack) return (int)cudaErrorInvalidValue;
  return launch_probe<MODE_I4, false>(q, e, B, n, d, tile, tiles_per_chunk,
                                      n_chunks, bq, vec, out, stream);
}

}  // extern "C"
