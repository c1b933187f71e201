// IVF probe kernel for Hopper (sm_90a), plain C interface.
//
// ivf_probe replaces `_probe_kernel` via `ivf_search_fused`
// (lattice_tpu/ops/ivf.py:759, :784). For each query b and each of its P
// probed buckets c = probe[b, p], it scores the bucket's S rows,
//   score(b, p, s) = f32 sum of T(q[b]) * bucket[c, s]   (T = bf16 or f32)
// with NEG_INF where ids[c, s] < 0 (padding, removed and filtered rows), and
// keeps the sorted top-k1 of (score, position = p*S + s) for its run of
// rows. Kernel B (`merge_candidates`, scan_topk.cu) merges the lists of a
// query; its lower-id-first rule on positions is the order `lax.top_k`
// gives over the flattened [P*S] slab: probe rank, then slot. The caller
// maps positions to row ids.
//
// What bounds it on the H100: bytes. One query at nprobe=8 over buckets of
// S ~ 1,150 rows x 768 bf16 reads ~14 MB, under 5 us at 3.35 TB/s; there
// are 2 FLOP per 2 bytes read, far below the tensor cores' balance point,
// so the products run on CUDA cores in f32. The TPU ran one grid step per
// (query, bucket) pair, B*P steps in order; eight such blocks at B=1 would
// leave 124 of the 132 SMs idle. Design:
// - each probed bucket's rows are split over `splits` blocks so that the
//   grid covers about two blocks per SM even at B=1 (the wrapper picks
//   rows_per_block, a multiple of 16);
// - a block loads its own probe index and casts its query to the bucket
//   type once, into shared memory (as f32 values of that type);
// - each warp scores UNROLL rows at a time, every lane reading 16-byte
//   units of each row (UNROLL loads in flight per lane) and accumulating
//   in f32, then a butterfly sum across the warp; rows whose id is < 0 are
//   not read at all;
// - the block's TILE scores land in shared memory and warp 0 folds them
//   into the block's running top-k1 (topk_select.cuh);
// - the block writes its list once.
// Simple first: no cp.async, TMA or wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int THREADS = 128;                 // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                    // rows a warp scores at once
constexpr int GROUP = WARPS * UNROLL;        // rows a block scores at once
constexpr int TILE = 128;                    // rows per selection pass
constexpr int ROWS_ALIGN = 16;               // must match ops/ivf.py
static_assert(TILE % GROUP == 0, "a tile is whole groups");

template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr int VE = 8;               // elements per 16-byte unit
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // f32 dot of one 16-byte unit with 8 query values; a bf16 widens to f32
  // exactly by moving its bits to the top half (element 2j is the low half
  // of word j)
  static __device__ __forceinline__ float dot(uint4 u, const float* q,
                                              float acc) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(__uint_as_float(w[j] << 16), q[2 * j], acc);
      acc = fmaf(__uint_as_float(w[j] & 0xffff0000u), q[2 * j + 1], acc);
    }
    return acc;
  }
};
template <> struct Elem<float> {
  static constexpr int VE = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float dot(uint4 u, const float* q,
                                              float acc) {
    acc = fmaf(__uint_as_float(u.x), q[0], acc);
    acc = fmaf(__uint_as_float(u.y), q[1], acc);
    acc = fmaf(__uint_as_float(u.z), q[2], acc);
    acc = fmaf(__uint_as_float(u.w), q[3], acc);
    return acc;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// One block: query b, probe rank p, rows [lo, hi) of bucket probe[b, p].
// blockIdx.x = (b * P + p) * splits + split.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ivf_probe_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                 const T* __restrict__ data, const int* __restrict__ ids,
                 int P, int C, int S, int d, int k1, int rows_per_block,
                 int splits, int vec, float* __restrict__ cand_s,
                 int* __restrict__ cand_i) {
  using E = Elem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);          // [round4(d)]
  float* sc = qs + round4(d);                          // [TILE]
  float* ls = sc + TILE;                               // [k1]
  int* li = reinterpret_cast<int*>(ls + k1);           // [k1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x % splits;
  const int bp = blockIdx.x / splits;                  // b * P + p
  const int b = bp / P, p = bp % P;
  const int c = probe[bp];
  const bool bucket_ok = c >= 0 && c < C;
  const int lo = split * rows_per_block;
  const int hi = min(lo + rows_per_block, S);

  for (int k = threadIdx.x; k < d; k += THREADS)
    qs[k] = E::round(q[(size_t)b * d + k]);
  for (int j = threadIdx.x; j < k1; j += THREADS) {
    ls[j] = neg_infinity();
    li[j] = EMPTY_ID;
  }
  __syncthreads();
  const T* bucket = data + (size_t)(bucket_ok ? c : 0) * S * d;
  const int* bids = ids + (size_t)(bucket_ok ? c : 0) * S;

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    for (int g = 0; g < TILE; g += GROUP) {
      const int r0 = t0 + g + warp * UNROLL;
      float acc[UNROLL];
      bool live[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = r0 + u;
        live[u] = bucket_ok && s < hi && bids[s] >= 0;
        acc[u] = 0.f;
      }
      if (vec) {
        for (int k = lane * E::VE; k < d; k += 32 * E::VE) {
          uint4 v[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            v[u] = live[u] ? __ldg(reinterpret_cast<const uint4*>(
                                 bucket + (size_t)(r0 + u) * d + k))
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) acc[u] = E::dot(v[u], qs + k, acc[u]);
        }
      } else {
        for (int k = lane; k < d; k += 32) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (live[u])
              acc[u] = fmaf(E::get(bucket[(size_t)(r0 + u) * d + k]), qs[k],
                            acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc[u] = warp_sum(acc[u]);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          sc[g + warp * UNROLL + u] = live[u] ? acc[u] : NEG_INF;
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int c0 = 0; c0 < TILE && t0 + c0 < hi; c0 += 32) {
        const int s = t0 + c0 + lane;
        const bool in = s < hi;
        offer(ls, li, k1, in ? sc[c0 + lane] : NEG_INF, p * S + s, in, lane);
      }
    }
    __syncthreads();
  }

  const size_t base = (size_t)blockIdx.x * k1;
  for (int j = threadIdx.x; j < k1; j += THREADS) {
    cand_s[base + j] = ls[j];
    cand_i[base + j] = li[j];
  }
}

template <typename T>
int launch_probe(const void* q, const void* probe, const void* data,
                 const void* ids, int B, int P, int C, int S, int d, int k1,
                 int rows_per_block, int splits, int vec, void* cand_s,
                 void* cand_i, void* stream) {
  if (B < 1 || P < 1 || P > C || S < 1 || d < 1 || k1 < 1 || k1 > MAX_K1 ||
      (long long)P * S > 0x7ffffffeLL || rows_per_block < ROWS_ALIGN ||
      rows_per_block % ROWS_ALIGN != 0 || splits < 1 ||
      (long long)(splits - 1) * rows_per_block >= S ||
      (long long)splits * rows_per_block < S ||
      (long long)B * P * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(round4(d) + TILE + 2 * k1) * 4;
  auto kern = ivf_probe_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((long long)B * P * splits);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int*>(probe),
      static_cast<const T*>(data), static_cast<const int*>(ids), P, C, S, d,
      k1, rows_per_block, splits, vec, static_cast<float*>(cand_s),
      static_cast<int*>(cand_i));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch (0 = success).

int lt_ivf_probe_bf16(const void* q, const void* probe, const void* data,
                      const void* ids, int B, int P, int C, int S, int d,
                      int k1, int rows_per_block, int splits, int vec,
                      void* cand_s, void* cand_i, void* stream) {
  return launch_probe<__nv_bfloat16>(q, probe, data, ids, B, P, C, S, d, k1,
                                     rows_per_block, splits, vec, cand_s,
                                     cand_i, stream);
}

int lt_ivf_probe_f32(const void* q, const void* probe, const void* data,
                     const void* ids, int B, int P, int C, int S, int d,
                     int k1, int rows_per_block, int splits, int vec,
                     void* cand_s, void* cand_i, void* stream) {
  return launch_probe<float>(q, probe, data, ids, B, P, C, S, d, k1,
                             rows_per_block, splits, vec, cand_s, cand_i,
                             stream);
}

}  // extern "C"
