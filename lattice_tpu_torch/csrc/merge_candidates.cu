// Kernel B, merge_candidates, for Hopper (sm_90a), plain C interface.
//
// Replaces the `approx_max_k` finish of `_binned_candidates`
// (lattice_tpu/ops/pallas_topk.py:525), made exact: the sorted top-k1 of
// each query's m candidates (cs [B, m] f32, ci [B, m] i32), ordered by
// (score descending, id ascending), for any 1 <= k1 <= min(m, 512). It
// merges the per-chunk lists of kernels A, C, D (scan_topk.cu) and of
// ivf_probe (ivf_probe.cu), but assumes nothing of its input: the lists
// need not be sorted, nor m be a multiple of k1.
//
// A second entry, lt_merge_positions, takes no ids: a candidate's id is its
// column, 0 ... m - 1. It is the exact top-k over whole score rows (the
// deep path's fused [Q, N] rows, the negated BFS distance rows of
// khop_select), where an id tensor would be one more [Q, N] int32 read.
//
// Order. Each candidate becomes one 64-bit key; a larger key ranks first.
// The high word is the order-preserving u32 of the score, with -0.0 taken
// as +0.0 first (the plain version's sort ties them and breaks the tie by
// id); the low word is ~(id ^ 0x80000000), so a lower id (any i32) gives a
// larger word. Invalid rows at NEG_INF (-1e30) and empty slots (-inf,
// EMPTY_ID) are keys like any other. Keys are equal only for equal ids
// with equal scores (the duplicated (-inf, EMPTY_ID) pads), whose outputs
// are equal whichever is taken. The kernel selects on keys and writes the
// ORIGINAL score bits and id of each winner, read back by position, so a
// -0.0 stays -0.0. Scores are not NaN (no plan produces one).
//
// What bounds it on the H100: bytes, B*m*8 read and B*k1*8 written, over
// 3.35 TB/s: ~0.005 us for one query's 8,192 candidates, ~0.2 us for
// 256 x 10,480. That is far below a launch, so in practice launch latency
// and the chain of dependent steps within a block bound it. The design
// keeps that chain short and spreads it over the card:
// - A block holds up to CAP = 16,384 keys of one query in shared memory
//   (staged once with 16-byte loads where aligned) and finds their top-k1
//   with a block-wide radix select: 8-bit digits from the top, one
//   histogram per pass (warp-aggregated shared atomics), a 256-bin scan to
//   find the digit holding the k1-th key, and an early exit once that
//   digit's bucket is exactly what is still needed (typically after 3 of
//   the 8 passes on cosine scores). The keys above the threshold, plus as
//   many equal to it as are needed, are compacted and sorted by a bitonic
//   sort of next_pow2(k1) keys in shared memory.
// - At small B one query's candidates are split over G blocks (grid G*B),
//   G chosen by the wrapper so that the grid fills the SMs and the G*k1
//   survivors are about as many as each block's slice. Each block writes
//   its sorted k1 (key, position) pairs to the wrapper's scratch and a
//   second launch selects the final k1 from them the same way, one block
//   per query (further launches only past CAP survivors). At large B, G =
//   1: one block per query, one launch, writing the output directly.
// No TMA, clusters or tensor cores: nothing here is a product, and every
// candidate is read once from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

typedef unsigned long long u64;

constexpr int MC_THREADS = 512;
constexpr int MC_CAP = 16384;   // keys one block holds (128 KB)
constexpr int RADIX = 256;

__device__ __forceinline__ u64 make_key(float s, int id) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0;  // -0.0 ties +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (uint32_t)(~((uint32_t)id ^ 0x80000000u));
}

struct SelectShared {
  u64 key[MAX_K1_LONG];   // the survivors, then sorted
  int idx[MAX_K1_LONG];   // their slots in the block's slice; -1 = none
  int hist[RADIX];
  int warp_sum[RADIX / 32];
  int digit, above, count;
  int n_above, n_eq;
};

// Slice length of a pass with g blocks per query over n keys: a multiple
// of 4, so that 16-byte loads stay inside a slice.
__host__ __device__ __forceinline__ int slice_len(int n, int g) {
  return ((n + g - 1) / g + 3) / 4 * 4;
}

// One pass: block (q, g) takes keys [g*L, g*L + L) of query q's n (from
// cs/ci on the first pass, from the previous pass's scratch after) and
// writes their sorted top-k1: the output on the last pass, else (key,
// position in cs/ci) pairs at [q, g, :] of a [B, G, k1] scratch. Without
// IDS there is no ci: a candidate's id is its position in the row.
template <bool IDS, bool FIRST, bool FINAL>
__global__ void __launch_bounds__(MC_THREADS)
merge_candidates_kernel(const float* __restrict__ cs,
                        const int* __restrict__ ci, int m, int vec,
                        const u64* __restrict__ in_key,
                        const int* __restrict__ in_pos, int n, int G, int L,
                        int k1, float* __restrict__ out_s,
                        int* __restrict__ out_i, u64* __restrict__ out_key,
                        int* __restrict__ out_pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  __shared__ SelectShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x / G, g = blockIdx.x % G;
  const int lo = min(n, g * L), len = min(n, lo + L) - lo;
  int P = 1;
  while (P < k1) P <<= 1;

  if (FIRST) {
    const float* s_row = cs + (size_t)q * m + lo;
    const int* i_row = IDS ? ci + (size_t)q * m + lo : nullptr;
    if (vec) {
      for (int j = 4 * tid; j < len; j += 4 * MC_THREADS) {
        const float4 s4 = *reinterpret_cast<const float4*>(s_row + j);
        const int4 i4 = IDS ? *reinterpret_cast<const int4*>(i_row + j)
                            : make_int4(lo + j, lo + j + 1, lo + j + 2,
                                        lo + j + 3);
        keys[j] = make_key(s4.x, i4.x);
        keys[j + 1] = make_key(s4.y, i4.y);
        keys[j + 2] = make_key(s4.z, i4.z);
        keys[j + 3] = make_key(s4.w, i4.w);
      }
    } else {
      for (int j = tid; j < len; j += MC_THREADS)
        keys[j] = make_key(s_row[j], IDS ? i_row[j] : lo + j);
    }
  } else {
    const u64* k_row = in_key + (size_t)q * n + lo;
    for (int j = tid; j < len; j += MC_THREADS) keys[j] = k_row[j];
  }
  for (int j = tid; j < P; j += MC_THREADS) {
    sh.key[j] = 0;
    sh.idx[j] = -1;
  }
  if (tid < RADIX) sh.hist[tid] = 0;
  if (tid == 0) sh.n_above = sh.n_eq = 0;
  __syncthreads();

  // radix select: the keys above (prefix, mask) rank before the kk-th;
  // `need` of those equal to it complete the top kk
  const int kk = min(k1, len);
  u64 prefix = 0, mask = 0;
  int need = kk;
  if (kk < len) {
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int base = warp * 32; base < len; base += MC_THREADS) {
        const int j = base + lane;
        int digit = RADIX;  // not in the bucket being refined
        if (j < len) {
          const u64 key = keys[j];
          if ((key & mask) == prefix) digit = (int)(key >> shift) & (RADIX - 1);
        }
        const unsigned peers = __match_any_sync(FULL, digit);
        if (digit < RADIX && lane == __ffs(peers) - 1)
          atomicAdd(&sh.hist[digit], __popc(peers));
      }
      __syncthreads();
      // thread t holds digit 255 - t: an inclusive scan counts, for each
      // digit, the keys of the bucket at or above it
      int v = 0, incl = 0;
      if (tid < RADIX) {
        v = incl = sh.hist[RADIX - 1 - tid];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane == 31) sh.warp_sum[warp] = incl;
      }
      __syncthreads();
      if (tid < RADIX) {
        for (int w = 0; w < warp; ++w) incl += sh.warp_sum[w];
        if (incl - v < need && need <= incl) {
          sh.digit = RADIX - 1 - tid;
          sh.above = incl - v;
          sh.count = v;
        }
        sh.hist[RADIX - 1 - tid] = 0;  // for the next pass
      }
      __syncthreads();
      need -= sh.above;
      prefix |= (u64)sh.digit << shift;
      mask |= (u64)(RADIX - 1) << shift;
      if (sh.count == need) break;  // the whole bucket is in
    }
  }

  // compaction: (kk - need) keys above the threshold, `need` equal to it
  const int n_above = kk - need;
  for (int j = tid; j < len; j += MC_THREADS) {
    const u64 key = keys[j], km = key & mask;
    if (km > prefix) {
      const int s = atomicAdd(&sh.n_above, 1);
      sh.key[s] = key;
      sh.idx[s] = j;
    } else if (km == prefix) {
      const int e = atomicAdd(&sh.n_eq, 1);
      if (e < need) {
        sh.key[n_above + e] = key;
        sh.idx[n_above + e] = j;
      }
    }
  }
  __syncthreads();

  // bitonic sort of the P slots, descending (empty slots hold key 0)
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (tid < P / 2) {
        const int i = 2 * tid - (tid & (stride - 1)), j = i + stride;
        const u64 a = sh.key[i], b = sh.key[j];
        if (a != b && (a < b) == ((i & size) == 0)) {
          sh.key[i] = b;
          sh.key[j] = a;
          const int t = sh.idx[i];
          sh.idx[i] = sh.idx[j];
          sh.idx[j] = t;
        }
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < k1; j += MC_THREADS) {
    const int idx = sh.idx[j];
    const int pos = idx < 0 ? -1
                    : FIRST ? lo + idx
                            : in_pos[(size_t)q * n + lo + idx];
    if (FINAL) {
      const size_t o = (size_t)q * k1 + j;
      out_s[o] = pos < 0 ? neg_infinity() : cs[(size_t)q * m + pos];
      out_i[o] = pos < 0 ? EMPTY_ID : IDS ? ci[(size_t)q * m + pos] : pos;
    } else {
      const size_t o = ((size_t)q * G + g) * k1 + j;
      out_key[o] = sh.key[j];
      out_pos[o] = pos;
    }
  }
}

template <bool IDS, bool FIRST, bool FINAL>
int launch_pass(const float* cs, const int* ci, int B, int m, int vec,
                const u64* in_key, const int* in_pos, int n, int g, int k1,
                float* out_s, int* out_i, u64* out_key, int* out_pos,
                cudaStream_t stream) {
  auto kern = merge_candidates_kernel<IDS, FIRST, FINAL>;
  const int L = slice_len(n, g);
  const size_t smem = (size_t)L * sizeof(u64);
  // the default limit (48 KB, static shared memory included) needs no
  // host call
  if (smem + sizeof(SelectShared) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)g * B, MC_THREADS, smem, stream>>>(
      cs, ci, m, vec, in_key, in_pos, n, g, L, k1, out_s, out_i, out_key,
      out_pos);
  return (int)cudaGetLastError();
}

// The passes of one merge (without IDS, i is unused: ids are columns).
template <bool IDS>
int merge(const float* s, const int* i, int B, int m, int k1, int G,
          void* scratch, float* os, int* oi, cudaStream_t st) {
  if (B < 1 || k1 < 1 || k1 > MAX_K1_LONG || m < k1 || G < 1 ||
      slice_len(m, G) > MC_CAP || (G > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(i) % 16 == 0;
  if (G == 1)
    return launch_pass<IDS, true, true>(s, i, B, m, vec, nullptr, nullptr,
                                        m, 1, k1, os, oi, nullptr, nullptr,
                                        st);
  const size_t entries = (size_t)B * G * k1;
  u64* key[2] = {static_cast<u64*>(scratch),
                 static_cast<u64*>(scratch) + entries};
  int* pos[2] = {reinterpret_cast<int*>(key[1] + entries),
                 reinterpret_cast<int*>(key[1] + entries) + entries};
  int rc = launch_pass<IDS, true, false>(s, i, B, m, vec, nullptr, nullptr,
                                         m, G, k1, nullptr, nullptr, key[0],
                                         pos[0], st);
  // each later pass reads the previous one's [B, g, k1] survivors
  for (int level = 1, g = G; rc == 0; ++level) {
    const int n = g * k1;
    g = (n + MC_CAP - 1) / MC_CAP;
    const int in = (level - 1) & 1, out = level & 1;
    if (g == 1)
      return launch_pass<IDS, false, true>(s, i, B, m, vec, key[in],
                                           pos[in], n, 1, k1, os, oi,
                                           nullptr, nullptr, st);
    rc = launch_pass<IDS, false, false>(s, i, B, m, vec, key[in], pos[in], n,
                                        g, k1, nullptr, nullptr, key[out],
                                        pos[out], st);
  }
  return rc;
}

}  // namespace

extern "C" {

// Sorted top-k1 of cs/ci [B, m] into out_s/out_i [B, k1]; returns
// cudaGetLastError() after its last launch (0 = success). G blocks per
// query on the first pass (slices of at most CAP keys). With G > 1,
// `scratch` holds 2 * B * G * k1 * 12 bytes: two [B, G, k1] u64 key
// buffers, then two i32 position buffers; passes alternate between them.
int lt_merge_candidates(const void* cs, const void* ci, int B, int m, int k1,
                        int G, void* scratch, void* out_s, void* out_i,
                        void* stream) {
  if (ci == nullptr) return (int)cudaErrorInvalidValue;
  return merge<true>(static_cast<const float*>(cs),
                     static_cast<const int*>(ci), B, m, k1, G, scratch,
                     static_cast<float*>(out_s), static_cast<int*>(out_i),
                     static_cast<cudaStream_t>(stream));
}

// The same over cs [B, m] alone: candidate j of a row has id j.
int lt_merge_positions(const void* cs, int B, int m, int k1, int G,
                       void* scratch, void* out_s, void* out_i,
                       void* stream) {
  return merge<false>(static_cast<const float*>(cs), nullptr, B, m, k1, G,
                      scratch, static_cast<float*>(out_s),
                      static_cast<int*>(out_i),
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
