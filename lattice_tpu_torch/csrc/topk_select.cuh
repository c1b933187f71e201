// Running top-k selection shared by the kernels of csrc/ (scan_topk.cu,
// ivf_probe.cu).
//
// A warp owns one sorted list (ls, li) of length k1 <= MAX_K1 in shared
// memory, ordered by (score descending, id ascending): the order
// `lax.top_k` gives when the id is a row id or a position. Empty slots hold
// (-inf, EMPTY_ID), so they rank after every offered candidate, NEG_INF
// (-1e30) ones included. After the first entries a batch of 32 candidates
// rarely beats the list's last entry, so selection costs one ballot per 32
// candidates.

#pragma once

#include <cuda_runtime.h>

constexpr int MAX_K1 = 128;     // longest candidate list
constexpr float NEG_INF = -1e30f;
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

static __device__ __forceinline__ float neg_infinity() {
  return __int_as_float(0xff800000);
}

// (s, i) ranks before (s2, i2): higher score, then lower id.
static __device__ __forceinline__ bool better(float s, int i, float s2,
                                              int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// Insert (s, id) into the sorted list (ls, li) of length k1 that this warp
// owns. Every lane passes the same candidate. No-op when it ranks after
// the whole list.
static __device__ void warp_insert(float* ls, int* li, int k1, float s,
                                   int id, int lane) {
  int pos = 0;  // entries that rank before the candidate (list is sorted)
#pragma unroll
  for (int j = 0; j < MAX_K1 / 32; ++j) {
    int i = lane + 32 * j;
    bool b = i < k1 && better(ls[i], li[i], s, id);
    pos += __popc(__ballot_sync(FULL, b));
  }
  if (pos >= k1) return;
  float ps[MAX_K1 / 32];
  int pi[MAX_K1 / 32];
#pragma unroll
  for (int j = 0; j < MAX_K1 / 32; ++j) {
    int i = lane + 32 * j;
    if (i < k1 && i > pos) { ps[j] = ls[i - 1]; pi[j] = li[i - 1]; }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < MAX_K1 / 32; ++j) {
    int i = lane + 32 * j;
    if (i < k1 && i > pos) { ls[i] = ps[j]; li[i] = pi[j]; }
    else if (i == pos) { ls[i] = s; li[i] = id; }
  }
  __syncwarp();
}

// Fold 32 candidates per step into this warp's list; lanes with `in`
// false offer nothing. Candidates are inserted one at a time in lane order.
static __device__ __forceinline__ void offer(float* ls, int* li, int k1,
                                             float s, int id, bool in,
                                             int lane) {
  bool ok = in && better(s, id, ls[k1 - 1], li[k1 - 1]);
  unsigned m = __ballot_sync(FULL, ok);
  while (m) {
    int src = __ffs(m) - 1;
    m &= m - 1;
    float cs = __shfl_sync(FULL, s, src);
    int ci = __shfl_sync(FULL, id, src);
    warp_insert(ls, li, k1, cs, ci, lane);
  }
}
