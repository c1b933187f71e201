// Batched exact top-k1 selection of kernel D (scan_topk.cu).
//
// A warp owns one sorted list (ls, li) of k1 entries per query in shared
// memory, ordered by (score descending, id ascending) as in
// topk_select.cuh, and beside each list a staging buffer (bs, bi) of `cap`
// <= 32 entries in no order. A scan adds candidates in three steps:
//
// - Gate: a candidate is kept only if it ranks before the list's k1-th
//   entry, `offer`'s test. The list changes only at a merge, so the gate
//   reads a threshold that may be stale: it keeps more than it must, never
//   less.
// - Compact: a ballot and a prefix count of it move the kept lanes'
//   candidates into the buffer's next slots. A full buffer is merged before
//   the rest of the ballot is gated again against the new threshold.
// - Merge (`merge_buffer`): the buffer, one entry a lane, is sorted by a
//   bitonic network of 15 shuffle steps. Each entry j finds by binary search
//   how many list entries rank before it, pos_j, so its output rank is
//   j + pos_j. A ballot-wide OR of those ranks marks, in each 32-slot word
//   of the list, the slots the buffer takes; every other slot o takes the
//   list entry o minus the buffer entries ranked before o. Ranks >= k1 are
//   dropped. All reads finish before a `__syncwarp`, then the writes.
//
// Why it is exact: (score, id) is a strict order (ids are distinct and
// every candidate is offered once), so the top k1 of a set is one list. A
// candidate that the gate drops ranks after k1 entries already kept, so it
// is in no top k1 of a superset; a merge keeps the top k1 of list and
// buffer. The lists therefore equal, entry for entry, what serial insertion
// (`offer`) gives. Empty slots hold (-inf, EMPTY_ID), which every offered
// candidate beats (invalid rows score NEG_INF = -1e30).
//
// What it costs: once the lists are full a step of 32 candidates is one
// ballot; a merge, about 15 shuffle pairs plus log2(k1) shared-memory
// probes a lane and four warp operations per 32 slots of the list, runs once
// per `cap` kept candidates instead of once per candidate. The merge is
// out of line: inlined at each of a tile's four steps, it made the
// kernel's whole tile loop slower.

#pragma once

#include <cuda_runtime.h>

#include "topk_select.cuh"

constexpr int SEL_CAP = 32;  // largest staging buffer: one entry a lane

// Merge the h (1 <= h <= 32) staged candidates (bs, bi) into the sorted
// list (ls, li) of length k1 <= KMAX. Every lane of the warp calls it.
template <int KMAX>
static __device__ __noinline__ void merge_buffer(float* ls, int* li, int k1,
                                                 const float* bs,
                                                 const int* bi, int h,
                                                 int lane) {
  __syncwarp();  // the staging writes of every lane are visible
  float s = neg_infinity();
  int id = EMPTY_ID;
  if (lane < h) { s = bs[lane]; id = bi[lane]; }
  // bitonic sort, best first; a pair's lower lane keeps the better entry
  // in blocks that sort up
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float os = __shfl_xor_sync(FULL, s, j);
      const int oi = __shfl_xor_sync(FULL, id, j);
      const bool keep_better = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_better ? better(os, oi, s, id) : better(s, id, os, oi)) {
        s = os;
        id = oi;
      }
    }
  // output rank of this lane's entry: its index plus the list entries
  // that rank before it (a lower bound in the sorted list)
  int out = 0x7fffffff;
  if (lane < h) {
    int lo = 0, len = k1;
    while (len > 0) {
      const int half = len >> 1, mid = lo + half;
      if (better(ls[mid], li[mid], s, id)) {
        lo = mid + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    out = lane + lo;
  }
  const int first = __shfl_sync(FULL, out, 0);  // slots before it stay
  float ns[KMAX / 32];
  int ni[KMAX / 32];
  int before = 0;  // buffer entries placed in earlier words
#pragma unroll
  for (int w = 0; w < KMAX / 32; ++w) {
    if (32 * w >= k1) break;
    const int o = 32 * w + lane;
    const unsigned mask = __reduce_or_sync(
        FULL, out < k1 && (out >> 5) == w ? 1u << (out & 31) : 0u);
    const int nb = before + __popc(mask & ((1u << lane) - 1));
    before += __popc(mask);
    const float vs = __shfl_sync(FULL, s, nb & 31);
    const int vi = __shfl_sync(FULL, id, nb & 31);
    if ((mask >> lane) & 1u) {
      ns[w] = vs;
      ni[w] = vi;
    } else if (o < k1 && o >= first) {
      ns[w] = ls[o - nb];
      ni[w] = li[o - nb];
    }
  }
  __syncwarp();
#pragma unroll
  for (int w = 0; w < KMAX / 32; ++w) {
    if (32 * w >= k1) break;
    const int o = 32 * w + lane;
    if (o < k1 && o >= first) {
      ls[o] = ns[w];
      li[o] = ni[w];
    }
  }
  __syncwarp();
}

// Gate, compact and (when the buffer fills) merge one step of 32
// candidates, one a lane; lanes with `in` false offer nothing. `cnt` is the
// buffer's fill and (ts, ti) the gate's threshold, the list's k1-th entry
// as of the last merge; both are warp-uniform and updated here.
template <int KMAX>
static __device__ __forceinline__ void stage(float* ls, int* li, int k1,
                                             float* bs, int* bi, int cap,
                                             int& cnt, float& ts, int& ti,
                                             float s, int id, bool in,
                                             int lane) {
  bool ok = in && better(s, id, ts, ti);
  unsigned m = __ballot_sync(FULL, ok);
  while (m) {
    const int r = __popc(m & ((1u << lane) - 1));
    const int room = cap - cnt;
    if (ok && r < room) { bs[cnt + r] = s; bi[cnt + r] = id; }
    cnt += min(__popc(m), room);
    if (cnt < cap) break;
    merge_buffer<KMAX>(ls, li, k1, bs, bi, cnt, lane);
    cnt = 0;
    ts = ls[k1 - 1];
    ti = li[k1 - 1];
    ok = ok && r >= room && better(s, id, ts, ti);
    m = __ballot_sync(FULL, ok);
  }
}
