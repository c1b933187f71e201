// Paired self-attention kernel for Hopper (sm_90a), plain C interface.
//
// paired_attention replaces `_paired_attn_kernel` via `paired_attention`
// (lattice_tpu/ops/attention.py:42, :71). For batch row b, head h and
// query i, over q/k/v [B, L, H*64] in their native layout (head h in
// columns [64h, 64h + 64)):
//   s[i, j] = f32 dot(q[b, i, h], k[b, j, h]) * sm_scale + neg[b, j]
//   neg = 0 where mask > 0, else -1e9 (additive, as the reference)
//   ctx[b, i, h] = (round_T(p) @ v[b, :, h]) / sum_j p,  p = exp(s - max s)
// written as f32 [B, L, H*64] in the same layout. A row whose keys are all
// masked sees equal scores (-1e9 absorbs a unit-scale score in f32) and
// comes out as the mean of V, finite, as in the reference.
//
// What bounds it on the H100: at the encoder's shape (B=128, L=512, H=12)
// one call is 4*B*L^2*H*64 = 103 GFLOP against ~0.5 GB of bf16 q/k/v and
// f32 out: the products, not the bytes. The bf16 kernel (the serving path)
// therefore runs both products on tensor cores and never writes the [L, L]
// scores to device memory:
// - one block per (64-query tile, head, batch row); 4 warps of 16 queries;
// - K and V tiles of 64 keys stream through shared memory as 16-byte
//   cp.async copies of the 128-byte head slices, double buffered so the
//   next tile's copy overlaps this tile's products; shared rows are padded
//   to 144 bytes so the ldmatrix reads are free of bank conflicts;
// - QK^T and PV with mma.sync m16n8k16 (bf16 in, f32 accumulate); the
//   score fragments are reused in registers as the A operand of PV;
// - an online softmax in f32 registers (running max and sum per row, the
//   context rescaled when the max grows). The TPU kernel's full-row
//   softmax held an [L, L] tile in VMEM, which does not fit a block here;
//   the two differ only in rounding;
// - p is rounded to bf16 for the PV product (the reference's rounding
//   point) while the denominator sums the f32 p.
// Keys past L are excluded outright (-inf, zero-filled rows); masked keys
// keep -1e9 and no tile is skipped, so all-masked rows stay right.
// The f32 entry (the dtype="float32" configuration, not the serving path)
// is a plain FMA kernel with the same tiling: one thread per query row, K
// and V tiles in shared memory, f32 throughout.
// Simple first: no wgmma, TMA or warp specialisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                 // head dim (ops/attention.py HEAD_DIM)
constexpr int BM = 64;                // queries per block
constexpr int BN = 64;                // keys per tile
constexpr int MAX_L = 512;            // ops/attention.py MAX_LEN
constexpr int THREADS = 128;          // bf16 kernel: 4 warps x 16 queries
constexpr int LDS = D + 8;            // padded shared row, bf16 elements
constexpr float MASKED = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float key_bias(const int* mask_row, int key, int L) {
  return key < L ? (mask_row[key] > 0 ? 0.f : MASKED) : neg_inf();
}

// ---- bf16: tensor cores ------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;        // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// Rows [r0, r0 + 64) of one head's [L, 64] slice (row stride W) into a
// padded shared tile; rows past L are zero-filled, so a masked product
// never meets garbage.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int L, int W) {
#pragma unroll
  for (int it = 0; it < BN * (D / 8) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * LDS + c, src + (size_t)(ok ? r0 + r : 0) * W + c,
               ok);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t; an A or C
// register pair covers row g (regs 0, 1) or g + 8 (regs 2, 3), columns
// 2t and 2t + 1 (A's regs 2, 3 the same columns + 8); a B register covers
// column g, rows 2t and 2t + 1 (+ 8 for the second).
__global__ void __launch_bounds__(THREADS)
paired_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ mask, int L, int W,
                        float scale, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][LDS]
  __nv_bfloat16* ks = qs + BM * LDS;                           // [2][BN][LDS]
  __nv_bfloat16* vs = ks + 2 * BN * LDS;                       // [2][BN][LDS]
  float* neg = reinterpret_cast<float*>(vs + 2 * BN * LDS);    // [tiles*BN]
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (L + BN - 1) / BN;
  const size_t head = (size_t)b * L * W + (size_t)h * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;

  for (int j = threadIdx.x; j < n_tiles * BN; j += THREADS)
    neg[j] = key_bias(mask + (size_t)b * L, j, L);
  load_tile(qs, qh, q0, L, W);
  load_tile(ks, kh, 0, L, W);
  load_tile(vs, vh, 0, L, W);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide d step
  unsigned qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                        kk * 16 + (lane >> 4) * 8);

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(ks + (cur ^ 1) * BN * LDS, kh, (t + 1) * BN, L, W);
      load_tile(vs + (cur ^ 1) * BN * LDS, vh, (t + 1) * BN, L, W);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ks + cur * BN * LDS;
    const __nv_bfloat16* vt = vs + cur * BN * LDS;

    // s = q . k^T over this tile's 64 keys: 8 fragments of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        unsigned r[4];
        ldsm_x4(r, kt + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * nn], qf[kk], r[0], r[1]);
        mma16816(s[2 * nn + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale, mask, and the running row max (rows g and g + 8)
    const float* nt = neg + t * BN;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float n0 = nt[j * 8 + 2 * t4], n1 = nt[j * 8 + 2 * t4 + 1];
      s[j][0] = s[j][0] * scale + n0;
      s[j][1] = s[j][1] * scale + n1;
      s[j][2] = s[j][2] * scale + n0;
      s[j][3] = s[j][3] * scale + n1;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    // key 0 is in the first tile, so the max is finite from there on and
    // exp(-inf - max) = 0 clears the empty start
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + ps0;     // per-lane partial sums; reduced at the end
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // o += bf16(p) . v: the score fragments of keys [16kk, 16kk + 16) are
    // the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        unsigned r[4];
        ldsm_x4_trans(r, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LDS + dd * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dd], pa, r[0], r[1]);
        mma16816(o[2 * dd + 1], pa, r[2], r[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float* ob = out + head;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t4;
    if (row0 < L)
      *reinterpret_cast<float2*>(ob + (size_t)row0 * W + c) =
          make_float2(o[j][0] / l0, o[j][1] / l0);
    if (row1 < L)
      *reinterpret_cast<float2*>(ob + (size_t)row1 * W + c) =
          make_float2(o[j][2] / l1, o[j][3] / l1);
  }
}

// ---- f32: CUDA-core FMAs -----------------------------------------------------

constexpr int F32_THREADS = BM;       // one thread per query row

__global__ void __launch_bounds__(F32_THREADS)
paired_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ mask, int L, int W,
                       float scale, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* kt = reinterpret_cast<float*>(smem);  // [BN][D]
  float* vt = kt + BN * D;                     // [BN][D]
  float* sc = vt + BN * D;                     // [BN][BM]: column per thread
  float* neg = sc + BN * BM;                   // [BN]
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + threadIdx.x;
  const size_t head = (size_t)b * L * W + (size_t)h * D;
  const int n_tiles = (L + BN - 1) / BN;

  float qr[D], o[D];
  {
    const float4* src = reinterpret_cast<const float4*>(
        q + head + (size_t)min(row, L - 1) * W);
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
        kv = *reinterpret_cast<const float4*>(k + head + (size_t)key * W + c);
        vv = *reinterpret_cast<const float4*>(v + head + (size_t)key * W + c);
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
    float4* dst = reinterpret_cast<float4*>(out + head + (size_t)row * W);
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

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch (0 = success).

int lt_paired_attention_bf16(const void* q, const void* k, const void* v,
                             const void* mask, int B, int L, int H,
                             float scale, void* out, void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (L + BN - 1) / BN;
  const size_t smem = (size_t)(BM + 4 * BN) * LDS * sizeof(__nv_bfloat16) +
                      (size_t)n_tiles * BN * sizeof(float);
  auto kern = paired_attn_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, H, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask), L,
      H * D, scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int lt_paired_attention_f32(const void* q, const void* k, const void* v,
                            const void* mask, int B, int L, int H,
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
      scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
