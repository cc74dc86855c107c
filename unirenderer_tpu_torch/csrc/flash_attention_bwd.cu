// K2 backward: dQ, dK, dV of non-causal flash attention, bf16 in / bf16 out,
// f32 accumulation.
//
// Replaces: the backward of unirenderer_tpu/ops/flash_attention.py
// `tpu_flash_attention`, i.e. the JAX library's Pallas TPU flash dq and dkv
// kernels behind its custom VJP (blocks of `_block_sizes`).  Like the
// forward (flash_attention.cu) it also takes the shapes the TPU left to XLA
// (cross-attention over 77 keys, D = 160), so every attention call of a
// training step differentiates here under the default attention route.
//
// What it computes, from Q, K, V, O, dO (B, S, H, D) and the forward's
// per-row log-sum-exp L (B, H, Sq), with z = Q K^T / sqrt(D):
//     P = exp(z - L)        dV = P^T dO        dP = dO V^T
//     Delta = rowsum(dO * O)   dS = P * (dP - Delta)
//     dQ = dS K / sqrt(D)   dK = dS^T Q / sqrt(D)
//
// What bounds it on an H100: tensor-core operations.  The function needs
// five products of 2 * Sq * Sk * D flops per (batch, head) (S, dP, dV, dQ,
// dK) against ~(4 Sq + 4 Sk) * D * 2 bytes; this design recomputes S and dP
// in both of its kernels, seven products.
//
// Design (first, simple version: mma.sync m16n8k16, no TMA, no wgmma, no
// pipelining), three launches and no atomics, so the result is
// deterministic:
//   1. `delta_kernel`: Delta = rowsum(dO * O) in f32, one warp per row.
//   2. `dkv_kernel`: one block of 4 warps per (b*h, 64-key tile, column
//      chunk); each warp owns 16 keys and loops over 64-query tiles,
//      recomputing S^T = K Q^T and dP^T = V dO^T (32 queries at a time) and
//      accumulating dV += P^T dO and dK += dS^T Q in registers.  At D > 96
//      the 2 x 16 x D accumulators do not fit a thread's registers beside
//      the score tiles, so the dK/dV columns are split into two chunks
//      (gridDim.z = 2), each block recomputing S and dP over the full D.
//   3. `dq_kernel`: one block of 4 warps per (b*h, 64-query tile); each warp
//      owns 16 queries and loops over 64-key tiles, recomputing S and dP and
//      accumulating dQ += dS K.
// S is recomputed exactly as the forward computed it: Q staged as
// bf16(q * softmax_scale * log2(e)), scores in log2 units, P = exp2(S - L *
// log2(e)); so P matches the forward's probabilities and L.  dQ and dK are
// scaled by softmax_scale in f32 at the end.  Keys past Sk and queries past
// Sq get P = 0: they contribute nothing and are never written.  D is
// zero-padded in shared memory to DP, the next multiple of 16.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing
// (Delta lives in a caller-given f32 workspace), launches on the caller's
// stream and returns the first CUDA error.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using attn::bf16;
using attn::ld32;
using attn::mma16816;
using attn::pack_bf16;

constexpr int kRows = 64;         // keys (dkv) or queries (dq) per block
constexpr int kCols = 64;         // queries (dkv) or keys (dq) per tile
constexpr int kHalf = 32;         // columns per register-resident step
constexpr int kThreads = 128;     // 4 warps, 16 rows each
constexpr int kLDT = kCols + 8;   // smem row pitch of the transposed tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                  // element strides (batch, seq, head)
  long long s[8][3];              // q, k, v, o, do, dq, dk, dv
};
enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

// Chunks of the dK/dV columns: two at D > 96 (see the header).
template <int DP>
__host__ __device__ constexpr int dkv_chunks() { return DP > 96 ? 2 : 1; }

__device__ __forceinline__ long long row_offset(const Strides& st, int t,
                                                int b, int h, long long r) {
  return b * st.s[t][0] + h * st.s[t][2] + r * st.s[t][1];
}

// rows [r0, r0 + kRows) of a (B, S, H, D) tensor into smem [kRows][LD],
// columns zero-padded to DP; `scale` != 0 multiplies by it and rounds to
// bf16 (the forward's Q staging).
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           const Strides& st, int t, int b,
                                           int h, int r0, int n, int d,
                                           float scale) {
  constexpr int LD = DP + 8, VPR = DP / 8;
  for (int i = threadIdx.x; i < kRows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c < d) {
      val = *reinterpret_cast<const uint4*>(
          src + row_offset(st, t, b, h, r0 + r) + c);
      if (scale != 0.f) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(p[j]);
          p[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// columns [c0, c0 + DC) of rows [r0, r0 + kCols) into smem transposed,
// [DC][kLDT]: dst[c][r] = src[r0 + r][c0 + c], zero past n rows / d columns.
template <int DC>
__device__ __forceinline__ void stage_cols_t(bf16* dst, const bf16* src,
                                             const Strides& st, int t, int b,
                                             int h, int r0, int n, int c0,
                                             int d) {
  constexpr int VPR = DC / 8;
  for (int i = threadIdx.x; i < kCols * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c0 + c < d) {
      val = *reinterpret_cast<const uint4*>(
          src + row_offset(st, t, b, h, r0 + r) + c0 + c);
    }
    const bf16* pv = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kLDT + r] = pv[j];
  }
}

// acc[nt] (16 x 8 each, nt < NT) += A(16 rows of `a`, k = D) * B^T where B
// holds 8 * NT rows of `b` starting at row b0, both [row][DP + 8] in smem.
template <int DP, int NT>
__device__ __forceinline__ void mma_rows_x_rows(float (*acc)[4],
                                                const bf16* a, int a0,
                                                const bf16* b, int b0) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf16* ap = a + (a0 + g) * LD + kk * 16 + t4 * 2;
    const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * LD), ld32(ap + 8),
                            ld32(ap + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* bp = b + (b0 + nt * 8 + g) * LD + kk * 16 + t4 * 2;
      mma16816(acc[nt], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[n] (16 x 8 each, n < NC8) += X (16 x kHalf, f32 C fragments x[4][4],
// rounded to bf16) * T[cols c0.., k = kHalf columns from k0] where T is a
// transposed smem tile [NC8 * 8][kLDT].
template <int NC8>
__device__ __forceinline__ void mma_frag_x_t(float (*acc)[4],
                                             float (*x)[4],
                                             const bf16* t, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kHalf / 16; ++kc) {
    const uint32_t pa[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                            pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                            pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                            pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int n = 0; n < NC8; ++n) {
      const bf16* tp = t + (n * 8 + g) * kLDT + k0 + kc * 16 + t4 * 2;
      mma16816(acc[n], pa, ld32(tp), ld32(tp + 8));
    }
  }
}

// Delta[bh, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp per row.
__global__ void __launch_bounds__(kThreads)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, int heads, int sq, int d,
             Strides st) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= sq) return;
  const bf16* op = o + row_offset(st, O, b, h, row);
  const bf16* gp = dout + row_offset(st, DO, b, h, row);
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    acc += __bfloat162float(op[c]) * __bfloat162float(gp[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[(long long)bh * sq + row] = acc;
}

template <int DP>
constexpr int dkv_smem_bytes() {
  constexpr int DC = DP / dkv_chunks<DP>();
  return (4 * kRows * (DP + 8) + 2 * DC * kLDT) * (int)sizeof(bf16) +
         2 * kCols * (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq,
           int sk, int d, Strides st, float qscale, float scale) {
  constexpr int LD = DP + 8;
  constexpr int DC = DP / dkv_chunks<DP>();   // dK/dV columns of this block
  constexpr int NC8 = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [kRows][LD] keys
  bf16* sV = sK + kRows * LD;                     // [kRows][LD]
  bf16* sQs = sV + kRows * LD;                    // [kCols][LD] scaled Q
  bf16* sdO = sQs + kCols * LD;                   // [kCols][LD]
  bf16* sQt = sdO + kCols * LD;                   // [DC][kLDT] raw Q^T chunk
  bf16* sdOt = sQt + DC * kLDT;                   // [DC][kLDT] dO^T chunk
  float* sL = reinterpret_cast<float*>(sdOt + DC * kLDT);  // log2 units
  float* sD = sL + kCols;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kRows, c0 = blockIdx.z * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, rw = warp * 16;
  const bool key_ok0 = k0 + rw + g < sk, key_ok1 = k0 + rw + g + 8 < sk;

  stage_rows<DP>(sK, k, st, K, b, h, k0, sk, d, 0.f);
  stage_rows<DP>(sV, v, st, V, b, h, k0, sk, d, 0.f);

  float acc_k[NC8][4], acc_v[NC8][4];
#pragma unroll
  for (int n = 0; n < NC8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_k[n][j] = acc_v[n][j] = 0.f;
  }

  const float* lse_bh = lse + (long long)bh * sq;
  const float* delta_bh = delta + (long long)bh * sq;
  for (int q0 = 0; q0 < sq; q0 += kCols) {
    __syncthreads();   // every warp is done with the previous query tile
    stage_rows<DP>(sQs, q, st, Q, b, h, q0, sq, d, qscale);
    stage_rows<DP>(sdO, dout, st, DO, b, h, q0, sq, d, 0.f);
    stage_cols_t<DC>(sQt, q, st, Q, b, h, q0, sq, c0, d);
    stage_cols_t<DC>(sdOt, dout, st, DO, b, h, q0, sq, c0, d);
    for (int i = threadIdx.x; i < kCols; i += kThreads) {
      const bool ok = q0 + i < sq;
      sL[i] = ok ? lse_bh[q0 + i] * kLog2e : INFINITY;
      sD[i] = ok ? delta_bh[q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int hq = 0; hq < kCols / kHalf; ++hq) {
      // S^T (16 keys x 32 queries) in log2 units, then P^T
      float p[kHalf / 8][4], ds[kHalf / 8][4];
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) p[nt][j] = ds[nt][j] = 0.f;
      }
      mma_rows_x_rows<DP, kHalf / 8>(p, sK, rw, sQs, hq * kHalf);
      mma_rows_x_rows<DP, kHalf / 8>(ds, sV, rw, sdO, hq * kHalf);
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
        const int col = hq * kHalf + nt * 8 + t4 * 2;
        const float l0 = sL[col], l1 = sL[col + 1];
        const float d0 = sD[col], d1 = sD[col + 1];
        p[nt][0] = key_ok0 ? exp2f(p[nt][0] - l0) : 0.f;
        p[nt][1] = key_ok0 ? exp2f(p[nt][1] - l1) : 0.f;
        p[nt][2] = key_ok1 ? exp2f(p[nt][2] - l0) : 0.f;
        p[nt][3] = key_ok1 ? exp2f(p[nt][3] - l1) : 0.f;
        // dS^T = P^T * (dP^T - Delta)
        ds[nt][0] = p[nt][0] * (ds[nt][0] - d0);
        ds[nt][1] = p[nt][1] * (ds[nt][1] - d1);
        ds[nt][2] = p[nt][2] * (ds[nt][2] - d0);
        ds[nt][3] = p[nt][3] * (ds[nt][3] - d1);
      }
      mma_frag_x_t<NC8>(acc_v, p, sdOt, hq * kHalf);
      mma_frag_x_t<NC8>(acc_k, ds, sQt, hq * kHalf);
    }
  }

  // ---- write dK (scaled) and dV, bf16, rows past Sk / columns past D skipped
  const int row0 = k0 + rw + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NC8; ++n) {
    const int col = c0 + n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sk) {
        *reinterpret_cast<uint32_t*>(dk + row_offset(st, DK, b, h, row0) +
                                     col) =
            pack_bf16(acc_k[n][0] * scale, acc_k[n][1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row_offset(st, DV, b, h, row0) +
                                     col) =
            pack_bf16(acc_v[n][0], acc_v[n][1]);
      }
      if (row1 < sk) {
        *reinterpret_cast<uint32_t*>(dk + row_offset(st, DK, b, h, row1) +
                                     col) =
            pack_bf16(acc_k[n][2] * scale, acc_k[n][3] * scale);
        *reinterpret_cast<uint32_t*>(dv + row_offset(st, DV, b, h, row1) +
                                     col) =
            pack_bf16(acc_v[n][2], acc_v[n][3]);
      }
    }
  }
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (4 * kRows * (DP + 8) + DP * kLDT) * (int)sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int heads, int sq, int sk, int d,
          Strides st, float qscale, float scale) {
  constexpr int LD = DP + 8;
  constexpr int ND8 = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD] scaled Q
  bf16* sdO = sQs + kRows * LD;                   // [kRows][LD]
  bf16* sK = sdO + kRows * LD;                    // [kCols][LD]
  bf16* sV = sK + kCols * LD;                     // [kCols][LD]
  bf16* sKt = sV + kCols * LD;                    // [DP][kLDT] K^T

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, rw = warp * 16;
  const int row0 = q0 + rw + g, row1 = row0 + 8;

  stage_rows<DP>(sQs, q, st, Q, b, h, q0, sq, d, qscale);
  stage_rows<DP>(sdO, dout, st, DO, b, h, q0, sq, d, 0.f);
  const float* lse_bh = lse + (long long)bh * sq;
  const float* delta_bh = delta + (long long)bh * sq;
  const float l0 = row0 < sq ? lse_bh[row0] * kLog2e : INFINITY;
  const float l1 = row1 < sq ? lse_bh[row1] * kLog2e : INFINITY;
  const float dl0 = row0 < sq ? delta_bh[row0] : 0.f;
  const float dl1 = row1 < sq ? delta_bh[row1] : 0.f;

  float acc[ND8][4];
#pragma unroll
  for (int n = 0; n < ND8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kCols) {
    __syncthreads();   // every warp is done with the previous key tile
    stage_rows<DP>(sK, k, st, K, b, h, k0, sk, d, 0.f);
    stage_rows<DP>(sV, v, st, V, b, h, k0, sk, d, 0.f);
    stage_cols_t<DP>(sKt, k, st, K, b, h, k0, sk, 0, d);
    __syncthreads();

#pragma unroll
    for (int hk = 0; hk < kCols / kHalf; ++hk) {
      float p[kHalf / 8][4], ds[kHalf / 8][4];
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) p[nt][j] = ds[nt][j] = 0.f;
      }
      mma_rows_x_rows<DP, kHalf / 8>(p, sQs, rw, sK, hk * kHalf);
      mma_rows_x_rows<DP, kHalf / 8>(ds, sdO, rw, sV, hk * kHalf);
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
        const int key = k0 + hk * kHalf + nt * 8 + t4 * 2;
        const bool ok0 = key < sk, ok1 = key + 1 < sk;
        p[nt][0] = ok0 ? exp2f(p[nt][0] - l0) : 0.f;
        p[nt][1] = ok1 ? exp2f(p[nt][1] - l0) : 0.f;
        p[nt][2] = ok0 ? exp2f(p[nt][2] - l1) : 0.f;
        p[nt][3] = ok1 ? exp2f(p[nt][3] - l1) : 0.f;
        ds[nt][0] = p[nt][0] * (ds[nt][0] - dl0);
        ds[nt][1] = p[nt][1] * (ds[nt][1] - dl0);
        ds[nt][2] = p[nt][2] * (ds[nt][2] - dl1);
        ds[nt][3] = p[nt][3] * (ds[nt][3] - dl1);
      }
      mma_frag_x_t<ND8>(acc, ds, sKt, hk * kHalf);
    }
  }

#pragma unroll
  for (int n = 0; n < ND8; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq) {
        *reinterpret_cast<uint32_t*>(dq + row_offset(st, DQ, b, h, row0) +
                                     col) =
            pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
      }
      if (row1 < sq) {
        *reinterpret_cast<uint32_t*>(dq + row_offset(st, DQ, b, h, row1) +
                                     col) =
            pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* lse, const float* delta, bf16* dq, bf16* dk,
           bf16* dv, int batch, int heads, int sq, int sk, int d,
           const Strides& st, cudaStream_t stream) {
  static bool dkv_attr = false, dq_attr = false;
  constexpr int dkv_smem = dkv_smem_bytes<DP>(), dq_smem = dq_smem_bytes<DP>();
  cudaError_t e = allow_smem(dkv_kernel<DP>, dkv_smem, &dkv_attr);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(dq_kernel<DP>, dq_smem, &dq_attr);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)d);
  const float qscale = kLog2e * scale;
  const dim3 dkv_grid((sk + kRows - 1) / kRows, batch * heads,
                      dkv_chunks<DP>());
  dkv_kernel<DP><<<dkv_grid, kThreads, dkv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, heads, sq, sk, d, st, qscale, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 dq_grid((sq + kRows - 1) / kRows, batch * heads);
  dq_kernel<DP><<<dq_grid, kThreads, dq_smem, stream>>>(
      q, k, v, dout, lse, delta, dq, heads, sq, sk, d, st, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, H, D); all bf16 with a
// unit stride on D.  lse: (B, H, Sq) f32, contiguous, from
// flash_attn_forward_lse; delta: an f32 workspace of B * H * Sq.  strides:
// 24 element strides, (batch, seq, head) for q, k, v, o, dout, dq, dk, dv
// in that order; each a multiple of 8, pointers 16-byte aligned.  Takes
// what the forward takes: D a multiple of 8 up to 160, B * H <= 65535.
int flash_attn_backward(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta, int batch,
                        int heads, int sq, int sk, int d,
                        const long long* strides, void* stream) {
  if (d % 8 != 0 || d < 8 || d > 160 || sq <= 0 || sk <= 0 ||
      batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st;
  for (int t = 0; t < 8; ++t) {
    for (int j = 0; j < 3; ++j) st.s[t][j] = strides[3 * t + j];
  }
  const bf16* qp = reinterpret_cast<const bf16*>(q);
  const bf16* kp = reinterpret_cast<const bf16*>(k);
  const bf16* vp = reinterpret_cast<const bf16*>(v);
  const bf16* op = reinterpret_cast<const bf16*>(o);
  const bf16* gp = reinterpret_cast<const bf16*>(dout);
  bf16* dqp = reinterpret_cast<bf16*>(dq);
  bf16* dkp = reinterpret_cast<bf16*>(dk);
  bf16* dvp = reinterpret_cast<bf16*>(dv);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);

  const dim3 delta_grid((sq + kThreads / 32 - 1) / (kThreads / 32),
                        batch * heads);
  delta_kernel<<<delta_grid, kThreads, 0, s>>>(op, gp, delta, heads, sq, d,
                                               st);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#define K2B_CASE(N, DP)                                                     \
  case N:                                                                   \
    return launch<DP>(qp, kp, vp, gp, lse, delta, dqp, dkp, dvp, batch,    \
                      heads, sq, sk, d, st, s);
  switch ((d + 15) / 16) {
    K2B_CASE(1, 16) K2B_CASE(2, 32) K2B_CASE(3, 48) K2B_CASE(4, 64)
    K2B_CASE(5, 80) K2B_CASE(6, 96) K2B_CASE(7, 112) K2B_CASE(8, 128)
    K2B_CASE(9, 144) K2B_CASE(10, 160)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2B_CASE
}

}  // extern "C"
