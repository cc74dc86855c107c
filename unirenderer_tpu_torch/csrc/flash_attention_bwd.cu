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
// five products of 2 * Sq * Sk * D flops per (batch, head) (S, dP, dV, dK,
// dQ) against ~(4 Sq + 4 Sk) * D * 2 bytes: ~400 flop/byte at S = 4096,
// D = 40, above the card's ~295 flop/byte ridge.  This design does those
// five products and no more, on Hopper's warpgroup MMA; what holds it back
// now is latency: the products of a query tile depend on each other in a
// chain (S, dP -> P, dS -> dV, dK, and dQ after a barrier), with 8 warps
// an SM.
//
// Design, three launches on the caller's stream (five when the query tiles
// are split, see 2.):
//   1. `bwd_prep_kernel`, one warp per query row: Delta = rowsum(dO * O) in
//      f32, and Q staged as the forward staged it, bf16(q * softmax_scale *
//      log2(e)), into a (B*H, Sq, D) workspace, so P is recomputed from the
//      same bits as the forward's and the main kernel copies it by cp.async;
//      it also zeroes the f32 sums of step 2.
//   2. `bwd_kernel`, one pass over the query tiles: a block owns 128 keys,
//      two warpgroups of 64, with K and V staged once; it walks 64-query
//      tiles of (staged Q, Q, dO, L, Delta) through a 2-stage cp.async ring.
//      All tiles sit in shared memory in wgmma's core-matrix layout
//      (wgmma_bf16.cuh), filled by 16-byte copies, so every operand is read
//      K-major or, transposed by its descriptor, MN-major: nothing is
//      transposed element by element.  Per 64 queries (32 at D > 96, for
//      registers) a warpgroup runs wgmma.mma_async m64nNk16:
//        S^T = K Q^T and dP^T = V dO^T (A and B from shared memory; P^T is
//          formed while dP^T still runs),
//        dV += P^T dO and dK += dS^T Q (A re-packed from the accumulators,
//          kept in registers over the whole pass),
//      and writes dS^T to shared memory.  After one barrier each warpgroup
//      forms dQ = dS K for the tile's 64 queries and its half of D over the
//      block's 128 keys (A = dS^T read transposed) while its dV/dK products
//      may still run, and adds it to an f32 (B*H, Sq, D) workspace with
//      float2 atomicAdd: the library's own route on this card.  S and dP
//      are computed once per (key, query) pair at every D.
//      Where the key blocks alone would not fill the card (cross-attention
//      over 77 keys, the 32^2 and 16^2 levels), gridDim.z splits the query
//      tiles too, and dK/dV are then added to f32 workspaces the same way.
//   3. `dq_convert_kernel`: the f32 sums -> bf16, dQ (and, when the query
//      tiles were split, dK) times softmax_scale in f32.
// Because of the atomics dQ (and a split dK/dV) changes from run to run in
// its last bits: f32 sums in another order, then rounded to bf16.
// Keys past Sk get P = 0; queries past Sq are zero rows of Q and dO (their
// L reads 0) and are never written.  D is zero-padded in shared memory to
// DP, the next multiple of 16.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing
// (Delta, the staged Q and the f32 sums live in caller-given workspaces),
// launches on the caller's stream and returns the first CUDA error.

#include <math.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace attn;

constexpr int kQT = 64;           // queries per ring stage
constexpr int kPrepThreads = 128; // 4 warps, one query row each
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Bwd {
  static constexpr int kKeys = 128;                    // keys per block
  static constexpr int kThreads = 256;                 // 2 warpgroups
  static constexpr int kStepQ = DP <= 96 ? 64 : 32;    // queries per step
  static constexpr int kTileQ = kQT * DP;              // a Qs, Q or dO tile
  static constexpr int kStage = 3 * kTileQ;            // staged Q, Q, dO
  static constexpr int kSmemBytes =
      (2 * kKeys * DP + 2 * kStage + kKeys * kQT) * (int)sizeof(bf16) +
      2 * 2 * kQT * (int)sizeof(float);                // L, Delta
};

struct Strides {                  // element strides (batch, seq, head)
  long long s[8][3];              // q, k, v, o, do, dq, dk, dv
};
enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ long long row_offset(const Strides& st, int t,
                                                int b, int h, long long r) {
  return b * st.s[t][0] + h * st.s[t][2] + r * st.s[t][1];
}

// Delta[bh, i] = sum_d dO * O; qs[bh, i, :] = bf16(q * qscale); the f32
// sums zeroed: dQ's rows, and dK's and dV's when `zero_kv`.  One warp per
// row (of max(Sq, Sk)), a pair per lane.
__global__ void __launch_bounds__(kPrepThreads)
bwd_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, bf16* __restrict__ qs,
                float* __restrict__ delta, float* __restrict__ dq_acc,
                float* __restrict__ dk_acc, float* __restrict__ dv_acc,
                int heads, int sq, int sk, int d, Strides st, float qscale,
                int zero_kv) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const float2 zero = make_float2(0.f, 0.f);
  if (zero_kv && row < sk) {
    const long long off = ((long long)bh * sk + row) * d;
    for (int c = 2 * lane; c < d; c += 64) {
      *reinterpret_cast<float2*>(dk_acc + off + c) = zero;
      *reinterpret_cast<float2*>(dv_acc + off + c) = zero;
    }
  }
  if (row >= sq) return;
  const bf16* op = o + row_offset(st, O, b, h, row);
  const bf16* gp = dout + row_offset(st, DO, b, h, row);
  const bf16* qp = q + row_offset(st, Q, b, h, row);
  const long long off = ((long long)bh * sq + row) * d;
  float acc = 0.f;
  for (int c = 2 * lane; c < d; c += 64) {
    const float2 of = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + c));
    const float2 gf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(gp + c));
    acc += of.x * gf.x + of.y * gf.y;
    *reinterpret_cast<uint32_t*>(qs + off + c) =
        scale_bf16x2(*reinterpret_cast<const uint32_t*>(qp + c), qscale);
    *reinterpret_cast<float2*>(dq_acc + off + c) = zero;
  }
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off2);
  }
  if (lane == 0) delta[(long long)bh * sq + row] = acc;
}

// Element offset of row r, 8-column block c in a core-matrix tile of
// `width` columns (wgmma_bf16.cuh's layout: 8 x 8 blocks of 128 bytes, the
// column blocks of one 8-row group next to each other).
__device__ __forceinline__ int core(int r, int c, int width) {
  return (r >> 3) * (width * 8) + c * 64 + (r & 7) * 8;
}

template <int DP>
__global__ void __launch_bounds__(Bwd<DP>::kThreads, 1)
bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const bf16* __restrict__ qs, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dq_acc,
           float* __restrict__ dk_acc, float* __restrict__ dv_acc,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq,
           int sk, int d, Strides st, float scale, int qt_per_block) {
  using T = Bwd<DP>;
  constexpr int NT = T::kThreads;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  constexpr int VPR = DP / 8;             // 16-byte vectors per row
  constexpr int SQ = T::kStepQ;
  constexpr int NQ = SQ / 8;              // 8-wide query blocks of a step
  constexpr int NH = DP / 2;              // dQ columns per warpgroup
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [kKeys][DP] core
  bf16* sV = sK + T::kKeys * DP;                  // [kKeys][DP] core
  bf16* sRing = sV + T::kKeys * DP;               // 2 x {Qs, Q, dO} core
  bf16* sdS = sRing + 2 * T::kStage;              // [kKeys][kQT] core, dS^T
  float* sF = reinterpret_cast<float*>(sdS + T::kKeys * kQT);  // 2 x {L, D}

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * T::kKeys;
  const int n_qt = (sq + kQT - 1) / kQT;
  const int it0 = blockIdx.z * qt_per_block;
  const int it1 = min(n_qt, it0 + qt_per_block);
  if (it0 >= it1) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;               // warpgroup: keys wg * 64 ..
  const int kw = warp * 16;               // the warp's first key
  const bool key_ok0 = k0 + kw + g < sk, key_ok1 = k0 + kw + g + 8 < sk;

  const bf16* qb = q + b * st.s[Q][0] + h * st.s[Q][2];
  const bf16* gb = dout + b * st.s[DO][0] + h * st.s[DO][2];
  const bf16* qsb = qs + (long long)bh * sq * d;
  const float* lse_bh = lse + (long long)bh * sq;
  const float* delta_bh = delta + (long long)bh * sq;
  float* dqa = dq_acc + (long long)bh * sq * d;

  // rows [r0, r0 + rows) of a (seq, D) slice -> a core-matrix tile, D
  // zero-padded to DP, rows at or past `limit` zero-filled
  auto load_core = [&](bf16* dst, const bf16* src, long long stride, int r0,
                       int rows, int limit) {
    for (int i = threadIdx.x; i < rows * VPR; i += NT) {
      const int r = i / VPR, c = i % VPR;
      const bool valid = r0 + r < limit && c * 8 < d;
      cp_async16(dst + core(r, c, DP),
                 valid ? src + (long long)(r0 + r) * stride + c * 8 : src,
                 valid);
    }
  };
  auto stage = [&](int it, int slot) {
    const int q0 = it * kQT;
    bf16* base = sRing + slot * T::kStage;
    load_core(base, qsb, d, q0, kQT, sq);
    load_core(base + T::kTileQ, qb, st.s[Q][1], q0, kQT, sq);
    load_core(base + 2 * T::kTileQ, gb, st.s[DO][1], q0, kQT, sq);
    float* f = sF + slot * 2 * kQT;
    for (int i = threadIdx.x; i < kQT; i += NT) {
      const bool ok = q0 + i < sq;
      cp_async4(f + i, ok ? lse_bh + q0 + i : lse_bh, ok);
      cp_async4(f + kQT + i, ok ? delta_bh + q0 + i : delta_bh, ok);
    }
  };

  // ---- K, V of this block's keys and the first query tile: group 0
  load_core(sK, k + b * st.s[K][0] + h * st.s[K][2], st.s[K][1], k0,
            T::kKeys, sk);
  load_core(sV, v + b * st.s[V][0] + h * st.s[V][2], st.s[V][1], k0,
            T::kKeys, sk);
  stage(it0, 0);
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_k[n][j] = acc_v[n][j] = 0.f;
  }

  for (int it = it0; it < it1; ++it) {
    const int slot = (it - it0) & 1;
    cp_async_wait<0>();          // tile it (and at first K, V) landed
    fence_proxy_async();         // ... and is visible to wgmma
    __syncthreads();             // for every thread; slot ^ 1 and dS^T free
    if (it + 1 < it1) stage(it + 1, slot ^ 1);
    cp_async_commit();
    const bf16* tQs = sRing + slot * T::kStage;
    const bf16* tQ = tQs + T::kTileQ;
    const bf16* tdO = tQ + T::kTileQ;
    const float* tL = sF + slot * 2 * kQT;
    const float* tD = tL + kQT;

#pragma unroll 1
    for (int c0 = 0; c0 < kQT; c0 += SQ) {
      // ---- S^T = K Q^T (log2 units) and dP^T = V dO^T, 64 keys x SQ a
      // warpgroup: A (keys) and B (queries) both K-major (k = D)
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_m64k16_ss<SQ, 0, 0>(
            s, smem_desc(sK + core(wg * 64, 2 * kk, DP), 128, DP * 16),
            smem_desc(tQs + core(c0, 2 * kk, DP), 128, DP * 16), kk > 0);
      }
      wgmma_commit();             // S^T: one group, dP^T the next
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_m64k16_ss<SQ, 0, 0>(
            dp, smem_desc(sV + core(wg * 64, 2 * kk, DP), 128, DP * 16),
            smem_desc(tdO + core(c0, 2 * kk, DP), 128, DP * 16), kk > 0);
      }
      wgmma_commit();
      // ---- P^T while dP^T runs; this thread holds keys kw+g (0,1) and
      // kw+g+8 (2,3) at queries c0 + nt*8 + 2*t4 (+1)
      wgmma_wait<1>();
      fence_operands(s);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const int col = c0 + nt * 8 + t4 * 2;
        const float2 l = *reinterpret_cast<const float2*>(tL + col);
        const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
        s[nt][0] = key_ok0 ? fast_exp2(s[nt][0] - l0) : 0.f;
        s[nt][1] = key_ok0 ? fast_exp2(s[nt][1] - l1) : 0.f;
        s[nt][2] = key_ok1 ? fast_exp2(s[nt][2] - l0) : 0.f;
        s[nt][3] = key_ok1 ? fast_exp2(s[nt][3] - l1) : 0.f;
      }
      // ---- dS^T = P^T * (dP^T - Delta)
      wgmma_wait<0>();
      fence_operands(dp);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const int col = c0 + nt * 8 + t4 * 2;
        const float2 dl = *reinterpret_cast<const float2*>(tD + col);
        dp[nt][0] = s[nt][0] * (dp[nt][0] - dl.x);
        dp[nt][1] = s[nt][1] * (dp[nt][1] - dl.y);
        dp[nt][2] = s[nt][2] * (dp[nt][2] - dl.x);
        dp[nt][3] = s[nt][3] * (dp[nt][3] - dl.y);
      }
      // ---- P^T and dS^T as bf16 A fragments (k = query); dS^T also to
      // shared memory (rows = keys, columns = queries) for dQ
      uint32_t pa[SQ / 16][4], da[SQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < SQ / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
        da[kc][0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
        da[kc][1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
        da[kc][2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
        da[kc][3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
      }
#pragma unroll
      for (int kc = 0; kc < SQ / 16; ++kc) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {   // query blocks 2kc, 2kc+1
          const int col = c0 + (2 * kc + half) * 8 + t4 * 2;
          *reinterpret_cast<uint32_t*>(sdS + core(kw + g, col >> 3, kQT) +
                                       (col & 7)) = da[kc][2 * half];
          *reinterpret_cast<uint32_t*>(sdS + core(kw + g + 8, col >> 3, kQT) +
                                       (col & 7)) = da[kc][2 * half + 1];
        }
      }
      // ---- dV += P^T dO and dK += dS^T Q: A from registers, B (k =
      // query, n = D) MN-major from the row-major tiles
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < SQ / 16; ++kc) {
        wgmma_m64k16<DP, 1>(
            acc_v, pa[kc],
            smem_desc(tdO + core(c0 + 16 * kc, 0, DP), DP * 16, 128), 1);
      }
#pragma unroll
      for (int kc = 0; kc < SQ / 16; ++kc) {
        wgmma_m64k16<DP, 1>(
            acc_k, da[kc],
            smem_desc(tQ + core(c0 + 16 * kc, 0, DP), DP * 16, 128), 1);
      }
      wgmma_commit();
      if (SQ < kQT) {            // the next step refills pa and da
        wgmma_wait<0>();
        fence_operands(acc_v);
        fence_operands(acc_k);
      }
    }
    fence_proxy_async();         // dS^T's stores, to wgmma's async proxy
    __syncthreads();             // every warpgroup's dS^T is in place

    // ---- dQ[64 queries, this warpgroup's half of D] += dS K over the
    // block's 128 keys: A = dS^T read MN-major (k = key), B = K MN-major
    {
      float cq[NH / 8][4];
#pragma unroll
      for (int n = 0; n < NH / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cq[n][j] = 0.f;
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < T::kKeys / 16; ++ks) {
        wgmma_m64k16_ss<NH, 1, 1>(
            cq, smem_desc(sdS + core(16 * ks, 0, kQT), kQT * 16, 128),
            smem_desc(sK + core(16 * ks, wg * (NH / 8), DP), DP * 16, 128),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();            // dQ, and dV / dK of the last step
      fence_operands(cq);
      fence_operands(acc_v);
      fence_operands(acc_k);
      const int row0 = it * kQT + (warp & 3) * 16 + g, row1 = row0 + 8;
#pragma unroll
      for (int n = 0; n < NH / 8; ++n) {
        const int col = wg * NH + n * 8 + t4 * 2;
        if (col < d) {            // a float2 atomic per row (sm_90)
          if (row0 < sq) {
            atomicAdd(reinterpret_cast<float2*>(dqa + (long long)row0 * d +
                                                col),
                      make_float2(cq[n][0], cq[n][1]));
          }
          if (row1 < sq) {
            atomicAdd(reinterpret_cast<float2*>(dqa + (long long)row1 * d +
                                                col),
                      make_float2(cq[n][2], cq[n][3]));
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- dK (scaled) and dV: bf16 when this block saw every query tile,
  // else f32 sums into the workspaces; rows past Sk / columns past D skipped
  const bool whole = gridDim.z == 1;
  auto put = [&](int row, int col, float k0v, float k1v, float v0v,
                 float v1v) {
    if (row >= sk) return;
    if (whole) {
      *reinterpret_cast<uint32_t*>(dk + row_offset(st, DK, b, h, row) +
                                   col) = pack_bf16(k0v * scale, k1v * scale);
      *reinterpret_cast<uint32_t*>(dv + row_offset(st, DV, b, h, row) +
                                   col) = pack_bf16(v0v, v1v);
    } else {
      const long long off = ((long long)bh * sk + row) * d + col;
      atomicAdd(reinterpret_cast<float2*>(dk_acc + off),
                make_float2(k0v, k1v));
      atomicAdd(reinterpret_cast<float2*>(dv_acc + off),
                make_float2(v0v, v1v));
    }
  };
  const int row0 = k0 + kw + g;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      put(row0, col, acc_k[n][0], acc_k[n][1], acc_v[n][0], acc_v[n][1]);
      put(row0 + 8, col, acc_k[n][2], acc_k[n][3], acc_v[n][2],
          acc_v[n][3]);
    }
  }
}

// out[b, i, h, :] = bf16(acc[bh, i, :] * scale), one warp per row, a pair
// per lane; `t` names out's strides.
__global__ void __launch_bounds__(kPrepThreads)
dq_convert_kernel(const float* __restrict__ acc, bf16* __restrict__ out,
                  int heads, int n, int d, Strides st, int t, float scale) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* src = acc + ((long long)bh * n + row) * d;
  bf16* dst = out + row_offset(st, t, b, h, row);
  for (int c = 2 * lane; c < d; c += 64) {
    const float2 a = *reinterpret_cast<const float2*>(src + c);
    *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(a.x * scale,
                                                      a.y * scale);
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, bf16* qs, const float* lse, float* delta,
           float* dq_acc, float* dkv_acc, bf16* dq, bf16* dk, bf16* dv,
           int batch, int heads, int sq, int sk, int d, const Strides& st,
           float scale, float qscale, cudaStream_t stream) {
  using T = Bwd<DP>;
  static bool attr_set = false;
  static int sms = 0;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // split the query tiles over gridDim.z until ~2 blocks per SM
  const int bh = batch * heads;
  const int n_kb = (sk + T::kKeys - 1) / T::kKeys;
  const int n_qt = (sq + kQT - 1) / kQT;
  const int blocks = n_kb * bh;
  int split = blocks >= 2 * sms ? 1 : (2 * sms + blocks - 1) / blocks;
  split = min(split, n_qt);
  const int per = (n_qt + split - 1) / split;
  split = (n_qt + per - 1) / per;
  const long long kv_elems = (long long)bh * sk * d;
  float* dk_acc = dkv_acc;
  float* dv_acc = dkv_acc + kv_elems;
  const int rows_per_block = kPrepThreads / 32;
  const int prep_rows = split > 1 ? max(sq, sk) : sq;
  bwd_prep_kernel<<<dim3((prep_rows + rows_per_block - 1) / rows_per_block,
                         bh),
                    kPrepThreads, 0, stream>>>(
      q, o, dout, qs, delta, dq_acc, dk_acc, dv_acc, heads, sq, sk, d, st,
      qscale, split > 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_kb, bh, split);
  bwd_kernel<DP><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      q, k, v, dout, qs, lse, delta, dq_acc, dk_acc, dv_acc, dk, dv,
      heads, sq, sk, d, st, scale, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_convert_kernel<<<dim3((sq + rows_per_block - 1) / rows_per_block, bh),
                      kPrepThreads, 0, stream>>>(dq_acc, dq, heads, sq, d,
                                                 st, DQ, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  const dim3 kv_grid((sk + rows_per_block - 1) / rows_per_block, bh);
  dq_convert_kernel<<<kv_grid, kPrepThreads, 0, stream>>>(
      dk_acc, dk, heads, sk, d, st, DK, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_convert_kernel<<<kv_grid, kPrepThreads, 0, stream>>>(
      dv_acc, dv, heads, sk, d, st, DV, 1.f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, H, D); all bf16 with a
// unit stride on D.  lse: (B, H, Sq) f32, contiguous, from
// flash_attn_forward_lse.  Workspaces: delta f32 of B*H*Sq, qs bf16 of
// B*H*Sq*D, dq_acc f32 of B*H*Sq*D, dkv_acc f32 of 2*B*H*Sk*D; each
// 16-byte aligned.  strides: 24 element strides, (batch, seq, head) for
// q, k, v, o, dout, dq, dk, dv in that order; each a multiple of 8,
// pointers 16-byte aligned.  Takes what the forward takes: D a multiple of
// 8 up to 160, B * H <= 65535.
int flash_attn_backward(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta, void* qs,
                        float* dq_acc, float* dkv_acc, int batch, int heads,
                        int sq, int sk, int d, const long long* strides,
                        void* stream) {
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
  bf16* qsp = reinterpret_cast<bf16*>(qs);
  bf16* dqp = reinterpret_cast<bf16*>(dq);
  bf16* dkp = reinterpret_cast<bf16*>(dk);
  bf16* dvp = reinterpret_cast<bf16*>(dv);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf((float)d);
  // the forward's staging factor (flash_attention.cu), to the bit
  const float qscale = kLog2e / sqrtf((float)d);

#define K2B_CASE(N, DP)                                                     \
  case N:                                                                   \
    return launch<DP>(qp, kp, vp, op, gp, qsp, lse, delta, dq_acc,         \
                      dkv_acc, dqp, dkp, dvp, batch, heads, sq, sk, d, st,  \
                      scale, qscale, s);
  switch ((d + 15) / 16) {
    K2B_CASE(1, 16) K2B_CASE(2, 32) K2B_CASE(3, 48) K2B_CASE(4, 64)
    K2B_CASE(5, 80) K2B_CASE(6, 96) K2B_CASE(7, 112) K2B_CASE(8, 128)
    K2B_CASE(9, 144) K2B_CASE(10, 160)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2B_CASE
}

}  // extern "C"
