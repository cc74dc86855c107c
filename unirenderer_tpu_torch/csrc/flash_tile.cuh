// The attention tile shared by K2 (flash_attention.cu) and K2s
// (splash_attention.cu): one block of 4 warps computes 64 query rows of
// softmax(Q K^T) V for one (batch, head), looping over 64-key tiles.
//
//   * q, k, v, o are read and written in the model's (B, S, H, D) layout
//     through strides: no transposes in device memory.
//   * D is zero-padded in shared memory only, to DP, the next multiple of
//     16 (the MMA depth): 40 -> 48, 80 and 160 stay.
//   * S = Q K^T and O += P V run on the tensor cores through mma.sync
//     m16n8k16 (bf16 in, f32 accumulate); the online softmax keeps its
//     running max and sum in f32 registers and works in log2 units (exp2),
//     and P is re-packed from the S accumulators into A fragments without
//     a trip through memory.
//   * key columns past Sk are set to -inf, so any Sk works.
//
// kSplash selects K2s's two differences from K2: the (batch, head) pairs
// are walked head-major (blockIdx.y = h * B + b, the library splash
// kernel's grid over heads with the batch inside), and the kernel applies
// no scale to Q (the caller pre-scaled it by 1/sqrt(D) in bf16): the f32
// scores are multiplied by log2(e) instead.  K2 folds
// softmax_scale * log2(e) into Q while it is staged.
//
// kLse (K2 under autograd) also writes each row's log-sum-exp of the
// natural-unit logits, f32, to lse[(b * heads + h) * sq + row]: the
// statistic the backward (flash_attention_bwd.cu) recomputes P from.
// Without it (serving, K2s) the tile is unchanged.

#pragma once

#include <math.h>

#include "mma_bf16.cuh"

namespace attn {

constexpr int kTileM = 64;        // query rows per block
constexpr int kTileN = 64;        // keys per tile
constexpr int kTileWarps = 4;
constexpr int kTileThreads = kTileWarps * 32;

template <int DP>
constexpr int flash_tile_smem_bytes() {
  return ((kTileM + kTileN) * (DP + 8) + DP * (kTileN + 8)) *
         (int)sizeof(bf16);
}

struct Strides {                  // element strides (batch, seq, head)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, o_sh;
};

template <int DP, bool kSplash, bool kLse = false>
__device__ __forceinline__ void flash_tile(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int batch, int heads, int sq, int sk, int d,
    const Strides& st, float qscale, float* __restrict__ lse = nullptr) {
  constexpr int LDQ = DP + 8;     // smem row pitch of Q and K (elements)
  constexpr int LDV = kTileN + 8; // smem row pitch of V^T
  constexpr int VPR = DP / 8;     // 16-byte vectors per padded row
  constexpr int KD = DP / 16;     // MMA k-steps over D
  constexpr int ND = DP / 8;      // 8-wide output column tiles
  constexpr int NN = kTileN / 8;  // 8-wide score column tiles
  constexpr float kLog2e = 1.4426950408889634f;

  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTileM * LDQ;
  bf16* sVt = sK + kTileN * LDQ;

  const int bh = blockIdx.y;
  const int b = kSplash ? bh % batch : bh / heads;
  const int h = kSplash ? bh / batch : bh % heads;
  const int q0 = blockIdx.x * kTileM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;
  bf16* ob = o + b * st.o_sb + h * st.o_sh;

  // ---- stage the Q tile (K2: scaled by softmax_scale * log2(e)) ----
  for (int i = tid; i < kTileM * VPR; i += kTileThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < sq && c < d) {
      val = *reinterpret_cast<const uint4*>(
          qb + (long long)(q0 + r) * st.q_ss + c);
      if (!kSplash) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(p[j]);
          p[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
        }
      }
    }
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) = val;
  }
  __syncthreads();

  const int rw = warp * 16;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* base = sQ + (rw + g) * LDQ + kk * 16 + t4 * 2;
    qf[kk][0] = ld32(base);
    qf[kk][1] = ld32(base + 8 * LDQ);
    qf[kk][2] = ld32(base + 8);
    qf[kk][3] = ld32(base + 8 * LDQ + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (sk + kTileN - 1) / kTileN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTileN;
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int i = tid; i < kTileN * VPR; i += kTileThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < sk && c < d) {
        kv = *reinterpret_cast<const uint4*>(
            kb + (long long)(k0 + r) * st.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(
            vb + (long long)(k0 + r) * st.v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) = kv;
      const bf16* pv = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * LDV + r] = pv[j];
    }
    __syncthreads();

    // ---- S = Q K^T, 16 x 64 per warp, in log2 units ----
    float s[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = sK + (nt * 8 + g) * LDQ + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma16816(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
      if (kSplash) {
        s[nt][0] *= kLog2e;
        s[nt][1] *= kLog2e;
        s[nt][2] *= kLog2e;
        s[nt][3] *= kLog2e;
      }
    }
    if (k0 + kTileN > sk) {
#pragma unroll
      for (int nt = 0; nt < NN; ++nt) {
        const int col = k0 + nt * 8 + t4 * 2;
        if (col >= sk) { s[nt][0] = -INFINITY; s[nt][2] = -INFINITY; }
        if (col + 1 >= sk) { s[nt][1] = -INFINITY; s[nt][3] = -INFINITY; }
      }
    }

    // ---- online softmax; this thread holds rows g (0,1) and g+8 (2,3) ----
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m_run[0] - mx0);
    const float alpha1 = exp2f(m_run[1] - mx1);
    m_run[0] = mx0;
    m_run[1] = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l_run[0] = l_run[0] * alpha0 + rs0;    // partial over this thread's columns
    l_run[1] = l_run[1] * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // ---- O += P V; P's A fragments come straight from the S accumulators
#pragma unroll
    for (int kc = 0; kc < kTileN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vr = sVt + (n * 8 + g) * LDV + kc * 16 + t4 * 2;
        mma16816(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // ---- normalise and write (B, S, H, D) ----
  float l0 = l_run[0], l1 = l_run[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + rw + g, row1 = row0 + 8;
  if (kLse && t4 == 0) {
    // m_run and l0/l1 are in log2 units of the log2(e)-scaled logits
    constexpr float kLn2 = 0.6931471805599453f;
    float* lrow = lse + (long long)(b * heads + h) * sq;
    if (row0 < sq) lrow[row0] = (m_run[0] + log2f(l0)) * kLn2;
    if (row1 < sq) lrow[row1] = (m_run[1] + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * st.o_ss + col) =
            pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
      }
      if (row1 < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * st.o_ss + col) =
            pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
      }
    }
  }
}

// The shapes the tile takes: D a multiple of 8 up to 160, at most 65535
// (batch, head) pairs.
inline bool flash_tile_takes(int batch, int heads, int sq, int sk, int d) {
  return d % 8 == 0 && d >= 8 && d <= 160 && sq > 0 && sk > 0 &&
         batch * heads <= 65535;
}

}  // namespace attn
