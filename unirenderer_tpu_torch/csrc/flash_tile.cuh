// The attention tile shared by K2 (flash_attention.cu) and K2s
// (splash_attention.cu): one block of two warpgroups (8 warps) computes 128
// query rows of softmax(Q K^T) V for one (batch, head), walking 64-key
// tiles.
//
//   * q, k, v, o are read and written in the model's (B, S, H, D) layout
//     through strides: no transposes in device memory.
//   * D is zero-padded in shared memory only, to DP, the next multiple of
//     16 (the MMA depth): 40 -> 48, 80 and 160 stay.
//   * 128 query rows a block (64 a warpgroup, 16 a warp), so each K/V tile
//     is fetched once per 128 rows.
//   * The products run on Hopper's warpgroup MMA (wgmma.mma_async
//     m64nNk16, bf16 in, f32 accumulate; wgmma_bf16.cuh): S = Q K^T with
//     N = 64 keys and O += P V with N = DP, A from registers (Q's fragments,
//     staged once; P re-packed from the score accumulators), B from shared
//     memory through descriptors.  wgmma is asynchronous: S of tile j and
//     P V of tile j-1 are issued together, and the softmax of tile j (exp2
//     on the MUFU unit, the running sums on FP32) runs while P V does; at
//     D = 40 these take about as long as the products, and in sequence
//     they would add up.  Nothing is in flight across iterations, which
//     keeps ptxas from serializing the wgmmas.
//   * K and V go global -> shared by cp.async, 16-byte copies placed in the
//     core-matrix layout wgmma reads (8 x 8 blocks of 128 bytes; K read
//     K-major, V MN-major, i.e. transposed by the descriptor, so nothing is
//     transposed element by element), through a ring of 4 stages: at tile j
//     the warpgroups read K of tile j and V of tile j-1, tile j+1 is in
//     flight and tile j+2 is issued.  One barrier per tile publishes tile j
//     (after a proxy fence, since wgmma reads through the async proxy) and
//     frees the slot of tile j-2.
//   * the online softmax keeps its running max and sum in f32 registers and
//     works in log2 units (exp2 by ex2.approx).
//   * key columns past Sk are set to -inf, so any Sk works; Q rows past Sq
//     are zero and never written.
//
// The scores are taken to log2 units in f32: the wgmma product's f32 score
// s is multiplied by `sscale` inside the exponent (exp2(s * sscale - m),
// one fmaf) and in the running max.  K2 stages Q as the bf16 input itself
// and passes sscale = softmax_scale * log2(e): the f32 scores of the bf16
// inputs, scaled in f32, as the JAX library kernel scales them (its
// `sm_scale`).  kSplash selects K2s's two differences: Q is staged as
// bf16(q * qscale) with qscale = bf16(1/sqrt(D)), which makes the staged Q
// the same bits as the splash route's pre-scaled Q (ops/flash_attention.py
// `prescale_q`: the factor rounded to bf16, the product rounded to bf16),
// and sscale = log2(e); and the (batch, head) pairs are walked head-major
// (blockIdx.y = h * B + b, the library splash kernel's grid over heads
// with the batch inside).
//
// kLse (K2 under autograd) also writes each row's log-sum-exp of the
// natural-unit logits, f32, to lse[(b * heads + h) * sq + row]: the
// statistic the backward (flash_attention_bwd.cu) recomputes P from.
// Without it (serving, K2s) the tile computes the same O, bit for bit.

#pragma once

#include <math.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace attn {

constexpr int kTileM = 128;       // query rows per block
constexpr int kTileN = 64;        // keys per K/V tile
constexpr int kTileThreads = 256; // 2 warpgroups, 16 rows a warp
constexpr int kTileStages = 4;    // K/V ring depth

template <int DP>
struct FlashTile {
  // at DP <= 64 two blocks share an SM (<= 128 registers a thread)
  static constexpr int kMinBlocks = DP <= 64 ? 2 : 1;
  static constexpr int kLDQ = DP + 8;      // Q's smem row pitch (elements):
                                           // 8 ldmatrix rows, 8 bank groups
  static constexpr int kKV = kTileN * DP;  // elements of a K or V tile
  static constexpr int kSmemBytes =
      (kTileM * kLDQ + 2 * kTileStages * kKV) * (int)sizeof(bf16);
};

struct Strides {                  // element strides (batch, seq, head)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, o_sh;
};

// elements a strided (batch, seq, head, d) view spans: its last element's
// offset + 1 (the extent the index-checked build holds indices to)
__device__ __forceinline__ long long view_extent(int batch, int seq,
                                                 int heads, int d,
                                                 long long sb, long long ss,
                                                 long long sh) {
  return (batch - 1) * sb + (seq - 1) * ss + (heads - 1) * sh + d;
}

template <int DP, bool kSplash, bool kLse = false>
__device__ __forceinline__ void flash_tile(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int batch, int heads, int sq, int sk, int d,
    const Strides& st, float qscale, float sscale,
    float* __restrict__ lse = nullptr) {
  constexpr int NS = kTileStages;
  constexpr int LDQ = FlashTile<DP>::kLDQ;
  constexpr int KV = FlashTile<DP>::kKV;
  constexpr int NT = kTileThreads;
  constexpr int KD = DP / 16;     // MMA k-steps over D
  constexpr int ND = DP / 8;      // 8-wide output column blocks
  constexpr int NN = kTileN / 8;  // 8-wide score column blocks
  constexpr int VPR = DP / 8;     // 16-byte vectors per padded row

  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [kTileM][LDQ]
  bf16* sK = sQ + kTileM * LDQ;                   // NS core-matrix tiles
  bf16* sV = sK + NS * KV;                        // NS core-matrix tiles

  const int bh = blockIdx.y;
  const int b = kSplash ? bh % batch : bh / heads;
  const int h = kSplash ? bh / batch : bh % heads;
  const int q0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = warp * 16;       // the warp's first row in the block

  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;
  bf16* ob = o + b * st.o_sb + h * st.o_sh;
#ifdef UNIRENDER_INDEX_CHECK
  UR_CHECK_INDEX(b, batch, "attention batch");
  UR_CHECK_INDEX(h, heads, "attention head");
  const long long q_ext =
      view_extent(batch, sq, heads, d, st.q_sb, st.q_ss, st.q_sh);
  const long long k_ext =
      view_extent(batch, sk, heads, d, st.k_sb, st.k_ss, st.k_sh);
  const long long v_ext =
      view_extent(batch, sk, heads, d, st.v_sb, st.v_ss, st.v_sh);
  const long long o_ext =
      view_extent(batch, sq, heads, d, st.o_sb, st.o_ss, st.o_sh);
#else
  const long long q_ext = 0;
#endif

  const int n_tiles = (sk + kTileN - 1) / kTileN;
  // K/V tile j into slot j % NS: key r, 16-byte column block c at element
  // (r / 8) * DP * 8 + c * 64 + (r % 8) * 8 (wgmma_bf16.cuh's layout)
  auto load_tile = [&](int j) {
    bf16* tk = sK + (j % NS) * KV;
    bf16* tv = sV + (j % NS) * KV;
    for (int i = threadIdx.x; i < kTileN * VPR; i += NT) {
      const int r = i / VPR, c = i % VPR, key = j * kTileN + r;
      const bool valid = key < sk && c * 8 < d;
      const int off = (r >> 3) * (DP * 8) + c * 64 + (r & 7) * 8;
#ifdef UNIRENDER_INDEX_CHECK
      if (valid) {
        UR_CHECK_INDEX(kb + (long long)key * st.k_ss + c * 8 + 7 - k, k_ext,
                       "attention K tile (copy)");
        UR_CHECK_INDEX(vb + (long long)key * st.v_ss + c * 8 + 7 - v, v_ext,
                       "attention V tile (copy)");
      }
      UR_CHECK_INDEX(off + 7, KV, "attention K/V tile (shared)");
#endif
      cp_async16(tk + off, valid ? kb + (long long)key * st.k_ss + c * 8 : kb,
                 valid);
      cp_async16(tv + off, valid ? vb + (long long)key * st.v_ss + c * 8 : vb,
                 valid);
    }
  };
  // ---- prologue: Q with tile 0 in group 0, tile 1 in group 1
  cp_async_rows<DP, NT>(sQ, qb, st.q_ss, q0, kTileM, sq, d, q, q_ext);
  load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  uint32_t qf[KD][4];               // Q's A fragments
  uint32_t pa[kTileN / 16][4];      // P of the last softmax, A fragments
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};   // log2 units
  float l_run[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};               // the last rescale of O

  // The top of tile j: tile j has landed (group j; tile j+1's may still
  // run) and is published to wgmma's async proxy; the barrier also frees
  // slot (j + 2) % NS (tile j-2: its P V finished before every warpgroup
  // left tile j-1), where tile j+2 goes.
  auto top = [&](int j) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (j + 2 < n_tiles) load_tile(j + 2);
    cp_async_commit();
  };
  // issue S = Q K^T of tile j (64 x 64 a warpgroup) into s, one group;
  // K read K-major: LBO 128 (next 8 of D), SBO DP * 16 (next 8 keys)
  auto issue_scores = [&](float (&s)[NN][4], int j) {
    const bf16* tk = sK + (j % NS) * KV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_m64k16<kTileN, 0>(s, qf[kk], smem_desc(tk + kk * 128, 128,
                                                   DP * 16), kk > 0);
    }
    wgmma_commit();
  };
  // issue O = alpha * O + P V of tile j, one group; V read MN-major
  // (transposed): LBO DP * 16 (next 8 keys), SBO 128 (next 8 of D)
  auto issue_pv = [&](int j) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    const bf16* tv = sV + (j % NS) * KV;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTileN / 16; ++kc) {
      wgmma_m64k16<DP, 1>(acc, pa[kc],
                          smem_desc(tv + kc * 2 * DP * 8, DP * 16, 128), 1);
    }
    wgmma_commit();
  };
  // the online softmax of tile j's finished scores s, in place: p =
  // exp2(s - m) in log2 units; keys past Sk masked by selects (a branch
  // around wgmma-written registers makes ptxas serialize the wgmmas); this
  // thread holds rows g (0,1) and g+8 (2,3)
  auto softmax = [&](float (&s)[NN][4], int j) {
    fence_operands(s);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      const int col = j * kTileN + nt * 8 + t4 * 2;
      s[nt][0] = col < sk ? s[nt][0] : -INFINITY;
      s[nt][2] = col < sk ? s[nt][2] : -INFINITY;
      s[nt][1] = col + 1 < sk ? s[nt][1] : -INFINITY;
      s[nt][3] = col + 1 < sk ? s[nt][3] : -INFINITY;
    }
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]) * sscale);
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]) * sscale);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    alpha[0] = fast_exp2(m_run[0] - mx0);
    alpha[1] = fast_exp2(m_run[1] - mx1);
    m_run[0] = mx0;
    m_run[1] = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      s[nt][0] = fast_exp2(fmaf(s[nt][0], sscale, -mx0));
      s[nt][1] = fast_exp2(fmaf(s[nt][1], sscale, -mx0));
      s[nt][2] = fast_exp2(fmaf(s[nt][2], sscale, -mx1));
      s[nt][3] = fast_exp2(fmaf(s[nt][3], sscale, -mx1));
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l_run[0] = l_run[0] * alpha[0] + rs0;    // partial: own columns
    l_run[1] = l_run[1] * alpha[1] + rs1;
  };
  auto pack_p = [&](const float (&s)[NN][4]) {
#pragma unroll
    for (int kc = 0; kc < kTileN / 16; ++kc) {
      pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
  };

  // ---- tile 0: Q's A fragments (K2s: staged as bf16(q * qscale)), its
  // scores and softmax
  top(0);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qf[kk], sQ + (rw + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
    if (kSplash) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        qf[kk][jj] = scale_bf16x2(qf[kk][jj], qscale);
      }
    }
  }
  {
    float s[NN][4];
    issue_scores(s, 0);
    wgmma_wait<0>();
    softmax(s, 0);
    pack_p(s);
  }
  // ---- tile j: S of tile j and P V of tile j-1 go to the tensor cores
  // together; the softmax of tile j runs while P V does, and nothing is in
  // flight across iterations
  for (int j = 1; j < n_tiles; ++j) {
    top(j);
    float s[NN][4];
    issue_scores(s, j);
    issue_pv(j - 1);
    wgmma_wait<1>();                // S of tile j is done
    softmax(s, j);
    wgmma_wait<0>();                // P V of tile j-1 is done
    fence_operands(acc);
    pack_p(s);
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();             // no copy outlives the block

  // ---- normalise and write (B, S, H, D) ----
  float l0 = l_run[0], l1 = l_run[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // packed before any divergent store touches them (see softmax)
  uint32_t out[ND][2];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    out[n][0] = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    out[n][1] = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  const int row0 = q0 + rw + g, row1 = row0 + 8;
  if (kLse && t4 == 0) {
    // m_run and l0/l1 are in log2 units of the scaled logits
    constexpr float kLn2 = 0.6931471805599453f;
    float* lrow = lse + (long long)(b * heads + h) * sq;
#ifdef UNIRENDER_INDEX_CHECK
    const long long lse_ext = (long long)batch * heads * sq;
    if (row0 < sq) {
      UR_CHECK_INDEX(lrow + row0 - lse, lse_ext, "attention lse");
    }
    if (row1 < sq) {
      UR_CHECK_INDEX(lrow + row1 - lse, lse_ext, "attention lse");
    }
#endif
    if (row0 < sq) lrow[row0] = (m_run[0] + log2f(l0)) * kLn2;
    if (row1 < sq) lrow[row1] = (m_run[1] + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
#ifdef UNIRENDER_INDEX_CHECK
      if (row0 < sq) {
        UR_CHECK_INDEX(ob + (long long)row0 * st.o_ss + col + 1 - o, o_ext,
                       "attention O");
      }
      if (row1 < sq) {
        UR_CHECK_INDEX(ob + (long long)row1 * st.o_ss + col + 1 - o, o_ext,
                       "attention O");
      }
#endif
      if (row0 < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * st.o_ss + col) =
            out[n][0];
      }
      if (row1 < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * st.o_ss + col) =
            out[n][1];
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
