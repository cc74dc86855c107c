// What the f32 attention kernels share (flash_attention_f32.cu,
// flash_attention_bwd_f32.cu): f32-accurate products on the tensor cores
// as three TF32 passes, their warp-level fragments, and the staging of
// (B, S, H, D) f32 tiles in shared memory by cp.async.
//
// Three passes.  TF32 keeps 10 of f32's 23 mantissa bits, so one pass
// rounds every operand to ~2^-11 relative: far outside the f32 kernels'
// 2^-14 of the plain version.  Each operand x is split instead into
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away, as
// cvt.rna.tf32.f32); x - hi is exact in f32 and lo keeps its next 11 bits, so
// hi + lo carries ~22 bits of x.  A product a b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b with an f32 accumulator (the two
// small cross terms first): each TF32 x TF32 product is exact in f32, and
// what is dropped, lo_a lo_b and the bits past lo, is ~2^-22 of a b:
// f32's own rounding.  Three m16n8k8 TF32 passes are 3 x 2 x 1024 flops
// at 495 TFLOP/s dense: 165 TFLOP/s of f32-accurate products, 2.5x the
// CUDA cores' 67.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, lane l = 4 g + t
// (g = l / 4 in 0..7, t = l % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product C = A T^T whose B operand is a tile T with n along its rows
// (S = Q K^T: K's rows are keys) reads b0 = T[g][t], b1 = T[g][t + 4]
// (`load_b_rows`).  A product whose B operand has k along its rows
// (O += P V: V's rows are keys) takes the k index permuted inside each
// step of 8: slot t is row 2t and slot t + 4 is row 2t + 1.  A sum over k
// does not depend on the order of its terms' slots, and then the C
// fragment of the previous product is already the A fragment of this one
// (a0 = c0, a1 = c2, a2 = c1, a3 = c3: `a_from_acc`), with no shuffle
// and nothing staged, and B reads b0 = T[2t][g], b1 = T[2t + 1][g]
// (`load_b_cols`).  So P, dS, P^T and dS^T never leave the registers,
// and no tile is ever stored transposed.
//
// Tiles.  A tile holds rows of D values zero-padded to DP = 8 NT at a
// pitch of DP + 4 floats (4 mod 8): the A and row-B fragment loads (8
// rows g, 4 columns t: bank 4 g' + t) and the column-B loads (rows 2t and
// 2t + 1, 8 columns g: bank 8 t' + g) each hit 32 distinct banks, and a
// row starts on 16 bytes for the copies.  Rows past the tensor's extent
// and columns past D are zero, so a ragged S, Sk or D needs no mask in
// the products (a zero adds nothing to an f32 sum): the kernels mask the
// scores of a ragged tile only, skip its 8-row steps wholly past the
// extent, and mask the stores.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"    // attn::cp_async16 / cp_async4 / commit / wait

namespace tf32 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxWarps = 4;       // a block: 1, 2 or 4 warps

struct Strides {                   // element strides (batch, seq, head)
  long long sb, ss, sh;
};

__host__ __device__ constexpr int pitch(int dp) { return dp + 4; }

// ---- the split and the three passes

// x rounded to TF32, round to nearest with ties away: the bits of
// cvt.rna.tf32.f32 for every finite x, in two integer operations (sm_90
// compiles the cvt to four, a NaN / infinity test among them)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// C(16x8, f32) += A(16x8, tf32, row) B(8x8, tf32, col): one pass
__device__ __forceinline__ void mma1688(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C += A B to f32 accuracy: the two cross terms, then hi hi
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  mma1688(c, a.lo, b.hi);
  mma1688(c, a.hi, b.lo);
  mma1688(c, a.hi, b.hi);
}

// ---- fragments from a staged tile (pitch ld) or from a C fragment

// A: rows 0..15 and columns 0..7 of `tile` (already offset to the warp's
// first row and the step's first column)
__device__ __forceinline__ void load_a(FragA& f, const float* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (lane >> 2) * ld + (lane & 3);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
}

// B with n along the tile's rows: B[k][n] = tile[n][k]
__device__ __forceinline__ void load_b_rows(FragB& f, const float* tile,
                                            int ld) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (lane >> 2) * ld + (lane & 3);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
}

// B with k along the tile's rows, k permuted: slot t is row 2t, slot
// t + 4 row 2t + 1 (the order `a_from_acc` gives A's columns)
__device__ __forceinline__ void load_b_cols(FragB& f, const float* tile,
                                            int ld) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + 2 * (lane & 3) * ld + (lane >> 2);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[ld], f.hi[1], f.lo[1]);
}

// A from a 16 x 8 C fragment, its columns permuted as `load_b_cols`'s k
__device__ __forceinline__ void a_from_acc(FragA& f, const float* c) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// ---- the products of a tile, MR blocks of 16 rows a warp
//
// A warp's B fragment (split once) serves its MR row blocks, so MR = 2
// halves the B operand's loads and splits per product.  A fragment array
// c[mr][n] is row block mr by 8-column step n.  kGuard: the tile is
// ragged, and its steps at or past `live` (all-zero operands past the
// tensor's extent) are skipped; a full tile takes no branch.

// c[mr][n] += A B^T: A the 16-row blocks of `a` (pitch ld, rows mr * 16),
// B^T's rows the tile `b`'s rows n * 8 .. n * 8 + 7, over NK k-steps.
// The k-steps are unrolled in full up to D = 64 and in pairs above, which
// keeps the wide instances' code (and their build) in bounds.
template <int MR, int NS, int NK, bool kGuard>
__device__ __forceinline__ void rows_times_rows(float (&c)[MR][NS][4],
                                                const float* a,
                                                const float* b, int ld,
                                                int live) {
#pragma unroll(NK <= 8 ? NK : 2)
  for (int kk = 0; kk < NK; ++kk) {
    FragA fa[MR];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr) {
      load_a(fa[mr], a + mr * 16 * ld + kk * 8, ld);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if (kGuard && n >= live) break;
      FragB fb;
      load_b_rows(fb, b + n * 8 * ld + kk * 8, ld);
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) mma3(c[mr][n], fa[mr], fb);
    }
  }
}

// out[mr][n] = sum over k-steps kk < NS of A_kk B_kk,n for n < NC, in a
// fresh accumulator: A_kk the C fragments c[mr][kk] (`a_from_acc`), B from
// `tile` (k along its rows, `load_b_cols`; offset to the first column).
// The tensor cores' f32 sums round toward zero, a bias that grows with
// the number of passes into one accumulator: the callers take each tile's
// sum here (3 NS passes) and add it to their running sums by an f32 add,
// which rounds to nearest.
template <int MR, int NS, int NC, bool kGuard>
__device__ __forceinline__ void acc_times_cols(float (&out)[MR][NC][4],
                                               const float (&c)[MR][NS][4],
                                               const float* tile, int ld,
                                               int live) {
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[mr][n][e] = 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    if (kGuard && kk >= live) break;
    FragA fa[MR];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr) a_from_acc(fa[mr], c[mr][kk]);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      FragB fb;
      load_b_cols(fb, tile + kk * 8 * ld + n * 8, ld);
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) mma3(out[mr][n], fa[mr], fb);
    }
  }
}

// Output columns a pass of `acc_times_cols` takes, so that its
// accumulators fit the registers beside the running sums: at MR = 1 all
// NT 8-column steps up to 10 and a quarter of them above; at MR = 2
// (NT <= 8) all up to 5 and half above.
__host__ __device__ constexpr int col_chunk(int nt, int mr) {
  return mr == 1 ? (nt <= 10 ? nt : nt / 4) : (nt <= 5 ? nt : nt / 2);
}

// ---- reductions over the 4 lanes (a quad) that share a C row

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---- staging

// rows [r0, r0 + n) of one (batch, head) slice -> dst (pitch DP + 4) by
// 16-byte cp.async, the block's threads together; rows at or past `limit`
// and columns at or past d zero-filled.  d, the row stride and the base
// are multiples of 4 floats.
template <int DP>
__device__ __forceinline__ void cp_async_tile(float* dst, const float* src,
                                              long long stride, int r0,
                                              int n, int limit, int d) {
  constexpr int V4 = DP / 4;
  for (int i = threadIdx.x; i < n * V4; i += blockDim.x) {
    const int r = i / V4, c = (i - r * V4) * 4;
    const bool valid = r0 + r < limit && c < d;
    attn::cp_async16(dst + r * pitch(DP) + c,
                     valid ? src + (long long)(r0 + r) * stride + c : src,
                     valid);
  }
}

// n f32 values src[r0 ..] -> dst by 4-byte cp.async, zero at or past limit
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src,
                                             int r0, int n, int limit) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool valid = r0 + i < limit;
    attn::cp_async4(dst + i, valid ? src + r0 + i : src, valid);
  }
}

// The rows of a streamed tile [r0, r0 + n) worth staging: up to the end
// of the 8-row step that holds the extent's last row.  The products skip
// the steps past it (`live`), so those rows are never read.
__device__ __forceinline__ int live_rows(int r0, int n, int limit) {
  return min(n, (limit - r0 + 7) / 8 * 8);
}

// The same rows as `cp_async_tile` through registers, each value times
// `scale` (rounded in f32; 1 leaves the bits): K2s's and K3's staged Q.
template <int DP>
__device__ __forceinline__ void load_tile_scaled(float* dst,
                                                 const float* src,
                                                 long long stride, int r0,
                                                 int n, int limit, int d,
                                                 float scale) {
  constexpr int V4 = DP / 4;
  for (int i = threadIdx.x; i < n * V4; i += blockDim.x) {
    const int r = i / V4, c = (i - r * V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit && c < d) {
      val = __ldg(reinterpret_cast<const float4*>(
          src + (long long)(r0 + r) * stride + c));
      val.x *= scale;
      val.y *= scale;
      val.z *= scale;
      val.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * pitch(DP) + c) = val;
  }
}

// ---- launch shapes

// Whether the f32 kernels take a call: D a multiple of 8 up to 160, every
// extent positive, B * H within the grid's y limit.
inline bool takes(int batch, int heads, int sq, int sk, int d) {
  return d % 8 == 0 && d > 0 && d <= 160 && batch > 0 && heads > 0 &&
         sq > 0 && sk > 0 && (long long)batch * heads <= 65535;
}

// Blocks of `rows_per_block` rows over `rows` rows of `slices` (batch,
// head) slices.
inline long long blocks(int rows, int rows_per_block, long long slices) {
  return (rows + rows_per_block - 1) / rows_per_block * slices;
}

// Warps a block (16 rows each) over `rows` rows of `slices` slices: 4,
// halved while the grid would fill fewer than two blocks an SM of an
// H100's 132, so a small call still spreads over the card.
inline int warps_for(int rows, long long slices) {
  int w = kMaxWarps;
  while (w > 1 && blocks(rows, 16 * w, slices) < 2 * 132) w /= 2;
  return w;
}

// A warp's row blocks (MR) and a block's warps over `rows` rows of
// `slices` slices at NT 8-column steps, the other operand streamed in
// tiles of `tile` rows over `streamed` rows: two row blocks and four warps
// where D <= 40 (beyond it two blocks' accumulators spill) and the grid
// still fills the card twice over.  Else one: where a single tile holds
// the streamed rows, nothing overlaps its copy, so four warps share it
// (those past the rows compute zeros); otherwise `warps_for`'s warps.
constexpr int kMaxNT2 = 5;

struct Blocking {
  int mr, warps;
};

inline Blocking blocking(int nt, int rows, int streamed, int tile,
                         long long slices) {
  if (nt <= kMaxNT2 && blocks(rows, 32 * kMaxWarps, slices) >= 2 * 132) {
    return {2, kMaxWarps};
  }
  if (streamed <= tile) return {1, kMaxWarps};
  return {1, warps_for(rows, slices)};
}

// The padded width's 8-column steps for D: one instance per listed NT.
inline int padded_steps(int d) {
  const int s = d / 8;
  return s <= 6 ? s : s <= 8 ? 8 : s <= 10 ? 10 : s <= 12 ? 12
       : s <= 16 ? 16 : 20;
}

}  // namespace tf32
