// What the f32 attention kernels share (flash_attention_f32.cu,
// flash_attention_bwd_f32.cu): 64-row tiles of (B, S, H, D) f32 tensors
// staged in shared memory through strides, and the 16 x 16 thread grid
// whose 4 x 4 micro-tiles the products use.
//
//   * A tile holds 64 rows of D values at a pitch of D + 4 floats.  D is a
//     multiple of 8, so the pitch is 4 mod 8: the 8 threads of a quarter
//     warp that read 16 bytes each from 8 consecutive rows (the micro-tile
//     column index tx + 16 j) hit 8 distinct 4-bank groups, and a row
//     still starts on 16 bytes.
//   * Rows past the tensor's extent are zero, so a ragged S or Sk needs no
//     branch in the products; the callers mask the scores and the stores.
//   * Thread t of 256 is (ty, tx) = (t / 16, t % 16).  Its micro-tile of a
//     64 x 64 product is rows ty * 4 + i and columns tx + 16 j (i, j < 4):
//     a row's 16 threads are one half warp, so a row reduction is four
//     shuffles.
//   * The products are f32 FMAs on the CUDA cores: every operand and every
//     partial sum is f32 (no TF32, no reduced-precision step).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace f32t {

constexpr int kRows = 64;          // rows of a tile (queries or keys)
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPPitch = kRows + 1; // pitch of a 64 x 64 score tile
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                   // element strides (batch, seq, head)
  long long sb, ss, sh;
};

__host__ __device__ inline int pitch(int d) { return d + 4; }

// Stage rows [r0, r0 + 64) of one (batch, head) slice into dst (pitch
// d + 4), each value times `scale` (rounded in f32; 1 leaves the bits),
// zeros past `rows`.  16-byte loads: d, the strides and the base are
// multiples of 4 floats.
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int r0,
                                          int rows, int d, float scale) {
  const int v4 = d / 4;
  const int ld = pitch(d);
  for (int idx = threadIdx.x; idx < kRows * v4; idx += kThreads) {
    const int r = idx / v4, c = (idx - r * v4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) {
      val = __ldg(reinterpret_cast<const float4*>(
          base + (long long)(r0 + r) * row_stride + c));
      val.x *= scale;
      val.y *= scale;
      val.z *= scale;
      val.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// acc[i][j] += sum over d of a[(ty*4 + i) * ld + d] * b[(tx + 16 j) * ld
// + d]: the 64 x 64 product of two staged tiles, A's rows by B's rows.
__device__ __forceinline__ void rows_by_rows(const float* a, const float* b,
                                             int d, float (&acc)[4][4]) {
  const int ld = pitch(d);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < d; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * ld + k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ld + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(x[i].x, y[j].x, s);
        s = fmaf(x[i].y, y[j].y, s);
        s = fmaf(x[i].z, y[j].z, s);
        s = fmaf(x[i].w, y[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][j] += sum over r < n of p[(ty*4 + i) * kPPitch + r] * t[r * ld +
// col_j], col_j = min(tx + 16 j, d - 1): a 64 x 64 score tile times a
// staged tile, into the micro-tile's rows and NJ columns (the columns past
// d repeat column d - 1 and are never stored).
template <int NJ>
__device__ __forceinline__ void scores_by_tile(const float* p,
                                               const float* t, int d, int n,
                                               float (&acc)[4][NJ]) {
  const int ld = pitch(d);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = min(tx + 16 * j, d - 1);
  for (int r = 0; r < n; ++r) {
    float pv[4], tv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty * 4 + i) * kPPitch + r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) tv[j] = t[r * ld + col[j]];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], tv[j], acc[i][j]);
    }
  }
}

// Sum (or max) over the 16 threads of a row (a half warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Whether the f32 kernels take a call: D a multiple of 8 up to 160, every
// extent positive, B * H within the grid's y limit.
inline bool takes(int batch, int heads, int sq, int sk, int d) {
  return d % 8 == 0 && d > 0 && d <= 160 && batch > 0 && heads > 0 &&
         sq > 0 && sk > 0 && (long long)batch * heads <= 65535;
}

}  // namespace f32t
