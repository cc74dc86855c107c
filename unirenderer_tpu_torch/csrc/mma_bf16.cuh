// Warp-level bf16 tensor-core helpers shared by the attention kernels
// (flash_tile.cuh for flash_attention.cu and splash_attention.cu,
// flash_attention_bwd.cu, attn_kernel.cu): mma.sync m16n8k16 with f32
// accumulation, bf16 packing, ldmatrix fragment loads and cp.async
// copies.  Plain CUDA, no PyTorch headers.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "index_check.cuh"

namespace attn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 tiles from shared memory: lanes 8i..8i+7 give the row
// addresses of tile i (16 bytes each), and register i receives tile i with
// lane l holding row l/4, columns 2(l%4) and 2(l%4)+1: an A fragment of
// mma16816 (lanes 0-15 rows 0-15 at column 0, lanes 16-31 the same rows
// at column 8), or two B fragments when the tile's rows are the n index.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Four 8x8 bf16 tiles from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of tile i, and register i receives tile i as the B
// fragment of mma16816 when the tile's rows are the k index.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 bytes global -> shared without a trip through registers; `valid`
// false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n));
}

// 4 bytes global -> shared (an f32), zero when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + rows) of a (seq, D) slice with row stride `stride` ->
// shared [rows][DP + 8] by cp.async, THREADS threads; D zero-padded to DP,
// rows at or past `limit` zero-filled.  In the index-checked build a
// caller that passes `base` (the tensor's start) and `extent` (its
// elements) has every 16-byte copy checked against them.
template <int DP, int THREADS>
__device__ __forceinline__ void cp_async_rows(bf16* dst, const bf16* src,
                                              long long stride, int r0,
                                              int rows, int limit, int d,
                                              const bf16* base = nullptr,
                                              long long extent = 0) {
  constexpr int LD = DP + 8, VPR = DP / 8;
  (void)base, (void)extent;
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool valid = r0 + r < limit && c < d;
#ifdef UNIRENDER_INDEX_CHECK
    if (base != nullptr && valid) {
      UR_CHECK_INDEX(src + (long long)(r0 + r) * stride + c + 7 - base,
                     extent, "attention rows (copy)");
    }
#endif
    cp_async16(dst + r * LD + c,
               valid ? src + (long long)(r0 + r) * stride + c : src, valid);
  }
}

// 2^x by the MUFU unit alone (ex2.approx.ftz: relative error ~2^-22, a
// result below 2^-126 flushed to zero): exp2f adds range fix-ups around the
// same instruction, and the softmax's exponentials are what bound the
// attention tiles at small D.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16x2 -> bf16(x * scale) per half, the product rounded from f32
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// softmax_scale * log2(e) = log2(e) / sqrt(D), rounded once to f32: the
// factor by which K2 and K2 bwd take their f32 scores to log2 units
inline float score_scale(int d) {
  return (float)(1.4426950408889634 / sqrt((double)d));
}

}  // namespace attn
