// K2: non-causal flash attention, forward, bf16 in / bf16 out.
//
// Replaces: unirenderer_tpu/ops/flash_attention.py `tpu_flash_attention`
// (the JAX library's Pallas TPU flash kernel with `_block_sizes`), and also
// serves the shapes the TPU left to XLA (`dmajor_attention` for the
// cross-attention with 77 keys, `dot_product_attention` for D=160), so every
// `Attention` call of the UNet and the attribute encoder/decoder runs here
// under the default attention route.
//
// What bounds it on an H100: tensor-core operations.  Self-attention at the
// flagship's 64^2 level (S=4096, D=40) does 4*S*S*D flops per (batch, head)
// against 4*S*D*2 bytes of traffic, ~1000 flop/byte, far above the card's
// ~295 flop/byte ridge.  The score matrix is never written to memory.
//
// Design: the tile of flash_tile.cuh (128 query rows a block in two
// warpgroups, K/V through a 4-stage cp.async ring in wgmma's core-matrix
// layout, wgmma.mma_async for S = Q K^T and O += P V with the softmax of a
// tile overlapping the P V of the one before), (batch, head) pairs
// batch-major; Q is staged as bf16(q * softmax_scale * log2(e)) (as the
// TPU's K3 does), so the softmax uses exp2 directly.  Under autograd the
// wrapper calls `flash_attn_forward_lse`, the same kernel with the tile's
// kLse flag, which also writes each row's log-sum-exp (f32, (B, H, Sq))
// for the backward (flash_attention_bwd.cu); `flash_attn_forward`
// (serving) writes none and computes the same O.
//
// What the tile does about its bound: each K/V tile is fetched once per
// 128 rows and read by the tensor cores once per 64 (a warpgroup); the
// products run asynchronously beside the softmax.  At D = 40 the products
// need ~190 flops a score against one exp2 (MUFU, 16 a clock per SM) and
// ~6 FP32 instructions, so the exponentials, not the tensor cores, set the
// pace; the tile still runs at ~3x the MUFU time (latency between the
// dependent steps of a tile), which is what holds it back now.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include "flash_tile.cuh"

namespace {

using attn::bf16;

template <int DP, bool kLse>
__global__ void __launch_bounds__(attn::kTileThreads,
                                  attn::FlashTile<DP>::kMinBlocks)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int batch,
                 int heads, int sq, int sk, int d, attn::Strides st,
                 float qscale, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn::flash_tile<DP, false, kLse>(smem_raw, q, k, v, o, batch, heads, sq,
                                    sk, d, st, qscale, lse);
}

template <int DP, bool kLse>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
           int heads, int sq, int sk, int d, const attn::Strides& st,
           float* lse, cudaStream_t stream) {
  using T = attn::FlashTile<DP>;
  constexpr int smem = T::kSmemBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const float qscale = 1.4426950408889634f / sqrtf((float)d);
  const dim3 grid((sq + attn::kTileM - 1) / attn::kTileM, batch * heads);
  flash_fwd_kernel<DP, kLse><<<grid, attn::kTileThreads, smem, stream>>>(
      q, k, v, o, batch, heads, sq, sk, d, st, qscale, lse);
  return (int)cudaGetLastError();
}

template <bool kLse>
int forward(const void* q, const void* k, const void* v, void* o, int batch,
            int heads, int sq, int sk, int d, const long long* strides,
            float* lse, void* stream) {
  if (!attn::flash_tile_takes(batch, heads, sq, sk, d)) {
    return (int)cudaErrorInvalidValue;
  }
  const attn::Strides st = {strides[0], strides[1], strides[2], strides[3],
                            strides[4], strides[5], strides[6], strides[7],
                            strides[8], strides[9], strides[10], strides[11]};
  const bf16* qp = reinterpret_cast<const bf16*>(q);
  const bf16* kp = reinterpret_cast<const bf16*>(k);
  const bf16* vp = reinterpret_cast<const bf16*>(v);
  bf16* op = reinterpret_cast<bf16*>(o);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define K2_CASE(N, DP)                                                      \
  case N:                                                                   \
    return launch<DP, kLse>(qp, kp, vp, op, batch, heads, sq, sk, d, st,   \
                            lse, s);
  switch ((d + 15) / 16) {
    K2_CASE(1, 16) K2_CASE(2, 32) K2_CASE(3, 48) K2_CASE(4, 64)
    K2_CASE(5, 80) K2_CASE(6, 96) K2_CASE(7, 112) K2_CASE(8, 128)
    K2_CASE(9, 144) K2_CASE(10, 160)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2_CASE
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all bf16 with a
// unit stride on D.  strides: 12 element strides, (batch, seq, head) for
// q, k, v, o in that order; each a multiple of 8, pointers 16-byte aligned.
int flash_attn_forward(const void* q, const void* k, const void* v, void* o,
                       int batch, int heads, int sq, int sk, int d,
                       const long long* strides, void* stream) {
  return forward<false>(q, k, v, o, batch, heads, sq, sk, d, strides,
                        nullptr, stream);
}

// The same, also writing lse: (B, H, Sq) f32, contiguous, the natural-log
// log-sum-exp of each row's scaled logits.
int flash_attn_forward_lse(const void* q, const void* k, const void* v,
                           void* o, float* lse, int batch, int heads, int sq,
                           int sk, int d, const long long* strides,
                           void* stream) {
  return forward<true>(q, k, v, o, batch, heads, sq, sk, d, strides, lse,
                       stream);
}

}  // extern "C"
