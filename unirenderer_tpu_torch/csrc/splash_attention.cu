// K2s: the splash-attention route, non-causal attention forward, bf16 in /
// bf16 out.
//
// Replaces: unirenderer_tpu/ops/flash_attention.py `tpu_splash_attention`
// (`_splash_kernel`: the JAX library's Pallas TPU splash kernel with a
// FullMask per head, blocks bq 2048 / bkv 1024, a grid over heads with
// `vmap` over the batch), which the TPU ran under UNIRENDER_ATTN=splash for
// the tileable self-attention shapes (S and Sk multiples of 128, D <= 128
// or a multiple of 128): (B, 4096, 8, 40) and (B, 1024, 8, 80) at the
// flagship widths.
//
// What it computes, as the TPU route did: Q pre-scaled by 1/sqrt(D) with
// the factor rounded to bf16 and the product rounded to bf16
// (flash_attention.py:110), no further scale: softmax over the f32 scores
// of the rounded Q, then P V.  The kernel evaluates exp(x) as
// exp2(x * log2(e)) in f32.  The pre-scale happens in the kernel, on Q's
// fragments in registers (the caller passes the rounded factor), so the
// route is one launch and reads Q once.
//
// What bounds it on an H100: tensor-core operations, as for K2 (~1000
// flop/byte at S=4096, D=40 against the card's ~295 flop/byte ridge), and
// then the softmax's exp2.
//
// Design: the tile of flash_tile.cuh, which K2 also runs (128 query rows a
// block in two warpgroups, K/V through a cp.async ring, wgmma.mma_async
// products beside an online exp2 softmax in f32 registers), launched
// head-major:
// blockIdx.y = h * B + b, as the splash grid walks heads with the batch
// inside.  The library kernel's 2048 x 1024 blocks are a TPU VMEM size;
// here a block owns 128 query rows and walks 64-key tiles, the size that
// fits an SM's registers.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include "flash_tile.cuh"

namespace {

using attn::bf16;

template <int DP>
__global__ void __launch_bounds__(attn::kTileThreads,
                                  attn::FlashTile<DP>::kMinBlocks)
splash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  int batch, int heads, int sq, int sk, int d,
                  attn::Strides st, float qscale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn::flash_tile<DP, true>(smem_raw, q, k, v, o, batch, heads, sq, sk, d,
                             st, qscale);
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
           int heads, int sq, int sk, int d, const attn::Strides& st,
           float qscale, cudaStream_t stream) {
  using T = attn::FlashTile<DP>;
  constexpr int smem = T::kSmemBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        splash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((sq + attn::kTileM - 1) / attn::kTileM, heads * batch);
  splash_fwd_kernel<DP><<<grid, attn::kTileThreads, smem, stream>>>(
      q, k, v, o, batch, heads, sq, sk, d, st, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all bf16 with a
// unit stride on D.  strides: 12 element strides, (batch, seq, head) for
// q, k, v, o in that order; each a multiple of 8, pointers 16-byte
// aligned.  qscale: 1/sqrt(D) rounded to bf16 (Q is staged as
// bf16(q * qscale)).
int splash_attn_forward(const void* q, const void* k, const void* v,
                        void* o, int batch, int heads, int sq, int sk, int d,
                        const long long* strides, float qscale,
                        void* stream) {
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
#define K2S_CASE(N, DP)                                                     \
  case N:                                                                   \
    return launch<DP>(qp, kp, vp, op, batch, heads, sq, sk, d, st, qscale,  \
                      s);
  switch ((d + 15) / 16) {
    K2S_CASE(1, 16) K2S_CASE(2, 32) K2S_CASE(3, 48) K2S_CASE(4, 64)
    K2S_CASE(5, 80) K2S_CASE(6, 96) K2S_CASE(7, 112) K2S_CASE(8, 128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2S_CASE
}

}  // extern "C"
