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
// Design (first, simple version: no TMA, no wgmma, no pipelining): the
// tile of flash_tile.cuh, one block of 4 warps per (b*h, 64-row query
// tile), (batch, head) pairs batch-major; Q is scaled by
// softmax_scale * log2(e) while it is staged (as the TPU's K3 does), so the
// softmax uses exp2 directly.  No logsumexp is saved: backward comes with
// the training slice.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include "flash_tile.cuh"

namespace {

using attn::bf16;

template <int DP>
__global__ void __launch_bounds__(attn::kTileThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int batch,
                 int heads, int sq, int sk, int d, attn::Strides st,
                 float qscale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn::flash_tile<DP, false>(smem_raw, q, k, v, o, batch, heads, sq, sk, d,
                              st, qscale);
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
           int heads, int sq, int sk, int d, const attn::Strides& st,
           cudaStream_t stream) {
  constexpr int smem = attn::flash_tile_smem_bytes<DP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const float qscale = 1.4426950408889634f / sqrtf((float)d);
  const dim3 grid((sq + attn::kTileM - 1) / attn::kTileM, batch * heads);
  flash_fwd_kernel<DP><<<grid, attn::kTileThreads, smem, stream>>>(
      q, k, v, o, batch, heads, sq, sk, d, st, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all bf16 with a
// unit stride on D.  strides: 12 element strides, (batch, seq, head) for
// q, k, v, o in that order; each a multiple of 8, pointers 16-byte aligned.
int flash_attn_forward(const void* q, const void* k, const void* v, void* o,
                       int batch, int heads, int sq, int sk, int d,
                       const long long* strides, void* stream) {
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
  switch ((d + 15) / 16) {
    case 1: return launch<16>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 2: return launch<32>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 3: return launch<48>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 4: return launch<64>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 5: return launch<80>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 6: return launch<96>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 7: return launch<112>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 8: return launch<128>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 9: return launch<144>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    case 10: return launch<160>(qp, kp, vp, op, batch, heads, sq, sk, d, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
