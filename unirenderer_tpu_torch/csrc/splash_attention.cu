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
// What it computes, as the TPU route did: the caller pre-scales Q by
// 1/sqrt(D) and rounds it to bf16 (flash_attention.py:110), so the kernel
// applies no scale of its own: softmax over the f32 scores of the rounded
// Q, then P V.  The kernel evaluates exp(x) as exp2(x * log2(e)) in f32.
//
// What bounds it on an H100: tensor-core operations, as for K2 (~1000
// flop/byte at S=4096, D=40 against the card's ~295 flop/byte ridge).
//
// Design: the tile of flash_tile.cuh, which K2 also runs (mma.sync
// m16n8k16, online exp2 softmax in f32 registers, P kept in registers, no
// pipelining yet), launched head-major: blockIdx.y = h * B + b, as the
// splash grid walks heads with the batch inside.  The library kernel's
// 2048 x 1024 blocks are a TPU VMEM size; here a block owns 64 query rows
// and walks 64-key tiles, the size that fits an SM's registers.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include "flash_tile.cuh"

namespace {

using attn::bf16;

template <int DP>
__global__ void __launch_bounds__(attn::kTileThreads)
splash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  int batch, int heads, int sq, int sk, int d,
                  attn::Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn::flash_tile<DP, true>(smem_raw, q, k, v, o, batch, heads, sq, sk, d,
                             st, 1.0f);
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
           int heads, int sq, int sk, int d, const attn::Strides& st,
           cudaStream_t stream) {
  constexpr int smem = attn::flash_tile_smem_bytes<DP>();
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
      q, k, v, o, batch, heads, sq, sk, d, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D) pre-scaled by 1/sqrt(D), k/v: (B, Sk, H, D),
// o: (B, Sq, H, D), all bf16 with a unit stride on D.  strides: 12 element
// strides, (batch, seq, head) for q, k, v, o in that order; each a
// multiple of 8, pointers 16-byte aligned.
int splash_attn_forward(const void* q, const void* k, const void* v,
                        void* o, int batch, int heads, int sq, int sk, int d,
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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
