// K2 in f32, and the f32 forms of K2s and K3: non-causal attention
// forward over f32 (B, S, H, D) tensors, f32 out.
//
// Replaces, for f32 operands:
//   * unirenderer_tpu/ops/flash_attention.py `tpu_flash_attention` (:68,
//     the JAX library's Pallas TPU flash kernel, which takes operands of
//     the input type and scales its f32 scores by `sm_scale`):
//     `flash_attn_forward_f32`, and `flash_attn_forward_lse_f32` under
//     autograd (also each row's log-sum-exp for the backward,
//     flash_attention_bwd_f32.cu);
//   * `tpu_splash_attention` (:99, Q pre-scaled by 1/sqrt(D) in q's type,
//     the scores unscaled): `splash_attn_forward_f32`;
//   * unirenderer_tpu/ops/attn_kernel.py `_kernel` (:48, via
//     `unet_flash_attention`: Q pre-scaled by softmax_scale * log2(e) in
//     q's type, exp2, optionally no running max): `unet_flash_forward_f32`.
// One kernel serves all three; they differ in three f32 factors and a
// flag: Q is staged as f32(q * qscale) (1 for K2, which leaves the bits),
// the score s = (Q' . k) * sscale, and p = exp2((s - m) * escale) with m
// the running row max (escale = log2 e: the natural exponential of K2 and
// K2s; 1: K3's exp2), or exp2(s) without the running max (K3's
// running_max = False, exact while the scaled scores stay below ~126).
// The wrapper rounds the factors to f32 as the JAX callers round them to
// q's type.  K2s walks the (batch, head) pairs head-major, as the library
// splash kernel's grid over heads does.
//
// What bounds it on an H100: f32 operations.  The tensor cores take no
// full-precision f32, so the two products (S = Q K^T, O += P V; 4 S Sk D
// flops a (batch, head)) run as FMAs on the CUDA cores, 67 TFLOP/s at
// most; at the flagship's 64^2 level (S 4096, D 40) that is ~300 flops
// per byte of q, k, v and o, far above the f32 ridge (~20 flop/byte).
// One exponential a score on the special-function unit is the other
// floor; at D = 40 it is 1.5x the FMA time.  Single-pass TF32 is out: its
// 10-bit mantissa cannot hold the f32 kernels to 2^-14 of the plain
// version, and "f32" has to mean f32.
//
// Design (simple first; making it fast is later work): a block of 256
// threads owns 64 query rows of one (batch, head); Q, then each 64-key
// tile of K and V, is staged in shared memory (f32_tile.cuh: pitch D + 4,
// rows past the extent zero); each thread computes a 4 x 4 micro-tile of
// the scores with register-blocked FMAs (16 FMAs per two 16-byte shared
// loads), masks the keys past Sk to -inf, runs the online softmax with
// its row's 16 threads (half-warp shuffles), writes its p to a 64 x 65
// score tile and accumulates O for its 4 rows and D / 16 columns.  O is
// divided by the row sum at the end.  Q, K and V are read once per block
// from device memory; nothing of the scores leaves the SM.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include "f32_tile.cuh"

namespace {

using f32t::kPPitch;
using f32t::kRows;
using f32t::kThreads;

struct Params {
  const float *q, *k, *v;
  float* o;
  float* lse;                       // (B, H, Sq) or null
  int batch, heads, sq, sk, d;
  f32t::Strides qs, ks, vs, os;
  float qscale, sscale, escale;
  int running_max, head_major;
};

// NJ = ceil(D / 16): the output columns a thread accumulates.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int ld = f32t::pitch(p.d);
  float* q_t = reinterpret_cast<float*>(smem4);
  float* k_t = q_t + kRows * ld;
  float* v_t = k_t + kRows * ld;
  float* s_t = v_t + kRows * ld;      // 64 x kPPitch
  const int bh = blockIdx.y;
  const int b = p.head_major ? bh % p.batch : bh / p.heads;
  const int h = p.head_major ? bh / p.batch : bh % p.heads;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = p.k + b * p.ks.sb + h * p.ks.sh;
  const float* vb = p.v + b * p.vs.sb + h * p.vs.sh;

  f32t::load_tile(q_t, p.q + b * p.qs.sb + h * p.qs.sh, p.qs.ss, q0, p.sq,
                  p.d, p.qscale);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = p.running_max ? -INFINITY : 0.f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < p.sk; k0 += kRows) {
    __syncthreads();                  // the last tile's reads are done
    f32t::load_tile(k_t, kb, p.ks.ss, k0, p.sk, p.d, 1.f);
    f32t::load_tile(v_t, vb, p.vs.ss, k0, p.sk, p.d, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    f32t::rows_by_rows(q_t, k_t, p.d, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < p.sk ? s[i][j] * p.sscale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      float corr = 1.f;
      if (p.running_max) {
        // every key tile holds a key, so the new max is finite
        const float m_new = fmaxf(m[i], f32t::row_max(mx));
        corr = exp2f((m[i] - m_new) * p.escale);
        m[i] = m_new;
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2f((s[i][j] - m[i]) * p.escale);
        sum += e;
        s_t[(ty * 4 + i) * kPPitch + tx + 16 * j] = e;
      }
      l[i] = l[i] * corr + f32t::row_sum(sum);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    f32t::scores_by_tile<NJ>(s_t, v_t, p.d, min(kRows, p.sk - k0), acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    const float inv = 1.f / l[i];
    float* orow = p.o + b * p.os.sb + (long long)row * p.os.ss +
                  h * p.os.sh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) orow[col] = acc[i][j] * inv;
    }
    if (p.lse != nullptr && tx == 0) {
      // natural units: the scores are natural logits when escale = log2 e
      p.lse[((long long)b * p.heads + h) * p.sq + row] = m[i] + logf(l[i]);
    }
  }
}

template <int NJ>
int launch(const Params& p, cudaStream_t stream) {
  auto smem_of = [](int d) {
    return (3 * kRows * f32t::pitch(d) + kRows * kPPitch) *
           (int)sizeof(float);
  };
  static bool attr_set = false;       // sized for the largest D of NJ
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_of(16 * NJ));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((p.sq + kRows - 1) / kRows, p.batch * p.heads);
  attn_fwd_f32_kernel<NJ><<<grid, kThreads, smem_of(p.d), stream>>>(p);
  return (int)cudaGetLastError();
}

int forward(const void* q, const void* k, const void* v, void* o,
            float* lse, int batch, int heads, int sq, int sk, int d,
            const long long* strides, float qscale, float sscale,
            float escale, int running_max, int head_major, void* stream) {
  if (!f32t::takes(batch, heads, sq, sk, d)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = reinterpret_cast<const float*>(q);
  p.k = reinterpret_cast<const float*>(k);
  p.v = reinterpret_cast<const float*>(v);
  p.o = reinterpret_cast<float*>(o);
  p.lse = lse;
  p.batch = batch;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.os = {strides[9], strides[10], strides[11]};
  p.qscale = qscale;
  p.sscale = sscale;
  p.escale = escale;
  p.running_max = running_max;
  p.head_major = head_major;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 3: return launch<3>(p, s);
    case 4: return launch<4>(p, s);
    case 5: return launch<5>(p, s);
    case 6: return launch<6>(p, s);
    case 7: return launch<7>(p, s);
    case 8: return launch<8>(p, s);
    case 9: return launch<9>(p, s);
    case 10: return launch<10>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all f32 with a
// unit stride on D.  strides: 12 element strides, (batch, seq, head) for
// q, k, v, o in that order; each a multiple of 4, pointers 16-byte
// aligned.  sscale: f32(1/sqrt(D)).  Returns a CUDA error code.
int flash_attn_forward_f32(const void* q, const void* k, const void* v,
                           void* o, int batch, int heads, int sq, int sk,
                           int d, const long long* strides, float sscale,
                           void* stream) {
  return forward(q, k, v, o, nullptr, batch, heads, sq, sk, d, strides, 1.f,
                 sscale, f32t::kLog2e, 1, 0, stream);
}

// The same, also writing lse: (B, H, Sq) f32, contiguous, the natural-log
// log-sum-exp of each row's scaled logits.
int flash_attn_forward_lse_f32(const void* q, const void* k, const void* v,
                               void* o, float* lse, int batch, int heads,
                               int sq, int sk, int d,
                               const long long* strides, float sscale,
                               void* stream) {
  return forward(q, k, v, o, lse, batch, heads, sq, sk, d, strides, 1.f,
                 sscale, f32t::kLog2e, 1, 0, stream);
}

// K2s: Q staged as f32(q * qscale), qscale = f32(1/sqrt(D)); the scores
// unscaled; head-major.
int splash_attn_forward_f32(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int sq, int sk,
                            int d, const long long* strides, float qscale,
                            void* stream) {
  return forward(q, k, v, o, nullptr, batch, heads, sq, sk, d, strides,
                 qscale, 1.f, f32t::kLog2e, 1, 1, stream);
}

// K3: Q staged as f32(q * qscale), qscale = f32(softmax_scale * log2 e);
// p = exp2(s - m), or exp2(s) without the running max.
int unet_flash_forward_f32(const void* q, const void* k, const void* v,
                           void* o, int batch, int heads, int sq, int sk,
                           int d, const long long* strides, float qscale,
                           int running_max, void* stream) {
  return forward(q, k, v, o, nullptr, batch, heads, sq, sk, d, strides,
                 qscale, 1.f, 1.f, running_max, 0, stream);
}

}  // extern "C"
