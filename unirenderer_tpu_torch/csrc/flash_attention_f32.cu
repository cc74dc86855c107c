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
// What bounds it on an H100: f32-accurate products.  The two products
// (S = Q K^T, O += P V) take 4 S Sk D flops a (batch, head).  On the
// CUDA cores they are f32 FMAs at 67 TFLOP/s; on the tensor cores they
// run as three TF32 passes (mma_tf32.cuh: hi/lo splits, the cross terms
// and hi hi, each product exact, the sum in f32), 495 / 3 = 165 TFLOP/s
// of products as accurate as f32's own.  One pass would be 3x faster
// again, but its 10-bit operands miss the 2^-14 gate against the plain
// version by 8-20x: "f32" has to mean f32.  At the flagship's 64^2 level
// (S 4096, D 40) the three passes bound a call at 0.26 ms; the other
// floor is one exponential a score on the special-function unit (0.064
// ms).  The bytes (q, k, v read, o written once) are 0.013 ms.
//
// Design: a warp owns 16 query rows, or 32 (two row blocks, so each K
// and V fragment it loads and splits serves two products) where D <= 40
// and the grid still fills the card twice over; a block has 1, 2 or 4
// warps (fewer where the grid would leave SMs idle: small() has 8
// (batch, head) slices of 256 queries).  Q is staged once (scaled); K and
// V come in 64-key tiles through a two-stage ring filled by cp.async, the
// next tile in flight while the current one's products run.  Per tile a
// warp takes S = Q K^T as 3-pass m16n8k8 products (16 x 64 scores a row
// block in registers), runs the online softmax in the accumulator layout
// (a row's max and sum over its quad of lanes, exp2 as above), and adds
// P V, P taken straight from the score registers (mma_tf32.cuh's
// permuted k), each tile's P V summed apart and added to O in f32.  Only
// a ragged last tile masks keys past Sk to -inf and skips its 8-key steps
// past Sk; a full tile takes no branch.  Every fragment load is free of
// bank conflicts at pitch D + 4.  O is divided by the row sum at the end.
// Q, K and V are read once per block from device memory; nothing of the
// scores leaves the SM.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include "mma_tf32.cuh"

namespace {

constexpr int kKeys = 64;             // keys a tile

struct Params {
  const float *q, *k, *v;
  float* o;
  float* lse;                       // (B, H, Sq) or null
  int batch, heads, sq, sk, d;
  tf32::Strides qs, ks, vs, os;
  float qscale, sscale, escale;
  int running_max, head_major;
};

// A warp's running state: per row block mr, rows g and g + 8 ([r]).
template <int NT, int MR>
struct Rows {
  float m[MR][2], l[MR][2], acc[MR][NT][4];
};

// One key tile [k0, k0 + kKeys): S = Q K^T, the online softmax, O = O corr
// + P V.  kRagged: the tile runs past Sk, so its keys past Sk are masked
// and its 8-key steps past Sk skipped.
template <int NT, int MR, bool kRagged>
__device__ __forceinline__ void key_tile(Rows<NT, MR>& st, const Params& p,
                                         const float* qw, const float* k_t,
                                         const float* v_t, int k0) {
  constexpr int LD = tf32::pitch(8 * NT), NS = kKeys / 8;
  constexpr int NC = tf32::col_chunk(NT, MR);
  const int t = threadIdx.x & 3;
  const int live = kRagged ? min(NS, (p.sk - k0 + 7) / 8) : NS;
  float s[MR][NS][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mr][n][e] = 0.f;
    }
  }
  tf32::rows_times_rows<MR, NS, NT, kRagged>(s, qw, k_t, LD, live);
  // scale, and mask the keys past Sk: element e of s[mr][n] is row e / 2
  // of the block, key n*8 + 2t + e%2
  float corr[MR][2];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mr][n][e] *= p.sscale;
        if (kRagged && k0 + n * 8 + 2 * t + (e & 1) >= p.sk) {
          s[mr][n][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[mr][n][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[mr][r] = 1.f;
      if (p.running_max) {
        // every key tile holds a key, so the new max is finite
        const float m_new = fmaxf(st.m[mr][r], tf32::quad_max(mx[r]));
        corr[mr][r] = exp2f((st.m[mr][r] - m_new) * p.escale);
        st.m[mr][r] = m_new;
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mr][n][e] = exp2f((s[mr][n][e] - st.m[mr][e >> 1]) * p.escale);
        sum[e >> 1] += s[mr][n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.l[mr][r] = st.l[mr][r] * corr[mr][r] + sum[r];   // the lane's part
    }
  }
  // O = O corr + P V, P from the score registers
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += NC) {
    float pv[MR][NC][4];
    tf32::acc_times_cols<MR, NS, NC, kRagged>(pv, s, v_t + c0 * 8, LD, live);
#pragma unroll
    for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& o = st.acc[mr][c0 + n][e];
          o = fmaf(o, corr[mr][e >> 1], pv[mr][n][e]);
        }
      }
    }
  }
}

// NT: 8-column steps of the padded width DP (D <= DP, zeros past D); MR:
// blocks of 16 query rows a warp.
template <int NT, int MR>
__global__ void __launch_bounds__(32 * tf32::kMaxWarps, 1)
attn_fwd_f32_kernel(Params p) {
  constexpr int DP = 8 * NT, LD = tf32::pitch(DP);
  extern __shared__ float4 smem4[];
  const int rows = blockDim.x / 2 * MR;   // 16 MR a warp
  float* q_t = reinterpret_cast<float*>(smem4);
  float* ring = q_t + rows * LD;      // 2 stages x (K, V) x kKeys x LD
  const int bh = blockIdx.y;
  const int b = p.head_major ? bh % p.batch : bh / p.heads;
  const int h = p.head_major ? bh / p.batch : bh % p.heads;
  const int q0 = blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* kb = p.k + b * p.ks.sb + h * p.ks.sh;
  const float* vb = p.v + b * p.vs.sb + h * p.vs.sh;
  const int tiles = (p.sk + kKeys - 1) / kKeys;

  auto stage = [&](int j) {
    float* s = ring + (j & 1) * 2 * kKeys * LD;
    const int n = tf32::live_rows(j * kKeys, kKeys, p.sk);
    tf32::cp_async_tile<DP>(s, kb, p.ks.ss, j * kKeys, n, p.sk, p.d);
    tf32::cp_async_tile<DP>(s + kKeys * LD, vb, p.vs.ss, j * kKeys, n, p.sk,
                            p.d);
  };
  stage(0);
  attn::cp_async_commit();
  tf32::load_tile_scaled<DP>(q_t, p.q + b * p.qs.sb + h * p.qs.sh, p.qs.ss,
                             q0, rows, p.sq, p.d, p.qscale);
  const float* qw = q_t + warp * 16 * MR * LD;

  Rows<NT, MR> st;
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.m[mr][r] = p.running_max ? -INFINITY : 0.f;
      st.l[mr][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[mr][n][e] = 0.f;
    }
  }
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) stage(j + 1);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();         // tile j has landed
    __syncthreads();
    const float* k_t = ring + (j & 1) * 2 * kKeys * LD;
    const float* v_t = k_t + kKeys * LD;
    if ((j + 1) * kKeys <= p.sk) {
      key_tile<NT, MR, false>(st, p, qw, k_t, v_t, j * kKeys);
    } else {
      key_tile<NT, MR, true>(st, p, qw, k_t, v_t, j * kKeys);
    }
    __syncthreads();                  // the stage is free for tile j + 2
  }
  attn::cp_async_wait<0>();
  const int t = lane & 3;
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + (warp * MR + mr) * 16 + (lane >> 2) + 8 * r;
      const float lsum = tf32::quad_sum(st.l[mr][r]);
      if (row >= p.sq) continue;
      const float inv = 1.f / lsum;
      float* orow = p.o + b * p.os.sb + (long long)row * p.os.ss +
                    h * p.os.sh;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.d) {
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(st.acc[mr][n][2 * r] * inv,
                          st.acc[mr][n][2 * r + 1] * inv);
        }
      }
      if (p.lse != nullptr && t == 0) {
        // natural units: the scores are natural logits when escale = log2 e
        p.lse[((long long)b * p.heads + h) * p.sq + row] =
            st.m[mr][r] + logf(lsum);
      }
    }
  }
}

template <int NT, int MR>
int launch_with(const Params& p, int warps, cudaStream_t stream) {
  auto smem_of = [](int warps) {
    return (16 * MR * warps + 4 * kKeys) * tf32::pitch(8 * NT) *
           (int)sizeof(float);
  };
  static bool attr_set = false;       // sized for the largest block
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_f32_kernel<NT, MR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_of(tf32::kMaxWarps));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = 16 * MR * warps;
  const dim3 grid((p.sq + rows - 1) / rows, p.batch * p.heads);
  attn_fwd_f32_kernel<NT, MR>
      <<<grid, 32 * warps, smem_of(warps), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NT>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int M2 = NT <= tf32::kMaxNT2 ? 2 : 1;
  const tf32::Blocking bl =
      tf32::blocking(NT, p.sq, p.sk, kKeys, (long long)p.batch * p.heads);
  return bl.mr == 2 ? launch_with<NT, M2>(p, bl.warps, stream)
                    : launch_with<NT, 1>(p, bl.warps, stream);
}

int forward(const void* q, const void* k, const void* v, void* o,
            float* lse, int batch, int heads, int sq, int sk, int d,
            const long long* strides, float qscale, float sscale,
            float escale, int running_max, int head_major, void* stream) {
  if (!tf32::takes(batch, heads, sq, sk, d)) {
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
  switch (tf32::padded_steps(d)) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 3: return launch<3>(p, s);
    case 4: return launch<4>(p, s);
    case 5: return launch<5>(p, s);
    case 6: return launch<6>(p, s);
    case 8: return launch<8>(p, s);
    case 10: return launch<10>(p, s);
    case 12: return launch<12>(p, s);
    case 16: return launch<16>(p, s);
    case 20: return launch<20>(p, s);
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
                 sscale, tf32::kLog2e, 1, 0, stream);
}

// The same, also writing lse: (B, H, Sq) f32, contiguous, the natural-log
// log-sum-exp of each row's scaled logits.
int flash_attn_forward_lse_f32(const void* q, const void* k, const void* v,
                               void* o, float* lse, int batch, int heads,
                               int sq, int sk, int d,
                               const long long* strides, float sscale,
                               void* stream) {
  return forward(q, k, v, o, lse, batch, heads, sq, sk, d, strides, 1.f,
                 sscale, tf32::kLog2e, 1, 0, stream);
}

// K2s: Q staged as f32(q * qscale), qscale = f32(1/sqrt(D)); the scores
// unscaled; head-major.
int splash_attn_forward_f32(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int sq, int sk,
                            int d, const long long* strides, float qscale,
                            void* stream) {
  return forward(q, k, v, o, nullptr, batch, heads, sq, sk, d, strides,
                 qscale, 1.f, tf32::kLog2e, 1, 1, stream);
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
