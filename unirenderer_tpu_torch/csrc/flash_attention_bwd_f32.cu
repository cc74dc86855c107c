// K2 bwd in f32: the gradients of non-causal attention over f32
// (B, S, H, D) tensors, from the forward's output O and log-sum-exp L
// (flash_attention_f32.cu `flash_attn_forward_lse_f32`).
//
// Replaces, for f32 operands: the dq and dkv kernels of the JAX library's
// Pallas TPU flash attention behind its custom VJP
// (unirenderer_tpu/ops/flash_attention.py `tpu_flash_attention` :68 under
// `jax.grad`, `_block_sizes` :39-66), which take operands of the input
// type.  The arithmetic is flash_attention_bwd.cu's, in f32 throughout:
//
//     Delta = rowsum(dO * O)          P  = exp(s * sm_scale - L)
//     dV = P^T dO                     dP = dO V^T
//     dS = P * (dP - Delta)           dQ = dS K * sm_scale
//                                     dK = dS^T Q * sm_scale
//
// with s = Q . k, sm_scale = f32(1/sqrt(D)) and exp taken as exp2 of
// (s * sm_scale - L) * log2 e.
//
// What bounds it on an H100: f32 operations.  The five products take
// 10 S Sk D flops a (batch, head); the tensor cores take no full-precision
// f32, so they are FMAs on the CUDA cores (67 TFLOP/s at most), far above
// the f32 ridge at the UNet's shapes.
//
// Design (simple first): two launches, no atomics, so a rerun gives the
// same bits.
//   1. dQ, query-major (the forward's grid: 64 query rows of one (batch,
//      head) a block of 256 threads): Delta of its rows (also written out
//      for launch 2), then over the 64-key tiles S and dP as 4 x 4
//      micro-tiles (f32_tile.cuh), dS into a 64 x 65 tile, dQ += dS K.
//   2. dK and dV, key-major: 64 keys of one (batch, head) a block, K and V
//      staged once; over the 64-query tiles the transposed S^T and dP^T as
//      micro-tiles (keys by queries, so no transpose is ever stored), P^T
//      and dS^T into 64 x 65 tiles, dV += P^T dO, dK += dS^T Q.
// Launch 2 recomputes S and dP, 7 products in all against the 5 the
// gradients need: the price of keeping dQ's sums out of atomics.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing
// (the caller passes Delta's workspace), launches on the caller's stream
// and returns cudaGetLastError().

#include "f32_tile.cuh"

namespace {

using f32t::kPPitch;
using f32t::kRows;
using f32t::kThreads;

struct Params {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *delta;        // delta: (B, H, Sq) workspace
  int batch, heads, sq, sk, d;
  f32t::Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float sm_scale;
};

template <typename T>
__device__ __forceinline__ T* slice(T* t, const f32t::Strides& s, int b,
                                   int h) {
  return t + b * s.sb + h * s.sh;
}

// ---- 1. Delta and dQ, 64 query rows a block
template <int NJ>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_f32_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int ld = f32t::pitch(p.d);
  float* q_t = reinterpret_cast<float*>(smem4);
  float* do_t = q_t + kRows * ld;
  float* k_t = do_t + kRows * ld;
  float* v_t = k_t + kRows * ld;
  float* ds_t = v_t + kRows * ld;     // 64 x kPPitch
  float* l_t = ds_t + kRows * kPPitch;
  float* dl_t = l_t + kRows;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long row_base = ((long long)b * p.heads + h) * p.sq;

  f32t::load_tile(q_t, slice(p.q, p.qs, b, h), p.qs.ss, q0, p.sq, p.d, 1.f);
  f32t::load_tile(do_t, slice(p.dout, p.dos, b, h), p.dos.ss, q0, p.sq, p.d,
                  1.f);
  __syncthreads();
  // Delta = rowsum(dO * O), in order over D; with L, per row of the tile
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x, row = q0 + r;
    float dl = 0.f, lv = 0.f;
    if (row < p.sq) {
      const float* orow = slice(p.o, p.os, b, h) + (long long)row * p.os.ss;
      for (int c = 0; c < p.d; ++c) dl = fmaf(do_t[r * ld + c], orow[c], dl);
      lv = p.lse[row_base + row];
      p.delta[row_base + row] = dl;
    }
    dl_t[r] = dl;
    l_t[r] = lv;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const float* kb = slice(p.k, p.ks, b, h);
  const float* vb = slice(p.v, p.vs, b, h);
  for (int k0 = 0; k0 < p.sk; k0 += kRows) {
    __syncthreads();
    f32t::load_tile(k_t, kb, p.ks.ss, k0, p.sk, p.d, 1.f);
    f32t::load_tile(v_t, vb, p.vs.ss, k0, p.sk, p.d, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    f32t::rows_by_rows(q_t, k_t, p.d, s);
    f32t::rows_by_rows(do_t, v_t, p.d, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = q0 + r < p.sq && k0 + tx + 16 * j < p.sk;
        const float pr =
            live ? exp2f((s[i][j] * p.sm_scale - l_t[r]) * f32t::kLog2e)
                 : 0.f;
        ds_t[r * kPPitch + tx + 16 * j] = pr * (dp[i][j] - dl_t[r]);
      }
    }
    __syncthreads();
    f32t::scores_by_tile<NJ>(ds_t, k_t, p.d, min(kRows, p.sk - k0), acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    float* out = slice(p.dq, p.dqs, b, h) + (long long)row * p.dqs.ss;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) out[col] = acc[i][j] * p.sm_scale;
    }
  }
}

// ---- 2. dK and dV, 64 keys a block
template <int NJ>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_f32_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int ld = f32t::pitch(p.d);
  float* k_t = reinterpret_cast<float*>(smem4);
  float* v_t = k_t + kRows * ld;
  float* q_t = v_t + kRows * ld;
  float* do_t = q_t + kRows * ld;
  float* p_t = do_t + kRows * ld;     // P^T, 64 keys x kPPitch
  float* ds_t = p_t + kRows * kPPitch;
  float* l_t = ds_t + kRows * kPPitch;
  float* dl_t = l_t + kRows;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long row_base = ((long long)b * p.heads + h) * p.sq;

  f32t::load_tile(k_t, slice(p.k, p.ks, b, h), p.ks.ss, k0, p.sk, p.d, 1.f);
  f32t::load_tile(v_t, slice(p.v, p.vs, b, h), p.vs.ss, k0, p.sk, p.d, 1.f);
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }
  const float* qb = slice(p.q, p.qs, b, h);
  const float* dob = slice(p.dout, p.dos, b, h);
  for (int q0 = 0; q0 < p.sq; q0 += kRows) {
    __syncthreads();
    f32t::load_tile(q_t, qb, p.qs.ss, q0, p.sq, p.d, 1.f);
    f32t::load_tile(do_t, dob, p.dos.ss, q0, p.sq, p.d, 1.f);
    if (threadIdx.x < kRows) {
      const int row = q0 + threadIdx.x;
      l_t[threadIdx.x] = row < p.sq ? p.lse[row_base + row] : 0.f;
      dl_t[threadIdx.x] = row < p.sq ? p.delta[row_base + row] : 0.f;
    }
    __syncthreads();
    // keys (ty * 4 + i) by queries (tx + 16 j)
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    }
    f32t::rows_by_rows(k_t, q_t, p.d, st);
    f32t::rows_by_rows(v_t, do_t, p.d, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool live = q0 + r < p.sq;
        const float pr =
            live ? exp2f((st[i][j] * p.sm_scale - l_t[r]) * f32t::kLog2e)
                 : 0.f;
        p_t[c * kPPitch + r] = pr;
        ds_t[c * kPPitch + r] = pr * (dpt[i][j] - dl_t[r]);
      }
    }
    __syncthreads();
    const int n = min(kRows, p.sq - q0);
    f32t::scores_by_tile<NJ>(p_t, do_t, p.d, n, dv);
    f32t::scores_by_tile<NJ>(ds_t, q_t, p.d, n, dk);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.sk) continue;
    float* dkrow = slice(p.dk, p.dks, b, h) + (long long)key * p.dks.ss;
    float* dvrow = slice(p.dv, p.dvs, b, h) + (long long)key * p.dvs.ss;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) {
        dkrow[col] = dk[i][j] * p.sm_scale;
        dvrow[col] = dv[i][j];
      }
    }
  }
}

int dq_smem(int d) {
  return (4 * kRows * f32t::pitch(d) + kRows * kPPitch + 2 * kRows) *
         (int)sizeof(float);
}

int dkdv_smem(int d) {
  return (4 * kRows * f32t::pitch(d) + 2 * kRows * kPPitch + 2 * kRows) *
         (int)sizeof(float);
}

template <int NJ>
int launch(const Params& p, cudaStream_t stream) {
  static bool attr_set = false;       // sized for the largest D of NJ
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dq_f32_kernel<NJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem(16 * NJ));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(attn_bwd_dkdv_f32_kernel<NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem(16 * NJ));
    }
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int bh = p.batch * p.heads;
  attn_bwd_dq_f32_kernel<NJ>
      <<<dim3((p.sq + kRows - 1) / kRows, bh), kThreads, dq_smem(p.d),
         stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkdv_f32_kernel<NJ>
      <<<dim3((p.sk + kRows - 1) / kRows, bh), kThreads, dkdv_smem(p.d),
         stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, H, D); all f32 with
// a unit stride on D.  lse: (B, H, Sq) f32 contiguous (the forward's);
// delta: a (B, H, Sq) f32 workspace.  strides: 24 element strides,
// (batch, seq, head) for q, k, v, o, dout, dq, dk, dv in that order, each
// a multiple of 4; pointers 16-byte aligned.  sm_scale: f32(1/sqrt(D)).
// Returns a CUDA error code, 0 on success.
int flash_attn_backward_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, void* dq, void* dk, void* dv,
                            float* delta, int batch, int heads, int sq,
                            int sk, int d, const long long* strides,
                            float sm_scale, void* stream) {
  if (!f32t::takes(batch, heads, sq, sk, d)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = reinterpret_cast<const float*>(q);
  p.k = reinterpret_cast<const float*>(k);
  p.v = reinterpret_cast<const float*>(v);
  p.o = reinterpret_cast<const float*>(o);
  p.dout = reinterpret_cast<const float*>(dout);
  p.lse = lse;
  p.dq = reinterpret_cast<float*>(dq);
  p.dk = reinterpret_cast<float*>(dk);
  p.dv = reinterpret_cast<float*>(dv);
  p.delta = delta;
  p.batch = batch;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  f32t::Strides* all[] = {&p.qs, &p.ks, &p.vs, &p.os,
                          &p.dos, &p.dqs, &p.dks, &p.dvs};
  for (int i = 0; i < 8; ++i) {
    *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  p.sm_scale = sm_scale;
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

}  // extern "C"
