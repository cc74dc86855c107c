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
// What bounds it on an H100: f32-accurate products.  The five products
// take 10 S Sk D flops a (batch, head).  As f32 FMAs on the CUDA cores
// they run at 67 TFLOP/s; as three TF32 passes on the tensor cores
// (mma_tf32.cuh: hi/lo splits, each product exact, the sums in f32) at
// 495 / 3 = 165 TFLOP/s, as accurate as f32, where one pass misses the
// 2^-12 gate against the plain backward.  At the flagship's 64^2 level
// (S 4096, D 40) that bounds a call at 0.65 ms; this design's 7 products
// put its own floor at 0.91 ms.
//
// Design: two launches, no atomics, so a rerun gives the same bits.
//   1. dQ, query-major: a warp owns 16 query rows (32 where D <= 40 and
//      the grid fills the card twice over, as K2 f32's), a block 1, 2 or
//      4 warps.  Q, dO and O are staged once, Delta of the block's rows
//      computed (and written out for launch 2) with L beside it; K and V
//      stream through a two-stage cp.async ring.  Per key tile a warp
//      takes S = Q K^T and dP = dO V^T as 3-pass m16n8k8 products, P and
//      dS in the accumulator registers, then dQ += dS K with dS straight
//      from those registers (mma_tf32.cuh's permuted k).
//   2. dK and dV, key-major: a warp owns 16 (or 32) keys; K and V are
//      staged once; Q, dO, L and Delta stream through the ring.  Per query
//      tile S^T = K Q^T and dP^T = V dO^T (keys by queries, so nothing is
//      stored transposed), P^T and dS^T in registers, dV += P^T dO, dK +=
//      dS^T Q.  Above D = 80 the grid's z splits dK's and dV's columns in
//      two, so the four accumulators stay in registers (S^T and dP^T are
//      taken once a half).
// Each tile's dQ, dK and dV products are summed apart and added to the
// running sums in f32.  Launch 1's ragged last key tile masks its keys
// past Sk and skips its 8-key steps past it; launch 2's ragged query tile
// needs neither (its queries past Sq add zeros).  Launch 2 recomputes S
// and dP, 7 products in all against the 5 the gradients need: the price
// of keeping dQ's sums out of atomics.  At one row block a warp and
// D <= 64 the streamed tiles are 64 keys or queries; else 32, so the
// registers and shared memory hold them.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing
// (the caller passes Delta's workspace), launches on the caller's stream
// and returns cudaGetLastError().

#include "mma_tf32.cuh"

namespace {

struct Params {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *delta;        // delta: (B, H, Sq) workspace
  int batch, heads, sq, sk, d;
  tf32::Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float sm_scale;
};

template <typename T>
__device__ __forceinline__ T* slice(T* t, const tf32::Strides& s, int b,
                                   int h) {
  return t + b * s.sb + h * s.sh;
}

// the streamed tile: 64 rows up to DP = 64 at one row block a warp, 32
// above or at two, so shared memory and the registers hold them
template <int NT, int MR>
__host__ __device__ constexpr int tile_rows() {
  return NT <= 8 && MR == 1 ? 64 : 32;
}

// output column chunks of launch 2 (grid z) and their 8-column steps
template <int NT>
__host__ __device__ constexpr int chunks() {
  return (NT + 9) / 10;
}

template <int NT>
__host__ __device__ constexpr int chunk_steps() {
  return NT / chunks<NT>();
}

// ---- 1. Delta and dQ

// One key tile [k0, k0 + KT): S = Q K^T, dP = dO V^T, dS = P (dP - Delta),
// dQ += dS K.  kRagged: the tile runs past Sk (its keys past Sk masked,
// its 8-key steps past Sk skipped).  Query rows past Sq need no mask:
// their Q, dO, L and Delta are zero, so their dS is, and they are not
// stored.
template <int NT, int MR, bool kRagged>
__device__ __forceinline__ void dq_tile(float (&acc)[MR][NT][4],
                                        const Params& p, const float* qw,
                                        const float* dow, const float* k_t,
                                        const float* v_t, const float* l_w,
                                        const float* dl_w, int k0) {
  constexpr int LD = tf32::pitch(8 * NT), KT = tile_rows<NT, MR>();
  constexpr int NS = KT / 8, NC = tf32::col_chunk(NT, MR);
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int live = kRagged ? min(NS, (p.sk - k0 + 7) / 8) : NS;
  float s[MR][NS][4], dp[MR][NS][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mr][n][e] = dp[mr][n][e] = 0.f;
    }
  }
  tf32::rows_times_rows<MR, NS, NT, kRagged>(s, qw, k_t, LD, live);
  tf32::rows_times_rows<MR, NS, NT, kRagged>(dp, dow, v_t, LD, live);
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mr * 16 + g + 8 * (e >> 1);
      const float lv = l_w[r], dl = dl_w[r];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bool on = !kRagged || k0 + n * 8 + 2 * t + (e & 1) < p.sk;
        const float pr =
            on ? exp2f((s[mr][n][e] * p.sm_scale - lv) * tf32::kLog2e)
               : 0.f;
        s[mr][n][e] = pr * (dp[mr][n][e] - dl);     // dS
      }
    }
  }
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += NC) {
    float part[MR][NC][4];
    tf32::acc_times_cols<MR, NS, NC, kRagged>(part, s, k_t + c0 * 8, LD,
                                              live);
#pragma unroll
    for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mr][c0 + n][e] += part[mr][n][e];
      }
    }
  }
}

template <int NT, int MR>
__global__ void __launch_bounds__(32 * tf32::kMaxWarps, 1)
attn_bwd_dq_f32_kernel(Params p) {
  constexpr int DP = 8 * NT, LD = tf32::pitch(DP), KT = tile_rows<NT, MR>();
  extern __shared__ float4 smem4[];
  const int rows = blockDim.x / 2 * MR;
  float* q_t = reinterpret_cast<float*>(smem4);
  float* do_t = q_t + rows * LD;
  float* o_t = do_t + rows * LD;
  float* ring = o_t + rows * LD;      // 2 stages x (K, V) x KT x LD
  float* l_t = ring + 4 * KT * LD;
  float* dl_t = l_t + rows;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const long long row_base = ((long long)b * p.heads + h) * p.sq;
  const float* kb = slice(p.k, p.ks, b, h);
  const float* vb = slice(p.v, p.vs, b, h);
  const int tiles = (p.sk + KT - 1) / KT;

  auto stage = [&](int j) {
    float* s = ring + (j & 1) * 2 * KT * LD;
    const int n = tf32::live_rows(j * KT, KT, p.sk);
    tf32::cp_async_tile<DP>(s, kb, p.ks.ss, j * KT, n, p.sk, p.d);
    tf32::cp_async_tile<DP>(s + KT * LD, vb, p.vs.ss, j * KT, n, p.sk, p.d);
  };
  tf32::cp_async_tile<DP>(q_t, slice(p.q, p.qs, b, h), p.qs.ss, q0, rows,
                          p.sq, p.d);
  tf32::cp_async_tile<DP>(do_t, slice(p.dout, p.dos, b, h), p.dos.ss, q0,
                          rows, p.sq, p.d);
  tf32::cp_async_tile<DP>(o_t, slice(p.o, p.os, b, h), p.os.ss, q0, rows,
                          p.sq, p.d);
  attn::cp_async_commit();
  stage(0);
  attn::cp_async_commit();
  attn::cp_async_wait<1>();           // Q, dO and O; the first tile in flight
  __syncthreads();
  // Delta = rowsum(dO * O) of the warp's rows, a quad of lanes across D
  // for 8 rows a pass, and L beside it (zero past Sq); the warp's tiles
  // read only its own rows
  const int w0 = warp * 16 * MR;      // the warp's first row in the block
  for (int r8 = w0; r8 < w0 + 16 * MR; r8 += 8) {
    const int r = r8 + (lane >> 2), row = q0 + r;
    float dl = 0.f;
    for (int c = lane & 3; c < p.d; c += 4) {
      dl = fmaf(do_t[r * LD + c], o_t[r * LD + c], dl);
    }
    dl = tf32::quad_sum(dl);
    if ((lane & 3) == 0) {
      dl_t[r] = dl;
      l_t[r] = row < p.sq ? p.lse[row_base + row] : 0.f;
      if (row < p.sq) p.delta[row_base + row] = dl;
    }
  }
  float acc[MR][NT][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mr][n][e] = 0.f;
    }
  }
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) stage(j + 1);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();
    __syncthreads();
    const float* k_t = ring + (j & 1) * 2 * KT * LD;
    const float* v_t = k_t + KT * LD;
    if ((j + 1) * KT <= p.sk) {
      dq_tile<NT, MR, false>(acc, p, q_t + w0 * LD, do_t + w0 * LD, k_t,
                             v_t, l_t + w0, dl_t + w0, j * KT);
    } else {
      dq_tile<NT, MR, true>(acc, p, q_t + w0 * LD, do_t + w0 * LD, k_t,
                            v_t, l_t + w0, dl_t + w0, j * KT);
    }
    __syncthreads();
  }
  attn::cp_async_wait<0>();
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + w0 + mr * 16 + (lane >> 2) + 8 * r;
      if (row >= p.sq) continue;
      float* out = slice(p.dq, p.dqs, b, h) + (long long)row * p.dqs.ss;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.d) {
          *reinterpret_cast<float2*>(out + col) =
              make_float2(acc[mr][n][2 * r] * p.sm_scale,
                          acc[mr][n][2 * r + 1] * p.sm_scale);
        }
      }
    }
  }
}

// ---- 2. dK and dV, chunk blockIdx.z of the columns

// One query tile of QT: S^T = K Q^T, dP^T = V dO^T, P^T, dS^T,
// dV += P^T dO, dK += dS^T Q over the chunk's columns from c0.  A ragged
// tile needs no mask: its queries past Sq have zero Q, dO, L and Delta,
// so their P^T is 1 and dO, dS^T and Q are zero there, and they add
// nothing.  Keys past Sk are not stored.
template <int NT, int MR>
__device__ __forceinline__ void dkdv_tile(
    float (&dk)[MR][chunk_steps<NT>()][4],
    float (&dv)[MR][chunk_steps<NT>()][4], const Params& p, const float* kw,
    const float* vw, const float* q_t, const float* do_t, const float* l_t,
    const float* dl_t, int c0) {
  constexpr int LD = tf32::pitch(8 * NT), QT = tile_rows<NT, MR>();
  constexpr int NS = QT / 8, NC = chunk_steps<NT>();
  const int t = threadIdx.x & 3;
  // keys (the warp's 16 MR) by queries (the tile's QT)
  float st[MR][NS][4], dpt[MR][NS][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[mr][n][e] = dpt[mr][n][e] = 0.f;
    }
  }
  tf32::rows_times_rows<MR, NS, NT, false>(st, kw, q_t, LD, NS);
  tf32::rows_times_rows<MR, NS, NT, false>(dpt, vw, do_t, LD, NS);
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + 2 * t + (e & 1);
      const float lv = l_t[c], dl = dl_t[c];
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        const float pr =
            exp2f((st[mr][n][e] * p.sm_scale - lv) * tf32::kLog2e);
        st[mr][n][e] = pr;                               // P^T
        dpt[mr][n][e] = pr * (dpt[mr][n][e] - dl);       // dS^T
      }
    }
  }
  float part[MR][NC][4];
  tf32::acc_times_cols<MR, NS, NC, false>(part, st, do_t + c0, LD, NS);
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[mr][n][e] += part[mr][n][e];
    }
  }
  tf32::acc_times_cols<MR, NS, NC, false>(part, dpt, q_t + c0, LD, NS);
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mr][n][e] += part[mr][n][e];
    }
  }
}

template <int NT, int MR>
__global__ void __launch_bounds__(32 * tf32::kMaxWarps, 1)
attn_bwd_dkdv_f32_kernel(Params p) {
  constexpr int DP = 8 * NT, LD = tf32::pitch(DP), QT = tile_rows<NT, MR>();
  constexpr int NC = chunk_steps<NT>();
  extern __shared__ float4 smem4[];
  const int rows = blockDim.x / 2 * MR;
  float* k_t = reinterpret_cast<float*>(smem4);
  float* v_t = k_t + rows * LD;
  float* ring = v_t + rows * LD;      // 2 stages x (Q, dO) x QT x LD
  float* vec = ring + 4 * QT * LD;    // 2 stages x (L, Delta) x QT
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * rows;
  const int c0 = blockIdx.z * NC * 8;  // the chunk's first column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const long long row_base = ((long long)b * p.heads + h) * p.sq;
  const float* qb = slice(p.q, p.qs, b, h);
  const float* dob = slice(p.dout, p.dos, b, h);
  const int tiles = (p.sq + QT - 1) / QT;

  auto stage = [&](int j) {
    float* s = ring + (j & 1) * 2 * QT * LD;
    float* sv = vec + (j & 1) * 2 * QT;
    tf32::cp_async_tile<DP>(s, qb, p.qs.ss, j * QT, QT, p.sq, p.d);
    tf32::cp_async_tile<DP>(s + QT * LD, dob, p.dos.ss, j * QT, QT, p.sq,
                            p.d);
    tf32::cp_async_vec(sv, p.lse + row_base, j * QT, QT, p.sq);
    tf32::cp_async_vec(sv + QT, p.delta + row_base, j * QT, QT, p.sq);
  };
  tf32::cp_async_tile<DP>(k_t, slice(p.k, p.ks, b, h), p.ks.ss, k0, rows,
                          p.sk, p.d);
  tf32::cp_async_tile<DP>(v_t, slice(p.v, p.vs, b, h), p.vs.ss, k0, rows,
                          p.sk, p.d);
  stage(0);
  attn::cp_async_commit();
  const int w0 = warp * 16 * MR;
  float dk[MR][NC][4], dv[MR][NC][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mr][n][e] = dv[mr][n][e] = 0.f;
    }
  }
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) stage(j + 1);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();
    __syncthreads();
    const float* q_t = ring + (j & 1) * 2 * QT * LD;
    const float* l_t = vec + (j & 1) * 2 * QT;
    dkdv_tile<NT, MR>(dk, dv, p, k_t + w0 * LD, v_t + w0 * LD, q_t,
                      q_t + QT * LD, l_t, l_t + QT, c0);
    __syncthreads();
  }
  attn::cp_async_wait<0>();
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + w0 + mr * 16 + (lane >> 2) + 8 * r;
      if (key >= p.sk) continue;
      float* dkrow = slice(p.dk, p.dks, b, h) + (long long)key * p.dks.ss;
      float* dvrow = slice(p.dv, p.dvs, b, h) + (long long)key * p.dvs.ss;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = c0 + n * 8 + 2 * t;
        if (col < p.d) {
          *reinterpret_cast<float2*>(dkrow + col) =
              make_float2(dk[mr][n][2 * r] * p.sm_scale,
                          dk[mr][n][2 * r + 1] * p.sm_scale);
          *reinterpret_cast<float2*>(dvrow + col) =
              make_float2(dv[mr][n][2 * r], dv[mr][n][2 * r + 1]);
        }
      }
    }
  }
}

template <int NT, int MR>
int dq_smem(int warps) {
  const int rows = 16 * MR * warps;
  return ((3 * rows + 4 * tile_rows<NT, MR>()) * tf32::pitch(8 * NT) +
          2 * rows) * (int)sizeof(float);
}

template <int NT, int MR>
int dkdv_smem(int warps) {
  const int rows = 16 * MR * warps, qt = tile_rows<NT, MR>();
  return ((2 * rows + 4 * qt) * tf32::pitch(8 * NT) + 4 * qt) *
         (int)sizeof(float);
}

template <int NT, int MR>
int launch_dq(const Params& p, int warps, cudaStream_t stream) {
  static bool attr_set = false;       // sized for the largest block
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dq_f32_kernel<NT, MR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        dq_smem<NT, MR>(tf32::kMaxWarps));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = 16 * MR * warps;
  attn_bwd_dq_f32_kernel<NT, MR>
      <<<dim3((p.sq + rows - 1) / rows, p.batch * p.heads), 32 * warps,
         dq_smem<NT, MR>(warps), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NT, int MR>
int launch_dkdv(const Params& p, int warps, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkdv_f32_kernel<NT, MR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        dkdv_smem<NT, MR>(tf32::kMaxWarps));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = 16 * MR * warps;
  attn_bwd_dkdv_f32_kernel<NT, MR>
      <<<dim3((p.sk + rows - 1) / rows, p.batch * p.heads, chunks<NT>()),
         32 * warps, dkdv_smem<NT, MR>(warps), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NT>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int M2 = NT <= tf32::kMaxNT2 ? 2 : 1;
  const long long bh = (long long)p.batch * p.heads;
  const tf32::Blocking bq =
      tf32::blocking(NT, p.sq, p.sk, tile_rows<NT, 1>(), bh);
  const int e = bq.mr == 2 ? launch_dq<NT, M2>(p, bq.warps, stream)
                           : launch_dq<NT, 1>(p, bq.warps, stream);
  if (e != 0) return e;
  const tf32::Blocking bk = tf32::blocking(NT, p.sk, p.sq, tile_rows<NT, 1>(),
                                           bh * chunks<NT>());
  return bk.mr == 2 ? launch_dkdv<NT, M2>(p, bk.warps, stream)
                    : launch_dkdv<NT, 1>(p, bk.warps, stream);
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
  if (!tf32::takes(batch, heads, sq, sk, d)) {
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
  tf32::Strides* all[] = {&p.qs, &p.ks, &p.vs, &p.os,
                          &p.dos, &p.dqs, &p.dks, &p.dvs};
  for (int i = 0; i < 8; ++i) {
    *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  p.sm_scale = sm_scale;
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

}  // extern "C"
