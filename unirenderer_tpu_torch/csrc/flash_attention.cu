// K2: non-causal flash attention, forward, bf16 in / bf16 out.
//
// Replaces: unirenderer_tpu/ops/flash_attention.py `tpu_flash_attention`
// (the JAX library's Pallas TPU flash kernel with `_block_sizes`), and also
// serves the shapes the TPU left to XLA (`dmajor_attention` for the
// cross-attention with 77 keys, `dot_product_attention` for D=160), so every
// `Attention` call of the UNet and the attribute encoder runs here.
//
// What bounds it on an H100: tensor-core operations.  Self-attention at the
// flagship's 64^2 level (S=4096, D=40) does 4*S*S*D flops per (batch, head)
// against 4*S*D*2 bytes of traffic, ~1000 flop/byte, far above the card's
// ~295 flop/byte ridge.  The score matrix is never written to memory.
//
// Design (first, simple version: no TMA, no wgmma, no pipelining):
//   * one block of 4 warps per (b*h, 64-row query tile); each warp owns 16
//     query rows.  q, k, v, o are read and written in the model's
//     (B, S, H, D) layout through strides: no transposes in device memory.
//   * D is zero-padded in shared memory only, to the next multiple of 16
//     (the MMA depth): 40 -> 48, 80 and 160 stay.  Any D that is a multiple
//     of 8 up to 160 works.
//   * Q is scaled by softmax_scale * log2(e) while it is staged (as the
//     TPU's K3 does), so the softmax uses exp2 directly.
//   * the loop over 64-key tiles stages K (row-major) and V (transposed) in
//     shared memory; S = Q K^T and O += P V run on the tensor cores through
//     mma.sync m16n8k16 (bf16 in, f32 accumulate); the online softmax keeps
//     its running max and sum in f32 registers, and P is re-packed from the
//     S accumulators into A fragments without a trip through memory.
//   * key columns past Sk are set to -inf, so Sk = 77 (or any length) works.
//   * no logsumexp is saved: backward comes with the training slice.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

template <int DP>
constexpr int smem_bytes() {
  return ((kBM + kBN) * (DP + 8) + DP * (kBN + 8)) * (int)sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int heads,
                 int sq, int sk, int d, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss,
                 long long o_sh, float qscale) {
  constexpr int LDQ = DP + 8;     // smem row pitch of Q and K (elements)
  constexpr int LDV = kBN + 8;    // smem row pitch of V^T
  constexpr int VPR = DP / 8;     // 16-byte vectors per padded row
  constexpr int KD = DP / 16;     // MMA k-steps over D
  constexpr int ND = DP / 8;      // 8-wide output column tiles
  constexpr int NN = kBN / 8;     // 8-wide score column tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBM * LDQ;
  bf16* sVt = sK + kBN * LDQ;

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  bf16* ob = o + b * o_sb + h * o_sh;

  // ---- stage the scaled Q tile ----
  for (int i = tid; i < kBM * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < sq && c < d) {
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * q_ss + c);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        p[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
    }
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) = val;
  }
  __syncthreads();

  const int rw = warp * 16;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* base = sQ + (rw + g) * LDQ + kk * 16 + t4 * 2;
    qf[kk][0] = ld32(base);
    qf[kk][1] = ld32(base + 8 * LDQ);
    qf[kk][2] = ld32(base + 8);
    qf[kk][3] = ld32(base + 8 * LDQ + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (sk + kBN - 1) / kBN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int i = tid; i < kBN * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < sk && c < d) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) = kv;
      const bf16* pv = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * LDV + r] = pv[j];
    }
    __syncthreads();

    // ---- S = (scaled Q) K^T, 16 x 64 per warp, log2 units ----
    float s[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = sK + (nt * 8 + g) * LDQ + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma16816(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }
    if (k0 + kBN > sk) {
#pragma unroll
      for (int nt = 0; nt < NN; ++nt) {
        const int col = k0 + nt * 8 + t4 * 2;
        if (col >= sk) { s[nt][0] = -INFINITY; s[nt][2] = -INFINITY; }
        if (col + 1 >= sk) { s[nt][1] = -INFINITY; s[nt][3] = -INFINITY; }
      }
    }

    // ---- online softmax; this thread holds rows g (0,1) and g+8 (2,3) ----
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m_run[0] - mx0);
    const float alpha1 = exp2f(m_run[1] - mx1);
    m_run[0] = mx0;
    m_run[1] = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l_run[0] = l_run[0] * alpha0 + rs0;    // partial over this thread's columns
    l_run[1] = l_run[1] * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // ---- O += P V; P's A fragments come straight from the S accumulators
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vr = sVt + (n * 8 + g) * LDV + kc * 16 + t4 * 2;
        mma16816(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // ---- normalise and write (B, S, H, D) ----
  float l0 = l_run[0], l1 = l_run[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + rw + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * o_ss + col) =
            pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
      }
      if (row1 < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * o_ss + col) =
            pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
      }
    }
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
           int heads, int sq, int sk, int d, const long long* st,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const float qscale = 1.4426950408889634f / sqrtf((float)d);
  const dim3 grid((sq + kBM - 1) / kBM, batch * heads);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, heads, sq, sk, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], qscale);
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
  if (d % 8 != 0 || d < 8 || d > 160 || sq <= 0 || sk <= 0 ||
      batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* qp = reinterpret_cast<const bf16*>(q);
  const bf16* kp = reinterpret_cast<const bf16*>(k);
  const bf16* vp = reinterpret_cast<const bf16*>(v);
  bf16* op = reinterpret_cast<bf16*>(o);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<16>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 2: return launch<32>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 3: return launch<48>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 4: return launch<64>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 5: return launch<80>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 6: return launch<96>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 7: return launch<112>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 8: return launch<128>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 9: return launch<144>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    case 10: return launch<160>(qp, kp, vp, op, batch, heads, sq, sk, d, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
