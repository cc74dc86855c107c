// K1: GroupNorm (+ optional SiLU) forward over NHWC bf16 activations.
//
// Replaces: unirenderer_tpu/ops/groupnorm.py `_kernel` (reached through
// `_fused_fwd` and `fused_groupnorm_silu`), the Pallas TPU kernel that holds
// one batch element's whole (HW, C) slice in VMEM and normalises it in one
// read and one write.
//
// What bounds it on an H100: memory.  It does a handful of flops per
// element, far below the ~295 flop/byte ridge of bf16 on this card.  The
// least it can move is one read of x and one write of y; this design reads
// x twice (statistics, then apply), so its floor is 3 x the activation
// bytes over 3.35 TB/s.
//
// Why the TPU design does not carry over: a (4096, 320) bf16 slice (2.6 MB)
// does not fit one SM's 227 KB of shared memory, and the VAE's
// (262144, 128) slice fits nowhere on chip.  So the reduction is split
// across blocks and finished in a second step:
//   1. gn_stats:    grid (row chunks, B).  Each thread walks rows of one
//                   16-byte column vector (8 channels) with a per-channel
//                   Welford update; the block merges its threads and then
//                   its channels into per-group (mean, M2) with Chan's
//                   parallel formula and writes one partial per
//                   (b, chunk, group).  No E[x^2] - mean^2 anywhere: a
//                   group holds up to a million elements at the VAE's top
//                   level, where the one-pass form loses the variance.
//   2. gn_finalize: one warp per (b, group) Chan-merges the chunk partials
//                   and writes (mean, rstd).
//   3. gn_apply:    grid (row chunks, B), 16-byte loads and stores along C
//                   (contiguous in NHWC), normalise, affine, optional SiLU,
//                   output in bf16.
// Any C that is a multiple of 8 and of G works, so C/G need not be a power
// of two (10, 20, 40, 60 at flagship widths; 4 in the VAE).
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing
// (the caller passes the workspace), launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;            // bf16 channels per 16-byte vector
constexpr int kThreads = 256;      // target threads per block

__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float meanb, float m2b) {
  if (nb == 0.f) return;
  const float nt = n + nb;
  const float d = meanb - mean;
  const float f = nb / nt;
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nt;
}

// blockDim = (V, RL): V = C / 8 column vectors, RL row lanes.
__global__ void gn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                float2* __restrict__ part, int hw, int c,
                                int groups, int rows_per_chunk,
                                int n_chunks) {
  extern __shared__ float sh[];
  const int nv = blockDim.x, rl = blockDim.y;
  const int vc = threadIdx.x, ry = threadIdx.y;
  const int nthreads = nv * rl;
  const int tid = ry * nv + vc;
  float* s_n = sh;                          // [nthreads]
  float* s_mean = s_n + nthreads;           // [nthreads * 8]
  float* s_m2 = s_mean + nthreads * kVec;   // [nthreads * 8]

  const int b = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(hw, r0 + rows_per_chunk);
  const __nv_bfloat16* xb = x + (size_t)b * hw * c + (size_t)vc * kVec;

  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) mean[i] = m2[i] = 0.f;
  for (int r = r0 + ry; r < r1; r += rl) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xb + (size_t)r * c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    n += 1.f;
    const float inv = 1.f / n;
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      float d = f.x - mean[2 * i];
      mean[2 * i] += d * inv;
      m2[2 * i] += d * (f.x - mean[2 * i]);
      d = f.y - mean[2 * i + 1];
      mean[2 * i + 1] += d * inv;
      m2[2 * i + 1] += d * (f.y - mean[2 * i + 1]);
    }
  }
  s_n[tid] = n;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s_mean[tid * kVec + i] = mean[i];
    s_m2[tid * kVec + i] = m2[i];
  }
  __syncthreads();

  // merge the row lanes of each column vector into lane 0
  if (ry == 0) {
    for (int j = 1; j < rl; ++j) {
      const int o = j * nv + vc;
      const float nb = s_n[o];
      float nn = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        nn = n;
        chan_merge(nn, mean[i], m2[i], nb, s_mean[o * kVec + i],
                   s_m2[o * kVec + i]);
      }
      n = nn;
    }
    s_n[vc] = n;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s_mean[vc * kVec + i] = mean[i];
      s_m2[vc * kVec + i] = m2[i];
    }
  }
  __syncthreads();

  // merge the channels of each group; channel ch sits at s_*[ch]
  const int cg = c / groups;
  for (int g = tid; g < groups; g += nthreads) {
    float gn = 0.f, gmean = 0.f, gm2 = 0.f;
    for (int ch = g * cg; ch < (g + 1) * cg; ++ch) {
      chan_merge(gn, gmean, gm2, s_n[ch / kVec], s_mean[ch], s_m2[ch]);
    }
    part[((size_t)b * n_chunks + chunk) * groups + g] =
        make_float2(gmean, gm2);
  }
}

// One warp per (b, group).
__global__ void gn_finalize_kernel(const float2* __restrict__ part,
                                   float2* __restrict__ stats, int hw,
                                   int groups, int cg, int rows_per_chunk,
                                   int n_chunks, float eps) {
  const int bg = blockIdx.x;
  const int b = bg / groups, g = bg % groups;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int ch = threadIdx.x; ch < n_chunks; ch += 32) {
    const float2 p = part[((size_t)b * n_chunks + ch) * groups + g];
    const int rows = min(hw, (ch + 1) * rows_per_chunk) - ch * rows_per_chunk;
    chan_merge(n, mean, m2, (float)rows * (float)cg, p.x, p.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
  if (threadIdx.x == 0) {
    const float var = fmaxf(m2 / n, 0.f);
    stats[bg] = make_float2(mean, rsqrtf(var + eps));
  }
}

__global__ void gn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                const float2* __restrict__ stats,
                                __nv_bfloat16* __restrict__ y, int hw, int c,
                                int groups, int rows_per_chunk, int silu) {
  const int rl = blockDim.y;
  const int vc = threadIdx.x, ry = threadIdx.y;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int cg = c / groups;
  float mu[kVec], a[kVec], sh[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int ch = vc * kVec + i;
    const float2 st = stats[b * groups + ch / cg];
    mu[i] = st.x;
    a[i] = st.y * scale[ch];
    sh[i] = bias[ch];
  }
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(hw, r0 + rows_per_chunk);
  const size_t base = (size_t)b * hw * c + (size_t)vc * kVec;
  for (int r = r0 + ry; r < r1; r += rl) {
    const size_t off = base + (size_t)r * c;
    uint4 raw = *reinterpret_cast<const uint4*>(x + off);
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      float v0 = (f.x - mu[2 * i]) * a[2 * i] + sh[2 * i];
      float v1 = (f.y - mu[2 * i + 1]) * a[2 * i + 1] + sh[2 * i + 1];
      if (silu) {
        v0 = v0 / (1.f + expf(-v0));
        v1 = v1 / (1.f + expf(-v1));
      }
      h2[i] = __floats2bfloat162_rn(v0, v1);
    }
    *reinterpret_cast<uint4*>(y + off) = raw;
  }
}

struct Plan {
  int nv, rl, rows_per_chunk, n_chunks;
};

Plan make_plan(int batch, int hw, int c) {
  Plan p;
  p.nv = c / kVec;
  p.rl = p.nv >= kThreads ? 1 : kThreads / p.nv;
  // aim for ~4 blocks per SM over the whole batch, at least 2 rows a lane
  const long long total_rows = (long long)batch * hw;
  long long rows = (total_rows + 527) / 528;
  if (rows < 2LL * p.rl) rows = 2LL * p.rl;
  rows = (rows + p.rl - 1) / p.rl * p.rl;
  if (rows > hw) rows = hw;
  p.rows_per_chunk = (int)rows;
  p.n_chunks = (hw + p.rows_per_chunk - 1) / p.rows_per_chunk;
  return p;
}

}  // namespace

extern "C" {

// Bytes of workspace gn_silu_forward needs for these sizes.
long long gn_workspace_bytes(int batch, int hw, int c, int groups) {
  const Plan p = make_plan(batch, hw, c);
  return (long long)sizeof(float2) *
         ((long long)batch * p.n_chunks * groups + (long long)batch * groups);
}

// x, y: (batch, hw, c) bf16, contiguous, 16-byte aligned.
// scale, bias: (c,) f32.  ws: gn_workspace_bytes(...) bytes.
int gn_silu_forward(const void* x, const void* scale, const void* bias,
                    void* y, void* ws, int batch, int hw, int c, int groups,
                    float eps, int silu, void* stream) {
  if (c % kVec != 0 || c % groups != 0 || c / kVec > 1024 || batch <= 0 ||
      hw <= 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = make_plan(batch, hw, c);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(ws);
  float2* stats = part + (size_t)batch * p.n_chunks * groups;
  const dim3 block(p.nv, p.rl);
  const dim3 grid(p.n_chunks, batch);
  const size_t smem = sizeof(float) * (size_t)p.nv * p.rl * (1 + 2 * kVec);
  gn_stats_kernel<<<grid, block, smem, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), part, hw, c, groups,
      p.rows_per_chunk, p.n_chunks);
  gn_finalize_kernel<<<batch * groups, 32, 0, st>>>(
      part, stats, hw, groups, c / groups, p.rows_per_chunk, p.n_chunks,
      eps);
  gn_apply_kernel<<<grid, block, 0, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const float*>(scale),
      reinterpret_cast<const float*>(bias), stats,
      reinterpret_cast<__nv_bfloat16*>(y), hw, c, groups, p.rows_per_chunk,
      silu);
  return (int)cudaGetLastError();
}

}  // extern "C"
