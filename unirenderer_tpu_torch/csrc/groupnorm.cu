// K1: GroupNorm (+ optional SiLU) forward over NHWC activations, bf16 or
// f32 (a template on the activation type; the output has the input's
// type, as the JAX kernel writes `x.dtype`), one launch per call.
//
// Replaces: unirenderer_tpu/ops/groupnorm.py `_kernel` (reached through
// `_fused_fwd` and `fused_groupnorm_silu`), the Pallas TPU kernel that holds
// one batch element's whole (HW, C) slice in VMEM and normalises it in one
// read and one write.
//
// What bounds it on an H100: memory.  It does a handful of flops per
// element, far below the ~295 flop/byte ridge of bf16 on this card; the
// least it can move is one read of x and one write of y.  At the UNet's
// small shapes what bounds it in practice is launches: a forward request
// calls it ~1300 times.
//
// Why the TPU design does not carry over: a (4096, 320) bf16 slice (2.6 MB)
// does not fit one SM's 227 KB of shared memory, and the VAE's
// (262144, 128) slice fits nowhere on chip.  So the statistics are split
// across blocks, and one grid-wide barrier joins them:
//   * a persistent grid, every block resident at once (a cooperative
//     launch; the grid comes from the occupancy calculator and the SM
//     count), block (b, chunk) owning a contiguous range of the rows of
//     batch element b;
//   * each thread walks rows of one 16-byte column vector (8 bf16 or 4
//     f32 channels) with a per-channel Welford update (no E[x^2] -
//     mean^2 anywhere: a group holds up to a million elements at the
//     VAE's top level, where the one-pass form loses the variance); the
//     block merges its row lanes by Chan's formula in a fixed tree, then
//     its channels into per-group (mean, M2) (equal counts: the mean of
//     the means, M2 plus n * the squared spread of the means), and writes
//     one partial per (b, chunk, group);
//   * grid barrier; every block merges the partials of its batch element's
//     groups in a fixed order (a lane per chunk stride, then a fixed tree
//     over the lanes; no float atomics), so a rerun gives the same bits;
//   * the block applies (x - mean) * rstd * scale + bias, optional SiLU,
//     and writes y in x's type with 16-byte stores.
// Where the block's rows fit in shared memory (every UNet and attribute
// encoder shape at batch 2), the first pass keeps them there and the apply
// reads them back: x is read from device memory once.  Where they do not
// (the VAE's 256^2-512^2 levels) the apply reads x again, mostly from L2
// for all but the largest.  The branch is chosen from the shape before the
// launch; both are the same kernel.
// scale and bias are read in their own type (bf16 or f32, a template).
// Any C that is a multiple of the vector width (8 bf16, 4 f32) and of G
// works, so C/G need not be a power of two (10, 20, 40, 60 at flagship
// widths; 4 in the VAE).  The f32 form does the same Welford / Chan merges
// in the same fixed order, over 4-channel vectors.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing
// (the caller passes the workspace: one float2 per (block, group), fully
// written before it is read), launches on the caller's stream and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "index_check.cuh"

namespace cg = cooperative_groups;

extern "C" int gn_max_blocks(void);

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSlots = 64;         // launch plans kept

__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float meanb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = meanb;
    m2 = m2b;
    return;
  }
  const float nt = n + nb;
  const float d = meanb - mean;
  const float f = __fdividef(nb, nt);
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nt;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// The activation types: channels per 16-byte vector.  A block has at
// most 4096 / kN threads (one column vector each across a 4096-channel
// row: 512 in bf16, 1024 in f32), and at least 2048 / that of them share
// an SM, so either way a thread has at most 64 registers.
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  static constexpr int kThreads = 512;
  static constexpr int kMinBlocks = 2;
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static constexpr int kThreads = 1024;
  static constexpr int kMinBlocks = 1;
};

// One Welford step over a 16-byte vector: 8 bf16 channels, taken in pairs
__device__ __forceinline__ void welford(float n_inv, const uint4& raw,
                                        float (&mean)[8], float (&m2)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    float d = f.x - mean[2 * i];
    mean[2 * i] += d * n_inv;
    m2[2 * i] += d * (f.x - mean[2 * i]);
    d = f.y - mean[2 * i + 1];
    mean[2 * i + 1] += d * n_inv;
    m2[2 * i + 1] += d * (f.y - mean[2 * i + 1]);
  }
}

// ... or 4 f32 channels
__device__ __forceinline__ void welford(float n_inv, const uint4& raw,
                                        float (&mean)[4], float (&m2)[4]) {
  const float f[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                      __uint_as_float(raw.z), __uint_as_float(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = f[i] - mean[i];
    mean[i] += d * n_inv;
    m2[i] += d * (f[i] - mean[i]);
  }
}

// Thread t works column vector t % V (V = C / kN) on row lane t / V; RL
// row lanes, blockDim.x = V * RL rounded up to whole warps (the extra
// threads only join the warp reductions).  grid = batch * n_chunks blocks,
// block (b, chunk) at b * n_chunks + chunk.
// Shared memory: [scratch: 1 + 2 kN floats a thread][group stats:
// 2 * groups floats, 16-byte aligned][x cache: cached ? rows_per_chunk * C
// of T].
template <typename T, typename P>
__global__ void __launch_bounds__(Vec<T>::kThreads, Vec<T>::kMinBlocks)
gn_fused_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                const P* __restrict__ bias, T* __restrict__ y,
                float2* __restrict__ part, int hw, int c, int groups,
                int rl, int rows_per_chunk, int n_chunks,
                int scratch_floats, float eps, int silu, int cached) {
  constexpr int kVec = Vec<T>::kN;
  extern __shared__ float4 smem4[];
  float* scratch = reinterpret_cast<float*>(smem4);
  float2* gstat = reinterpret_cast<float2*>(scratch + scratch_floats);
  uint4* cache = reinterpret_cast<uint4*>(scratch + scratch_floats +
                                          (2 * groups + 3) / 4 * 4);
  const int nv = c / kVec;
  const int tid = threadIdx.x;
  const int vc = tid % nv, ry = tid / nv;     // ry >= rl: no rows
  const int b = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(hw, r0 + rows_per_chunk);
  const int cg_ = c / groups;
  const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)b * hw * c);
  const int pitch = c / kVec;          // uint4s a row
  // extents of the checked build: x and y in uint4s, the partials, the
  // x cache (uint4s)
  const long long x_ext = (long long)(gridDim.x / n_chunks) * hw * pitch;
  const long long x_off = (long long)b * hw * pitch;
  const long long part_ext = (long long)gridDim.x * groups;
  const long long cache_ext = (long long)rows_per_chunk * pitch;
  (void)x_ext, (void)x_off, (void)part_ext, (void)cache_ext;

  // ---- 1. per-channel Welford over this thread's rows, four loads in
  // flight at a time
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) mean[i] = m2[i] = 0.f;
  for (int r = ry < rl ? r0 + ry : r1; r < r1; r += 4 * rl) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + u * rl < r1) {
        UR_CHECK_INDEX(x_off + (long long)(r + u * rl) * pitch + vc, x_ext,
                       "K1 x");
        raw[u] = xb[(size_t)(r + u * rl) * pitch + vc];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + u * rl < r1) {
        if (cached) {
          UR_CHECK_INDEX((r + u * rl - r0) * pitch + vc, cache_ext,
                         "K1 x cache");
          cache[(r + u * rl - r0) * pitch + vc] = raw[u];
        }
        n += 1.f;
        welford(__frcp_rn(n), raw[u], mean, m2);
      }
    }
  }

  // ---- 2. merge the row lanes of each column vector by a fixed tree over
  // ry: at each step lanes [s, 2s) hand their sums to lanes [0, s); row
  // lane 0 ends with the block's sums
  int top = 1;
  while (top < rl) top <<= 1;
  for (int step = top >> 1; step > 0; step >>= 1) {
    const int slots = step * nv;          // (1 + 2 * kVec) floats each
    if (ry >= step && ry < 2 * step) {
      const int o = (ry - step) * nv + vc;
      scratch[o] = n;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        scratch[(1 + i) * slots + o] = mean[i];
        scratch[(1 + kVec + i) * slots + o] = m2[i];
      }
    }
    __syncthreads();
    if (ry < step && ry + step < rl) {
      const int o = ry * nv + vc;
      const float nb = scratch[o];
      float nn = n;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        nn = n;
        chan_merge(nn, mean[i], m2[i], nb, scratch[(1 + i) * slots + o],
                   scratch[(1 + kVec + i) * slots + o]);
      }
      n = nn;
    }
    __syncthreads();
  }
  // per-channel (mean, M2) over the block's rows, channel ch at [ch], [c+ch]
  if (ry == 0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      scratch[vc * kVec + i] = mean[i];
      scratch[c + vc * kVec + i] = m2[i];
    }
  }
  __syncthreads();

  // ---- 3. channels -> groups (every channel has the block's row count):
  // a warp per group, lanes over its channels, fixed butterfly sums
  const float rows = (float)(r1 - r0);
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int gi = warp; gi < groups; gi += n_warps) {
    float sm = 0.f;
    for (int ch = gi * cg_ + lane; ch < (gi + 1) * cg_; ch += 32) {
      sm += scratch[ch];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sm += __shfl_xor_sync(0xffffffffu, sm, off);
    }
    const float gmean = sm / (float)cg_;
    float sq = 0.f;
    for (int ch = gi * cg_ + lane; ch < (gi + 1) * cg_; ch += 32) {
      const float dm = scratch[ch] - gmean;
      sq += scratch[c + ch] + rows * dm * dm;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) {
      UR_CHECK_INDEX((long long)blockIdx.x * groups + gi, part_ext,
                     "K1 partials (write)");
      part[(size_t)blockIdx.x * groups + gi] = make_float2(gmean, sq);
    }
  }

  // ---- 4. every block's partials written
  cg::this_grid().sync();

  // ---- 5. merge the chunks of batch element b per group, in a fixed
  // order: `span` lanes a group (a power of two up to 32, as many as the
  // block holds), lane l taking chunks l, l + span, ... in turn; then a
  // fixed tree over the lanes
  int span = 32;
  while (span > 1 && groups * span > (int)blockDim.x) span >>= 1;
  const int per_round = blockDim.x / span;
  const int sub = tid % span;
  const float2* pb = part + (size_t)b * n_chunks * groups;
  for (int g0 = 0; g0 < groups; g0 += per_round) {
    const int gi = g0 + tid / span;
    float gn = 0.f, gmean = 0.f, gm2 = 0.f;
    if (gi < groups) {
      auto take = [&](int ch, float2 p) {
        const float nrows = (float)(min(hw, (ch + 1) * rows_per_chunk) -
                                    ch * rows_per_chunk);
        chan_merge(gn, gmean, gm2, nrows * (float)cg_, p.x, p.y);
      };
      int ch = sub;
      for (; ch + 3 * span < n_chunks; ch += 4 * span) {
        float2 p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          UR_CHECK_INDEX((long long)(b * n_chunks + ch + u * span) * groups +
                             gi, part_ext, "K1 partials (read)");
          p[u] = __ldcg(pb + (size_t)(ch + u * span) * groups + gi);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) take(ch + u * span, p[u]);
      }
      for (; ch < n_chunks; ch += span) {
        UR_CHECK_INDEX((long long)(b * n_chunks + ch) * groups + gi,
                       part_ext, "K1 partials (read)");
        take(ch, __ldcg(pb + (size_t)ch * groups + gi));
      }
    }
    for (int off = span >> 1; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, gn, off, span);
      const float mb = __shfl_down_sync(0xffffffffu, gmean, off, span);
      const float qb = __shfl_down_sync(0xffffffffu, gm2, off, span);
      if (sub < off) chan_merge(gn, gmean, gm2, nb, mb, qb);
    }
    if (gi < groups && sub == 0) {
      UR_CHECK_INDEX(gi, groups, "K1 group statistics");
      const float var = fmaxf(gm2 / gn, 0.f);
      gstat[gi] = make_float2(gmean, rsqrtf(var + eps));
    }
  }
  __syncthreads();

  // ---- 6. apply: (x - mean) * rstd * scale + bias, optional SiLU
  float mu[kVec], a[kVec], sh[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int ch = vc * kVec + i;
    UR_CHECK_INDEX(ch, c, "K1 scale/bias");
    UR_CHECK_INDEX(ch / cg_, groups, "K1 group statistics");
    const float2 st = gstat[ch / cg_];
    mu[i] = st.x;
    a[i] = st.y * to_float(scale[ch]);
    sh[i] = to_float(bias[ch]);
  }
  uint4* yb = reinterpret_cast<uint4*>(y + (size_t)b * hw * c);
  for (int r = ry < rl ? r0 + ry : r1; r < r1; r += rl) {
    UR_CHECK_INDEX(cached ? (long long)(r - r0) * pitch + vc
                          : x_off + (long long)r * pitch + vc,
                   cached ? cache_ext : x_ext, "K1 x (apply)");
    uint4 raw = cached ? cache[(r - r0) * pitch + vc]
                       : xb[(size_t)r * pitch + vc];
    if constexpr (kVec == 8) {         // bf16, in pairs
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec / 2; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        float v0 = (f.x - mu[2 * i]) * a[2 * i] + sh[2 * i];
        float v1 = (f.y - mu[2 * i + 1]) * a[2 * i + 1] + sh[2 * i + 1];
        if (silu) {
          v0 = __fdividef(v0, 1.f + __expf(-v0));
          v1 = __fdividef(v1, 1.f + __expf(-v1));
        }
        h2[i] = __floats2bfloat162_rn(v0, v1);
      }
    } else {                           // f32
      float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float v = (f[i] - mu[i]) * a[i] + sh[i];
        if (silu) v = __fdividef(v, 1.f + __expf(-v));
        f[i] = v;
      }
    }
    UR_CHECK_INDEX(x_off + (long long)r * pitch + vc, x_ext, "K1 y");
    yb[(size_t)r * pitch + vc] = raw;
  }
}

struct Plan {
  int batch, hw, c, groups, dtype;      // the key (dtype: kind() below)
  int nv, rl, threads, rows_per_chunk, n_chunks, scratch_floats, cached;
  size_t smem;
};

Plan g_plans[kSlots];
int g_n_plans = 0;
int g_sms = 0, g_max_smem = 0;

// The plan key's type code: bit 0 bf16 parameters, bit 1 f32 activations.
int kind(int x_f32, int param_bf16) {
  return (x_f32 ? 2 : 0) | (param_bf16 ? 1 : 0);
}

template <typename T, typename P>
int occupancy(int threads, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, gn_fused_kernel<T, P>, threads, smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

template <typename T, typename P>
cudaError_t allow_max_smem() {
  return cudaFuncSetAttribute(gn_fused_kernel<T, P>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              g_max_smem);
}

// The launch plan of a shape: the cached branch with as many blocks an SM
// as fit (x's rows in shared memory, in bytes of T), else the re-reading
// branch over every block the card holds at once.  0 on success.
template <typename T, typename P>
int make_plan(Plan& p) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kThreads = Vec<T>::kThreads;
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&g_max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaError_t e = allow_max_smem<bf16, float>();
    if (e == cudaSuccess) e = allow_max_smem<bf16, bf16>();
    if (e == cudaSuccess) e = allow_max_smem<float, float>();
    if (e == cudaSuccess) e = allow_max_smem<float, bf16>();
    if (e != cudaSuccess) return (int)e;
  }
  p.nv = p.c / kVec;
  p.rl = kThreads / p.nv;
  if (p.rl > p.hw) p.rl = p.hw;
  const int threads = (p.nv * p.rl + 31) / 32 * 32;
  p.threads = threads;
  int top = 1;
  while (top < p.rl) top <<= 1;
  const int tree = (1 + 2 * kVec) * (top / 2) * p.nv;
  const int scratch = tree > 2 * p.c ? tree : 2 * p.c;
  p.scratch_floats = (scratch + 3) / 4 * 4;         // 16-byte aligned
  const size_t fixed16 =
      sizeof(float) * (p.scratch_floats + (2 * p.groups + 3) / 4 * 4);
  // at least ~8 KB of x a block: fewer partials where x is small
  const int min_rows = 4096 / p.c > 1 ? 4096 / p.c : 1;
  auto split = [&](int n_blocks) {
    int chunks = n_blocks / p.batch;
    if (chunks > p.hw / min_rows) chunks = p.hw / min_rows;
    if (chunks < 1) chunks = 1;
    p.rows_per_chunk = (p.hw + chunks - 1) / chunks;
    p.n_chunks = (p.hw + p.rows_per_chunk - 1) / p.rows_per_chunk;
  };
  const int occ0 = occupancy<T, P>(threads, fixed16);
  for (int per_sm = 1; per_sm <= occ0; ++per_sm) {
    split(per_sm * g_sms);
    const size_t smem =
        fixed16 + (size_t)p.rows_per_chunk * p.c * sizeof(T);
    if (smem <= (size_t)g_max_smem &&
        occupancy<T, P>(threads, smem) * g_sms >= p.batch * p.n_chunks) {
      p.cached = 1;
      p.smem = smem;
      return 0;
    }
  }
  split(occ0 * g_sms);
  p.cached = 0;
  p.smem = fixed16;
  if (occ0 < 1 || p.batch * p.n_chunks > occ0 * g_sms) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  return 0;
}

const Plan* plan_for(int batch, int hw, int c, int groups, int dtype,
                     int* err) {
  for (int i = 0; i < g_n_plans; ++i) {
    const Plan& p = g_plans[i];
    if (p.batch == batch && p.hw == hw && p.c == c && p.groups == groups &&
        p.dtype == dtype) {
      return &p;
    }
  }
  Plan p = {};
  p.batch = batch;
  p.hw = hw;
  p.c = c;
  p.groups = groups;
  p.dtype = dtype;
  switch (dtype) {
    case 0: *err = make_plan<bf16, float>(p); break;
    case 1: *err = make_plan<bf16, bf16>(p); break;
    case 2: *err = make_plan<float, float>(p); break;
    default: *err = make_plan<float, bf16>(p); break;
  }
  if (*err) return nullptr;
  Plan& slot = g_plans[g_n_plans < kSlots ? g_n_plans++ : batch % kSlots];
  slot = p;
  return &slot;
}

template <typename T>
int forward(const void* x, const void* scale, const void* bias, void* y,
            void* ws, int batch, int hw, int c, int groups, float eps,
            int silu, int param_bf16, void* stream) {
  constexpr int kVec = Vec<T>::kN;
  if (c % kVec != 0 || c % groups != 0 || c / kVec > Vec<T>::kThreads ||
      batch <= 0 || hw <= 0 || groups <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int err = 0;
  const Plan* p = plan_for(batch, hw, c, groups,
                           kind(sizeof(T) == 4, param_bf16), &err);
  if (p == nullptr) return err;
#ifdef UNIRENDER_INDEX_CHECK
  // the grid's partials must fit the workspace the caller sized
  if (batch * p->n_chunks > gn_max_blocks()) {
    return (int)cudaErrorInvalidValue;
  }
#endif
  const T* xp = reinterpret_cast<const T*>(x);
  T* yp = reinterpret_cast<T*>(y);
  float2* part = reinterpret_cast<float2*>(ws);
  int hw_ = hw, c_ = c, g_ = groups, rl = p->rl, rpc = p->rows_per_chunk,
      nch = p->n_chunks, sf = p->scratch_floats, silu_ = silu,
      cached = p->cached;
  float eps_ = eps;
  const void* sp = scale;
  const void* bp = bias;
  void* args[] = {(void*)&xp, (void*)&sp,  (void*)&bp,  (void*)&yp,
                  (void*)&part, (void*)&hw_, (void*)&c_, (void*)&g_,
                  (void*)&rl,   (void*)&rpc, (void*)&nch, (void*)&sf,
                  (void*)&eps_, (void*)&silu_, (void*)&cached};
  const dim3 block(p->threads);
  const dim3 grid(batch * p->n_chunks);
  const void* fn = param_bf16 ? (const void*)gn_fused_kernel<T, bf16>
                              : (const void*)gn_fused_kernel<T, float>;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, grid, block, args, p->smem, reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Most blocks a launch may use: float2s of workspace per group.
int gn_max_blocks(void) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * 32;                     // resident blocks an SM at most
}

// x, y: (batch, hw, c) bf16, contiguous, 16-byte aligned.  scale, bias:
// (c,) of one type, bf16 (param_bf16 = 1) or f32 (0).  ws: at least
// gn_max_blocks() * groups float2.  Returns a CUDA error code, 0 on success.
int gn_silu_forward(const void* x, const void* scale, const void* bias,
                    void* y, void* ws, int batch, int hw, int c, int groups,
                    float eps, int silu, int param_bf16, void* stream) {
  return forward<bf16>(x, scale, bias, y, ws, batch, hw, c, groups, eps,
                       silu, param_bf16, stream);
}

// The same over f32 x and y (c a multiple of 4, up to 4096).
int gn_silu_forward_f32(const void* x, const void* scale, const void* bias,
                        void* y, void* ws, int batch, int hw, int c,
                        int groups, float eps, int silu, int param_bf16,
                        void* stream) {
  return forward<float>(x, scale, bias, y, ws, batch, hw, c, groups, eps,
                        silu, param_bf16, stream);
}

// The launch plan of a shape without launching: out[0] 1 for the branch
// that keeps x's rows in shared memory, 0 for the re-reading one; out[1]
// blocks (batch * chunks); out[2] rows a chunk; out[3] threads a block;
// out[4] dynamic shared memory bytes.  Returns a CUDA error code.
int gn_plan(int batch, int hw, int c, int groups, int x_f32, int param_bf16,
            int* out) {
  const int vec = x_f32 ? Vec<float>::kN : Vec<bf16>::kN;
  if (c % vec != 0 || c % groups != 0 || c > 4096 || batch <= 0 ||
      hw <= 0 || groups <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int err = 0;
  const Plan* p = plan_for(batch, hw, c, groups, kind(x_f32, param_bf16),
                           &err);
  if (p == nullptr) return err;
  out[0] = p->cached;
  out[1] = batch * p->n_chunks;
  out[2] = p->rows_per_chunk;
  out[3] = p->threads;
  out[4] = (int)p->smem;
  return 0;
}

}  // extern "C"
