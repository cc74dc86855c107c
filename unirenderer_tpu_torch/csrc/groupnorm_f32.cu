// K1 f32: GroupNorm (+ optional SiLU) forward over NHWC f32 activations,
// one thread-block cluster per batch element, one launch per call.
//
// Replaces: unirenderer_tpu/ops/groupnorm.py `_kernel` (reached through
// `_fused_fwd` and `fused_groupnorm_silu`) for f32 x whose per-element
// (HW, C) slice fits one cluster's shared memory: the Pallas TPU kernel
// that holds one batch element's slice in VMEM and normalises it in one
// read and one write.  Every f32 shape this plan does not take goes to the
// f32 instance of csrc/groupnorm.cu (a cooperative grid); bf16 always
// does.  The wrapper (ops/groupnorm.py) decides from the shape, before any
// launch.
//
// What bounds it on an H100: memory.  A few flops an element against one
// read of x and one write of y: 0.02-10 us at small()'s shapes (16 KB - 1
// MB a batch element, 0.03-16 MB a call).  At those sizes latency costs
// more: the cooperative kernel of csrc/groupnorm.cu reads ~15-28 us a
// call; at (16,16,16,128) its 17.0 us split into 6.8 us of launch and
// timing that any kernel pays, 3.7 us re-reading every block's partials
// after its grid barrier, 2.8 us of in-block merge trees, 1.2 us of grid
// barrier and 2.2 us of reading and writing x (PERF.md §6,
// k1_f32_cost.py on an H100 at 700 W).
//
// The design keeps all of a batch element inside one cluster, so nothing
// crosses a grid, and keeps each step short:
//   * cluster (b) = ctas CTAs, rank r owning a contiguous range of
//     ceil(HW / ctas) rows of batch element b.  ctas: the least power of
//     two whose shared memory holds the slice and which the card can
//     place (at most 16: above 8 only where the occupancy calculator
//     places it); then the largest power of two up to 16 at which each
//     CTA keeps at least 4096 / C rows and the card holds every batch
//     element's cluster at once, with the most row lanes (threads) that
//     allow it; where none does, the least, in waves.  Small calls so
//     spread over the SMs; at small()'s largest, (16,64,64,64), 8-CTA
//     clusters ran in two waves and read slower than the cooperative
//     kernel, 16-CTA ones of 256 threads run at once and read faster;
//   * thread (column vector, row lane) reads its rows once, four 16-byte
//     loads in flight, keeps them in shared memory and walks them with a
//     per-channel Welford update (no E[x^2] - mean^2: a group holds up to
//     a million elements at the VAE's top level, where the one-pass form
//     loses the variance); scale and bias are read meanwhile;
//   * each column's row lanes merged at once by Chan's formula for k
//     parts (the n-weighted mean of the lane means, then M2 plus n times
//     their squared spread about it; fixed xor-butterfly sums in a
//     segment of the warp, no branch); the channels of a group merged at
//     equal counts into one (mean, M2) partial a group, which the CTA
//     stores into every rank's table in distributed shared memory (after
//     a cluster barrier arrived at on entry, so every rank has started);
//   * cluster.sync(); every CTA merges the ranks' partials from its own
//     table by Chan's formula in rank order (no float atomics), so all
//     ranks hold the same statistics and a rerun gives the same bits.
//     Nothing reads another rank's shared memory after the barrier, so a
//     CTA may leave as soon as it is done;
//   * apply from shared memory: (x - mean) * rstd * scale + bias, optional
//     SiLU, 16-byte stores.
// No cooperative launch, no grid barrier, no workspace, no memset: one
// device kernel a call, batch elements independent of each other.
// scale and bias are read in their own type (f32 or bf16, a template).
// Any C that is a multiple of 4 (up to 4096) and of G works.
// plain version: ops/groupnorm.py `groupnorm_silu_reference`; the row
// ranges and merge order in plain torch: `cluster_stats_reference`.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxThreads = 1024;
constexpr int kMaxCtas = 16;        // a cluster: 8 portable, 16 if placeable
constexpr int kMaxLanes = 32;       // row lanes a column vector at most
constexpr int kRowsPerLane = 4;     // rows a row lane walks, about
constexpr int kSlots = 64;          // launch plans kept

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

// Sums of 4 values over the lanes of an aligned segment of `width` lanes
// (a power of two): a fixed xor butterfly, every lane ending with the
// same bits (each step adds the same two values in either order).
__device__ __forceinline__ void segment_sum(float (&v)[4], int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
  }
}

__device__ __forceinline__ float segment_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Merge the (n, mean, M2) of 4 channels held by the lanes of a segment,
// `total` rows in all, into the segment's (mean, M2), every lane holding
// them: the n-weighted mean of the lane means, then M2 plus n times the
// squared spread of the lane means about it (Chan's formula for k parts
// at once: no branch, one division).
__device__ __forceinline__ void segment_merge(float n, float (&mean)[4],
                                              float (&m2)[4], int width,
                                              int total) {
  const float inv = total > 0 ? __frcp_rn((float)total) : 0.f;
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = n * mean[i];
  segment_sum(s, width);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = mean[i] - s[i] * inv;
    m2[i] += n * d * d;
    mean[i] = s[i] * inv;
  }
  segment_sum(m2, width);
}

// One Welford step over a 16-byte vector of 4 f32 channels.
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

// Rows row lane `ry` of `lanes` walks out of `rows`.
__device__ __forceinline__ int lane_rows(int ry, int lanes, int rows) {
  return ry < rows ? (rows - ry + lanes - 1) / lanes : 0;
}

// Floats of shared memory before the x cache: per-channel (mean, M2) of
// the CTA's rows [2C], the merged group statistics [2G], every rank's
// group partials, stored by each rank [2G ctas], then each
// thread's per-channel (mean, M2) [C / 4 columns of `lanes` x 8 floats
// and 4 of padding]; 16-byte aligned.
__host__ __device__ __forceinline__ int head_floats(int c, int groups,
                                                    int ctas) {
  return (2 * c + 2 * groups + 2 * groups * ctas + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int fixed_floats(int c, int groups,
                                                     int ctas, int lanes) {
  return head_floats(c, groups, ctas) + c / 4 * (8 * lanes + 4);
}

// grid = batch * ctas CTAs in clusters of ctas, cluster b on batch
// element b.  Thread t works column vector t % (C / 4) on row lane
// t / (C / 4) (`lanes` of them; threads past C / 4 * lanes only join the
// barriers).
template <typename P>
__global__ void __launch_bounds__(kMaxThreads, 1)
gn_cluster_kernel(const float* __restrict__ x, const P* __restrict__ scale,
                  const P* __restrict__ bias, float* __restrict__ y, int hw,
                  int c, int groups, int rows_per_cta, int lanes, float eps,
                  int silu) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / n_ctas;
  extern __shared__ float4 smem4[];
  float* chstat = reinterpret_cast<float*>(smem4);
  float2* gstat = reinterpret_cast<float2*>(chstat + 2 * c);
  float2* ranks = gstat + groups;
  float* lane_part =
      reinterpret_cast<float*>(smem4) + head_floats(c, groups, n_ctas);
  uint4* cache = reinterpret_cast<uint4*>(smem4) +
                 fixed_floats(c, groups, n_ctas, lanes) / 4;
  const int nv = c / 4;
  const int cg_ = c / groups;
  const int tid = threadIdx.x;
  const int r0 = min(hw, rank * rows_per_cta);
  const int rows = min(hw, r0 + rows_per_cta) - r0;
  const uint4* xb =
      reinterpret_cast<const uint4*>(x) + ((size_t)b * hw + r0) * nv;
  uint4* yb = reinterpret_cast<uint4*>(y) + ((size_t)b * hw + r0) * nv;
  const int vc = tid % nv, ry = tid / nv;
  const int first = ry < lanes ? ry : rows;  // threads past the lanes: none
  const int lane_pitch = 8 * lanes + 4;      // floats a column's partials

  // every rank's shared memory is written below only once every rank has
  // started: arrive now, wait before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // ---- 1. the CTA's rows, read once (four 16-byte loads in flight a
  // thread) into shared memory, with a per-channel Welford walk over this
  // thread's rows; its (mean, M2) into shared memory
  float sc[4], sh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sc[i] = to_float(scale[vc * 4 + i]);
    sh[i] = to_float(bias[vc * 4 + i]);
  }
  {
    float n = 0.f, mean[4], m2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mean[i] = m2[i] = 0.f;
    for (int r = first; r < rows; r += 4 * lanes) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (r + u * lanes < rows) {
          raw[u] = xb[(size_t)(r + u * lanes) * nv + vc];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (r + u * lanes < rows) {
          cache[(r + u * lanes) * nv + vc] = raw[u];
          n += 1.f;
          welford(__frcp_rn(n), raw[u], mean, m2);
        }
      }
    }
    if (ry < lanes) {
      float4* w = reinterpret_cast<float4*>(lane_part + vc * lane_pitch +
                                            ry * 8);
      w[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
      w[1] = make_float4(m2[0], m2[1], m2[2], m2[3]);
    }
  }
  __syncthreads();

  // ---- 2. each column's row lanes merged at once: a segment of width
  // (lanes rounded up to a power of two) warp lanes a column
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  int width = 1;
  while (width < lanes) width *= 2;
  const int cpw = 32 / width;
  for (int unit = warp; unit * cpw < nv; unit += n_warps) {
    const int v = unit * cpw + lane / width, j = lane % width;
    float mean[4], m2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mean[i] = m2[i] = 0.f;
    float n = 0.f;
    if (v < nv && j < lanes) {
      const float4* w = reinterpret_cast<const float4*>(
          lane_part + v * lane_pitch + j * 8);
      const float4 a = w[0], q = w[1];
      mean[0] = a.x, mean[1] = a.y, mean[2] = a.z, mean[3] = a.w;
      m2[0] = q.x, m2[1] = q.y, m2[2] = q.z, m2[3] = q.w;
      n = (float)lane_rows(j, lanes, rows);
    }
    segment_merge(n, mean, m2, width, rows);
    if (j == 0 && v < nv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        chstat[4 * v + i] = mean[i];
        chstat[c + 4 * v + i] = m2[i];
      }
    }
  }
  __syncthreads();

  // ---- 3. channels -> groups (every channel has the CTA's row count): a
  // segment of gw lanes a group (its channels, or 32 at most), fixed
  // butterfly sums; the group's (mean, M2) partial stored into every
  // rank's table, at this rank's row
  int gw = 1;
  while (gw < 32 && gw < cg_) gw *= 2;
  const int gpw = 32 / gw;
  const float nrows = (float)rows;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int g0 = warp * gpw; g0 < groups; g0 += n_warps * gpw) {
    const int gi = g0 + lane / gw, k = lane % gw;
    const int ch0 = gi * cg_ + k, ch1 = gi < groups ? (gi + 1) * cg_ : 0;
    float sm = 0.f;
    for (int ch = ch0; ch < ch1; ch += gw) sm += chstat[ch];
    const float gmean = segment_sum(sm, gw) / (float)cg_;
    float sq = 0.f;
    for (int ch = ch0; ch < ch1; ch += gw) {
      const float dm = chstat[ch] - gmean;
      sq += chstat[c + ch] + nrows * dm * dm;
    }
    sq = segment_sum(sq, gw);
    if (gi < groups) {
      for (int r = k; r < n_ctas; r += gw) {
        cluster.map_shared_rank(ranks, r)[rank * groups + gi] =
            make_float2(gmean, sq);
      }
    }
  }

  // ---- 4. every rank's partials stored in every rank's table
  cluster.sync();

  // ---- 5. merge the ranks per group by Chan's formula in rank order (no
  // float atomics): every rank the same bits
  for (int gi = tid; gi < groups; gi += blockDim.x) {
    float gn = 0.f, gmean = 0.f, gm2 = 0.f;
    for (int r = 0; r < n_ctas; ++r) {
      const int a0 = min(hw, r * rows_per_cta);
      const int a1 = min(hw, a0 + rows_per_cta);
      const float2 pr = ranks[r * groups + gi];
      chan_merge(gn, gmean, gm2, (float)(a1 - a0) * (float)cg_, pr.x, pr.y);
    }
    const float var = fmaxf(__fdividef(gm2, gn), 0.f);
    gstat[gi] = make_float2(gmean, rsqrtf(var + eps));
  }
  __syncthreads();

  // ---- 6. apply from shared memory: (x - mean) * rstd * scale + bias,
  // optional SiLU
  float mu[4], a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 st = gstat[(vc * 4 + i) / cg_];
    mu[i] = st.x;
    a[i] = st.y * sc[i];
  }
  for (int r = first; r < rows; r += lanes) {
    uint4 raw = cache[r * nv + vc];
    float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = (f[i] - mu[i]) * a[i] + sh[i];
      if (silu) v = __fdividef(v, 1.f + __expf(-v));
      f[i] = v;
    }
    yb[(size_t)r * nv + vc] = raw;
  }
}

struct Plan {
  int batch, hw, c, groups, param_bf16;   // the key
  int ctas, rows_per_cta, lanes, threads;  // ctas 0: not taken
  size_t smem;
};

Plan g_plans[kSlots];
int g_n_plans = 0;
int g_max_smem = 0;

template <typename P>
cudaError_t set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      gn_cluster_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g_max_smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gn_cluster_kernel<P>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  }
  return e;
}

cudaLaunchConfig_t launch_config(const Plan& p, cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.batch * p.ctas);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Row lanes a column vector for CTAs of `rows` rows: about kRowsPerLane
// rows each, at most kMaxLanes and 1024 threads.
int default_lanes(int rows, int nv) {
  int lanes = (rows + kRowsPerLane - 1) / kRowsPerLane;
  if (lanes > kMaxLanes) lanes = kMaxLanes;
  if (lanes > kMaxThreads / nv) lanes = kMaxThreads / nv;
  return lanes;
}

// Fill p's rows, lanes, threads (C / 4 column vectors times `lanes`, in
// whole warps) and shared memory for a cluster of n CTAs.  Returns how
// many such clusters the card holds at once (0: it cannot place one).
template <typename P>
int size_for(Plan& p, int n, int lanes) {
  const int nv = p.c / 4;
  p.ctas = n;
  p.rows_per_cta = (p.hw + n - 1) / n;
  p.lanes = lanes;
  p.threads = (nv * lanes + 31) / 32 * 32;
  p.smem = sizeof(float) * fixed_floats(p.c, p.groups, n, lanes) +
           (size_t)p.rows_per_cta * nv * sizeof(uint4);
  if (p.smem > (size_t)g_max_smem) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, attr, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(
          &clusters, (const void*)gn_cluster_kernel<P>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();               // a size the card refuses
    return 0;
  }
  return clusters;
}

// The launch plan of a shape: the least power of two of CTAs (up to 16)
// whose shared memory holds the slice and which the card can place; then
// the largest power of two from there up to 16 at which each CTA keeps at
// least 4096 / C rows and the card holds every batch element's cluster at
// once (the occupancy calculator), with the most row lanes (from
// default_lanes down, halving) that allow it; where no size lets every
// cluster run at once, the least one, in waves.  ctas = 0 where no cluster
// holds the slice: the cooperative kernel takes such shapes.  0 on
// success.
template <typename P>
int make_plan(Plan& p) {
  if (g_max_smem == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaError_t e = set_attributes<float>();
    if (e == cudaSuccess) e = set_attributes<bf16>();
    if (e != cudaSuccess) return (int)e;
  }
  const int nv = p.c / 4;
  auto lanes_of = [&](int n) {
    return default_lanes((p.hw + n - 1) / n, nv);
  };
  int least = 1;
  while (least <= kMaxCtas && size_for<P>(p, least, lanes_of(least)) < 1) {
    least *= 2;
  }
  if (least > kMaxCtas) {
    p.ctas = 0;
    return 0;
  }
  const int min_rows = 4096 / p.c > 1 ? 4096 / p.c : 1;
  int best = least, best_lanes = lanes_of(least);
  for (int n = least; n <= kMaxCtas; n *= 2) {
    if (n > least && n > p.hw / min_rows) break;
    for (int lanes = lanes_of(n); lanes >= 1; lanes /= 2) {
      if (size_for<P>(p, n, lanes) >= p.batch) {
        best = n;
        best_lanes = lanes;
        break;
      }
    }
  }
  size_for<P>(p, best, best_lanes);
  return 0;
}

const Plan* plan_for(int batch, int hw, int c, int groups, int param_bf16,
                     int* err) {
  for (int i = 0; i < g_n_plans; ++i) {
    const Plan& p = g_plans[i];
    if (p.batch == batch && p.hw == hw && p.c == c && p.groups == groups &&
        p.param_bf16 == param_bf16) {
      return &p;
    }
  }
  Plan p = {};
  p.batch = batch;
  p.hw = hw;
  p.c = c;
  p.groups = groups;
  p.param_bf16 = param_bf16;
  *err = param_bf16 ? make_plan<bf16>(p) : make_plan<float>(p);
  if (*err) return nullptr;
  Plan& slot = g_plans[g_n_plans < kSlots ? g_n_plans++ : batch % kSlots];
  slot = p;
  return &slot;
}

bool valid(int batch, int hw, int c, int groups) {
  return c % 4 == 0 && c <= 4096 && groups > 0 && c % groups == 0 &&
         batch > 0 && hw > 0;
}

template <typename P>
int forward(const float* x, const void* scale, const void* bias, float* y,
            const Plan& p, float eps, int silu, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, attr, stream);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_cluster_kernel<P>, x, reinterpret_cast<const P*>(scale),
      reinterpret_cast<const P*>(bias), y, p.hw, p.c, p.groups,
      p.rows_per_cta, p.lanes, eps, silu);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (batch, hw, c) f32, contiguous, 16-byte aligned, c a multiple of 4
// up to 4096.  scale, bias: (c,) of one type, bf16 (param_bf16 = 1) or f32
// (0).  The shape must be one gn_cluster_plan takes.  Returns a CUDA error
// code, 0 on success.
int gn_cluster_forward_f32(const void* x, const void* scale, const void* bias,
                           void* y, int batch, int hw, int c, int groups,
                           float eps, int silu, int param_bf16,
                           void* stream) {
  if (!valid(batch, hw, c, groups)) return (int)cudaErrorInvalidValue;
  int err = 0;
  const Plan* p = plan_for(batch, hw, c, groups, param_bf16 ? 1 : 0, &err);
  if (p == nullptr) return err;
  if (p->ctas == 0) return (int)cudaErrorInvalidValue;
  const float* xp = reinterpret_cast<const float*>(x);
  float* yp = reinterpret_cast<float*>(y);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return param_bf16 ? forward<bf16>(xp, scale, bias, yp, *p, eps, silu, s)
                    : forward<float>(xp, scale, bias, yp, *p, eps, silu, s);
}

// The launch plan of a shape without launching: out[0] CTAs a cluster (0:
// the plan does not take the shape), out[1] rows a CTA, out[2] threads a
// CTA, out[3] dynamic shared memory bytes.  Returns a CUDA error code.
int gn_cluster_plan(int batch, int hw, int c, int groups, int param_bf16,
                    int* out) {
  if (!valid(batch, hw, c, groups)) return (int)cudaErrorInvalidValue;
  int err = 0;
  const Plan* p = plan_for(batch, hw, c, groups, param_bf16 ? 1 : 0, &err);
  if (p == nullptr) return err;
  out[0] = p->ctas;
  out[1] = p->rows_per_cta;
  out[2] = p->threads;
  out[3] = (int)p->smem;
  return 0;
}

}  // extern "C"
