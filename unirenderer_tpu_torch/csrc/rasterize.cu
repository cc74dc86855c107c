// K4: tile rasterizer over a batch of views, with its per-triangle set-up
// and its binning.
//
// Replaces: unirenderer_tpu/ops/rasterize_pallas.py `_make_kernel` (reached
// through `rasterize_pallas`; its set-up `_precompute` and its chunk lists
// `_survivor_lists`), the Pallas TPU kernel that walks, per 1x1024-pixel
// row tile, a compacted list of 256-triangle chunks whose screen box
// overlaps the tile and keeps the nearest hit per pixel.  It in turn stands
// in for nvdiffrast's `dr.rasterize`.
//
// What it computes, per pixel centre (x + 0.5, y + 0.5), y down: for every
// triangle with area != 0 whose three edge functions all have the sign of
// its area there, and whose screen box holds the centre (which keeps an
// f32 sliver from covering pixels far off it, whatever the binning),
// perspective-correct barycentrics (u, v) and z; it keeps the
// lexicographic minimum of (z, triangle index) over those hits (and, with
// prev_z, over hits with z > prev_z + 1e-6), and writes (u, v, z, index+1),
// all zero on a miss.
//
// What bounds it on an H100: at the collate's shapes neither bytes nor
// arithmetic.  Moving the triangles in and the outputs out (16 B a pixel)
// takes ~11 us at 3.35 TB/s for 2 x 1024^2 pixels and 32768 triangles, and
// the edge tests of the binned pairs take a few us.  What the kernels pay
// is latency: four dependent launches, and in the raster each pixel's
// serial walk over its tile's list (a box test an entry, the edges for the
// entries whose box holds it, the divisions of a hit), which takes most of
// the time (chip_smoke.py phase 5 prints each kernel's share).
//
// Design: count / scan / fill binning, five operations on the caller's
// stream, nothing allocated here (the caller passes every buffer):
//   0. cudaMemsetAsync zeroes the per-tile counters and the per-view
//      counters of wide triangles.
//   1. `rast_setup_count_kernel`, one thread per triangle: gathers its
//      three clip-space vertices and writes the 16-float record and the
//      screen box of ops/rasterize.py `_setup`, bit for bit (each torch operation
//      there rounds once: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in
//      its order, no contraction to FMA).  From the box it finds the 16x16
//      tiles whose pixel centres the box holds (exactly, in double); a
//      triangle on at most max_bin_tiles tiles adds one to each of their
//      counters.  A triangle of area 0 (padding, behind the eye, a repeated
//      index) has the empty box and counts nothing.
//   2. `rast_scan_kernel`, one block: the exclusive scan of the B x n_tiles
//      counters into list offsets, the total last.
//   3. `rast_fill_kernel`, one thread per triangle: writes its index into
//      each of its tiles' lists, at a slot taken by atomicSub on the tile's
//      counter (which counts down to 0).  A triangle on more than
//      max_bin_tiles tiles goes, once, to its view's list of wide
//      triangles instead.  So the tile lists hold at most max_bin_tiles a
//      triangle and the caller sizes them from B and T alone: no read-back,
//      no overflow, nothing clipped.
//   4. `rast_raster_kernel`, one CTA of 256 threads per tile and view, one
//      thread per pixel: walks the tile's list and then its view's wide
//      list in batches of 256, each thread staging one triangle's edge
//      coefficients (in double: converted once a tile, not once a pixel),
//      area, z, 1/w and box in shared memory by index (no compaction, two
//      barriers a batch); every thread then tests its pixel against the
//      staged boxes and, inside one, evaluates the edges.  A tile with
//      nothing to walk writes misses and exits.  Outputs are written once,
//      coalesced along x.
// The order of a list depends on the atomics, so a hit replaces the
// running best when (z, index) is lexicographically smaller: the plain
// version's rule, whatever the order.  Edge functions are evaluated in
// double with the plain version's two roundings (exact products, so no
// cancellation error near an edge) and tested there as their float
// rounding would test (it rounds |E| <= 2^-150 to a zero); a hit rounds
// them to float, and the barycentrics and z use __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn in the plain version's order.  The two agree bit
// for bit.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns the first CUDA error.

#include <assert.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                  // tile side in pixels
constexpr int kThreads = kTile * kTile;    // one thread per pixel
constexpr int kSetupThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;              // counters per scan thread a round
constexpr float kBig = 1e30f;

// min / max that return NaN if either side is NaN, as torch's amin / amax
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The tiles whose pixel centres (x + 0.5, y + 0.5) the box (xmin, xmax,
// ymin, ymax) holds, clamped to the image: false if none.  x + 0.5 >= xmin
// iff x >= ceil(xmin - 0.5), exact in double for an f32 xmin.
__device__ __forceinline__ bool tile_range(float4 box, int width, int height,
                                           int& tx0, int& tx1, int& ty0,
                                           int& ty1) {
  if (!(box.x <= box.y) || !(box.z <= box.w)) return false;  // empty, NaN
  const double xl = fmax(ceil((double)box.x - 0.5), 0.0);
  const double xh = fmin(floor((double)box.y - 0.5), (double)(width - 1));
  const double yl = fmax(ceil((double)box.z - 0.5), 0.0);
  const double yh = fmin(floor((double)box.w - 0.5), (double)(height - 1));
  if (!(xl <= xh) || !(yl <= yh)) return false;
  tx0 = (int)xl / kTile;
  tx1 = (int)xh / kTile;
  ty0 = (int)yl / kTile;
  ty1 = (int)yh / kTile;
  return true;
}

// Screen coordinates of one vertex, as `_setup`: inv_w = 1 / w_safe,
// sx = (x * inv_w * 0.5 + 0.5) * W, sy likewise with H, sz = z * inv_w.
struct Vert {
  float sx, sy, sz, inv_w;
  bool behind;
};

__device__ __forceinline__ Vert screen(float4 p, float fw, float fh) {
  const float w_safe =
      fabsf(p.w) < 1e-9f ? (p.w < 0.f ? -1e-9f : 1e-9f) : p.w;
  Vert v;
  v.inv_w = __fdiv_rn(1.f, w_safe);
  v.sx = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(p.x, v.inv_w), 0.5f), 0.5f),
                   fw);
  v.sy = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(p.y, v.inv_w), 0.5f), 0.5f),
                   fh);
  v.sz = __fmul_rn(p.z, v.inv_w);
  v.behind = p.w <= 1e-9f;
  return v;
}

// rec: [B][T] records of 16 floats (4 float4):
//   (a0 b0 c0 a1) (b1 c1 a2 b2) (c2 area z0 z1) (z2 w0 w1 w2)
// edge k, opposite vertex k, from `_setup`'s edge(ax, ay, bx, by):
//   a = ay - by, b = bx - ax, c = ax * by - ay * bx
template <typename Idx>
__global__ void __launch_bounds__(kSetupThreads)
rast_setup_count_kernel(const float4* __restrict__ pos,
                        const Idx* __restrict__ tri, int batch, int n_verts,
                        int n_tris, int height, int width, int n_tx,
                        int n_tiles, int max_bin_tiles,
                        float4* __restrict__ rec, float4* __restrict__ box,
                        int* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * kSetupThreads + threadIdx.x;
  if (i >= (long long)batch * n_tris) return;
  const int b = (int)(i / n_tris);
  const Idx* ti = tri + i * 3;
  const long long i0 = (long long)ti[0], i1 = (long long)ti[1],
                  i2 = (long long)ti[2];
  assert(i0 >= 0 && i0 < n_verts && i1 >= 0 && i1 < n_verts && i2 >= 0 &&
         i2 < n_verts);
  const float4* pb = pos + (long long)b * n_verts;
  const float fw = (float)width, fh = (float)height;
  const Vert v0 = screen(pb[i0], fw, fh), v1 = screen(pb[i1], fw, fh),
             v2 = screen(pb[i2], fw, fh);
  const bool bad = v0.behind || v1.behind || v2.behind || i0 == i1 ||
                   i1 == i2 || i0 == i2;
  // edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), edge(x0, y0, x1, y1)
  const float a0 = __fsub_rn(v1.sy, v2.sy), b0 = __fsub_rn(v2.sx, v1.sx);
  const float c0 = __fsub_rn(__fmul_rn(v1.sx, v2.sy), __fmul_rn(v1.sy, v2.sx));
  const float a1 = __fsub_rn(v2.sy, v0.sy), b1 = __fsub_rn(v0.sx, v2.sx);
  const float c1 = __fsub_rn(__fmul_rn(v2.sx, v0.sy), __fmul_rn(v2.sy, v0.sx));
  const float a2 = __fsub_rn(v0.sy, v1.sy), b2 = __fsub_rn(v1.sx, v0.sx);
  const float c2 = __fsub_rn(__fmul_rn(v0.sx, v1.sy), __fmul_rn(v0.sy, v1.sx));
  float area = __fadd_rn(__fadd_rn(__fmul_rn(a2, v2.sx), __fmul_rn(b2, v2.sy)),
                         c2);
  if (bad || fabsf(area) <= 1e-12f) area = 0.f;
  float4* r = rec + i * 4;
  r[0] = make_float4(a0, b0, c0, a1);
  r[1] = make_float4(b1, c1, a2, b2);
  r[2] = make_float4(c2, area, v0.sz, v1.sz);
  r[3] = make_float4(v2.sz, v0.inv_w, v1.inv_w, v2.inv_w);
  const float4 bx =
      area == 0.f
          ? make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY)
          : make_float4(nan_min(nan_min(v0.sx, v1.sx), v2.sx),
                        nan_max(nan_max(v0.sx, v1.sx), v2.sx),
                        nan_min(nan_min(v0.sy, v1.sy), v2.sy),
                        nan_max(nan_max(v0.sy, v1.sy), v2.sy));
  box[i] = bx;
  int tx0, tx1, ty0, ty1;
  if (!tile_range(bx, width, height, tx0, tx1, ty0, ty1)) return;
  if ((tx1 - tx0 + 1) * (ty1 - ty0 + 1) > max_bin_tiles) return;  // wide
  int* cb = counts + (long long)b * n_tiles;
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) atomicAdd(cb + ty * n_tx + tx, 1);
  }
}

// start[i] = counts[0] + ... + counts[i - 1] for i < n, start[n] = the total.
// One block walks the counters in rounds of kScanThreads * kScanItems, each
// thread summing its kScanItems neighbours, a warp scan of those sums and a
// scan of the warps' totals, plus the carry of the rounds before.
__global__ void __launch_bounds__(kScanThreads)
rast_scan_kernel(const int* __restrict__ counts, int* __restrict__ start,
                 int n) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads * kScanItems) {
    const int first = base + threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = first + j < n ? counts[first + j] : 0;
      sum += v[j];
    }
    int incl = sum;                          // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {                         // scan of the warps' totals
      int w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += o;
      }
      s_warp[lane] = w;                      // inclusive
    }
    __syncthreads();
    int run = s_carry + (warp > 0 ? s_warp[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (first + j < n) start[first + j] = run;
      run += v[j];
    }
    __syncthreads();                         // every thread read s_carry
    if (threadIdx.x == 0) s_carry += s_warp[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) start[n] = s_carry;
}

__global__ void __launch_bounds__(kSetupThreads)
rast_fill_kernel(const float4* __restrict__ box, int batch, int n_tris,
                 int height, int width, int n_tx, int n_tiles,
                 int max_bin_tiles, const int* __restrict__ start,
                 int* __restrict__ counts,
                 int* __restrict__ wide_count, int* __restrict__ pairs,
                 int* __restrict__ wide) {
  const long long i = (long long)blockIdx.x * kSetupThreads + threadIdx.x;
  if (i >= (long long)batch * n_tris) return;
  const int b = (int)(i / n_tris), t = (int)(i % n_tris);
  int tx0, tx1, ty0, ty1;
  if (!tile_range(box[i], width, height, tx0, tx1, ty0, ty1)) return;
  if ((tx1 - tx0 + 1) * (ty1 - ty0 + 1) > max_bin_tiles) {
    wide[(long long)b * n_tris + atomicAdd(wide_count + b, 1)] = t;
    return;
  }
  const long long tb = (long long)b * n_tiles;
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) {
      const long long tile = tb + ty * n_tx + tx;
      pairs[start[tile] + atomicSub(counts + tile, 1) - 1] = t;
    }
  }
}

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// E(p) = a px + b py + c in double: the plain version's
// (px * a + py * b) + c with both products exact in double (floats), so
// the fma rounds their sum once, as the add of the two products does.
__device__ __forceinline__ double edge_d(double px, double py, double a,
                                         double b, double c) {
  return __dadd_rn(__fma_rn(px, a, __dmul_rn(py, b)), c);
}

// One triangle's edge coefficients as the raster walks them, staged in
// shared memory in double: converted once a tile, not once a pixel.
struct Staged {
  double2 e[5];       // (a0 b0) (c0 a1) (b1 c1) (a2 b2) (c2 -)
};

__global__ void __launch_bounds__(kThreads)
rast_raster_kernel(const float4* __restrict__ rec,
                   const float4* __restrict__ box,
                   const int* __restrict__ start,
                   const int* __restrict__ wide_count,
                   const int* __restrict__ pairs, const int* __restrict__ wide,
                   const float* __restrict__ prev_z, int n_tris, int height,
                   int width, int n_tx, int n_tiles,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   float* __restrict__ out_z, int* __restrict__ out_id) {
  __shared__ Staged s_tri[kThreads];
  __shared__ float4 s_box[kThreads];
  __shared__ float4 s_az[kThreads];       // (area, z0, z1, z2)
  __shared__ float4 s_w[kThreads];        // (1/w0, 1/w1, 1/w2, index)

  const int b = blockIdx.y;
  const long long tile = (long long)b * n_tiles + blockIdx.x;
  const int x = (blockIdx.x % n_tx) * kTile + (int)threadIdx.x % kTile;
  const int y = (blockIdx.x / n_tx) * kTile + (int)threadIdx.x / kTile;
  const bool in_image = x < width && y < height;
  const size_t pix = ((size_t)b * height + y) * width + x;
  const int first = start[tile];
  const int n_bin = start[tile + 1] - first;
  const int total = n_bin + wide_count[b];

  float best_z = kBig, best_u = 0.f, best_v = 0.f;
  int best_t = INT32_MAX;
  if (total > 0) {                          // the same for the whole block
    const float px = (float)x + 0.5f, py = (float)y + 0.5f;
    const double dpx = px, dpy = py;
    // (float)d >= 0 iff d >= -2^-150: smaller magnitudes round to -0
    const double tiny = 7.006492321624085e-46;     // 2^-150
    const bool peel = prev_z != nullptr;
    float z_floor = 0.f;
    if (peel && in_image) z_floor = __fadd_rn(prev_z[pix], 1e-6f);
    const int* wide_b = wide + (long long)b * n_tris;
    const float4* rec_b = rec + (long long)b * n_tris * 4;
    const float4* box_b = box + (long long)b * n_tris;
    for (int base = 0; base < total; base += kThreads) {
      const int j = base + (int)threadIdx.x;
      if (j < total) {                      // stage one triangle
        const int t = j < n_bin ? pairs[first + j] : wide_b[j - n_bin];
        const float4* r = rec_b + (long long)t * 4;
        const float4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3];
        const float area = r2.y;
        Staged& st = s_tri[threadIdx.x];
        st.e[0] = make_double2(r0.x, r0.y);
        st.e[1] = make_double2(r0.z, r0.w);
        st.e[2] = make_double2(r1.x, r1.y);
        st.e[3] = make_double2(r1.z, r1.w);
        st.e[4] = make_double2(r2.x, 0.0);
        // a zero or NaN area covers nothing: the empty box skips it
        s_box[threadIdx.x] =
            (area > 0.f || area < 0.f)
                ? box_b[t]
                : make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
        s_az[threadIdx.x] = make_float4(area, r2.z, r2.w, r3.x);
        s_w[threadIdx.x] = make_float4(r3.y, r3.z, r3.w, __int_as_float(t));
      }
      __syncthreads();
      const int n = min(kThreads, total - base);
      if (in_image) {
        for (int k = 0; k < n; ++k) {
          const float4 bb = s_box[k];
          if (!(px >= bb.x && px <= bb.y && py >= bb.z && py <= bb.w)) {
            continue;
          }
          const Staged& st = s_tri[k];
          const double2 q0 = st.e[0], q1 = st.e[1], q2 = st.e[2];
          const double2 q3 = st.e[3], q4 = st.e[4];
          const double d0 = edge_d(dpx, dpy, q0.x, q0.y, q1.x);
          const double d1 = edge_d(dpx, dpy, q1.y, q2.x, q2.y);
          const double d2 = edge_d(dpx, dpy, q3.x, q3.y, q4.x);
          // the plain version's test on the rounded edges, in double: every
          // edge with the sign of the area (the same for the whole block)
          const float4 az = s_az[k];
          const bool inside =
              az.x > 0.f ? (d0 >= -tiny && d1 >= -tiny && d2 >= -tiny)
                         : (d0 <= tiny && d1 <= tiny && d2 <= tiny);
          if (!inside) continue;
          const float4 wi = s_w[k];
          const float e0 = __double2float_rn(d0), e1 = __double2float_rn(d1);
          const float su = __fdiv_rn(e0, az.x);
          const float sv = __fdiv_rn(e1, az.x);
          const float sw = __fsub_rn(__fsub_rn(1.f, su), sv);
          float denom = dot3(su, wi.x, sv, wi.y, sw, wi.z);
          if (fabsf(denom) < 1e-12f) denom = 1e-12f;
          const float pu = __fdiv_rn(__fmul_rn(su, wi.x), denom);
          const float pv = __fdiv_rn(__fmul_rn(sv, wi.y), denom);
          const float pw = __fsub_rn(__fsub_rn(1.f, pu), pv);
          const float z = dot3(pu, az.y, pv, az.z, pw, az.w);
          if (peel && !(z > z_floor)) continue;
          const int t = __float_as_int(wi.w);
          if (z < kBig && (z < best_z || (z == best_z && t < best_t))) {
            best_z = z;
            best_u = pu;
            best_v = pv;
            best_t = t;
          }
        }
      }
      __syncthreads();                      // the batch is restaged next
    }
  }
  if (in_image) {
    const bool hit = best_t != INT32_MAX;
    out_u[pix] = best_u;
    out_v[pix] = best_v;
    out_z[pix] = hit ? best_z : 0.f;
    out_id[pix] = hit ? best_t + 1 : 0;
  }
}

}  // namespace

extern "C" {

// pos: (B, V, 4) f32, 16-byte aligned; tri: (B, T, 3) int32 (tri_int64 = 0)
// or int64; prev_z: (B, H, W) f32 or null.  Buffers, all caller-given:
// rec (B, T, 16) f32 and box (B, T, 4) f32, 16-byte aligned; counts int32
// of B * n_tiles + B (the tile counters, then the views' wide counters);
// start int32 of B * n_tiles + 1; pairs int32 of B * T * max_bin_tiles;
// wide int32 of B * T.  n_tiles = ceil(W / 16) * ceil(H / 16).  A triangle
// on more than max_bin_tiles tiles goes to its view's wide list.  Outputs:
// out_uvz (3, B, H, W) f32, out_id (B, H, W) int32.
int rast_forward(const void* pos, const void* tri, int tri_int64,
                 const void* prev_z, int batch, int n_verts, int n_tris,
                 int height, int width, int max_bin_tiles, void* rec,
                 void* box, int* counts,
                 int* start, int* pairs, int* wide, void* out_uvz,
                 void* out_id, void* stream) {
  const int n_tx = (width + kTile - 1) / kTile;
  const int n_ty = (height + kTile - 1) / kTile;
  if (batch <= 0 || batch > 65535 || n_tx <= 0 || n_ty <= 0 || n_tris < 0 ||
      n_verts <= 0 || max_bin_tiles <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = n_tx * n_ty;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* pos4 = static_cast<const float4*>(pos);
  float4* rec4 = static_cast<float4*>(rec);
  float4* box4 = static_cast<float4*>(box);
  int* wide_count = counts + (long long)batch * n_tiles;
  cudaError_t e = cudaMemsetAsync(
      counts, 0, ((size_t)batch * n_tiles + batch) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)batch * n_tris;
  const unsigned blocks = (unsigned)((n + kSetupThreads - 1) / kSetupThreads);
  if (n > 0) {
    if (tri_int64) {
      rast_setup_count_kernel<long long><<<blocks, kSetupThreads, 0, s>>>(
          pos4, static_cast<const long long*>(tri), batch, n_verts, n_tris,
          height, width, n_tx, n_tiles, max_bin_tiles, rec4, box4, counts);
    } else {
      rast_setup_count_kernel<int><<<blocks, kSetupThreads, 0, s>>>(
          pos4, static_cast<const int*>(tri), batch, n_verts, n_tris, height,
          width, n_tx, n_tiles, max_bin_tiles, rec4, box4, counts);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rast_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, start, batch * n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    rast_fill_kernel<<<blocks, kSetupThreads, 0, s>>>(
        box4, batch, n_tris, height, width, n_tx, n_tiles, max_bin_tiles,
        start, counts, wide_count, pairs, wide);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t plane = (size_t)batch * height * width;
  float* uvz = static_cast<float*>(out_uvz);
  const dim3 grid((unsigned)n_tiles, (unsigned)batch);
  rast_raster_kernel<<<grid, kThreads, 0, s>>>(
      rec4, box4, start, wide_count, pairs, wide,
      static_cast<const float*>(prev_z), n_tris, height, width, n_tx, n_tiles,
      uvz, uvz + plane, uvz + 2 * plane, static_cast<int*>(out_id));
  return (int)cudaGetLastError();
}

}  // extern "C"
