// K4: tile rasterizer over a batch of views.
//
// Replaces: unirenderer_tpu/ops/rasterize_pallas.py `_make_kernel` (reached
// through `rasterize_pallas`), the Pallas TPU kernel that walks, per
// 1x1024-pixel row tile, a compacted list of 256-triangle chunks whose
// screen box overlaps the tile and keeps the nearest hit per pixel.  It in
// turn stands in for nvdiffrast's `dr.rasterize`.
//
// What it computes, per pixel centre (x + 0.5, y + 0.5), y down: for every
// triangle with area != 0 whose three edge functions all have the sign of
// its area there, and whose screen box holds the centre (which keeps an
// f32 sliver from covering pixels far off it, whatever the binning),
// perspective-correct barycentrics (u, v) and z; it keeps the
// lexicographic minimum of (z, triangle index) over those hits (and, with
// prev_z, over hits with z > prev_z + 1e-6), and writes (u, v, z, index+1),
// all zero on a miss.  The per-triangle set-up (16-float records, screen
// boxes, chunk boxes) is computed by the caller in torch, as the JAX code
// computes it outside its pallas_call.
//
// What bounds it on an H100: at the collate's shapes neither bytes nor
// arithmetic.  Moving the records in (64 B a triangle) and the outputs out
// (16 B a pixel) takes ~11 us at 3.35 TB/s for 2 x 1024^2 pixels and 32768
// triangles, and the edge tests the bins imply (12 f64 operations each, at
// 34 TFLOP/s outside the tensor cores) take a few us.  What a simple kernel
// pays is latency: the serial walk over chunk lists, block-wide
// compactions and __syncthreads between them.
//
// Design:
//   * One CTA of 256 threads per 16x16-pixel tile and view (grid: tiles x
//     B), one thread per pixel.  A 1x1024 row tile suits the TPU's lanes,
//     not an SM: a square tile culls more triangles per pixel.
//   * Binning happens in the CTA: its threads test the chunk boxes against
//     the tile (256 at a time) and compact the survivors, in order, into
//     shared memory with a ballot and a per-warp prefix.  For each
//     surviving chunk they test its 256 triangle boxes the same way and
//     stage the survivors' 16-float records in shared memory; every thread
//     then walks the staged records for its pixel.  Empty-box (degenerate
//     or padding) triangles never survive.  No global scratch, one launch.
//   * Chunks and staged triangles are walked in increasing index and a hit
//     replaces the running best only when strictly nearer, so the running
//     (z, id, u, v) in registers is the lexicographic (z, index) minimum,
//     whatever the bins hold.  Outputs are written once, coalesced along x.
//   * Edge functions are evaluated in double and rounded once to float
//     (exact products, so no cancellation error near an edge); the
//     barycentrics and z use __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn
//     in the plain version's order.  With explicit rounding everywhere no
//     FMA contraction can move a silhouette pixel against the plain
//     version: the two agree bit for bit.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                  // tile side in pixels
constexpr int kThreads = kTile * kTile;    // one thread per pixel
constexpr int kChunk = 256;                // triangles per chunk (= threads)
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;

// box = (xmin, xmax, ymin, ymax); an empty box is (inf, -inf, inf, -inf)
__device__ __forceinline__ bool box_hits_tile(float4 box, float x0,
                                              float y0) {
  return box.x < x0 + kTile && box.y > x0 && box.z < y0 + kTile &&
         box.w > y0;
}

// Ordered block-wide compaction: each thread passes a flag; returns the
// thread's slot among the flagged ones (in thread order) or -1, and the
// number flagged in *total.  Every thread of the block must call it.
__device__ __forceinline__ int compact_slot(bool flag, int* s_warp,
                                            int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int base = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    base += (w < warp) ? c : 0;
    sum += c;
  }
  *total = sum;
  __syncthreads();                          // s_warp is reused next call
  return flag ? base + __popc(m & ((1u << lane) - 1u)) : -1;
}

// E(p) = a px + b py + c in double, rounded once to float: the products of
// floats are exact in double, so cancellation near an edge costs nothing.
__device__ __forceinline__ float edge_fn(float px, float py, float a,
                                         float b, float c) {
  const double s = __dadd_rn(__dmul_rn((double)px, (double)a),
                             __dmul_rn((double)py, (double)b));
  return __double2float_rn(__dadd_rn(s, (double)c));
}

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// rec: [B][T] records of 16 floats (4 float4):
//   (a0 b0 c0 a1) (b1 c1 a2 b2) (c2 area z0 z1) (z2 w0 w1 w2)
__global__ void __launch_bounds__(kThreads)
rast_tile_kernel(const float4* __restrict__ rec,
                 const float4* __restrict__ box,
                 const float4* __restrict__ cbox,
                 const float* __restrict__ prev_z, int n_tris,
                 int n_chunks, int height, int width, int n_tx,
                 float* __restrict__ out_u, float* __restrict__ out_v,
                 float* __restrict__ out_z, int* __restrict__ out_id) {
  __shared__ float4 s_rec[kChunk * 4];
  __shared__ float4 s_box[kChunk];
  __shared__ int s_idx[kChunk];
  __shared__ int s_chunk[kThreads];
  __shared__ int s_warp[kWarps];

  const int b = blockIdx.y;
  const int tx0 = (blockIdx.x % n_tx) * kTile;
  const int ty0 = (blockIdx.x / n_tx) * kTile;
  const int x = tx0 + (int)threadIdx.x % kTile;
  const int y = ty0 + (int)threadIdx.x / kTile;
  const bool in_image = x < width && y < height;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float fx0 = (float)tx0, fy0 = (float)ty0;
  const size_t pix = ((size_t)b * height + y) * width + x;
  const bool peel = prev_z != nullptr;
  float z_floor = 0.f;
  if (peel && in_image) z_floor = __fadd_rn(prev_z[pix], 1e-6f);

  const float4* rec_b = rec + (size_t)b * n_tris * 4;
  const float4* box_b = box + (size_t)b * n_tris;
  const float4* cbox_b = cbox + (size_t)b * n_chunks;

  float best_z = kBig, best_u = 0.f, best_v = 0.f;
  int best_id = 0;

  for (int g = 0; g < n_chunks; g += kThreads) {
    const int ci = g + (int)threadIdx.x;
    int n_live_chunks;
    const int cslot = compact_slot(
        ci < n_chunks && box_hits_tile(cbox_b[ci], fx0, fy0), s_warp,
        &n_live_chunks);
    if (cslot >= 0) s_chunk[cslot] = ci;
    __syncthreads();
    for (int j = 0; j < n_live_chunks; ++j) {
      const int t = s_chunk[j] * kChunk + (int)threadIdx.x;
      const float4 tbox = t < n_tris ? box_b[t] : make_float4(0, 0, 0, 0);
      int n_live;
      const int slot = compact_slot(
          t < n_tris && box_hits_tile(tbox, fx0, fy0), s_warp, &n_live);
      if (slot >= 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s_rec[slot * 4 + k] = rec_b[t * 4 + k];
        s_box[slot] = tbox;
        s_idx[slot] = t;
      }
      __syncthreads();
      if (in_image) {
        for (int k = 0; k < n_live; ++k) {
          const float4 r0 = s_rec[k * 4 + 0], r1 = s_rec[k * 4 + 1];
          const float4 r2 = s_rec[k * 4 + 2], r3 = s_rec[k * 4 + 3];
          const float area = r2.y;
          const float e0 = edge_fn(px, py, r0.x, r0.y, r0.z);
          const float e1 = edge_fn(px, py, r0.w, r1.x, r1.y);
          const float e2 = edge_fn(px, py, r1.z, r1.w, r2.x);
          const float4 bb = s_box[k];
          const bool inside =
              ((e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && area > 0.f) ||
               (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f && area < 0.f)) &&
              px >= bb.x && px <= bb.y && py >= bb.z && py <= bb.w;
          if (!inside) continue;
          const float su = __fdiv_rn(e0, area);
          const float sv = __fdiv_rn(e1, area);
          const float sw = __fsub_rn(__fsub_rn(1.f, su), sv);
          float denom = dot3(su, r3.y, sv, r3.z, sw, r3.w);
          if (fabsf(denom) < 1e-12f) denom = 1e-12f;
          const float pu = __fdiv_rn(__fmul_rn(su, r3.y), denom);
          const float pv = __fdiv_rn(__fmul_rn(sv, r3.z), denom);
          const float pw = __fsub_rn(__fsub_rn(1.f, pu), pv);
          const float z = dot3(pu, r2.z, pv, r2.w, pw, r3.x);
          if (peel && !(z > z_floor)) continue;
          if (z < best_z) {
            best_z = z;
            best_u = pu;
            best_v = pv;
            best_id = s_idx[k] + 1;
          }
        }
      }
      __syncthreads();                      // s_rec is restaged next chunk
    }
  }
  if (in_image) {
    out_u[pix] = best_u;
    out_v[pix] = best_v;
    out_z[pix] = best_id ? best_z : 0.f;
    out_id[pix] = best_id;
  }
}

}  // namespace

extern "C" int rast_forward(const void* rec, const void* box,
                            const void* cbox, const void* prev_z, int batch,
                            int n_tris, int n_chunks, int height, int width,
                            void* out_uvz, void* out_id, void* stream) {
  const int n_tx = (width + kTile - 1) / kTile;
  const int n_ty = (height + kTile - 1) / kTile;
  if (batch <= 0 || batch > 65535 || n_tx <= 0 || n_ty <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)batch * height * width;
  float* uvz = static_cast<float*>(out_uvz);
  dim3 grid((unsigned)(n_tx * n_ty), (unsigned)batch);
  rast_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(rec), static_cast<const float4*>(box),
      static_cast<const float4*>(cbox), static_cast<const float*>(prev_z),
      n_tris, n_chunks, height, width, n_tx, uvz, uvz + plane,
      uvz + 2 * plane, static_cast<int*>(out_id));
  return (int)cudaGetLastError();
}
