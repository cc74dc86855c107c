// K3: the unet_flash attention route, non-causal attention forward, bf16 in
// / bf16 out, warp-specialised for Hopper.
//
// Replaces: unirenderer_tpu/ops/attn_kernel.py `_kernel` (via
// `unet_flash_attention`), the TPU's forward-only kernel for the UNet's
// self-attention, reached under UNIRENDER_ATTN=unet_flash for the tileable
// shapes ((B, 4096, 8, 40) and (B, 1024, 8, 80) at the flagship widths).
//
// What it computes, as the TPU kernel did: Q pre-scaled in Q's type,
// bf16(q * bf16(softmax_scale * log2(e))) (attn_kernel.py:132; here while Q
// is staged, so the route is one launch), the softmax as exp2(s - m) of the
// f32 scores, P rounded to bf16 for P V.  `running_max` false drops the row
// max and the accumulator rescale: p = exp2(s), exact while the scaled
// logits stay below ~126 (f32 exp2 overflows at 2^128).
//
// What bounds it on an H100: its floor at D = 40 is the exponentials.
// Each score costs 4 D = 160 tensor-core operations and one exp2; the
// tensor cores do 989e12 operations a second, the special-function unit
// (MUFU) 16 exp2 per clock per SM (~4e12 a second), so below D ~ 64 the
// exp2 unit, not the tensor cores, sets the floor.  The TPU kernel's
// docstring names the same resource.  What the design does about it:
//   * warp specialisation: one producer warp keeps TMA loads of K and V
//     tiles in flight into a ring of kStages slots (full and empty
//     mbarriers per slot; no block-wide barrier in the loop), and two
//     consumer warpgroups of 64 query rows each compute on the slots that
//     have landed.  setmaxnreg moves registers from the producer to them.
//   * ping-pong: a pair of named barriers lets one consumer warpgroup issue
//     its products (wgmma) only while the other runs its softmax, so one's
//     exp2 overlaps the other's tensor-core work.
//   * `pipelined`: within a warpgroup, S of tile j is issued together with
//     P V of tile j-1, and the softmax of tile j runs while that P V does
//     (the JAX kernel's overlap of block j's QK^T with block j-1's update).
//     Unpipelined, S, softmax and P V run in sequence in the warpgroup.
//     Every wgmma group is retired before a loop's back edge, and masks are
//     selects, so ptxas does not serialise the wgmmas.
// Measured, the K/V loads from L2 bound it before the exp2 unit does (all
// 32 query tiles of a head stream the head's K and V), so every exp2 runs
// on the MUFU unit: taking a quarter of them onto the FMA pipe by a
// polynomial made it no faster at any main-path shape.
//
// Shared-memory layout and the tensor maps.  wgmma reads its B operand
// from shared memory either without swizzle, in 8 x 8 core matrices of 16-
// byte rows, or swizzled in atoms of 8 rows of 32, 64 or 128 bytes.  D = 40
// or 80 fills no 64- or 128-byte row (D would be padded to 64 or 128, a
// third or more of the products wasted), and 16-byte rows make the TMA
// fetch twice as many pieces as 32-byte ones, which on the H100 made the
// loads, not the products, the bound.  So the tensor map is (D, S, H, B)
// over the (B, S, H, D) strides with a box of (16, BN, 1, 1) and the
// 32-byte swizzle, and a K or V tile is DP / 16 such boxes side by side:
// key r, column group c (16 elements) at byte c * BN * 32 + r * 32,
// swizzled within 256-byte atoms.  K is read K-major for S = Q K^T (one
// box a k-step; SBO 256: next 8 keys); V MN-major, i.e. transposed by its
// descriptor, for O += P V (LBO BN * 32: next 16 of D; SBO 256: next 8
// keys).  D is padded to DP (a multiple of 16) by the box reaching past D,
// keys past Sk by the box reaching past S: the TMA fills both with zeros,
// and nothing is copied or transposed in device memory.  A zero key gives
// a score of 0, not -inf, so the last tile masks keys past Sk by selects.
// The two maps are encoded on the host at every call (a host function of
// the driver, reached through the runtime's entry-point query so the
// library links only the runtime).
//
// Q is read by the consumers straight into their wgmma A fragments (16
// rows a warp, once per block), scaled by qscale and rounded to bf16 in
// registers; rows past Sq are zero and never written.
//
// Interface: plain C, no PyTorch headers.  The launcher allocates nothing,
// launches on the caller's stream and returns cudaGetLastError() (or the
// encoder's failure as cudaErrorInvalidValue).

#include <cuda.h>
#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "tma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace attn;

constexpr int kBM = 128;                 // query rows per block
constexpr int kThreads = 384;            // producer warpgroup + 2 consumers
constexpr int kConsumers = 256;          // threads of the two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int DP>
struct Cfg {
  static constexpr int BN = DP <= 96 ? 128 : 64;     // keys per tile
  static constexpr int kTileBytes = BN * DP * 2;     // one K or V tile
  static constexpr int kStages = 4;                  // K/V ring depth
  static constexpr int kSmemBytes =
      2 * kStages * kTileBytes + 4 * kStages * 8 + 1024;  // + barriers, align
};

template <int DP, bool kPipelined, bool kRunningMax>
__global__ void __launch_bounds__(kThreads, 1)
unet_flash_kernel(const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const bf16* __restrict__ q, bf16* __restrict__ o,
                  int heads, int sq, int sk, int d, long long q_sb,
                  long long q_ss, long long q_sh, long long o_sb,
                  long long o_ss, long long o_sh, float qscale) {
  constexpr int BN = Cfg<DP>::BN;
  constexpr int KD = DP / 16;        // MMA k-steps over D
  constexpr int ND = DP / 8;         // 8-wide output column blocks
  constexpr int NN = BN / 8;         // 8-wide score column blocks
  constexpr int TILE = BN * DP;      // elements of a K or V tile
  constexpr int kStages = Cfg<DP>::kStages;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* sK = reinterpret_cast<bf16*>(base);             // kStages tiles
  bf16* sV = sK + kStages * TILE;                       // kStages tiles
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sV + kStages * TILE);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, kConsumers / 32);   // one arrival a warp
      mbar_init(empty_v + s, kConsumers / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        mbar_wait(empty_k + s, ph ^ 1);
        mbar_expect_tx(full_k + s, Cfg<DP>::kTileBytes);
#pragma unroll
        for (int c = 0; c < KD; ++c) {
          tma_load_4d(sK + s * TILE + c * BN * 16, &tmk, full_k + s, c * 16,
                      j * BN, h, b);
        }
        mbar_wait(empty_v + s, ph ^ 1);
        mbar_expect_tx(full_v + s, Cfg<DP>::kTileBytes);
#pragma unroll
        for (int c = 0; c < KD; ++c) {
          tma_load_4d(sV + s * TILE + c * BN * 16, &tmv, full_v + s, c * 16,
                      j * BN, h, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
    regs_alloc<kConsumerRegs>();
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + g, row1 = row0 + 8;

    // Q's A fragments, staged as bf16(q * qscale)
    uint32_t qf[KD][4];
    {
      const bf16* qb = q + b * q_sb + h * q_sh;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int row = (jj & 1) ? row1 : row0;
          const int col = kk * 16 + t4 * 2 + (jj >> 1) * 8;
          uint32_t val = 0;
          if (row < sq && col < d) val = ld32(qb + row * q_ss + col);
          qf[kk][jj] = scale_bf16x2(val, qscale);
        }
      }
    }

    float s[NN][4];                  // the scores of the current tile
    uint32_t pa[BN / 16][4];         // P of the last softmax, A fragments
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    float m_run[2] = {-INFINITY, -INFINITY};   // log2 units
    float l_run[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};               // the last rescale of O

    // ping-pong: warpgroup cw issues its products after bar.sync on
    // barrier 1 + cw, and then lets the other warpgroup go
    auto my_turn = [&]() { named_sync(1 + cw, kConsumers); };
    auto your_turn = [&]() { named_arrive(2 - cw, kConsumers); };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto wait_k = [&](int j) {
      mbar_wait(full_k + j % kStages, (j / kStages) & 1);
    };
    auto wait_v = [&](int j) {
      mbar_wait(full_v + j % kStages, (j / kStages) & 1);
    };
    // S = Q K^T of tile j (64 x BN a warpgroup), one group
    auto issue_scores = [&](int j) {
      const bf16* tk = sK + (j % kStages) * TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_m64k16<BN, 0>(s, qf[kk],
                            smem_desc_sw32(tk + kk * BN * 16, 16, 256),
                            kk > 0);
      }
      wgmma_commit();
    };
    // O = alpha * O + P V of tile j (O + P V without the running max), one
    // group
    auto issue_pv = [&](int j) {
      if constexpr (kRunningMax) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
      }
      const bf16* tv = sV + (j % kStages) * TILE;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        wgmma_m64k16<DP, 1>(acc, pa[kc],
                            smem_desc_sw32(tv + kc * 256, BN * 32, 256), 1);
      }
      wgmma_commit();
    };
    // the softmax of tile j's finished scores, in place (log2 units); this
    // thread holds rows g (s[.][0..1]) and g + 8 (s[.][2..3]).  kMask: keys
    // past Sk to -inf by selects.
    auto softmax = [&](int j, auto mask_tag) {
      constexpr bool kMask = decltype(mask_tag)::value;
      fence_operands(s);
      if constexpr (kMask) {
#pragma unroll
        for (int nt = 0; nt < NN; ++nt) {
          const int col = j * BN + nt * 8 + t4 * 2;
          s[nt][0] = col < sk ? s[nt][0] : -INFINITY;
          s[nt][2] = col < sk ? s[nt][2] : -INFINITY;
          s[nt][1] = col + 1 < sk ? s[nt][1] : -INFINITY;
          s[nt][3] = col + 1 < sk ? s[nt][3] : -INFINITY;
        }
      }
      float mx0 = 0.f, mx1 = 0.f;
      if constexpr (kRunningMax) {
        mx0 = m_run[0];
        mx1 = m_run[1];
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
        alpha[0] = fast_exp2(m_run[0] - mx0);
        alpha[1] = fast_exp2(m_run[1] - mx1);
        m_run[0] = mx0;
        m_run[1] = mx1;
      }
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NN; ++nt) {
        s[nt][0] = fast_exp2(s[nt][0] - mx0);
        s[nt][1] = fast_exp2(s[nt][1] - mx0);
        s[nt][2] = fast_exp2(s[nt][2] - mx1);
        s[nt][3] = fast_exp2(s[nt][3] - mx1);
        rs0 += s[nt][0] + s[nt][1];
        rs1 += s[nt][2] + s[nt][3];
      }
      if constexpr (kRunningMax) {
        l_run[0] = l_run[0] * alpha[0] + rs0;   // partial: own columns
        l_run[1] = l_run[1] * alpha[1] + rs1;
      } else {
        l_run[0] += rs0;
        l_run[1] += rs1;
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
    };
    using Mask = std::true_type;
    using NoMask = std::false_type;

    // The ping-pong's turns: warpgroup 0 goes first; each warpgroup takes
    // as many turns as the other, and warpgroup 1 skips its last hand-over
    // so that no arrival is left on barrier 1 when the block ends.
    if (cw == 0) named_arrive(1, kConsumers);
    if (kPipelined) {
      // tile 0: S and its softmax (masked: it may be the last tile)
      wait_k(0);
      my_turn();
      issue_scores(0);
      your_turn();
      wgmma_wait<0>();
      release(empty_k);
      softmax(0, Mask());
      pack_p();
      // tile j: S of tile j with P V of tile j-1; the softmax of tile j
      // runs while P V does; nothing in flight across iterations
      auto step = [&](int j, auto mask_tag) {
        wait_k(j);
        my_turn();
        issue_scores(j);
        wait_v(j - 1);
        issue_pv(j - 1);
        your_turn();
        wgmma_wait<1>();               // S of tile j is done
        release(empty_k + j % kStages);
        softmax(j, mask_tag);
        wgmma_wait<0>();               // P V of tile j-1 is done
        fence_operands(acc);
        release(empty_v + (j - 1) % kStages);
        pack_p();
      };
      for (int j = 1; j < n_tiles - 1; ++j) step(j, NoMask());
      if (n_tiles > 1) step(n_tiles - 1, Mask());
      wait_v(n_tiles - 1);
      my_turn();
      issue_pv(n_tiles - 1);
      if (cw == 0) your_turn();
      wgmma_wait<0>();
      fence_operands(acc);
    } else {
      // S, softmax and P V of tile j in sequence
      auto step = [&](int j, auto mask_tag, bool last) {
        wait_k(j);
        my_turn();
        issue_scores(j);
        your_turn();
        wgmma_wait<0>();
        release(empty_k + j % kStages);
        softmax(j, mask_tag);
        pack_p();
        wait_v(j);
        my_turn();
        issue_pv(j);
        if (!last || cw == 0) your_turn();
        wgmma_wait<0>();
        fence_operands(acc);
        release(empty_v + j % kStages);
      };
      for (int j = 0; j < n_tiles - 1; ++j) step(j, NoMask(), false);
      step(n_tiles - 1, Mask(), true);
    }

    // ---- normalise and write (B, S, H, D)
    float l0 = l_run[0], l1 = l_run[1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // packed before any divergent store touches them
    uint32_t out[ND][2];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      out[n][0] = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
      out[n][1] = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + t4 * 2;
      if (col < d) {
        if (row0 < sq) {
          *reinterpret_cast<uint32_t*>(ob + row0 * o_ss + col) = out[n][0];
        }
        if (row1 < sq) {
          *reinterpret_cast<uint32_t*>(ob + row1 * o_ss + col) = out[n][1];
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no driver library of its own.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of one (B, S, H, D) operand: dims (D, S, H, B), box (16, BN, 1,
// 1) with the 32-byte swizzle; element strides (batch, seq, head).
bool encode_map(CUtensorMap* map, const bf16* base, int batch, int heads,
                int seq, int d, long long sb, long long ss, long long sh,
                int bn) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {16, (cuuint32_t)bn, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<bf16*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, bool kPipelined, bool kRunningMax>
int launch3(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
            int heads, int sq, int sk, int d, const long long* st,
            float qscale, cudaStream_t stream) {
  constexpr int BN = Cfg<DP>::BN;
  constexpr int smem = Cfg<DP>::kSmemBytes;
  auto kernel = unet_flash_kernel<DP, kPipelined, kRunningMax>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tmk, tmv;
  if (!encode_map(&tmk, k, batch, heads, sk, d, st[3], st[4], st[5], BN) ||
      !encode_map(&tmv, v, batch, heads, sk, d, st[6], st[7], st[8], BN)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((sq + kBM - 1) / kBM, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      tmk, tmv, q, o, heads, sq, sk, d, st[0], st[1], st[2], st[9], st[10],
      st[11], qscale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
           int heads, int sq, int sk, int d, const long long* st,
           float qscale, int pipelined, int running_max,
           cudaStream_t stream) {
#define K3_ARGS q, k, v, o, batch, heads, sq, sk, d, st, qscale, stream
  if (pipelined) {
    return running_max ? launch3<DP, true, true>(K3_ARGS)
                       : launch3<DP, true, false>(K3_ARGS);
  }
  return running_max ? launch3<DP, false, true>(K3_ARGS)
                     : launch3<DP, false, false>(K3_ARGS);
#undef K3_ARGS
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all bf16 with a
// unit stride on D, D a multiple of 8 up to 128.  strides: 12 element
// strides, (batch, seq, head) for q, k, v, o in that order; each a multiple
// of 8, pointers 16-byte aligned.  qscale: softmax_scale * log2(e) rounded
// to bf16 (Q is staged as bf16(q * qscale)).
int unet_flash_forward(const void* q, const void* k, const void* v,
                       void* o, int batch, int heads, int sq, int sk, int d,
                       const long long* strides, float qscale,
                       int pipelined, int running_max, void* stream) {
  if (d % 8 != 0 || d < 8 || d > 128 || sq <= 0 || sk <= 0 ||
      batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* qp = reinterpret_cast<const bf16*>(q);
  const bf16* kp = reinterpret_cast<const bf16*>(k);
  const bf16* vp = reinterpret_cast<const bf16*>(v);
  bf16* op = reinterpret_cast<bf16*>(o);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define K3_CASE(N, DP)                                                      \
  case N:                                                                   \
    return launch<DP>(qp, kp, vp, op, batch, heads, sq, sk, d, strides,    \
                      qscale, pipelined, running_max, s);
  switch ((d + 15) / 16) {
    K3_CASE(1, 16) K3_CASE(2, 32) K3_CASE(3, 48) K3_CASE(4, 64)
    K3_CASE(5, 80) K3_CASE(6, 96) K3_CASE(7, 112) K3_CASE(8, 128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K3_CASE
}

}  // extern "C"
