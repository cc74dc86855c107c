// Hopper data-movement and scheduling helpers for warp-specialised kernels
// (attn_kernel.cu): the Tensor Memory Accelerator's tile loads
// (cp.async.bulk.tensor), the mbarriers that report their completion and
// hand ring slots back, the wgmma descriptor of the 32-byte swizzle those
// loads lay down, named barriers between warpgroups, and register
// reallocation between warpgroups (setmaxnreg, sm_90a only).  Plain CUDA,
// no PyTorch headers.

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase after `count` arrivals (and, once a
// thread has armed it with expect_tx, the bytes it was told to expect).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// One arrival, and `bytes` more transaction bytes for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.  A barrier that
// has completed no phase yet counts its phase of parity 1 as complete, so a
// producer's first wait on an empty slot (parity 1) passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// A TMA tile load of a 4-d tensor map box into shared memory; its bytes
// complete_tx on `bar`.  Coordinates are elements, innermost first; a box
// that reaches past the tensor's extent is filled with zeros there.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory matrix descriptor for the 32-byte swizzle that a
// TMA box of 32-byte rows with CU_TENSOR_MAP_SWIZZLE_32B lays down (atoms
// of 8 rows x 32 bytes, 256-byte aligned); byte offsets.  K-major: SBO is
// the stride between 8-row groups, LBO unused (1).  MN-major: LBO is the
// stride between 16-element column groups, SBO between 8-row groups of K
// (CUTLASS's make_gmma_desc, LayoutType::B32).
__device__ __forceinline__ uint64_t smem_desc_sw32(const void* p,
                                                   uint32_t lbo,
                                                   uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)3 << 62);
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `n` threads: sync
// waits for n arrivals in all, arrive counts one and goes on.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Register reallocation between warpgroups: every warp of the warpgroup
// executes it; the producer gives registers back, the consumers take them.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

}  // namespace attn
