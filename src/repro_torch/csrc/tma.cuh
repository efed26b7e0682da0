// Shared memory addresses, mbarriers and the copy engine (TMA) on Hopper
// (sm_90a), for the kernels that stage their tiles by TMA: flash_prefill
// (csrc/flash_prefill.cu), its backward (csrc/flash_prefill_bwd.cu) and
// the decode family (csrc/decode_warp.cuh);
// per-thread asynchronous copies, for the scans and their backwards
// (csrc/ssm_scan.cu, csrc/mlstm_scan.cu, csrc/ssm_scan_bwd.cu,
// csrc/mlstm_scan_bwd.cu), which stage the next tile while they step this
// one; and the thread block cluster's barrier and distributed shared
// memory, for the backwards' sums across blocks.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for `bar`'s phase of parity `parity`. A load that never lands
// (a fault in the tensor maps) traps after ~2^26 polls instead of
// hanging the card: the launch then fails with an error.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    if (polls == (1 << 26)) __trap();
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// Box (c0 = column, c1 = row, c2 = batch * heads + head) of `map` into
// shared memory at dst, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the copy engine, completing `bar`'s transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// BYTES (4 or 16) from global src to shared dst, both BYTES-aligned, by
// one thread's asynchronous copy (cp.async). The copy lands by the
// issuing thread's copy_wait(); a barrier after that shows it to the
// block.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 16, "cp.async copies 4 or 16 bytes");
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Wait for every asynchronous copy this thread has issued.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This block's rank in its thread block cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster's barrier in two halves: every thread of every block of the
// cluster arrives (its shared memory writes released to the cluster), and
// a wait returns once all have arrived (their writes acquired). Between
// the two a thread may do work that needs no other block. Each arrive is
// followed by one wait before the next arrive, and every thread of a warp
// takes both (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (this block's shared memory) in the shared memory of
// block `rank` of this cluster (distributed shared memory), as a generic
// pointer: plain loads through it are ordered by cluster_wait() like any
// other, and independent ones are issued together.
template <typename T>
__device__ __forceinline__ const T* cluster_map(const T* p, uint32_t rank) {
  uint64_t a;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(a)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(a);
}

// cuTensorMapEncodeTiled, libcuda's entry point found through the runtime
// (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}


}  // namespace tma
