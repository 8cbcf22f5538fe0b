// Pieces shared by the tensor-core vocoder kernels (vocoder_tc.cu, bf16;
// vocoder_tc32.cu, f32 by 3xTF32): block shape, wgmma descriptors, the
// geometry helpers and the weight ring.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // two warpgroups
constexpr int kMTW = 4;          // m-tiles (64 rows) a warpgroup accumulates
constexpr int kSlots = 2;        // weight ring depth
constexpr size_t kSmemMax = 227 * 1024;

// Descriptor of a no-swizzle K-major operand: 8-row x 16-byte core
// matrices, `lbo` bytes to the next core matrix along K, `sbo` bytes to the
// next 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, 0.1f * v); }

__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ __forceinline__ size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

__host__ __device__ inline int odd(int v) { return v | 1; }

// Warpgroups side by side along a pass's columns (2), or splitting its
// m-tiles (1).
__host__ __device__ inline int col_wgs(int ncols, int nw) { return ncols % (2 * nw) == 0 ? 2 : 1; }

// Rows a pass's 64-row m-tiles cover: with one warpgroup a column block,
// both run the same number of tiles.
__host__ __device__ inline int tile_rows(int rows, int wn) {
  return wn == 2 ? cdiv(rows, 64) * 64 : cdiv(rows, 128) * 128;
}

// A pass's m-tiles must fit the warpgroups' accumulators (mt m-tiles a
// warpgroup, nw columns a warpgroup's tile).
inline bool fits(int ncols, int nw, int rows, int mt) {
  return tile_rows(rows, col_wgs(ncols, nw)) <= 64 * mt * (3 - col_wgs(ncols, nw));
}

// The weight ring: chunk c lives in slot c % kSlots; thread 0 issues the
// copies, every thread waits on the slot's mbarrier with parity (c/kSlots)&1.
struct Ring {
  uint32_t bars, slots;
  const unsigned char* w;
  const int* off;
  int slot_bytes, nchunks, next;

  __device__ void init() const {
    for (int s = 0; s < kSlots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  __device__ void issue(int c) const {
    const uint32_t bar = bars + 8 * (c % kSlots);
    const int o = __ldg(off + c);
    const uint32_t bytes = (uint32_t)(__ldg(off + c + 1) - o);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(slots + (uint32_t)((c % kSlots) * slot_bytes)), "l"(w + o), "r"(bytes),
           "r"(bar)
        : "memory");
  }

  __device__ uint32_t wait(int c) const {
    const uint32_t bar = bars + 8 * (c % kSlots);
    const uint32_t parity = (c / kSlots) & 1;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred P;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
          "selp.u32 %0, 1, 0, P;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
    return slots + (uint32_t)((c % kSlots) * slot_bytes);
  }
};

}  // namespace
