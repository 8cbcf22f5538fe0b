// Probe that the kernel build-and-launch path works: y = x + 1 over n f32.
//
// Replaces the TPU probe m2tts_tpu/serving/pipeline.py
// (Synthesizer._pallas_available, its inner kernel k): x + 1 on one (8, 128)
// f32 tile. Bound: launch latency; it moves 8 KB. Each thread handles four
// neighbouring values with one 16-byte load and store, so one block of 256
// threads covers the tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i + 3 < n) {
    float4 v = *reinterpret_cast<const float4*>(x + i);
    v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
    *reinterpret_cast<float4*>(y + i) = v;
  } else {
    for (int k = i; k < n; ++k) y[k] = x[k] + 1.0f;
  }
}

}  // namespace

// x and y must be 16-byte aligned (as every allocation of the caller is).
extern "C" int m2tts_probe_add_one(const float* x, float* y, int n, void* stream) {
  if (n < 1 || ((uintptr_t)x | (uintptr_t)y) % 16) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<(n + 1023) / 1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return (int)cudaGetLastError();
}
