// Probe that the kernel build-and-launch path works: y = x + 1 over n f32.
//
// Replaces the TPU probe m2tts_tpu/serving/pipeline.py
// (Synthesizer._pallas_available, its inner kernel k): x + 1 on one (8, 128)
// f32 tile. Bound: launch latency; it moves 8 KB.

#include <cuda_runtime.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" int m2tts_probe_add_one(const float* x, float* y, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return (int)cudaGetLastError();
}
