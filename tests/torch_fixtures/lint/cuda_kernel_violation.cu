// Lint fixture: CUDA kernel hygiene, violations (never compiled).
#include <cassert>
#include <cstdio>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 16384;

// no __launch_bounds__
__global__ void unbounded_kernel(float* x, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) x[j] *= 2.0f;
}

__global__ void __launch_bounds__(kThreads) chatty_kernel(float* x, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  assert(j >= 0);
  if (j == 0) printf("n = %d\n", n);
}

__global__ void __launch_bounds__(kThreads) half_sum_kernel(const __half* x,
                                                            float* out,
                                                            int n) {
  __half acc = __float2half(0.0f);
  for (int j = threadIdx.x; j < n; j += blockDim.x) acc += x[j];
  out[threadIdx.x] = __half2float(acc);
}

__global__ void __launch_bounds__(kThreads) big_smem_kernel(float* x) {
  __shared__ float s_big[kBig];  // 64 KB: over the 48 KB static limit
  s_big[threadIdx.x] = x[threadIdx.x];
  __syncthreads();
  x[threadIdx.x] = s_big[kThreads - 1 - threadIdx.x];
}

}  // namespace

extern "C" {

int fx_unbounded(void* x, int n, void* stream) {
  unbounded_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

int fx_chatty(void* x, int n, void* stream) {
  chatty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
