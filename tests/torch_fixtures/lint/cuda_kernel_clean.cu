// Lint fixture: CUDA kernel hygiene, clean (never compiled).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRes = 32;

struct __align__(16) Row {
  float a, b, lo, span;
  int tgt, ok, pad0, pad1;
};

__device__ __forceinline__ float twice(float x) { return 2.0f * x; }

template <bool kVec>
__global__ void __launch_bounds__(kThreads) sum_kernel(const float* x,
                                                       float* out, int n) {
  __shared__ float s_part[kWarps];
  __shared__ Row s_row[4];
  __shared__ float s_req[kMaxRes];
  float acc = 0.0f;  // accumulate in float32
  for (int j = threadIdx.x; j < n; j += blockDim.x) acc += twice(x[j]);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += s_part[w];
    out[blockIdx.x] = t + s_row[0].a + s_req[0];
  }
}

__global__ void __launch_bounds__(kThreads) scale_kernel(float* x, int n) {
  extern __shared__ float s_dyn[];  // sized at launch: not counted
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) x[j] = twice(x[j]) + s_dyn[0] * 0.0f;
}

template <bool kVec>
cudaError_t launch_sum(const float* x, float* out, int n, cudaStream_t s) {
  sum_kernel<kVec><<<1, kThreads, 0, s>>>(x, out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fx_sum(const void* x, void* out, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = n % 4 == 0
      ? launch_sum<true>(static_cast<const float*>(x),
                         static_cast<float*>(out), n, s)
      : launch_sum<false>(static_cast<const float*>(x),
                          static_cast<float*>(out), n, s);
  return static_cast<int>(err);
}

int fx_scale(void* x, int n, void* stream) {
  scale_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 4,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
