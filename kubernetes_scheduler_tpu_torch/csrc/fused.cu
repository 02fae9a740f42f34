// Hand-written Hopper (sm_90a) kernels of the fused scheduling path.
//
// Counterparts of the Pallas TPU kernels in
// kubernetes_scheduler_tpu/ops/pallas_fused.py:
//
//   masked_score_kernel  K1  fused_masked_score     (pallas_fused.py:252)
//   row_stats_kernel     K2  fused_score_row_stats  (pallas_fused.py:385)
//   auction_bid_kernel   K3  fused_auction_bid      (pallas_fused.py:581)
//   greedy_scan_kernel   K4  fused_greedy_scan      (pallas_fused.py:476)
//
// Each kernel sits behind a plain C function (ks_*) that launches it on
// the caller's stream and returns cudaGetLastError(); ops/fused.py binds
// them with ctypes. Kernels never allocate and never synchronise.
//
// Layout: row-major and unpadded, as the PyTorch caller holds the
// tensors. Per-pod values are uniform across a block and staged in shared
// memory; per-node values are read by consecutive threads from
// consecutive addresses. The [k, p]/[k, n] transposes of the TPU kernels
// existed for its lanes and are not carried over, except for the selector
// operands, whose [4S, p] / [3S, n] rows already give coalesced reads.
//
// Arithmetic uses explicit round-to-nearest intrinsics (__fmul_rn,
// __fsub_rn, __fadd_rn, __fdiv_rn), so nvcc cannot contract a*b - c*d
// into an FMA: every value is bit-identical to the plain PyTorch version
// in ops/fused.py, which runs each operation as its own kernel.

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

// float32(-1e30), the NEG sentinel of ops/assign.py, and NEG * 0.5
constexpr float kNeg = -0x1.93e594p+99f;
constexpr float kNegHalf = -0x1.93e594p+98f;
constexpr float kMaxRawScore = 10.0f;    // ops/score.MAX_RAW_SCORE
constexpr float kMaxNodeScore = 100.0f;  // ops/normalize.MAX_NODE_SCORE
constexpr int kMaxRes = 32;              // ops/fused.MAX_RESOURCES
constexpr int kMaxSel = 32;              // ops/fused.MAX_FUSED_SELECTORS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;

// 10 - 10 * |alpha * v - beta * u|  (ops/score.balanced_cpu_diskio)
__device__ __forceinline__ float raw_score(float alpha, float beta, float u,
                                           float v) {
  const float load = fabsf(__fsub_rn(__fmul_rn(alpha, v), __fmul_rn(beta, u)));
  return __fsub_rn(kMaxRawScore, __fmul_rn(kMaxRawScore, load));
}

// K1: one thread per (pod, node) cell; blockIdx.y walks pods, blockIdx.x
// node chunks. Output: the (optionally min-max normalized) score where the
// cell is feasible, NEG elsewhere.
__global__ void __launch_bounds__(kThreads) masked_score_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const unsigned char* __restrict__ pod_ok, const int* __restrict__ target,
    const float* __restrict__ u, const float* __restrict__ v,
    const unsigned char* __restrict__ node_mask,
    const float* __restrict__ pod_req, const float* __restrict__ alloc,
    const float* __restrict__ reqd, const float* __restrict__ aff_pod,
    const float* __restrict__ aff_node, const float* __restrict__ other,
    const float* __restrict__ stats, float* __restrict__ out, int p, int n,
    int r, int n_sel) {
  __shared__ float s_req[kMaxRes];
  __shared__ float s_aff[4 * kMaxSel];
  for (int i = blockIdx.y; i < p; i += gridDim.y) {
    __syncthreads();  // the previous pod's shared rows are no longer read
    for (int k = threadIdx.x; k < r; k += blockDim.x)
      s_req[k] = pod_req[(size_t)i * r + k];
    for (int k = threadIdx.x; k < 4 * n_sel; k += blockDim.x)
      s_aff[k] = aff_pod[(size_t)k * p + i];
    __syncthreads();
    const float a = alpha[i];
    const float b = beta[i];
    const bool ok_i = pod_ok[i] != 0;
    const int tgt = target[i];
    float hi = 0.0f, lo = 0.0f;
    if (stats != nullptr) {
      hi = stats[i];
      lo = stats[p + i];
    }
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
         j += gridDim.x * blockDim.x) {
      float s = raw_score(a, b, u[j], v[j]);
      bool fit = ok_i && node_mask[j] != 0;
      // NodeResourcesFit; an unrequested resource never excludes a node
      for (int k = 0; k < r; ++k) {
        const float q = s_req[k];
        const size_t at = (size_t)j * r + k;
        fit = fit && (__fadd_rn(reqd[at], q) <= alloc[at] || q == 0.0f);
      }
      // spec.nodeName pinning against the global node index
      fit = fit && (tgt < 0 || tgt == j);
      // count-based families per selector: required presence, anti
      // absence, reverse avoiders, spread skew (count + 1 - dmin > maxSkew)
      for (int sel = 0; sel < n_sel; ++sel) {
        const bool req_sel = s_aff[sel] > 0.0f;
        const bool anti = s_aff[n_sel + sel] > 0.0f;
        const bool match = s_aff[2 * n_sel + sel] > 0.0f;
        const float thresh = s_aff[3 * n_sel + sel];
        const bool present = aff_node[(size_t)sel * n + j] > 0.0f;
        const bool avoider = aff_node[(size_t)(n_sel + sel) * n + j] > 0.0f;
        const float cplus = aff_node[(size_t)(2 * n_sel + sel) * n + j];
        const bool bad = (req_sel && !present) || (anti && present) ||
                         (match && avoider) || (cplus > thresh);
        fit = fit && !bad;
      }
      if (other != nullptr) fit = (other[(size_t)i * n + j] > 0.0f) && fit;
      if (stats != nullptr)
        s = __fdiv_rn(__fmul_rn(__fsub_rn(s, lo), kMaxNodeScore),
                      __fsub_rn(hi, lo));
      out[(size_t)i * n + j] = fit ? s : kNeg;
    }
  }
}

// K2: one block per pod row; each thread folds a strided slice of the
// node-masked raw scores, then the block reduces (max, min). Both are
// exact in any order.
__global__ void __launch_bounds__(kThreads) row_stats_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ u, const float* __restrict__ v,
    const unsigned char* __restrict__ node_mask, float* __restrict__ out,
    int p, int n) {
  __shared__ float s_hi[kWarps];
  __shared__ float s_lo[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = blockIdx.x; i < p; i += gridDim.x) {
    const float a = alpha[i];
    const float b = beta[i];
    float hi = -FLT_MAX, lo = FLT_MAX;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      if (node_mask[j] != 0) {
        const float s = raw_score(a, b, u[j], v[j]);
        hi = fmaxf(hi, s);
        lo = fminf(lo, s);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      hi = fmaxf(hi, __shfl_down_sync(0xffffffffu, hi, off));
      lo = fminf(lo, __shfl_down_sync(0xffffffffu, lo, off));
    }
    __syncthreads();  // the previous pod's partials are no longer read
    if (lane == 0) {
      s_hi[warp] = hi;
      s_lo[warp] = lo;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        hi = fmaxf(hi, s_hi[w]);
        lo = fminf(lo, s_lo[w]);
      }
      out[i] = hi;
      out[p + i] = lo;
    }
  }
}

// (value, column) pair order of the auction's argmax: the greater value
// wins, and among equal values the smaller column (jnp.argmax's first
// maximum).
__device__ __forceinline__ bool bid_better(float val, int col, float best,
                                           int best_col) {
  return val > best || (val == best && col < best_col);
}

// K3: one block per pod row. An active pod's row is reduced to the first
// column of max(sj - price) over cells with sj > NEG/2 and capacity for
// every requested resource; bid = 0, has = 0 when no cell qualifies.
// Inactive pods read nothing.
__global__ void __launch_bounds__(kThreads) auction_bid_kernel(
    const float* __restrict__ sj, const float* __restrict__ price,
    const unsigned char* __restrict__ active, const float* __restrict__ req,
    const float* __restrict__ free_cap, int* __restrict__ bid,
    int* __restrict__ has, int p, int n, int r) {
  __shared__ float s_req[kMaxRes];
  __shared__ float s_val[kWarps];
  __shared__ int s_col[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = blockIdx.x; i < p; i += gridDim.x) {
    if (active[i] == 0) {  // uniform across the block
      if (threadIdx.x == 0) {
        bid[i] = 0;
        has[i] = 0;
      }
      continue;
    }
    __syncthreads();  // the previous pod's shared rows are no longer read
    for (int k = threadIdx.x; k < r; k += blockDim.x)
      s_req[k] = req[(size_t)i * r + k];
    __syncthreads();
    const float* row = sj + (size_t)i * n;
    float best = __int_as_float(0xff800000);  // -inf
    int best_col = INT_MAX;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float x = row[j];
      if (x > kNegHalf) {
        bool cap = true;
        for (int k = 0; k < r; ++k) {
          const float q = s_req[k];
          cap = cap && (q <= free_cap[(size_t)j * r + k] || q == 0.0f);
        }
        if (cap) {
          const float val = __fsub_rn(x, price[j]);
          if (val > best) {  // columns ascend per thread: first max kept
            best = val;
            best_col = j;
          }
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o_val = __shfl_down_sync(0xffffffffu, best, off);
      const int o_col = __shfl_down_sync(0xffffffffu, best_col, off);
      if (bid_better(o_val, o_col, best, best_col)) {
        best = o_val;
        best_col = o_col;
      }
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_col[warp] = best_col;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        if (bid_better(s_val[w], s_col[w], best, best_col)) {
          best = s_val[w];
          best_col = s_col[w];
        }
      }
      const bool found = best_col != INT_MAX;
      bid[i] = found ? best_col : 0;
      has[i] = found ? 1 : 0;
    }
  }
}

// K4: the sequential greedy scan over pods in scan (priority) order,
// replacing fused_greedy_scan (pallas_fused.py:476, body _greedy_kernel
// :421). Pod i takes the first column of the row maximum of sj over cells
// with sj > NEG/2 and capacity for every requested resource (an
// unrequested resource never excludes a node); its request is subtracted
// from that one column before pod i + 1 reads `free`. picks[i] = -1, and
// nothing changes, when no cell qualifies.
//
// Bound on the H100: bytes. sj is read once, p * n * 4 B (1,024 x 10,000
// on the main path: about 41 MB, about 12 us at 3.35 TB/s); everything
// else is small. Every pod depends on the capacity the previous one left,
// and CUDA blocks carry nothing between them, so ONE block of kGreedyThreads
// threads walks the pods in order: each thread folds a strided slice of
// the row into a first-max (value, column) pair, the block reduces the
// pairs with K3's rule, thread 0 writes the pick and decrements the chosen
// column, and a barrier publishes it before the next pod. The p
// block-wide reductions in sequence, on one SM, keep this kernel far above
// the byte bound; PERF.md records its time as it is.
//
// `free` lives in the free_after output in device memory (n * r * 4 B:
// 120 KB at r = 3, in L2), so any n and r work, including n * r * 4 B
// above a block's 227 KB of shared memory. It is read with plain loads,
// never the read-only path: thread 0 writes it between pods, and
// __syncthreads() makes that write visible to the block.
constexpr int kGreedyThreads = 1024;
constexpr int kGreedyWarps = kGreedyThreads / 32;

__global__ void __launch_bounds__(kGreedyThreads) greedy_scan_kernel(
    const float* __restrict__ sj, const float* __restrict__ req,
    const float* __restrict__ free0, float* free_cap, int* __restrict__ picks,
    int p, int n, int r) {
  __shared__ float s_req[kMaxRes];
  __shared__ float s_val[kGreedyWarps];
  __shared__ int s_col[kGreedyWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  for (size_t at = threadIdx.x; at < (size_t)n * r; at += blockDim.x)
    free_cap[at] = free0[at];
  for (int i = 0; i < p; ++i) {
    // the previous pod's decrement and shared rows are complete
    __syncthreads();
    for (int k = threadIdx.x; k < r; k += blockDim.x)
      s_req[k] = req[(size_t)i * r + k];
    __syncthreads();
    const float* row = sj + (size_t)i * n;
    float best = __int_as_float(0xff800000);  // -inf
    int best_col = INT_MAX;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float x = row[j];
      if (x > kNegHalf && x > best) {  // columns ascend: first max kept
        bool cap = true;
        for (int k = 0; k < r; ++k) {
          const float q = s_req[k];
          cap = cap && (q <= free_cap[(size_t)j * r + k] || q == 0.0f);
        }
        if (cap) {
          best = x;
          best_col = j;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o_val = __shfl_down_sync(0xffffffffu, best, off);
      const int o_col = __shfl_down_sync(0xffffffffu, best_col, off);
      if (bid_better(o_val, o_col, best, best_col)) {
        best = o_val;
        best_col = o_col;
      }
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_col[warp] = best_col;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < n_warps; ++w) {
        if (bid_better(s_val[w], s_col[w], best, best_col)) {
          best = s_val[w];
          best_col = s_col[w];
        }
      }
      const bool found = best_col != INT_MAX;
      picks[i] = found ? best_col : -1;
      if (found) {
        for (int k = 0; k < r; ++k) {
          const size_t at = (size_t)best_col * r + k;
          free_cap[at] = __fsub_rn(free_cap[at], s_req[k]);
        }
      }
    }
  }
}

inline int grid_rows(int p) { return p < kMaxGridY ? p : kMaxGridY; }

}  // namespace

extern "C" {

const char* ks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ks_masked_score(const void* alpha, const void* beta, const void* pod_ok,
                    const void* target, const void* u, const void* v,
                    const void* node_mask, const void* pod_req,
                    const void* alloc, const void* reqd, const void* aff_pod,
                    const void* aff_node, const void* other,
                    const void* stats, void* out, int p, int n, int r,
                    int n_sel, void* stream) {
  if (p > 0 && n > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, grid_rows(p));
    masked_score_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(alpha), static_cast<const float*>(beta),
        static_cast<const unsigned char*>(pod_ok),
        static_cast<const int*>(target), static_cast<const float*>(u),
        static_cast<const float*>(v),
        static_cast<const unsigned char*>(node_mask),
        static_cast<const float*>(pod_req), static_cast<const float*>(alloc),
        static_cast<const float*>(reqd), static_cast<const float*>(aff_pod),
        static_cast<const float*>(aff_node), static_cast<const float*>(other),
        static_cast<const float*>(stats), static_cast<float*>(out), p, n, r,
        n_sel);
  }
  return static_cast<int>(cudaGetLastError());
}

int ks_row_stats(const void* alpha, const void* beta, const void* u,
                 const void* v, const void* node_mask, void* out, int p,
                 int n, void* stream) {
  if (p > 0) {
    row_stats_kernel<<<grid_rows(p), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(alpha), static_cast<const float*>(beta),
        static_cast<const float*>(u), static_cast<const float*>(v),
        static_cast<const unsigned char*>(node_mask),
        static_cast<float*>(out), p, n);
  }
  return static_cast<int>(cudaGetLastError());
}

int ks_auction_bid(const void* sj, const void* price, const void* active,
                   const void* req, const void* free_cap, void* bid,
                   void* has, int p, int n, int r, void* stream) {
  if (p > 0) {
    auction_bid_kernel<<<grid_rows(p), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sj), static_cast<const float*>(price),
        static_cast<const unsigned char*>(active),
        static_cast<const float*>(req), static_cast<const float*>(free_cap),
        static_cast<int*>(bid), static_cast<int*>(has), p, n, r);
  }
  return static_cast<int>(cudaGetLastError());
}

int ks_greedy_scan(const void* sj, const void* req, const void* free0,
                   void* free_cap, void* picks, int p, int n, int r,
                   void* stream) {
  greedy_scan_kernel<<<1, kGreedyThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sj), static_cast<const float*>(req),
      static_cast<const float*>(free0), static_cast<float*>(free_cap),
      static_cast<int*>(picks), p, n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
