// Hand-written Hopper (sm_90a) kernels of the fused scheduling path.
//
// Counterparts of the Pallas TPU kernels in
// kubernetes_scheduler_tpu/ops/pallas_fused.py:
//
//   masked_score_kernel  K1  fused_masked_score     (pallas_fused.py:252)
//   row_stats_kernel     K2  fused_score_row_stats  (pallas_fused.py:385)
//   auction_bid_kernel   K3  fused_auction_bid      (pallas_fused.py:581)
//   greedy_lists_kernel  K4  fused_greedy_scan      (pallas_fused.py:476)
//   + greedy_pass_kernel     (phase 1 on every SM, phase 2 on one block)
//
// Each kernel sits behind a plain C function (ks_*) that launches it on
// the caller's stream and returns cudaGetLastError(); ops/fused.py binds
// them with ctypes. Kernels never allocate and never synchronise: K4's
// candidate lists are scratch the wrapper allocates.
//
// Layout: row-major and unpadded, as the PyTorch caller holds the
// tensors. Per-pod values are uniform across a block and staged in shared
// memory; per-node values are read by consecutive threads from
// consecutive addresses (K3 and K4 four columns a thread, one 16-byte load
// where n % 4 == 0). The [k, p]/[k, n] transposes of the TPU kernels
// existed for its lanes and are not carried over, except for the selector
// operands, whose [4S, p] / [3S, n] rows already give coalesced reads.
// K3 and K4 read a node's capacity words only for a cell whose value could
// change the first maximum they keep.
//
// Arithmetic uses explicit round-to-nearest intrinsics (__fmul_rn,
// __fsub_rn, __fadd_rn, __fdiv_rn), so nvcc cannot contract a*b - c*d
// into an FMA: every value is bit-identical to the plain PyTorch version
// in ops/fused.py, which runs each operation as its own kernel.

#include <cfloat>
#include <climits>
#include <cstdint>
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
constexpr unsigned kFull = 0xffffffffu;

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

// The four row values at columns j..j+3, for j < n a multiple of 4, and
// `fill` past column n - 1: one 16-byte load where rows are 16-byte aligned
// (kVec: n % 4 == 0 and an aligned base, so j + 3 < n), else scalar loads.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int j,
                                        int n, float fill) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(row + j));
  return make_float4(__ldg(row + j), j + 1 < n ? __ldg(row + j + 1) : fill,
                     j + 2 < n ? __ldg(row + j + 2) : fill,
                     j + 3 < n ? __ldg(row + j + 3) : fill);
}

// Capacity for every requested resource of one node (cap[col * r + k]);
// an unrequested resource never excludes a node.
__device__ __forceinline__ bool fits(const float* q, const float* cap,
                                     int col, int r) {
  const float* c = cap + (size_t)col * r;
  bool ok = true;
  for (int k = 0; k < r; ++k) ok = ok & ((q[k] <= c[k]) | (q[k] == 0.0f));
  return ok;
}

// K3: one block per pod row. An active pod's row is reduced to the first
// column of max(sj - price) over cells with sj > NEG/2 and capacity for
// every requested resource; bid = 0, has = 0 when no cell qualifies.
// Inactive pods read nothing.
//
// Bound: bytes, the active rows of sj (plus price, which stays in L2).
// Each thread takes four consecutive columns at a time (one 16-byte load
// of sj and one of price where n % 4 == 0), so its columns ascend and its
// running (best, column) pair is already the first maximum of its cells.
// It computes val = sj - price first and reads the node's r capacity words
// only when val beats its running best: a cell that does not beat it
// cannot change the first maximum, whether it fits or not. On a row of
// random order that is a few cells per thread instead of every cell, so
// the stride-r capacity reads no longer set the pace.
template <bool kVec>
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
    auto cell = [&](float x, float pr, int col) {
      const float val = __fsub_rn(x, pr);
      if (x > kNegHalf && val > best && fits(s_req, free_cap, col, r)) {
        best = val;
        best_col = col;
      }
    };
    for (int j = 4 * threadIdx.x; j < n; j += 4 * blockDim.x) {
      const float4 x = load4<kVec>(row, j, n, kNeg);
      const float4 pr = load4<kVec>(price, j, n, 0.0f);
      cell(x.x, pr.x, j);
      cell(x.y, pr.y, j + 1);
      cell(x.z, pr.z, j + 2);
      cell(x.w, pr.w, j + 3);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o_val = __shfl_down_sync(kFull, best, off);
      const int o_col = __shfl_down_sync(kFull, best_col, off);
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

// K4: the greedy scan over pods in scan (priority) order, replacing
// fused_greedy_scan (pallas_fused.py:476, body _greedy_kernel :421). Pod i
// takes the first column of the row maximum of sj over cells with
// sj > NEG/2 and capacity for every requested resource under the capacity
// the pods before it left; its request is subtracted from that one column
// (__fsub_rn). picks[i] = -1, and nothing changes, when no cell qualifies.
//
// Bound on the H100: bytes. sj is read once, p * n * 4 B (1,024 x 10,000
// on the main path: about 41 MB, about 12 us at 3.35 TB/s). The carry
// makes every pod depend on the one before it, but only through the few
// columns earlier pods took, so the scan is split in two launches:
//
// 1. greedy_lists_kernel, one block per row on every SM: each row's
//    candidate list, its qualifying cells (sj > NEG/2 and capacity under
//    free0) in the order "greater value, then smaller column", as (value,
//    column) pairs: up to kListLen = 256 of them, of which the first `cnt`
//    are known to be the row's first `cnt` qualifying cells.
// 2. greedy_pass_kernel, one block: warp 0 walks the pods in order. Pod i
//    tests its list against the current `free`, 32 entries at a time, one
//    per lane; the first entry that still fits is the pick.
//
// Why that is exact (the subset argument): a request is never negative on
// the main path, so `free` only decreases (f - q <= f for q >= 0 under
// round-to-nearest), and the test (q <= f) | (q == 0) is monotone in f.
// The cells pod i can take at its turn are therefore a subset of those it
// could take under free0, and every cell ranked above the first listed
// one that still fits either never qualified or is an earlier entry that
// no longer fits. When no entry fits and the list holds every qualifying
// cell of the row, nothing qualifies: the pick is -1. Otherwise (the list
// is "full") the whole block scans the row under the current `free`, over
// the cells ranked after the list's last entry only (the fallback; ties at
// that boundary follow the order, so equal values at larger columns are
// scanned).
//
// The guard: a request component < 0 (or NaN) breaks the subset argument,
// since `free` would grow. Warp 0 checks each request as it reads it; from
// the first such pod on, every pod takes the unrestricted row scan, which
// is the plain per-pod step and exact for any input. `fallbacks` counts the
// pods that took a row scan of either kind.
//
// `free` lives in shared memory when n * r * 4 B fits beside the static
// shared memory (120 KB at r = 3), else in the free_after output in device
// memory (280 KB at r = 7), read with plain loads: warp 0 writes it between
// pods, and __syncwarp / __syncthreads make the write visible. Pods whose
// list decides never stop the other 31 warps, which wait at the barrier
// until warp 0 meets a pod that needs the block's row scan.
constexpr int kListThreads = 256;
constexpr int kListWarps = kListThreads / 32;
constexpr int kListLen = kListWarps * 32;    // ops/fused.GREEDY_LIST_LEN
constexpr int kListFull = 1 << 30;           // list_cnt flag: cells remain
constexpr int kChunk = 4 * 32;               // columns a warp reads per step
constexpr int kPassThreads = 1024;
constexpr int kPassWarps = kPassThreads / 32;  // one per lane of warp 0
constexpr int kBatches = kListLen / 32;      // list entries per lane
constexpr int kScanUnroll = 4;               // row scan: 16-byte loads in flight

// Insert (v, c) into a warp's list, one entry per lane in bid_better order
// (lane 0 the best; empty entries are (-inf, INT_MAX)); the last entry
// drops out. A no-op when all 32 entries rank above (v, c).
__device__ __forceinline__ void list_insert(float& lv, int& lc, float v,
                                            int c, int lane) {
  const int pos = __popc(__ballot_sync(kFull, bid_better(lv, lc, v, c)));
  const float up_v = __shfl_up_sync(kFull, lv, 1);
  const int up_c = __shfl_up_sync(kFull, lc, 1);
  if (lane == pos) {
    lv = v;
    lc = c;
  } else if (lane > pos) {
    lv = up_v;
    lc = up_c;
  }
}

// Phase 1. Warp w of row i's block reads the 128-column chunks w, w + 8,
// ... (lane l four consecutive columns of each, one 16-byte load where
// aligned, the next chunk's load in flight), so the columns a warp meets
// ascend from chunk to chunk. It keeps its own top 32; a cell is a
// candidate only when its value beats the list's last value at the start
// of its chunk (an equal value comes at a larger column and ranks below),
// and only a candidate's r capacity words are read. Candidates are
// inserted one at a time.
//
// The eight warp lists (256 entries) are then sorted into one list by a
// merge network in shared memory: per level, each element is compared with
// its mirror in the other run, then half-cleaners (21 compare-exchange
// steps). Every qualifying cell ranked above a full warp list's last entry
// is in that warp's list, so the merged list is exact down to B, the best
// last entry of a full warp list (all of it when no warp list is full):
// cnt = min(list_len, B's position + 1), flagged kListFull unless the
// list holds every qualifying cell of the row.
template <bool kVec>
__global__ void __launch_bounds__(kListThreads) greedy_lists_kernel(
    const float* __restrict__ sj, const float* __restrict__ req,
    const float* __restrict__ free0, float* __restrict__ list_val,
    int* __restrict__ list_col, int* __restrict__ list_cnt, int p, int n,
    int r, int list_len) {
  __shared__ float s_req[kMaxRes];
  __shared__ float s_lv[kListLen];
  __shared__ int s_lc[kListLen];
  __shared__ int s_bcol;   // B's column, INT_MAX when no warp list is full
  __shared__ int s_bpos;   // B's position in the merged list
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float neg_inf = __int_as_float(0xff800000);
  const float4 fill = make_float4(kNeg, kNeg, kNeg, kNeg);
  constexpr int kStride = kListWarps * kChunk;
  for (int i = blockIdx.x; i < p; i += gridDim.x) {
    __syncthreads();  // the previous row's shared values are no longer read
    for (int k = t; k < r; k += blockDim.x) s_req[k] = req[(size_t)i * r + k];
    __syncthreads();
    const float* row = sj + (size_t)i * n;
    float lv = neg_inf;  // this lane's entry of the warp's list
    int lc = INT_MAX;
    float thr = neg_inf;  // the list's last value
    int j = warp * kChunk + 4 * lane;
    float4 ahead = j < n ? load4<kVec>(row, j, n, kNeg) : fill;
    for (int base = warp * kChunk; base < n; base += kStride, j += kStride) {
      const float4 x = ahead;
      ahead = j + kStride < n ? load4<kVec>(row, j + kStride, n, kNeg) : fill;
      unsigned pend = 0;
      if (x.x > kNegHalf && x.x > thr && fits(s_req, free0, j, r)) pend |= 1u;
      if (x.y > kNegHalf && x.y > thr && fits(s_req, free0, j + 1, r)) pend |= 2u;
      if (x.z > kNegHalf && x.z > thr && fits(s_req, free0, j + 2, r)) pend |= 4u;
      if (x.w > kNegHalf && x.w > thr && fits(s_req, free0, j + 3, r)) pend |= 8u;
      for (unsigned who = __ballot_sync(kFull, pend != 0); who != 0;
           who = __ballot_sync(kFull, pend != 0)) {
        const int src = __ffs(who) - 1;
        const int e = __ffs(pend) - 1;  // this lane's first pending cell
        const float mine = e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
        const float v = __shfl_sync(kFull, mine, src);
        const int c = __shfl_sync(kFull, j + e, src);
        if (lane == src) pend &= pend - 1;
        list_insert(lv, lc, v, c, lane);
      }
      thr = __shfl_sync(kFull, lv, 31);
    }
    s_lv[t] = lv;
    s_lc[t] = lc;
    __syncthreads();
    if (t == 0) {  // B: the best last entry of a full warp list
      float bv = neg_inf;
      int bc = INT_MAX;
      for (int w = 0; w < kListWarps; ++w) {
        const int last = 32 * w + 31;
        if (s_lc[last] != INT_MAX && bid_better(s_lv[last], s_lc[last], bv, bc)) {
          bv = s_lv[last];
          bc = s_lc[last];
        }
      }
      s_bcol = bc;
      s_bpos = kListLen - 1;
    }
    __syncthreads();  // B is read before the merge moves entries
    for (int run = 32; run < kListLen; run *= 2) {
      for (int d = run; d > 0; d >>= 1) {
        // d == run: compare with the mirror in the other run; then halves
        const int o = t & (2 * d - 1);
        const int u = d == run ? t - o + 2 * d - 1 - o : t ^ d;
        if (o < d) {
          const float uv = s_lv[u];
          const int uc = s_lc[u];
          if (bid_better(uv, uc, s_lv[t], s_lc[t])) {
            s_lv[u] = s_lv[t];
            s_lc[u] = s_lc[t];
            s_lv[t] = uv;
            s_lc[t] = uc;
          }
        }
        __syncthreads();
      }
    }
    lv = s_lv[t];
    lc = s_lc[t];
    list_val[(size_t)i * kListLen + t] = lv;
    list_col[(size_t)i * kListLen + t] = lc;
    if (lc == s_bcol && lc != INT_MAX) s_bpos = t;
    const int found = __syncthreads_count(lc != INT_MAX);
    if (t == 0) {
      const bool complete = s_bcol == INT_MAX;
      const int exact = complete ? found : s_bpos + 1;
      const int cnt = exact < list_len ? exact : list_len;
      list_cnt[i] = cnt | (!complete || cnt < found ? kListFull : 0);
    }
  }
}

// One pod's operands for warp 0's walk: lane k holds request word k, and
// list entry k's column.
struct PodEntry {
  float q;
  int cnt;
  int col;
};

__device__ __forceinline__ PodEntry load_pod(const float* __restrict__ req,
                                             const int* __restrict__ list_col,
                                             const int* __restrict__ list_cnt,
                                             int i, int p, int r, int lane) {
  PodEntry e{0.0f, 0, 0};
  if (i < p) {
    e.q = lane < r ? req[(size_t)i * r + lane] : 0.0f;
    e.cnt = list_cnt[i];
    e.col = list_col[(size_t)i * kListLen + lane];
  }
  return e;
}

// Phase 2: see the K4 note above. Warp 0 prefetches the next two pods'
// operands; entries past the first 32 of a list are loaded together only
// for a pod whose first 32 are all taken.
template <bool kVec>
__global__ void __launch_bounds__(kPassThreads) greedy_pass_kernel(
    const float* __restrict__ sj, const float* __restrict__ req,
    const float* __restrict__ free0, const float* __restrict__ list_val,
    const int* __restrict__ list_col, const int* __restrict__ list_cnt,
    float* free_after, int* __restrict__ picks, int* __restrict__ fallbacks,
    int p, int n, int r, int free_in_smem) {
  extern __shared__ float s_free[];
  __shared__ float s_req[kMaxRes];
  __shared__ float s_val[kPassWarps];
  __shared__ int s_col[kPassWarps];
  __shared__ int s_pod;       // the pod whose row the block scans; p: done
  __shared__ int s_after;     // scan only the cells ranked after (s_last_*)
  __shared__ float s_last_val;
  __shared__ int s_last_col;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* fr = free_in_smem ? s_free : free_after;
  const size_t nr = (size_t)n * r;
  for (size_t at = threadIdx.x; at < nr; at += blockDim.x) fr[at] = free0[at];
  __syncthreads();
  int next = 0;        // warp 0: the first pod not yet placed
  bool exact = true;   // warp 0: no request so far had a component < 0 or NaN
  int scans = 0;       // warp 0: pods that took a row scan
  for (;;) {
    if (warp == 0) {
      __syncwarp();  // the previous scan's update of `free` is visible
      int i = next;
      PodEntry ahead0 = load_pod(req, list_col, list_cnt, i, p, r, lane);
      PodEntry ahead1 = load_pod(req, list_col, list_cnt, i + 1, p, r, lane);
      for (; i < p; ++i) {
        const PodEntry e = ahead0;
        ahead0 = ahead1;
        ahead1 = load_pod(req, list_col, list_cnt, i + 2, p, r, lane);
        __syncwarp();  // every lane is done with the previous pod's s_req
        if (lane < r) s_req[lane] = e.q;
        __syncwarp();
        exact = exact && !__any_sync(kFull, lane < r && !(e.q >= 0.0f));
        if (!exact) break;  // the guard: unrestricted row scans from here on
        const int cnt = e.cnt & (kListFull - 1);
        int pick = -1;
        unsigned m = __ballot_sync(kFull, lane < cnt && fits(s_req, fr, e.col, r));
        if (m != 0) {
          pick = __shfl_sync(kFull, e.col, __ffs(m) - 1);
        } else if (cnt > 32) {
          const int* cols = list_col + (size_t)i * kListLen;
          int more[kBatches - 1];
#pragma unroll
          for (int b = 1; b < kBatches; ++b)
            more[b - 1] = 32 * b + lane < cnt ? cols[32 * b + lane] : 0;
#pragma unroll
          for (int b = 1; b < kBatches; ++b) {
            if (pick < 0 && 32 * b < cnt) {
              m = __ballot_sync(kFull, 32 * b + lane < cnt &&
                                           fits(s_req, fr, more[b - 1], r));
              if (m != 0) pick = __shfl_sync(kFull, more[b - 1], __ffs(m) - 1);
            }
          }
        }
        if (pick < 0 && (e.cnt & kListFull)) break;  // the restricted scan
        if (lane == 0) picks[i] = pick;
        if (pick >= 0 && lane < r) {
          float* f = fr + (size_t)pick * r + lane;
          *f = __fsub_rn(*f, e.q);
        }
        __syncwarp();
      }
      if (lane == 0) {
        s_pod = i;
        s_after = exact;
        if (i < p && exact) {
          const int last = (list_cnt[i] & (kListFull - 1)) - 1;
          s_last_val = list_val[(size_t)i * kListLen + last];
          s_last_col = list_col[(size_t)i * kListLen + last];
        }
      }
      next = i + 1;
    }
    __syncthreads();
    const int i = s_pod;
    if (i >= p) break;
    const bool after = s_after != 0;
    const float last_val = s_last_val;
    const int last_col = s_last_col;
    const float* row = sj + (size_t)i * n;
    float best = __int_as_float(0xff800000);  // -inf
    int best_col = INT_MAX;
    auto cell = [&](float x, int col) {
      if (x > kNegHalf && x > best &&  // columns ascend: first max kept
          (!after || bid_better(last_val, last_col, x, col)) &&
          fits(s_req, fr, col, r)) {
        best = x;
        best_col = col;
      }
    };
    // thread t: float4 groups t, t + T, ... (T = blockDim.x), kScanUnroll
    // loads in flight before any is compared; its columns ascend
    const int groups = (n + 3) / 4;
    for (int g0 = threadIdx.x; g0 < groups; g0 += kScanUnroll * blockDim.x) {
      float4 x[kScanUnroll];
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int g = g0 + u * blockDim.x;
        x[u] = g < groups ? load4<kVec>(row, 4 * g, n, kNeg)
                          : make_float4(kNeg, kNeg, kNeg, kNeg);
      }
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int j = 4 * (g0 + u * blockDim.x);
        cell(x[u].x, j);
        cell(x[u].y, j + 1);
        cell(x[u].z, j + 2);
        cell(x[u].w, j + 3);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o_val = __shfl_down_sync(kFull, best, off);
      const int o_col = __shfl_down_sync(kFull, best_col, off);
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
    if (warp == 0) {
      best = s_val[lane];
      best_col = s_col[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float o_val = __shfl_down_sync(kFull, best, off);
        const int o_col = __shfl_down_sync(kFull, best_col, off);
        if (bid_better(o_val, o_col, best, best_col)) {
          best = o_val;
          best_col = o_col;
        }
      }
      const int pick = __shfl_sync(kFull, best_col, 0);
      if (lane == 0) picks[i] = pick == INT_MAX ? -1 : pick;
      if (pick != INT_MAX && lane < r) {
        float* f = fr + (size_t)pick * r + lane;
        *f = __fsub_rn(*f, s_req[lane]);
      }
      ++scans;
    }
  }
  if (free_in_smem) {
    for (size_t at = threadIdx.x; at < nr; at += blockDim.x)
      free_after[at] = fr[at];
  }
  if (threadIdx.x == 0) *fallbacks = scans;
}

inline int grid_rows(int p) { return p < kMaxGridY ? p : kMaxGridY; }

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool kVec>
cudaError_t launch_greedy_scan(const float* sj, const float* req,
                               const float* free0, float* free_after,
                               int* picks, float* list_val, int* list_col,
                               int* list_cnt, int* fallbacks, int p, int n,
                               int r, int list_len, cudaStream_t stream) {
  if (p > 0) {
    greedy_lists_kernel<kVec><<<grid_rows(p), kListThreads, 0, stream>>>(
        sj, req, free0, list_val, list_col, list_cnt, p, n, r, list_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // `free` in shared memory when it fits beside the static shared memory
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, greedy_pass_kernel<kVec>);
  if (err != cudaSuccess) return err;
  const size_t need = (size_t)n * r * sizeof(float);
  const bool in_smem = need + attr.sharedSizeBytes <= (size_t)optin;
  if (in_smem) {
    err = cudaFuncSetAttribute(greedy_pass_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(need));
    if (err != cudaSuccess) return err;
  }
  greedy_pass_kernel<kVec><<<1, kPassThreads, in_smem ? need : 0, stream>>>(
      sj, req, free0, list_val, list_col, list_cnt, free_after, picks,
      fallbacks, p, n, r, in_smem ? 1 : 0);
  return cudaGetLastError();
}

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
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* sj_f = static_cast<const float*>(sj);
    const auto* price_f = static_cast<const float*>(price);
    const auto* active_b = static_cast<const unsigned char*>(active);
    const auto* req_f = static_cast<const float*>(req);
    const auto* free_f = static_cast<const float*>(free_cap);
    if (n % 4 == 0 && aligned16(sj) && aligned16(price)) {
      auction_bid_kernel<true><<<grid_rows(p), kThreads, 0, s>>>(
          sj_f, price_f, active_b, req_f, free_f, static_cast<int*>(bid),
          static_cast<int*>(has), p, n, r);
    } else {
      auction_bid_kernel<false><<<grid_rows(p), kThreads, 0, s>>>(
          sj_f, price_f, active_b, req_f, free_f, static_cast<int*>(bid),
          static_cast<int*>(has), p, n, r);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int ks_greedy_scan(const void* sj, const void* req, const void* free0,
                   void* free_after, void* picks, void* list_val,
                   void* list_col, void* list_cnt, void* fallbacks, int p,
                   int n, int r, int list_len, void* stream) {
  const auto* sj_f = static_cast<const float*>(sj);
  const auto* req_f = static_cast<const float*>(req);
  const auto* free0_f = static_cast<const float*>(free0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n % 4 == 0 && aligned16(sj)
          ? launch_greedy_scan<true>(
                sj_f, req_f, free0_f, static_cast<float*>(free_after),
                static_cast<int*>(picks), static_cast<float*>(list_val),
                static_cast<int*>(list_col), static_cast<int*>(list_cnt),
                static_cast<int*>(fallbacks), p, n, r, list_len, s)
          : launch_greedy_scan<false>(
                sj_f, req_f, free0_f, static_cast<float*>(free_after),
                static_cast<int*>(picks), static_cast<float*>(list_val),
                static_cast<int*>(list_col), static_cast<int*>(list_cnt),
                static_cast<int*>(fallbacks), p, n, r, list_len, s);
  return static_cast<int>(err);
}

}  // extern "C"
