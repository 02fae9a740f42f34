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
// consecutive addresses (K1, K3 and K4 four columns a thread, one 16-byte
// load where n % 4 == 0). The [k, p]/[k, n] transposes of the TPU kernels
// existed for its lanes and are not carried over, except for the selector
// operands, whose [4S, p] / [3S, n] rows already give coalesced reads.
// K1 and K2 read the node operands once per group of pods, not once per
// cell; K3 and K4 read a node's capacity words only for a cell whose value
// could change the first maximum they keep.
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

// 10 - 10 * load, the tail of the score: non-increasing in load, since
// each correctly rounded step is monotone
__device__ __forceinline__ float score_of_load(float load) {
  return __fsub_rn(kMaxRawScore, __fmul_rn(kMaxRawScore, load));
}

// |alpha * v - beta * u|, the load of ops/score.balanced_cpu_diskio
__device__ __forceinline__ float load_of(float alpha, float beta, float u,
                                         float v) {
  return fabsf(__fsub_rn(__fmul_rn(alpha, v), __fmul_rn(beta, u)));
}

// 10 - 10 * |alpha * v - beta * u|  (ops/score.balanced_cpu_diskio)
__device__ __forceinline__ float raw_score(float alpha, float beta, float u,
                                           float v) {
  return score_of_load(load_of(alpha, beta, u, v));
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

// load4 for a stream touched once (evict-first, `ld.global.cs`), 0 past
// column n - 1
template <bool kVec>
__device__ __forceinline__ float4 load4_once(const float* row, int j, int n) {
  if (kVec) return __ldcs(reinterpret_cast<const float4*>(row + j));
  return make_float4(__ldcs(row + j), j + 1 < n ? __ldcs(row + j + 1) : 0.0f,
                     j + 2 < n ? __ldcs(row + j + 2) : 0.0f,
                     j + 3 < n ? __ldcs(row + j + 3) : 0.0f);
}

// The row values at columns j..j+3 that exist, as streaming stores
// (`st.global.cs`): one 16-byte store under kVec
template <bool kVec>
__device__ __forceinline__ void store4_once(float* row, int j, int n,
                                            float4 x) {
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(row + j), x);
    return;
  }
  __stcs(row + j, x.x);
  if (j + 1 < n) __stcs(row + j + 1, x.y);
  if (j + 2 < n) __stcs(row + j + 2, x.z);
  if (j + 3 < n) __stcs(row + j + 3, x.w);
}

// max and min that return NaN when either operand is NaN (PTX max.NaN,
// min.NaN, sm_80 on); fmaxf and fminf would drop the NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// K1: masked_score, replacing fused_masked_score (pallas_fused.py:252,
// body _fused_kernel :87). Output: the (optionally min-max normalized)
// score where the cell is feasible, NEG elsewhere.
//
// Bound on the H100: bytes, the [p, n] `other` read and the [p, n] output
// write, each touched once (2 x 41 MB at 1,024 x 10,000). The per-node
// operands (u, v, node_mask, r words of reqd and of alloc, 3S selector
// words) are ~45 B a column at S = 1 and r = 3; read once per cell they
// cost L2 ten times the HBM bytes. So a block is node-stationary:
//
// - it owns kScoreCols = 1,024 columns (four consecutive ones a thread)
//   and walks a group of kScoreGroup pods, with kScoreBlocks blocks
//   resident on an SM (registers capped to fit);
// - each thread reads its columns' node operands once into registers,
//   with the selector rows folded into per-column bitmasks: bit s of pres
//   and avo is selector s's presence and avoider flag (S <= 32: one word);
// - the group's pod scalars are staged in shared memory once, a PodRow
//   a pod (alpha, beta, the epilogue's lo and hi - lo, target, pod_ok,
//   and the selectors' required / anti / match flags as words of bits)
//   plus its requests;
// - NodeResourcesFit runs once per group, resource by resource: a thread
//   reads its four columns' reqd and alloc words of resource k and tests
//   every pod of the group against them, into a 64-bit word of fit bits
//   (bit 4g + c: pod g fits column j + c). Each word is read once per
//   group whatever r is, and the pod walk takes four bits a pod;
// - a cell's feasibility is a predicate per column, so each test is one
//   compare folded into it;
// - per pod, a thread reads its four cells of `other` as one 16-byte
//   streaming load (kPodUnroll rows in flight) and writes its four output
//   cells as one 16-byte streaming store.
//
// The selector test on words is exact: some selector s has
// (req_s & !pres_s) | (anti_s & pres_s) | (match_s & avo_s) exactly when
// the word (req & ~pres) | (anti & pres) | (match & avo) is nonzero. The
// spread term count + 1 - dmin > thresh stays a float compare per
// selector, made only for the pod's selectors with thresh below the
// largest count + 1 - dmin of the block's columns (NaN ignored): for any
// other selector no column of the block can fail it (a NaN on either side
// never fails), so skipping it is exact. Unconstrained selectors carry
// thresh = F32_MAX and are skipped.
//
// A pod whose four cells are infeasible before `other` (pod masked, pinned
// elsewhere, no node-masked column) does not read its `other` cells. The
// arithmetic is raw_score's and the epilogue's, unchanged, so every cell
// is bit-identical to the plain version.
//
// The pass is bound by instruction issue more than by bytes: the four
// correctly rounded divisions of the epilogue and the feasibility tests
// make up most of a pod's instructions. So the four scores come first
// (a division's rare slow path is a call, and no predicate is live
// across it), and the feasibility tests then run as straight-line
// predicates. On the H100, 16 pods a group, 3 blocks an SM and 2 rows of
// `other` in flight measured fastest of the shapes tried.
constexpr int kScoreCols = 4 * kThreads;  // columns a K1 block owns
constexpr int kScoreGroup = 16;           // pods a K1 block walks
constexpr int kScoreBlocks = 3;           // K1 blocks resident on an SM
constexpr int kPodUnroll = 2;             // `other` rows in flight a thread

// A pod's row of K1's shared table: three 16-byte shared loads a pod
struct __align__(16) PodRow {
  float a, b, lo, span;        // alpha, beta, the epilogue's lo and hi - lo
  int tgt, ok, pad0, pad1;     // nodeName pin (-1 none), pod_ok
  unsigned req, anti, match, spread;  // selector flags, bit s selector s
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kScoreBlocks) masked_score_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const unsigned char* __restrict__ pod_ok, const int* __restrict__ target,
    const float* __restrict__ u, const float* __restrict__ v,
    const unsigned char* __restrict__ node_mask,
    const float* __restrict__ pod_req, const float* __restrict__ alloc,
    const float* __restrict__ reqd, const float* __restrict__ aff_pod,
    const float* __restrict__ aff_node, const float* __restrict__ other,
    const float* __restrict__ stats, float* __restrict__ out, int p, int n,
    int r, int n_sel) {
  static_assert(4 * kScoreGroup <= 64, "a pod group's fit bits fill one word");
  __shared__ PodRow s_pod[kScoreGroup];
  __shared__ float s_q[kScoreGroup * kMaxRes];
  __shared__ float s_thr[kScoreGroup * kMaxSel];
  __shared__ float s_cmax[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float neg_inf = __int_as_float(0xff800000);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int j = blockIdx.x * kScoreCols + 4 * t;  // the first of 4 columns
  const bool live = j < n;

  // this thread's columns' node operands, read once for every pod
  float uu[4] = {0.0f, 0.0f, 0.0f, 0.0f}, vv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  unsigned nm = 0;  // bit c: column j + c exists and is node-masked in
  unsigned pres[4] = {0u, 0u, 0u, 0u}, avo[4] = {0u, 0u, 0u, 0u};
  float cmax = neg_inf;
  if (live) {
    const float4 u4 = load4<kVec>(u, j, n, 0.0f);
    const float4 v4 = load4<kVec>(v, j, n, 0.0f);
    uu[0] = u4.x; uu[1] = u4.y; uu[2] = u4.z; uu[3] = u4.w;
    vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c < n && node_mask[j + c] != 0) nm |= 1u << c;
    for (int sel = 0; sel < n_sel; ++sel) {
      const float4 pr = load4<kVec>(aff_node + (size_t)sel * n, j, n, 0.0f);
      const float4 av =
          load4<kVec>(aff_node + (size_t)(n_sel + sel) * n, j, n, 0.0f);
      const float4 cp =
          load4<kVec>(aff_node + (size_t)(2 * n_sel + sel) * n, j, n, neg_inf);
      pres[0] |= (unsigned)(pr.x > 0.0f) << sel;
      pres[1] |= (unsigned)(pr.y > 0.0f) << sel;
      pres[2] |= (unsigned)(pr.z > 0.0f) << sel;
      pres[3] |= (unsigned)(pr.w > 0.0f) << sel;
      avo[0] |= (unsigned)(av.x > 0.0f) << sel;
      avo[1] |= (unsigned)(av.y > 0.0f) << sel;
      avo[2] |= (unsigned)(av.z > 0.0f) << sel;
      avo[3] |= (unsigned)(av.w > 0.0f) << sel;
      cmax = fmaxf(cmax, fmaxf(fmaxf(cp.x, cp.y), fmaxf(cp.z, cp.w)));
    }
  }
  // the block's largest count + 1 - dmin (NaN ignored)
  for (int off = 16; off > 0; off >>= 1)
    cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, off));
  if (lane == 0) s_cmax[warp] = cmax;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) cmax = fmaxf(cmax, s_cmax[w]);

  const int groups = (p + kScoreGroup - 1) / kScoreGroup;
  for (int gi = blockIdx.y; gi < groups; gi += gridDim.y) {
    const int i0 = gi * kScoreGroup;
    const int cnt = min(kScoreGroup, p - i0);
    __syncthreads();  // the previous group's shared rows are no longer read
    if (t < cnt) {
      const int i = i0 + t;
      PodRow row;
      row.a = alpha[i];
      row.b = beta[i];
      row.lo = 0.0f;
      row.span = 0.0f;
      if (stats != nullptr) {
        row.lo = stats[p + i];
        row.span = __fsub_rn(stats[i], row.lo);
      }
      row.tgt = target[i];
      row.ok = pod_ok[i];
      row.pad0 = row.pad1 = 0;
      row.req = row.anti = row.match = row.spread = 0u;
      s_pod[t] = row;
    }
    for (int at = t; at < cnt * r; at += kThreads)
      s_q[at] = pod_req[(size_t)i0 * r + at];
    __syncthreads();  // the selector flags below complete s_pod's rows
    // selector flags: warp w takes pods w, w + 8, ...; lane s selector s
    for (int g = warp; n_sel > 0 && g < cnt; g += kWarps) {
      const size_t i = i0 + g;
      const bool on = lane < n_sel;
      const float thr = on ? aff_pod[(size_t)(3 * n_sel + lane) * p + i] : 0.0f;
      const unsigned req_b =
          __ballot_sync(kFull, on && aff_pod[(size_t)lane * p + i] > 0.0f);
      const unsigned anti_b = __ballot_sync(
          kFull, on && aff_pod[(size_t)(n_sel + lane) * p + i] > 0.0f);
      const unsigned match_b = __ballot_sync(
          kFull, on && aff_pod[(size_t)(2 * n_sel + lane) * p + i] > 0.0f);
      const unsigned spread_b = __ballot_sync(kFull, on && thr < cmax);
      if (on) s_thr[g * kMaxSel + lane] = thr;
      if (lane == 0) {
        s_pod[g].req = req_b;
        s_pod[g].anti = anti_b;
        s_pod[g].match = match_b;
        s_pod[g].spread = spread_b;
      }
    }
    __syncthreads();
    if (!live) continue;  // no barrier below
    // kPodUnroll rows of `other` in flight while the previous ones are
    // scored; a pod whose cells here are infeasible before `other` (pod
    // masked, pinned elsewhere, no node-masked column) reads none, and
    // without `other` every cell passes its test
    const float4 none4 = other != nullptr ? zero4 : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    float4 cur[kPodUnroll];
#pragma unroll
    for (int k = 0; k < kPodUnroll; ++k) {
      const int tg = s_pod[k].tgt;
      cur[k] = other != nullptr && k < cnt && nm != 0 && s_pod[k].ok != 0 &&
                       (tg < 0 || (unsigned)(tg - j) < 4u)
                   ? load4_once<kVec>(other + (size_t)(i0 + k) * n, j, n)
                   : none4;
    }
    // NodeResourcesFit for the group, while the first rows of `other`
    // load: bit 4g + c is cleared where pod g requests resource k and
    // reqd + request > alloc at column j + c (an unrequested resource
    // never excludes a node; NaN never fits)
    unsigned long long fit = ~0ull;
    for (int k = 0; k < r; ++k) {
      float rq[4], al[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool here = j + c < n;
        rq[c] = here ? __ldg(reqd + (size_t)(j + c) * r + k) : 0.0f;
        al[c] = here ? __ldg(alloc + (size_t)(j + c) * r + k) : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < kScoreGroup; ++g) {
        const float qk = s_q[g * r + k];
        const unsigned ok = (unsigned)((__fadd_rn(rq[0], qk) <= al[0]) | (qk == 0.0f)) |
                            (unsigned)((__fadd_rn(rq[1], qk) <= al[1]) | (qk == 0.0f)) << 1 |
                            (unsigned)((__fadd_rn(rq[2], qk) <= al[2]) | (qk == 0.0f)) << 2 |
                            (unsigned)((__fadd_rn(rq[3], qk) <= al[3]) | (qk == 0.0f)) << 3;
        fit &= ~((unsigned long long)(~ok & 0xfu) << (4 * g));
      }
    }
    for (int g0 = 0; g0 < cnt; g0 += kPodUnroll) {
      float4 nxt[kPodUnroll];
#pragma unroll
      for (int k = 0; k < kPodUnroll; ++k) {
        const int g = g0 + kPodUnroll + k;
        const int tg = g < cnt ? s_pod[g].tgt : 0;
        nxt[k] = other != nullptr && g < cnt && nm != 0 && s_pod[g].ok != 0 &&
                         (tg < 0 || (unsigned)(tg - j) < 4u)
                     ? load4_once<kVec>(other + (size_t)(i0 + g) * n, j, n)
                     : none4;
      }
#pragma unroll
      for (int k = 0; k < kPodUnroll; ++k) {
        const int g = g0 + k;
        if (g >= cnt) break;
        const PodRow pr = s_pod[g];
        // the four scores first: the division's rare slow path is a call,
        // and no feasibility predicate is live across it
        float res[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          res[c] = raw_score(pr.a, pr.b, uu[c], vv[c]);
          if (stats != nullptr)
            res[c] = __fdiv_rn(__fmul_rn(__fsub_rn(res[c], pr.lo), kMaxNodeScore),
                               pr.span);
        }
        // bit c: column j + c passes the pod and node masks, the nodeName
        // pin and the selector families (words are 0 without selectors)
        unsigned bits = pr.ok != 0 ? nm & (unsigned)(fit >> (4 * g)) & 0xfu : 0u;
        if (pr.tgt >= 0)
          bits &= (unsigned)(pr.tgt - j) < 4u ? 1u << (pr.tgt - j) : 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if ((pr.req & ~pres[c]) | (pr.anti & pres[c]) | (pr.match & avo[c]))
            bits &= ~(1u << c);
        for (unsigned sp = pr.spread; sp != 0; sp &= sp - 1) {
          const int sel = __ffs(sp) - 1;
          const float thr = s_thr[g * kMaxSel + sel];
          const float4 cp = load4<kVec>(
              aff_node + (size_t)(2 * n_sel + sel) * n, j, n, 0.0f);
          bits &= ~((unsigned)(cp.x > thr) | (unsigned)(cp.y > thr) << 1 |
                    (unsigned)(cp.z > thr) << 2 | (unsigned)(cp.w > thr) << 3);
        }
        // the last test as a predicate, straight-line: `other`
        const float oc[4] = {cur[k].x, cur[k].y, cur[k].z, cur[k].w};
        bool f[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) f[c] = ((bits >> c) & 1u) & (oc[c] > 0.0f);
        store4_once<kVec>(out + (size_t)(i0 + g) * n, j, n,
                          make_float4(f[0] ? res[0] : kNeg, f[1] ? res[1] : kNeg,
                                      f[2] ? res[2] : kNeg, f[3] ? res[3] : kNeg));
      }
#pragma unroll
      for (int k = 0; k < kPodUnroll; ++k) cur[k] = nxt[k];
    }
  }
}

// K2: row_stats, replacing fused_score_row_stats (pallas_fused.py:385,
// body _row_stats_kernel :176): per pod, the max and min raw score over
// node-masked nodes, -F32_MAX / F32_MAX for a pod with none, NaN for both
// when any node-masked cell's score is NaN (the reference's max and min
// propagate it; a NaN on a masked-out node changes nothing).
//
// Bound on the H100: operations, p x (node-masked nodes) cells from
// O(p + n) input bytes. The score is 10 - 10 * load with load =
// |alpha * v - beta * u|, and x -> 10 - 10 * x (each step rounded) is
// non-increasing, so max score = score_of_load(min load) and min score =
// score_of_load(max load), exactly: a cell costs two products, a
// difference and a NaN-propagating min and max of |d|, and 10 - 10 * x
// runs twice a row. No node-masked node leaves the max load at -inf
// (every load is >= 0 or NaN).
//
// Design: a block takes kStatsPods pods, held in registers, and walks all
// nodes, four consecutive ones a thread a step (16-byte loads of u and v
// and a 4-byte load of node_mask where aligned), so u, v and node_mask are
// read once per kStatsPods pods and each load serves kStatsPods cells. The
// block then reduces each pod's (min, max) across its threads in the same
// launch (a transposed warp reduction, then shared memory): no partials,
// no second pass. Min and max are exact in any order. At 1,024 pods that
// is 128 blocks, about one an SM. On the H100, one group a step measured
// faster than several in flight or double-buffered, and 640 threads faster
// than 384, 512, 768 or 1,024.
constexpr int kStatsPods = 8;       // pods a K2 block takes
constexpr int kStatsThreads = 640;  // threads a K2 block walks nodes with

// node_mask at columns j..j+3 as bits, 0 past column n - 1: one 4-byte
// load under kVec (n % 4 == 0, a 4-byte aligned base)
template <bool kVec>
__device__ __forceinline__ unsigned mask4(const unsigned char* __restrict__ m,
                                          int j, int n) {
  if (kVec) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(m + j));
    return (unsigned)((w & 0xffu) != 0) | (unsigned)((w & 0xff00u) != 0) << 1 |
           (unsigned)((w & 0xff0000u) != 0) << 2 |
           (unsigned)((w & 0xff000000u) != 0) << 3;
  }
  unsigned bits = 0;
  for (int c = 0; c < 4; ++c)
    if (j + c < n && __ldg(m + j + c) != 0) bits |= 1u << c;
  return bits;
}

// One step of K2's transposed warp reduction: each lane holds 2m values
// and keeps the half picked by lane bit `off`, folded with the partner's
// copy of it; the op is max for lanes with bit 16 set (the max loads),
// min for the others.
template <int kM>
__device__ __forceinline__ void fold_half(const float (&in)[2 * kM],
                                          float (&out)[kM], int lane,
                                          int off) {
  const bool upper = lane & off;
  const bool is_max = lane & 16;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    const float keep = upper ? in[kM + i] : in[i];
    const float send = upper ? in[i] : in[kM + i];
    const float got = __shfl_xor_sync(kFull, send, off);
    out[i] = is_max ? max_nan(keep, got) : min_nan(keep, got);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kStatsThreads) row_stats_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ u, const float* __restrict__ v,
    const unsigned char* __restrict__ node_mask, float* __restrict__ out,
    int p, int n) {
  constexpr int kStatsWarps = kStatsThreads / 32;
  constexpr int kStep = 4 * kStatsThreads;  // columns a block reads a step
  static_assert(kStatsPods == 8, "the transposed reduction folds 16 values");
  __shared__ float s_ab[2 * kStatsPods];
  __shared__ float s_red[kStatsWarps][2 * kStatsPods];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int i0 = blockIdx.x * kStatsPods;
  if (t < 2 * kStatsPods) {
    const int i = i0 + (t & (kStatsPods - 1));
    s_ab[t] = i < p ? (t < kStatsPods ? alpha[i] : beta[i]) : 0.0f;
  }
  __syncthreads();
  float a[kStatsPods], b[kStatsPods], lmin[kStatsPods], lmax[kStatsPods];
#pragma unroll
  for (int k = 0; k < kStatsPods; ++k) {
    a[k] = s_ab[k];
    b[k] = s_ab[kStatsPods + k];
    lmin[k] = __int_as_float(0x7f800000);  // +inf
    lmax[k] = __int_as_float(0xff800000);  // -inf
  }
  // thread t: the 4-node groups at columns 4t, 4t + kStep, ...
  for (int j = 4 * t; j < n; j += kStep) {
    const unsigned on = mask4<kVec>(node_mask, j, n);
    const float4 u4 = load4<kVec>(u, j, n, 0.0f);
    const float4 v4 = load4<kVec>(v, j, n, 0.0f);
    const float us[4] = {u4.x, u4.y, u4.z, u4.w};
    const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!((on >> c) & 1u)) continue;
#pragma unroll
      for (int k = 0; k < kStatsPods; ++k) {
        const float d = load_of(a[k], b[k], us[c], vs[c]);
        lmin[k] = min_nan(lmin[k], d);
        lmax[k] = max_nan(lmax[k], d);
      }
    }
  }
  // the pods' (min, max) across the warp: 16 values folded by halves,
  // 16 shuffles in all; lane l ends with value (l >> 1) & 15 in the order
  // lmin[0..7], lmax[0..7]
  float v16[16], v8[8], v4[4], v2[2], v1[1];
#pragma unroll
  for (int k = 0; k < kStatsPods; ++k) {
    v16[k] = lmin[k];
    v16[kStatsPods + k] = lmax[k];
  }
  fold_half<8>(v16, v8, lane, 16);
  fold_half<4>(v8, v4, lane, 8);
  fold_half<2>(v4, v2, lane, 4);
  fold_half<1>(v2, v1, lane, 2);
  const float got = __shfl_xor_sync(kFull, v1[0], 1);
  const float mine = lane & 16 ? max_nan(v1[0], got) : min_nan(v1[0], got);
  if ((lane & 1) == 0) s_red[warp][lane >> 1] = mine;
  __syncthreads();
  if (t < kStatsPods && i0 + t < p) {
    float mn = s_red[0][t], mx = s_red[0][kStatsPods + t];
    for (int w = 1; w < kStatsWarps; ++w) {
      mn = min_nan(mn, s_red[w][t]);
      mx = max_nan(mx, s_red[w][kStatsPods + t]);
    }
    const bool none = mx == __int_as_float(0xff800000);
    out[i0 + t] = none ? -FLT_MAX : score_of_load(mn);
    out[p + i0 + t] = none ? FLT_MAX : score_of_load(mx);
  }
}

// (value, column) pair order of the auction's argmax: the greater value
// wins, and among equal values the smaller column (jnp.argmax's first
// maximum).
__device__ __forceinline__ bool bid_better(float val, int col, float best,
                                           int best_col) {
  return val > best || (val == best && col < best_col);
}

// K4's total order on cells, as one integer: rank(x, col) > rank(y, c)
// exactly when cell (x, col) comes first. The high word is the value's
// key: a NaN above every number, +inf included, and -0 equal to +0. The
// low word puts the smaller column first among equal keys, NaN among NaN
// too (torch.argmax's and jnp.argmax's rule). No key is 0 (those would be
// a NaN's bits) and no low word is above INT_MAX, so every rank lies in
// (0, ~0). A cell qualifies for K4 (its value is not <= NEG/2, so a NaN
// does: the reference's XLA scan body, feasible & cap_ok) exactly when its
// key is above qualify_key(). K3 keeps bid_better: it never sees a NaN
// (auction_values zeroes a row whose bounds are not finite).
__device__ __forceinline__ unsigned value_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));  // -0 + 0 = +0
  return x != x ? 0xffffffffu : b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ unsigned long long cell_rank(unsigned key,
                                                        int col) {
  return ((unsigned long long)key << 32) | (unsigned)(INT_MAX - col);
}

__device__ __forceinline__ int rank_col(unsigned long long k) {
  return INT_MAX - (int)(unsigned)k;
}

__device__ __forceinline__ unsigned qualify_key() {
  return value_key(kNegHalf);
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

// fits() with its loop over resources kept rolled, for K4's list kernel:
// there nvcc unrolled the four inlined copies and ptxas spilled 16 bytes
// (8 with kVec) though the kernel used 48 of its 255 registers; rolled,
// the kernel spills nothing (csrc/kernel_budget.json). The same tests in
// the same order, so the same result.
__device__ __forceinline__ bool fits_rolled(const float* q, const float* cap,
                                            int col, int r) {
  const float* c = cap + (size_t)col * r;
  bool ok = true;
#pragma unroll 1
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
// takes the first cell, under cell_rank's order, of the cells that are
// not <= NEG/2 and have capacity for every requested resource under the
// capacity the pods before it left; its request is subtracted from that
// one column (__fsub_rn). picks[i] = -1, and nothing changes, when no cell
// qualifies. A NaN cell qualifies and ranks above every number, the first
// NaN first: the rule of the reference's XLA scan body (feasible & cap_ok,
// then jnp.argmax), which is what the reference runs off the TPU.
//
// Bound on the H100: bytes. sj is read once, p * n * 4 B (1,024 x 10,000
// on the main path: about 41 MB, about 12 us at 3.35 TB/s). The carry
// makes every pod depend on the one before it, but only through the few
// columns earlier pods took, so the scan is split in two launches:
//
// 1. greedy_lists_kernel, one block per row on every SM: each row's
//    candidate list, its qualifying cells (not <= NEG/2, and capacity under
//    free0) in cell_rank's order, as (key, column) pairs: up to
//    kListLen = 256 of them, of which the first `cnt` are known to be the
//    row's first `cnt` qualifying cells.
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
// no longer fits. None of this uses more of the order than that it is a
// fixed total order on cells, so it holds under cell_rank's, NaN
// included. When no entry fits and the list holds every qualifying
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
//
// Every comparison of cells is one comparison of their ranks: the list
// insert and merge, the bound B, the row scan (a cell between the running
// best and the list's last entry) and its reductions; the candidate test
// compares keys alone, since a warp's columns ascend.
constexpr int kListThreads = 256;
constexpr int kListWarps = kListThreads / 32;
constexpr int kListLen = kListWarps * 32;    // ops/fused.GREEDY_LIST_LEN
constexpr int kListFull = 1 << 30;           // list_cnt flag: cells remain
constexpr int kChunk = 4 * 32;               // columns a warp reads per step
constexpr int kPassThreads = 1024;
constexpr int kPassWarps = kPassThreads / 32;  // one per lane of warp 0
constexpr int kBatches = kListLen / 32;      // list entries per lane
constexpr int kScanUnroll = 4;               // row scan: 16-byte loads in flight

// Insert (k, c) into a warp's list, one (key, column) entry per lane in
// rank order (lane 0 the best; empty entries are (0, INT_MAX), rank 0);
// the last entry drops out. A no-op when all 32 entries rank above (k, c).
__device__ __forceinline__ void list_insert(unsigned& lk, int& lc, unsigned k,
                                            int c, int lane) {
  const int pos =
      __popc(__ballot_sync(kFull, cell_rank(lk, lc) > cell_rank(k, c)));
  const unsigned up_k = __shfl_up_sync(kFull, lk, 1);
  const int up_c = __shfl_up_sync(kFull, lc, 1);
  if (lane == pos) {
    lk = k;
    lc = c;
  } else if (lane > pos) {
    lk = up_k;
    lc = up_c;
  }
}

// Phase 1. Warp w of row i's block reads the 128-column chunks w, w + 8,
// ... (lane l four consecutive columns of each, one 16-byte load where
// aligned, the next chunk's load in flight), so the columns a warp meets
// ascend from chunk to chunk. It keeps its own top 32; a cell is a
// candidate only when its key is above both qualify_key() and the list's
// last key at the start of its chunk (an equal key comes at a larger
// column and ranks below), and only a candidate's r capacity words are
// read. Candidates are inserted one at a time.
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
    const float* __restrict__ free0, unsigned* __restrict__ list_key,
    int* __restrict__ list_col, int* __restrict__ list_cnt, int p, int n,
    int r, int list_len) {
  __shared__ float s_req[kMaxRes];
  __shared__ unsigned s_lk[kListLen];
  __shared__ int s_lc[kListLen];
  __shared__ int s_bcol;   // B's column, INT_MAX when no warp list is full
  __shared__ int s_bpos;   // B's position in the merged list
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float4 fill = make_float4(kNeg, kNeg, kNeg, kNeg);
  constexpr int kStride = kListWarps * kChunk;
  for (int i = blockIdx.x; i < p; i += gridDim.x) {
    __syncthreads();  // the previous row's shared values are no longer read
    for (int k = t; k < r; k += blockDim.x) s_req[k] = req[(size_t)i * r + k];
    __syncthreads();
    const float* row = sj + (size_t)i * n;
    unsigned lk = 0;  // this lane's entry of the warp's list
    int lc = INT_MAX;
    // a candidate's key is above thr: the list's last key, or
    // qualify_key() while the list has room
    unsigned thr = qualify_key();
    int j = warp * kChunk + 4 * lane;
    float4 ahead = j < n ? load4<kVec>(row, j, n, kNeg) : fill;
    for (int base = warp * kChunk; base < n; base += kStride, j += kStride) {
      const float4 x = ahead;
      ahead = j + kStride < n ? load4<kVec>(row, j + kStride, n, kNeg) : fill;
      const unsigned kx = value_key(x.x), ky = value_key(x.y),
                     kz = value_key(x.z), kw = value_key(x.w);
      unsigned pend = 0;
      if (kx > thr && fits_rolled(s_req, free0, j, r)) pend |= 1u;
      if (ky > thr && fits_rolled(s_req, free0, j + 1, r)) pend |= 2u;
      if (kz > thr && fits_rolled(s_req, free0, j + 2, r)) pend |= 4u;
      if (kw > thr && fits_rolled(s_req, free0, j + 3, r)) pend |= 8u;
      for (unsigned who = __ballot_sync(kFull, pend != 0); who != 0;
           who = __ballot_sync(kFull, pend != 0)) {
        const int src = __ffs(who) - 1;
        const int e = __ffs(pend) - 1;  // this lane's first pending cell
        const unsigned mine = e == 0 ? kx : e == 1 ? ky : e == 2 ? kz : kw;
        const unsigned k = __shfl_sync(kFull, mine, src);
        const int c = __shfl_sync(kFull, j + e, src);
        if (lane == src) pend &= pend - 1;
        list_insert(lk, lc, k, c, lane);
      }
      const unsigned last = __shfl_sync(kFull, lk, 31);
      if (last > thr) thr = last;
    }
    s_lk[t] = lk;
    s_lc[t] = lc;
    __syncthreads();
    if (t == 0) {  // B: the best last entry of a full warp list
      unsigned long long b = 0;
      int bc = INT_MAX;
      for (int w = 0; w < kListWarps; ++w) {
        const int last = 32 * w + 31;
        const unsigned long long k = cell_rank(s_lk[last], s_lc[last]);
        if (s_lc[last] != INT_MAX && k > b) {
          b = k;
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
          const unsigned uv = s_lk[u];
          const int uc = s_lc[u];
          if (cell_rank(uv, uc) > cell_rank(s_lk[t], s_lc[t])) {
            s_lk[u] = s_lk[t];
            s_lc[u] = s_lc[t];
            s_lk[t] = uv;
            s_lc[t] = uc;
          }
        }
        __syncthreads();
      }
    }
    lk = s_lk[t];
    lc = s_lc[t];
    list_key[(size_t)i * kListLen + t] = lk;
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
    const float* __restrict__ free0, const unsigned* __restrict__ list_key,
    const int* __restrict__ list_col, const int* __restrict__ list_cnt,
    float* free_after, int* __restrict__ picks, int* __restrict__ fallbacks,
    int p, int n, int r, int free_in_smem) {
  extern __shared__ float s_free[];
  __shared__ float s_req[kMaxRes];
  __shared__ unsigned long long s_rank[kPassWarps];
  // the row scan takes the cells ranked below s_hi: after the list's last
  // entry, or every cell (~0) once the guard has tripped
  __shared__ unsigned long long s_hi;
  __shared__ int s_pod;       // the pod whose row the block scans; p: done
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
        s_hi = ~0ull;
        if (i < p && exact) {
          const size_t last =
              (size_t)i * kListLen + (list_cnt[i] & (kListFull - 1)) - 1;
          s_hi = cell_rank(list_key[last], list_col[last]);
        }
      }
      next = i + 1;
    }
    __syncthreads();
    const int i = s_pod;
    if (i >= p) break;
    const unsigned long long hi = s_hi;
    const float* row = sj + (size_t)i * n;
    // the best cell that qualifies, fits and ranks below hi; thread t reads
    // float4 groups t, t + T, ... (T = blockDim.x), kScanUnroll loads in
    // flight before any is compared
    const unsigned long long none = cell_rank(qualify_key(), 0);
    unsigned long long best = none;
    auto cell = [&](float x, int col) {
      const unsigned long long k = cell_rank(value_key(x), col);
      if (k > best && k < hi && fits(s_req, fr, col, r)) best = k;
    };
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
      const unsigned long long o = __shfl_down_sync(kFull, best, off);
      if (o > best) best = o;
    }
    if (lane == 0) s_rank[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = s_rank[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(kFull, best, off);
        if (o > best) best = o;
      }
      best = __shfl_sync(kFull, best, 0);
      const int pick = best > none ? rank_col(best) : -1;
      if (lane == 0) picks[i] = pick;
      if (pick >= 0 && lane < r) {
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
                               int* picks, unsigned* list_key, int* list_col,
                               int* list_cnt, int* fallbacks, int p, int n,
                               int r, int list_len, cudaStream_t stream) {
  if (p > 0) {
    greedy_lists_kernel<kVec><<<grid_rows(p), kListThreads, 0, stream>>>(
        sj, req, free0, list_key, list_col, list_cnt, p, n, r, list_len);
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
      sj, req, free0, list_key, list_col, list_cnt, free_after, picks,
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
    const dim3 grid((n + kScoreCols - 1) / kScoreCols,
                    grid_rows((p + kScoreGroup - 1) / kScoreGroup));
    const bool vec = n % 4 == 0 && aligned16(u) && aligned16(v) &&
                     aligned16(out) && aligned16(other) && aligned16(aff_node);
    auto* kernel = vec ? masked_score_kernel<true> : masked_score_kernel<false>;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
    const int blocks = (p + kStatsPods - 1) / kStatsPods;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* alpha_f = static_cast<const float*>(alpha);
    const auto* beta_f = static_cast<const float*>(beta);
    const auto* u_f = static_cast<const float*>(u);
    const auto* v_f = static_cast<const float*>(v);
    const auto* mask_b = static_cast<const unsigned char*>(node_mask);
    if (n % 4 == 0 && aligned16(u) && aligned16(v) &&
        reinterpret_cast<uintptr_t>(node_mask) % 4 == 0) {
      row_stats_kernel<true><<<blocks, kStatsThreads, 0, s>>>(
          alpha_f, beta_f, u_f, v_f, mask_b, static_cast<float*>(out), p, n);
    } else {
      row_stats_kernel<false><<<blocks, kStatsThreads, 0, s>>>(
          alpha_f, beta_f, u_f, v_f, mask_b, static_cast<float*>(out), p, n);
    }
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
                   void* free_after, void* picks, void* list_key,
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
                static_cast<int*>(picks), static_cast<unsigned*>(list_key),
                static_cast<int*>(list_col), static_cast<int*>(list_cnt),
                static_cast<int*>(fallbacks), p, n, r, list_len, s)
          : launch_greedy_scan<false>(
                sj_f, req_f, free0_f, static_cast<float*>(free_after),
                static_cast<int*>(picks), static_cast<unsigned*>(list_key),
                static_cast<int*>(list_col), static_cast<int*>(list_cnt),
                static_cast<int*>(fallbacks), p, n, r, list_len, s);
  return static_cast<int>(err);
}

}  // extern "C"
