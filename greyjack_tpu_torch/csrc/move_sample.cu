// The plain step's move sampler for NVIDIA Hopper (sm_90a): one move on
// every candidate, then the fix of every value, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this function
// (`greyjack_tpu/ops/moves.py` `do_move`, then the variables manager's
// `fix_all`) as XLA ops. Python side: `greyjack_tpu_torch/ops/
// move_kernel.py`; its plain torch version is `ops/moves.py` `do_move`
// followed by `VariablesManager.fix_all`, which this kernel matches bit
// for bit, fed the same f64 uniforms `u` [I, P, W].
//
// One block is one candidate (island i, neighbour n). It
//   1. turns its columns of `u` into the noise leaves as `moves._draw`
//      does (f32 uniforms on the 2^-24 grid, Gumbels by two logf, integers,
//      the Binomial count as a block-wide sum);
//   2. picks the 8 preferred positions of the drawn group by the
//      total-order keys of `selection.topk_first` (score image above, the
//      reversed index below, so ties go to the lower index): each thread
//      keeps a sorted top 8 of its strided positions, each warp merges its
//      lanes' lists, and warp 0 merges the warps';
//   3. plans the one live move type: a list of at most 16 (target,
//      source) pairs for swap, swap-edges (the sequential swaps composed in
//      `do_move`'s order) and scramble, a slot range [lo, hi] of the
//      group's member row for insertion and inverse, or at most 8
//      resampled values for change;
//   4. writes its row, coalesced: each value read from the candidate (a
//      stride-0 base shares one row of L2 over the island), moved by the
//      plan's pairs or values, then clamped, rinted where discrete and
//      pinned where frozen; for insertion and inverse, a second pass over
//      the range writes each member of it from the member it takes its
//      value from, fixed alike (one move is live, so the range never meets
//      the pairs or the values).
//
// What bounds it on the H100: at the VRP plain cell (8 x 2048 candidates,
// V = 2000, W = 2018) the bytes it must move are the uniforms it reads,
// at most 8 x 2048 x 2018 x 8 B = 265 MB (the group's Gumbel columns
// dominate), and the rows it writes, 8 x 2048 x 2000 x 4 B = 131 MB (f32):
// 0.12 ms at 3.35 TB/s. The arithmetic (two logf a position) is far below the
// card's rate. The torch version runs ~400 launches over [I, P, V + 1]
// index tensors; the launch count, not the bytes, paced it.
//
// Arithmetic that must round as the torch version's ops do is written with
// the _rn intrinsics, which nvcc never contracts into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 8;           // config.MAX_MOVE_SIZE
constexpr int kScr = 6;         // config.SCRAMBLE_MAX
constexpr int kMap = 2 * kK;    // positions swap-edges may touch
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNone = INT64_MIN;  // below every key

// dims[] of the C entry point, in this order (move_kernel.DIMS)
enum Dim {
  kIslands, kCands, kVars, kWidth, kGroups, kLmax,
  kOffMove, kOffG, kGLo, kGHi, kOffCount, kOffGumbel, kOffKScr, kKScrLo,
  kKScrHi, kOffStart, kOffPerm, kOffRes,
  kEnabled, kStrideIsland, kStrideCand, kStrideVar, kF64, kNDims
};

struct Args {
  const double* u;
  const void* cand;
  const unsigned char* masks;  // bool [I, G, lmax] or null
  const int* members;          // [G, lmax]
  const int* sizes;            // [G]
  const double* thr;           // [6]
  const double* rates;         // [G]
  const void* lower;           // [V], the rows' type
  const void* upper;
  const unsigned char* disc;   // bool [V]
  const unsigned char* frozen;
  const void* initial;
  void* out;                   // [I, P, V]
  int* group;                  // [I, P]
  int* pos;                    // [I, P, 8]
  int* count;                  // [I, P]
  long long d[kNDims];
};

template <typename T>
struct Plan {
  int n_map, n_chg, range, lo, hi, mode;  // mode 0: rotate left, 1: right, 2: reverse
  int map_t[kMap], map_s[kMap], chg_t[kK];
  T chg_v[kK];
};

__device__ __forceinline__ float uniform_f32(double x) {
  return (float)(floor(__dmul_rn(x, 16777216.0)) / 16777216.0);
}

__device__ __forceinline__ float gumbel_f32(double x) {
  const float u = fmaxf(uniform_f32(x), 1.17549435e-38f);  // float32 tiny
  return -logf(-logf(u));
}

__device__ __forceinline__ int uniform_int(double x, int lo, int hi) {
  const int n = hi - lo;
  return (int)__dadd_rn(fmin(floor(__dmul_rn(x, (double)n)), (double)(n - 1)),
                        (double)lo);
}

// selection.topk_first's key: the float's order-preserving integer image
// above, the reversed index below
__device__ __forceinline__ long long order_key(float score, int rev) {
  int bits = __float_as_int(score);
  if (bits < 0) bits ^= 0x7fffffff;
  return (long long)bits * 4294967296LL + (long long)rev;
}

__device__ __forceinline__ void push(long long (&top)[kK], long long key) {
  if (key <= top[kK - 1]) return;
  top[kK - 1] = key;
#pragma unroll
  for (int j = kK - 1; j > 0; --j) {
    if (top[j] > top[j - 1]) {
      const long long t = top[j];
      top[j] = top[j - 1];
      top[j - 1] = t;
    }
  }
}

// the 8 largest keys of the warp's lanes' sorted lists, largest first
// (every lane gets them); keys are distinct, so one lane pops each
__device__ __forceinline__ void warp_top(long long (&top)[kK],
                                         long long (&best)[kK]) {
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    long long m = top[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long other = __shfl_xor_sync(kFull, m, o);
      m = other > m ? other : m;
    }
    best[r] = m;
    if (top[0] == m) {
#pragma unroll
      for (int j = 0; j < kK - 1; ++j) top[j] = top[j + 1];
      top[kK - 1] = kNone;
    }
  }
}

template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
template <> __device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
template <typename T> __device__ __forceinline__ T sub_rn(T a, T b);
template <> __device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
template <> __device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
template <> __device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// the change move's uniform: a raw f64 column, or its f32 grid value
template <typename T> __device__ __forceinline__ T res_uniform(double x);
template <> __device__ __forceinline__ float res_uniform(double x) {
  return uniform_f32(x);
}
template <> __device__ __forceinline__ double res_uniform(double x) {
  return x;
}

// VariablesManager.fix_all of one value: clamp (as torch.clamp, min of
// max), math_utils.rint_t where discrete, the initial value where frozen
template <typename T>
__device__ __forceinline__ T fix_value(T val, const Args& a, int x) {
  const T lo = static_cast<const T*>(a.lower)[x];
  const T hi = static_cast<const T*>(a.upper)[x];
  val = fmin(fmax(val, lo), hi);
  if (a.disc[x]) {
    const T f = floor(val), c = ceil(val);
    val = fabs(sub_rn(val, f)) < fabs(sub_rn(c, val)) ? f : c;
  }
  if (a.frozen[x]) val = static_cast<const T*>(a.initial)[x];
  return val;
}

// The plan of the one live move (`do_move`'s branches), by one thread.
template <typename T>
__device__ void make_plan(const Args& a, const double* u, int cand, int mt,
                          int g, int length, int c_raw,
                          const int (&sel)[kK], Plan<T>& plan) {
  const long long* d = a.d;
  const int lmax = (int)d[kLmax];
  const int enabled = (int)d[kEnabled];
  const int* row = a.members + (long long)g * lmax;

  const int c_change = min(max(c_raw, 1), kK);
  const int c_swap = min(max(c_raw, 2), kK);
  const int c_edges = min(max(c_raw, 2), max(min(length - 1, kK), 2));
  const int k_scr = uniform_int(u[d[kOffKScr]], (int)d[kKScrLo],
                                (int)d[kKScrHi]);
  const float u_start = uniform_f32(u[d[kOffStart]]);
  const int start = (int)floorf(
      __fmul_rn(u_start, (float)max(length - k_scr, 1)));

  // the tabu push's info
  int* pos = a.pos + (long long)cand * kK;
  for (int j = 0; j < kK; ++j) pos[j] = mt == 3 ? start : sel[j];
  const int per_type[6] = {c_change, c_swap, c_edges, 1, 2, 2};
  a.count[cand] = mt == 3 ? 1 : per_type[min(mt, 5)];
  a.group[cand] = g;

  plan.n_map = plan.n_chg = plan.range = 0;
  plan.lo = plan.hi = plan.mode = 0;
  const bool on = mt < 6 && ((enabled >> mt) & 1);
  if (!on) return;
  int sv[kK];
  for (int j = 0; j < kK; ++j) sv[j] = row[sel[j]];

  if (mt == 0 && length >= c_change) {         // change: resample U[lb, ub)
    for (int j = 0; j < c_change; ++j) {
      const T lo = static_cast<const T*>(a.lower)[sv[j]];
      const T hi = static_cast<const T*>(a.upper)[sv[j]];
      const T r = res_uniform<T>(u[d[kOffRes] + j]);
      plan.chg_t[j] = sv[j];
      plan.chg_v[j] = add_rn(lo, mul_rn(r, sub_rn(hi, lo)));
    }
    plan.n_chg = c_change;
  } else if (mt == 1 && length >= c_swap) {    // swap: left-rotate the values
    for (int j = 0; j < c_swap; ++j) {
      plan.map_t[j] = sv[j];
      plan.map_s[j] = sv[(j + 1) % c_swap];
    }
    plan.n_map = c_swap;
  } else if (mt == 2 && length >= 3) {         // swap-edges, in `_mswap` order
    int sn[kK];
    for (int j = 0; j < kK; ++j) sn[j] = row[min(sel[j] + 1, lmax - 1)];
    int n = 0;
    for (int i = 1; i < c_edges; ++i) {
      const int pi = i % c_edges, ci = (i + 1) % c_edges;
      for (int r = 0; r < 2; ++r) {
        const int xa = r ? sn[pi] : sv[pi], xb = r ? sn[ci] : sv[ci];
        int ia = -1, ib = -1;
        for (int j = 0; j < n; ++j) {
          if (plan.map_t[j] == xa) ia = j;
          if (plan.map_t[j] == xb) ib = j;
        }
        const int va = ia < 0 ? xa : plan.map_s[ia];
        const int vb = ib < 0 ? xb : plan.map_s[ib];
        if (ia < 0) { ia = n; plan.map_t[n++] = xa; }
        plan.map_s[ia] = vb;                   // p[a] = p[b] first,
        if (xb == xa) ib = ia;
        if (ib < 0) { ib = n; plan.map_t[n++] = xb; }
        plan.map_s[ib] = va;                   // then p[b] = old p[a]
      }
    }
    plan.n_map = n;
  } else if (mt == 3 && length > k_scr) {      // scramble the window
    const int w_start = min(max(start, 0), max(lmax - kScr, 0));
    long long key[kScr];
    for (int j = 0; j < kScr; ++j) {
      const float s = j < k_scr ? gumbel_f32(u[d[kOffPerm] + j]) : -INFINITY;
      key[j] = order_key(s, kScr - 1 - j);
    }
    for (int r = 0; r < k_scr; ++r) {          // selection sort, largest first
      int best = r;
      for (int j = r + 1; j < kScr; ++j) best = key[j] > key[best] ? j : best;
      const long long t = key[r];
      key[r] = key[best];
      key[best] = t;
      const int src = kScr - 1 - (int)(key[r] & 0xffffffffLL);
      plan.map_t[r] = row[min(w_start + r, lmax - 1)];
      plan.map_s[r] = row[min(w_start + src, lmax - 1)];
    }
    plan.n_map = k_scr;
  } else if ((mt == 4 || mt == 5) && length > 1 && sel[0] != sel[1]) {
    const int a0 = sel[0], b0 = sel[1];
    const bool both = ((enabled >> 4) & 1) && ((enabled >> 5) & 1);
    const bool insertion = both ? mt == 4 : ((enabled >> 4) & 1);
    plan.range = 1;
    plan.lo = min(a0, b0);
    plan.hi = max(a0, b0);
    plan.mode = insertion ? (a0 < b0 ? 0 : 1) : 2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
move_sample_kernel(const Args a) {
  __shared__ long long warp_keys[kWarps][kK];
  __shared__ int warp_counts[kWarps];
  __shared__ Plan<T> plan;

  const long long* d = a.d;
  const int cand = blockIdx.x;
  const int n_cands = (int)d[kCands];
  const int isl = cand / n_cands;
  const int nb = cand - isl * n_cands;
  const int v = (int)d[kVars];
  const int lmax = (int)d[kLmax];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double* u = a.u + (long long)cand * d[kWidth];

  int mt = 0;
  const double u_move = u[d[kOffMove]];
#pragma unroll
  for (int k = 0; k < 6; ++k) mt += a.thr[k] < u_move ? 1 : 0;
  const int g = uniform_int(u[d[kOffG]], (int)d[kGLo], (int)d[kGHi]);
  const int length = a.sizes[g];
  const int limit = mt == 2 ? length - 1 : length;
  const unsigned char* tabu =
      a.masks ? a.masks + ((long long)isl * d[kGroups] + g) * lmax : nullptr;

  // 1-2. the Gumbel scores of the valid positions, each thread's top 8
  long long top[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) top[j] = kNone;
  for (int t = threadIdx.x; t < lmax; t += kThreads) {
    float s = -INFINITY;
    if (t < limit) {
      s = gumbel_f32(u[d[kOffGumbel] + t]);
      if (tabu) s = __fsub_rn(s, tabu[t] ? 1.0e9f : 0.0f);
    }
    push(top, order_key(s, lmax - 1 - t));
  }
  // the Binomial change count: the f32 uniforms below the group's rate
  int below = 0;
  if (d[kOffCount] >= 0) {
    const float rate = (float)a.rates[g];
    for (int t = threadIdx.x; t < v; t += kThreads)
      below += uniform_f32(u[d[kOffCount] + t]) < rate ? 1 : 0;
  }
  long long best[kK];
  warp_top(top, best);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kK; ++j) warp_keys[warp][j] = best[j];
    warp_counts[warp] = below;
  }
  __syncthreads();

  // 3. warp 0 merges the warps' lists; its lane 0 plans the move
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kK; ++j) top[j] = lane < kWarps ? warp_keys[lane][j]
                                                        : kNone;
    warp_top(top, best);
    if (lane == 0) {
      int sel[kK];
      const int k_eff = min(kK, lmax);  // fewer slots repeat cyclically
      for (int j = 0; j < kK; ++j)
        sel[j] = lmax - 1 - (int)(best[j % k_eff] & 0xffffffffLL);
      int c_raw = 0;
      for (int w = 0; w < kWarps; ++w) c_raw += warp_counts[w];
      make_plan<T>(a, u, cand, mt, g, length, c_raw, sel, plan);
    }
  }
  __syncthreads();

  // 4. the moved and fixed row
  const T* base = static_cast<const T*>(a.cand) + isl * d[kStrideIsland] +
                  nb * d[kStrideCand];
  const long long sv = d[kStrideVar];
  T* out = static_cast<T*>(a.out) + (long long)cand * v;
  const int n_map = plan.n_map, n_chg = plan.n_chg;
  for (int x = threadIdx.x; x < v; x += kThreads) {
    int src = x;
    for (int j = 0; j < n_map; ++j)
      if (plan.map_t[j] == x) src = plan.map_s[j];
    T val = base[src * sv];
    for (int j = 0; j < n_chg; ++j)
      if (plan.chg_t[j] == x) val = plan.chg_v[j];
    out[x] = fix_value<T>(val, a, x);
  }
  if (plan.range) {  // the same for every thread of the block
    // the range's members after the row pass's writes of them
    __syncthreads();
    const int* row = a.members + (long long)g * lmax;
    const int lo = plan.lo, hi = plan.hi, mode = plan.mode;
    for (int s = lo + threadIdx.x; s <= hi; s += kThreads) {
      int from;
      if (mode == 0) from = s == hi ? lo : s + 1;
      else if (mode == 1) from = s == lo ? hi : s - 1;
      else from = lo + hi - s;
      const int x = row[s];
      out[x] = fix_value<T>(base[row[from] * sv], a, x);
    }
  }
}

}  // namespace

// Launches the sampler on `stream`; returns the CUDA error code (0 when the
// launch was accepted). Pointers are device pointers but `dims`, a host
// array of kNDims values (move_kernel.DIMS).
extern "C" int gj_move_sample(const double* u, const void* cand,
                              const unsigned char* masks, const int* members,
                              const int* sizes, const double* thr,
                              const double* rates, const void* lower,
                              const void* upper, const unsigned char* disc,
                              const unsigned char* frozen, const void* initial,
                              void* out, int* group,
                              int* pos, int* count, const long long* dims,
                              int n_dims, void* stream) {
  if (n_dims != kNDims) return (int)cudaErrorInvalidValue;
  Args a = {u, cand, masks, members, sizes, thr, rates, lower, upper, disc,
            frozen, initial, out, group, pos, count, {}};
  for (int i = 0; i < kNDims; ++i) a.d[i] = dims[i];
  const long long blocks = a.d[kIslands] * a.d[kCands];
  if (blocks <= 0) return 0;
  if (blocks > INT32_MAX || a.d[kVars] <= 0 || a.d[kLmax] <= 0 ||
      a.d[kGroups] <= 0 || a.d[kKScrHi] - a.d[kKScrLo] < 1 ||
      a.d[kKScrHi] - 1 > kScr || a.d[kGHi] - a.d[kGLo] < 1 ||
      a.d[kGHi] > a.d[kGroups])
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d[kF64])
    move_sample_kernel<double><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  else
    move_sample_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
