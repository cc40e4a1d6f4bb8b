// The VRP plain score's route analysis for NVIDIA Hopper (sm_90a): the
// stable sort of a row's stops by vehicle, its legs, its time-window walk,
// its duplicate count and its loads, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this prescoring
// (`greyjack_tpu/models/vrp/cotwin_builder.py` `build_common` on its
// integer-milli branch) as XLA ops. Python side: `greyjack_tpu_torch/ops/
// plain_kernel.py`; its plain torch version is the torch body of
// `models/vrp/cotwin_builder.py` `build_common` (`routes.
// sort_stops_by_vehicle`, `routes.vrp_routes_packed`, `segments.
// count_minus_n_unique`, `segments.segment_sum`), whose integers this
// kernel gives bit for bit:
//   dist[p]   i64: the chain legs (milli matrix, i32) summed in i64, plus
//             each stop's depot->first and last->depot legs added in i32
//             (two's complement, as the torch body adds them) and summed
//             in i64;
//   late[p]   i64: with time windows, per route in stop order
//             post = max(post, tw_start) + service from post =
//             work_day_start, lateness max(post - tw_end, 0) a stop and
//             overtime max(post - work_day_end, 0) at the last stop; 0
//             without;
//   dups[p]   i32: N - the number of distinct customer ids;
//   loads[p, k] i32: the demands of vehicle k's stops (wrapping sums).
// The walk runs in i64, so it is the sequential walk at any magnitude; the
// torch body runs it as a clamped i32 max-plus scan, which equals it
// wherever no value of the walk leaves +-2^29.
//
// A block works on one row (p) at a time. Where the row's working set fits
// a block's shared memory (about 17 KB at N = 1000, K = 40, L = 1008) it
// lives there and the grid has a block a row; otherwise (N or L in the
// tens of thousands) each block takes a slab of a global scratch buffer
// (`scratch`, `row_ints` ints a block) and the grid loops over the rows.
// No [P, N] intermediate reaches device memory:
//   1. each warp loads a contiguous segment of the row (whole 32-stop
//      chunks, coalesced), counts its stops per vehicle (`__match_any_sync`
//      peers, one shared add a peer group), adds the demands per vehicle
//      and marks the customer ids in an L-bit bitmap (a set bit that was
//      clear is a new distinct id);
//   2. warp 0 scans the per-vehicle counts into route starts; each
//      vehicle's counts over the warps become each warp's first slot of
//      that vehicle;
//   3. each warp walks its chunks in stop order and writes every stop to
//      its vehicle slot plus its rank among its peers of lower lanes, so a
//      vehicle's stops keep stop-index order, as the stable sort does;
//   4. the legs, a sorted slot a thread, from the L2-resident milli matrix;
//   5. the time windows, a route a thread, reading the packed customer
//      rows (16 B each, L1-cached);
//   6. block sums in i64.
//
// What bounds it on the H100: at the VRP plain cell (16,384 rows, N =
// 1000) the bytes it must move from device memory are the two i32 id
// columns, 131 MB (0.04 ms at 3.35 TB/s), and 16,384 x (K + 5) x 4 B of
// outputs; its ~3N matrix lookups a row hit L2 (the 4 MB matrix stays
// there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSmemMax = 227 * 1024;  // Hopper's opt-in block limit

// dims[] of the C entry point, in this order (plain_kernel.DIMS)
enum Dim {
  kRows, kStops, kVehicles, kLocations, kTimeWindowed, kSmem, kBlocks, kNDims
};

struct Args {
  const int* veh;       // [P, N] vehicle ids
  const int* cust;      // [P, N] customer ids
  const int* dm;        // [L * L] milli distances
  const int4* packed;   // [L] demand, tw_start, tw_end, service
  const int* depot;     // [K] depot location of each vehicle
  const int* w0;        // [K] work day start
  const int* w1;        // [K] work day end
  long long* dist;      // [P]
  long long* late;      // [P]
  int* dups;            // [P]
  int* loads;           // [P, K]
  int* scratch;         // [blocks * row_ints] or null: the rows in shared
  long long rows, row_ints;
  int n, k, l, tw;
};

// The block's reductions, always in shared memory: i64 partials [2W] and
// i32 partials [W] (`plain_kernel.RED_BYTES`).
constexpr long long kRedBytes = 8 * 2 * kWarps + 4 * kWarps;

// The ints of a row's working set: i32 v, c, sorted c, sorted v [N each],
// per-warp vehicle slots [W * K], route start, count and load [K each],
// the bitmap [ceil(L/32)] (`plain_kernel.row_ints`).
long long row_ints(long long n, long long k, long long l) {
  return 4 * n + kWarps * k + 3 * k + (l + 31) / 32;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// i32 addition with two's complement wrap-around, as torch adds i32
__device__ __forceinline__ int wrap_add(int x, int y) {
  return (int)((unsigned)x + (unsigned)y);
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(kFull, x, d);
  return x;
}

__global__ void __launch_bounds__(kThreads) vrp_plain_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, k = a.k, l = a.l;
  const int words = (l + 31) >> 5;
  long long* red64 = reinterpret_cast<long long*>(smem);  // [2W]
  int* red32 = reinterpret_cast<int*>(red64 + 2 * kWarps);  // [W]
  int* v_in = a.scratch ? a.scratch + blockIdx.x * a.row_ints
                        : red32 + kWarps;  // [N] the row's vehicle ids
  int* c_in = v_in + n;         // [N] its customer ids
  int* sc = c_in + n;           // [N] customer ids in vehicle order
  int* sv = sc + n;             // [N] vehicle ids in vehicle order
  int* slot = sv + n;           // [W][K] counts, then each warp's next slot
  int* start = slot + kWarps * k;  // [K] first sorted slot of each route
  int* cnt = start + k;         // [K] route lengths
  int* load = cnt + k;          // [K]
  unsigned* bits = reinterpret_cast<unsigned*>(load + k);  // [words]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one

  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    for (int i = tid; i < kWarps * k; i += kThreads) slot[i] = 0;
    for (int i = tid; i < k; i += kThreads) load[i] = 0;
    for (int i = tid; i < words; i += kThreads) bits[i] = 0;
    __syncthreads();

    // 1. load, per-warp vehicle counts, loads, distinct customer ids
    const int seg = (n + kThreads - 1) / kThreads * 32;  // whole chunks
    const int lo = min(n, warp * seg), hi = min(n, lo + seg);
    const int* vrow = a.veh + row * n;
    const int* crow = a.cust + row * n;
    int fresh = 0;
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const unsigned act = __ballot_sync(kFull, i < hi);
      if (i < hi) {
        // the columns are fixed (in bounds); the clamps only keep the
        // shared and matrix indices in range
        const int vi = clampi(vrow[i], 0, k - 1);
        const int ci = clampi(crow[i], 0, l - 1);
        v_in[i] = vi;
        c_in[i] = ci;
        const unsigned peers = __match_any_sync(act, vi);
        if (lane == __ffs(peers) - 1)
          atomicAdd(&slot[warp * k + vi], __popc(peers));
        atomicAdd(&load[vi], __ldg(&a.packed[ci]).x);
        const unsigned bit = 1u << (ci & 31);
        if (!(atomicOr(&bits[ci >> 5], bit) & bit)) ++fresh;
      }
    }
    __syncthreads();

    // 2. route starts: an exclusive scan of the vehicle totals (warp 0)
    if (warp == 0) {
      int carry = 0;
      for (int k0 = 0; k0 < k; k0 += 32) {
        const int kk = k0 + lane;
        int total = 0;
        if (kk < k)
          for (int w = 0; w < kWarps; ++w) total += slot[w * k + kk];
        int incl = total;
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += up;
        }
        if (kk < k) {
          start[kk] = carry + incl - total;
          cnt[kk] = total;
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
    }
    __syncthreads();
    for (int kk = tid; kk < k; kk += kThreads) {
      int next = start[kk];
      for (int w = 0; w < kWarps; ++w) {
        const int c = slot[w * k + kk];
        slot[w * k + kk] = next;
        next += c;
      }
    }
    __syncthreads();

    // 3. stable scatter into vehicle order, each warp's chunks in stop order
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const unsigned act = __ballot_sync(kFull, i < hi);
      int vi = 0;
      unsigned peers = 0;
      if (i < hi) {
        vi = v_in[i];
        peers = __match_any_sync(act, vi);
        const int at = slot[warp * k + vi] + __popc(peers & below);
        sc[at] = c_in[i];
        sv[at] = vi;
      }
      __syncwarp();
      if (i < hi && lane == 31 - __clz(peers))  // the group's highest lane
        slot[warp * k + vi] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();

    // 5. (first: its threads run longest) the time windows, a route a thread
    long long tsum = 0;
    if (a.tw) {
      for (int kk = tid; kk < k; kk += kThreads) {
        const int s0 = start[kk], m = cnt[kk];
        if (m == 0) continue;
        long long post = __ldg(&a.w0[kk]);
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const int4 r = __ldg(&a.packed[sc[s0 + j]]);
          post = max(post, (long long)r.y) + r.w;
          tsum += max(post - r.z, 0LL);
        }
        tsum += max(post - __ldg(&a.w1[kk]), 0LL);
      }
    }

    // 4. the legs, a sorted slot a thread
    long long dsum = 0;
    for (int i = tid; i < n; i += kThreads) {
      const int vi = sv[i], ci = sc[i];
      const bool first = i == 0 || sv[i - 1] != vi;
      const bool last = i == n - 1 || sv[i + 1] != vi;
      const long long dep = __ldg(&a.depot[vi]);
      int ends = 0;
      if (first) {
        ends = __ldg(&a.dm[dep * l + ci]);
      } else {
        dsum += __ldg(&a.dm[(long long)sc[i - 1] * l + ci]);
      }
      if (last) ends = wrap_add(ends, __ldg(&a.dm[(long long)ci * l + dep]));
      dsum += ends;
    }

    // 6. block sums
    dsum = warp_sum(dsum);
    tsum = warp_sum(tsum);
    const long long fw = warp_sum((long long)fresh);
    if (lane == 0) {
      red64[warp] = dsum;
      red64[kWarps + warp] = tsum;
      red32[warp] = (int)fw;
    }
    __syncthreads();
    for (int kk = tid; kk < k; kk += kThreads)
      a.loads[row * k + kk] = load[kk];
    if (tid == 0) {
      long long d = 0, t = 0;
      int u = 0;
      for (int w = 0; w < kWarps; ++w) {
        d += red64[w];
        t += red64[kWarps + w];
        u += red32[w];
      }
      a.dist[row] = d;
      a.late[row] = t;
      a.dups[row] = n - u;
    }
    __syncthreads();  // the next row overwrites the working set
  }
}

}  // namespace

extern "C" int gj_vrp_plain(const int* veh, const int* cust, const int* dm,
                            const int* packed, const int* depot,
                            const int* w0, const int* w1, long long* dist,
                            long long* late, int* dups, int* loads,
                            int* scratch, const long long* dims, int n_dims,
                            void* stream) {
  if (n_dims != kNDims) return (int)cudaErrorInvalidValue;
  const long long rows = dims[kRows], n = dims[kStops], k = dims[kVehicles],
                  l = dims[kLocations], smem = dims[kSmem],
                  blocks = dims[kBlocks];
  if (rows <= 0) return 0;
  const long long need = kRedBytes + (scratch ? 0 : 4 * row_ints(n, k, l));
  if (n <= 0 || n > INT32_MAX || k <= 0 || k > INT32_MAX || l <= 0 ||
      l > INT32_MAX || blocks <= 0 || blocks > rows || blocks > INT32_MAX ||
      smem < need || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vrp_plain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Args a = {veh, cust, dm, reinterpret_cast<const int4*>(packed), depot, w0,
            w1, dist, late, dups, loads, scratch, rows, row_ints(n, k, l),
            (int)n, (int)k, (int)l, (int)(dims[kTimeWindowed] != 0)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  vrp_plain_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}
