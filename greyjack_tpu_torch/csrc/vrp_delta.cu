// Fused VRP delta scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// greyjack_tpu/models/vrp/delta_pallas.py (launched there by `_call_kernel`).
// Python side: greyjack_tpu_torch/models/vrp/delta_kernel.py, whose
// `_kernel_reference` is the plain torch version of the same function and
// whose `_kernel_plan` picks this kernel's route, warps and shared memory.
//
// One row = one (island, neighbour, affected route). Per row the kernel
// reads the base route (six i32 payload tables of the island's ctx), patches
// the stay rows, shifts survivors by (inserts before - removals before),
// places the inserted stops, runs the integer lateness prefix scan
//   post = P + max(w0, cummax(floor - P)),  P = cumsum(service),
// and extracts the chain-leg sum, the first / last customer and 4*kd
// dirty-pair (u, v, carried leg) values. Outputs: four i32 [rows, 8] blocks,
// bit-equal to the Pallas kernel's.
//
// What bounds it on the H100: at the flagship (8 islands x 4096 neighbours
// x 3 routes = 98,304 rows, Rp = 128) the bytes it must move are 25.8 MB
// (7.7 us at 3.35 TB/s): the 32 B packed columns of each row in, 128 B of
// output blocks out, and the valid prefixes of the routes named. The
// integer work on the valid slots is smaller. What cost the first version (one warp a row,
// re-reading its 3 KB of route tables from L2, 11x the needed bytes, and
// working on all Rp slots whatever the route's length) and what this one
// does instead:
//   * work bounded by the route's length: a route's valid stops are a
//     prefix, ended by the first r_stop == n_stops (the ctx keeps zero
//     payloads and sentinel stops beyond it, and `_pre` pads likewise). A
//     row touches only the slots below need = min(Rp, max(base_len + KD,
//     length) + 1): the merge shifts survivors by at most KD, the scans
//     need one padding slot to carry the final `post`, and every slot
//     beyond reads as the padding's zero;
//   * the "shared" route (many rows an island: TabuSearch's 12,288): about
//     one block per SM, the blocks split over the islands; a block copies
//     its island's K routes into shared memory with TMA bulk copies
//     completing on an mbarrier, and each of its threads walks one row's
//     merged route slot by slot, a survivor cursor and two insert
//     positions giving each slot, the scans running as it goes. Per slot
//     that is a few dozen integer instructions and no shuffle; a warp-wide
//     row paid for five-step shuffle scans and warp syncs on every row;
//   * the "direct" route (few rows an island: LateAcceptance and
//     SimulatedAnnealing's 3, over 512 islands, whose whole ctx is 63 MB):
//     one warp a row reads only the first chunks of its route from device
//     memory in one round trip, lane-strided (slot = 32 * chunk + lane) so
//     that the prefix sum and cummax are warp scans with a carry, its
//     merge through a per-warp shared row. The shared route's walk, run
//     on routes in device memory, measured 5x slower at LateAcceptance's
//     1,536 rows: a thread's slot-by-slot reads wait on memory one after
//     another;
//   * a row's packed columns (sc / ins / pay / el, 32 B each) and its four
//     output rows move as fully coalesced warp accesses; nothing but the
//     four output blocks goes back to device memory.
// Measured (`chip_smoke.py`, PERF.md): the shared route spends about as
// long moving the packed columns and outputs, in one wave at the head and
// tail of the launch, as walking; the walk is instruction issue bound.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 24;    // delta_kernel._MAX_WARPS
constexpr int kDirectWarps = 8;  // delta_kernel._DIRECT_WARPS

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Inputs of one kernel call.
struct Args {
  const int* ctx;
  const int* av;
  const int* pack[4];  // sc, ins, pay, el: i32 [rows, 8] each
  int* out[4];         // misc, u, v, c: i32 [rows, 8] each
  int n_rows, rows_per_island, k_veh, rp, n_stops;
};

// ---- the direct route: one warp a row, routes read from device memory ----

// One row, given its route's six tables (`route`, 6 x rp ints in device
// memory) and its packed columns in the warp's stash (`pk`: sc, ins, pay,
// el, 8 each). `buf` is the warp's merge row, NK x rp ints.
template <bool TW, int KD>
__device__ __forceinline__ void score_row(const Args& a, const int* route,
                                          const int* pk, int* buf, int row,
                                          int lane) {
  const int rp = a.rp;
  int sc[8], in[8], pay[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sc[i] = pk[i];
    in[i] = pk[8 + i];
    pay[i] = pk[16 + i];
  }
  const int length = sc[2 * KD + 2];

  // every row processes chunk 0 and most rows chunk 1: their loads go out
  // together, ahead of the length scan, so a route costs one round trip to
  // memory
  const int* r1 = route + 32 + lane;
  const int rs0 = __ldg(route + lane);
  const int rc0 = __ldg(route + rp + lane);
  const int rleg0 = __ldg(route + 5 * rp + lane);
  const int rs1 = __ldg(r1);
  const int rc1 = __ldg(r1 + rp);
  const int rleg1 = __ldg(r1 + 5 * rp);
  int rct0 = 0, rfl0 = 0, rce0 = 0, rct1 = 0, rfl1 = 0, rce1 = 0;
  if (TW) {
    rct0 = __ldg(route + 2 * rp + lane);
    rfl0 = __ldg(route + 3 * rp + lane);
    rce0 = __ldg(route + 4 * rp + lane);
    rct1 = __ldg(r1 + 2 * rp);
    rfl1 = __ldg(r1 + 3 * rp);
    rce1 = __ldg(r1 + 4 * rp);
  }

  // base length: the first sentinel stop ends the route's valid prefix
  int blen = rp;
  for (int c0 = 0; c0 < rp; c0 += 32) {
    const int rs = c0 == 0    ? rs0
                   : c0 == 32 ? rs1
                              : __ldg(route + c0 + lane);
    const unsigned found = __ballot_sync(kFull, rs >= a.n_stops);
    if (found) {
      blen = c0 + __ffs(found) - 1;
      break;
    }
  }
  // slots that can differ from the padding, whole chunks
  const int need = min(rp, max(blen + KD, length) + 1);
  const int lim = (need + 31) & ~31;

  constexpr int NK = TW ? 5 : 2;  // merged keys: c, leg (+ ct, floor, ce)
  for (int j = lane; j < lim; j += 32) {
#pragma unroll
    for (int f = 0; f < NK; ++f) buf[f * rp + j] = 0;
  }
  __syncwarp();

  // patch, shift and scatter survivors; count survivors ranked before each
  // insert (slots beyond `lim` hold sentinel stops and zero payloads)
  int rank_cnt[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) rank_cnt[k] = 0;
  for (int j = lane; j < lim; j += 32) {
    // the chunks loaded above from registers, later ones from memory
    int rs = rs0, rc = rc0, rleg = rleg0, rct = rct0, rfl = rfl0, rce = rce0;
    if (j >= 32 && j < 64) {
      rs = rs1, rc = rc1, rleg = rleg1, rct = rct1, rfl = rfl1, rce = rce1;
    } else if (j >= 64) {
      rs = __ldg(route + j);
      rc = __ldg(route + rp + j);
      rleg = __ldg(route + 5 * rp + j);
      if (TW) {
        rct = __ldg(route + 2 * rp + j);
        rfl = __ldg(route + 3 * rp + j);
        rce = __ldg(route + 4 * rp + j);
      }
    }
#pragma unroll
    for (int k = 0; k < KD; ++k) {  // later k wins, as in the reference
      if (j == sc[k]) {
        rc = pay[4 * k];
        if (TW) {
          rct = pay[4 * k + 1];
          rfl = pay[4 * k + 2];
          rce = pay[4 * k + 3];
        }
      }
    }
    bool cleared = false;
    int rem = 0, insb = 0;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const int cp = sc[KD + k];
      cleared |= (j == cp);
      rem += (cp >= 0 && cp < j) ? 1 : 0;
      insb += (in[k] > 0 && in[KD + k] < rs) ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < KD; ++k)
      rank_cnt[k] +=
          __popc(__ballot_sync(kFull, !cleared && in[KD + k] >= rs));
    if (!cleared) {
      const int d = j + insb - rem;
      if (d >= 0 && d < lim) {
        buf[d] = rc;
        buf[rp + d] = rleg;
        if (TW) {
          buf[2 * rp + d] = rct;
          buf[3 * rp + d] = rfl;
          buf[4 * rp + d] = rce;
        }
      }
    }
  }
  bool iflag[KD];
  int ins_pos[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    iflag[k] = in[k] > 0;
    ins_pos[k] = rank_cnt[k] + in[2 * KD + k];
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const int ip = ins_pos[k];
      if (iflag[k] && ip >= 0 && ip < lim) {
        buf[ip] = pay[4 * k];
        buf[rp + ip] = 0;
        if (TW) {
          buf[2 * rp + ip] = pay[4 * k + 1];
          buf[3 * rp + ip] = pay[4 * k + 2];
          buf[4 * rp + ip] = pay[4 * k + 3];
        }
      }
    }
  }
  __syncwarp();

  // chain legs over valid adjacent pairs; the lateness scan chunk by chunk
  const bool has = length > 0;
  const int w0 = sc[2 * KD];
  const int w1 = sc[2 * KD + 1];
  int chain_part = 0, late_part = 0;
  int carry_p = 0, carry_m = INT_MIN, post = 0;
  for (int j = lane; j < lim; j += 32) {
    if (j + 1 < length) chain_part += buf[rp + j];
    if (TW) {
      const bool valid = j < length;
      int p = valid ? buf[2 * rp + j] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, p, o);
        if (lane >= o) p += t;
      }
      p += carry_p;
      // cummax of (floor - P); floor is -2^30 beyond the valid prefix
      int m = (valid ? buf[3 * rp + j] : -kBig) - p;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, m, o);
        if (lane >= o) m = max(m, t);
      }
      m = max(m, carry_m);
      post = p + max(w0, m);
      if (valid) late_part += max(post - buf[4 * rp + j], 0);
      carry_p = __shfl_sync(kFull, p, 31);
      carry_m = __shfl_sync(kFull, m, 31);
    }
  }
  const int chain = __reduce_add_sync(kFull, chain_part);
  int late_total = 0;
  if (TW) {
    // `lim` > length when length < rp, so the last chunk's last post is
    // the post of slot rp - 1
    const int post_end = __shfl_sync(kFull, post, 31);
    late_total = __reduce_add_sync(kFull, late_part) +
                 (has ? max(post_end - w1, 0) : 0);
  }

  // lanes 0..7 each write one column of the four output blocks
  if (lane < 8) {
    int col = -1;
    // (constant indices only: a runtime index would put the arrays in
    // local memory)
    if (lane < 2 * KD) {
      col = pk[24 + lane];
    } else if (lane < 4 * KD) {
      const bool second = KD == 2 && (lane & 1);
      const bool f = second ? iflag[KD - 1] : iflag[0];
      const int ip = second ? ins_pos[KD - 1] : ins_pos[0];
      col = f ? ip - (lane < 3 * KD ? 1 : 0) : -1;
    }
    const bool at = col >= 0 && col < lim;
    const bool right = col >= 0 && col + 1 < lim;
    const size_t o = (size_t)row * 8 + lane;
    a.out[1][o] = at ? buf[col] : 0;
    a.out[2][o] = right ? buf[col + 1] : 0;
    a.out[3][o] = at ? buf[rp + col] : 0;

    int m = 0;
    if (lane == 0) {
      m = late_total;
    } else if (lane == 1) {
      m = chain;
    } else if (lane == 2) {
      m = buf[0];
    } else if (lane == 3) {
      m = (length >= 1 && length <= rp) ? buf[length - 1] : 0;
    } else if (lane == 4) {
      m = iflag[0] ? ins_pos[0] : -1;
    } else if (lane == 5 && KD == 2) {
      m = iflag[KD - 1] ? ins_pos[KD - 1] : -1;
    }
    a.out[0][o] = m;
  }
  __syncwarp();
}

// The pack a lane reads: lane l holds column l % 8 of pack l / 8 (sc, ins,
// pay, el), so a warp loads a row's 128 B at once. Constant indices only:
// a runtime index into the kernel's parameters would copy them to local
// memory.
__device__ __forceinline__ const int* lane_pack(const Args& a, int lane) {
  const int q = lane >> 3;
  return (q == 0 ? a.pack[0] : q == 1 ? a.pack[1] : q == 2 ? a.pack[2]
                                                           : a.pack[3]) +
         (lane & 7);
}

template <bool TW, int KD>
__global__ void __launch_bounds__(32 * kDirectWarps)
    vrp_delta_direct(const Args a) {
  constexpr int NK = TW ? 5 : 2;
  extern __shared__ __align__(128) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int rp = a.rp;
  int* stash = smem + warp * (32 + NK * rp);
  int* buf = stash + 32;
  const int* my_pack = lane_pack(a, lane);
  const int step = gridDim.x * warps;
  int row = blockIdx.x * warps + warp;
  int word = 0, av = 0;
  if (row < a.n_rows) {
    word = __ldg(my_pack + (size_t)row * 8);
    av = __ldg(a.av + row);
  }
  for (; row < a.n_rows; row += step) {
    stash[lane] = word;
    const int cur_av = av;
    const int nxt = row + step;
    if (nxt < a.n_rows) {  // prefetch the next row's columns
      word = __ldg(my_pack + (size_t)nxt * 8);
      av = __ldg(a.av + nxt);
    }
    __syncwarp();
    const int isl = row / a.rows_per_island;
    const int* route = a.ctx + ((size_t)isl * a.k_veh + cur_av) * 6 * rp;
    score_row<TW, KD>(a, route, stash, buf, row, lane);
  }
}

// ---- the shared route: the island's routes in shared memory, one thread
// a row ----

// The island's routes sit in shared memory 4 words apart beyond their
// 6 * rp (16 B, so that TMA bulk copies stay aligned): threads of a warp
// walk different routes at about the same slot, and the padding spreads
// them over the banks.
constexpr int kRoutePad = 4;  // delta_kernel._ROUTE_PAD
constexpr int kSharedRp = 128;  // the shared route's Rp
// a merged slot's origin, one byte: base slot (< kFromInsert), insert
// kFromInsert + k, or nothing
constexpr int kFromInsert = 252;
constexpr int kFromNothing = 255;

// Bytes of dynamic shared memory a launch's layout indexes
// (delta_kernel._kernel_plan computes the same): the shared route's slab
// of routes, their lengths and one origin byte a slot for each thread;
// the direct route's per-warp stash of 32 words and merge row of NK x rp.
long long layout_bytes(int route, int tw, int k_veh, int rp, int warps) {
  if (route == 1)
    return 4LL * k_veh * (6 * rp + kRoutePad) + 4LL * k_veh +
           32LL * warps * rp;
  return 4LL * warps * (32 + (tw ? 5 : 2) * rp);
}

__device__ __forceinline__ int part(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A warp's 32 consecutive rows (row0 on, the first n of them real) of an
// i32 [rows, 8] array move as two fully coalesced 512 B accesses, lane j
// holding half j % 2 of row 16 q + j / 2 in access q; shuffles hand each
// lane its own row (lane l: row row0 + l), or collect it for the store.
__device__ __forceinline__ void load_rows(const int* arr, int row0, int n,
                                          int lane, int4& lo, int4& hi) {
  const int4* base = reinterpret_cast<const int4*>(arr + (size_t)row0 * 8);
  int4 v0 = make_int4(0, 0, 0, 0), v1 = v0;
  if (lane / 2 < n) v0 = __ldg(base + lane);
  if (16 + lane / 2 < n) v1 = __ldg(base + 32 + lane);
  const int s = 2 * (lane & 15);
  const bool second = lane >= 16;
  int t[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x0 = __shfl_sync(kFull, part(v0, i), s);
    const int x1 = __shfl_sync(kFull, part(v1, i), s);
    const int y0 = __shfl_sync(kFull, part(v0, i), s + 1);
    const int y1 = __shfl_sync(kFull, part(v1, i), s + 1);
    t[i] = second ? x1 : x0;
    t[4 + i] = second ? y1 : y0;
  }
  lo = make_int4(t[0], t[1], t[2], t[3]);
  hi = make_int4(t[4], t[5], t[6], t[7]);
}

__device__ __forceinline__ void store_rows(int* arr, int row0, int n,
                                           int lane, const int (&x)[8]) {
  int4* base = reinterpret_cast<int4*>(arr + (size_t)row0 * 8);
  const bool upper = lane & 1;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = 16 * q + lane / 2;
    int t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lo = __shfl_sync(kFull, x[i], r);
      const int hi = __shfl_sync(kFull, x[4 + i], r);
      t[i] = upper ? hi : lo;
    }
    if (r < n) base[32 * q + lane] = make_int4(t[0], t[1], t[2], t[3]);
  }
}

// The packed columns (sc, ins, pay, el) and route of rows r0 .. r0 + 31.
__device__ __forceinline__ void fetch_rows(const Args& a, int r0, int last,
                                           int lane, int4 (&pk)[8], int& av) {
  const int n = min(32, last - r0);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    load_rows(q == 0 ? a.pack[0] : q == 1 ? a.pack[1]
              : q == 2 ? a.pack[2] : a.pack[3],
              r0, n, lane, pk[2 * q], pk[2 * q + 1]);
  av = lane < n ? __ldg(a.av + r0 + lane) : 0;
}

// The merged slot x's customer and carried leg, from the walk's record of
// where each slot came from (`src`, one byte a slot: a survivor's base
// slot, an insert, or nothing).
template <int KD>
__device__ __forceinline__ void merged_at(const int* r, int blen,
                                          const uint8_t* src, int step, int x,
                                          int need, const int (&ps)[KD],
                                          const int (&pay)[8], int& c,
                                          int& leg) {
  c = 0;
  leg = 0;
  if (x < 0 || x >= need) return;  // from `need` on: the padding's zeros
  const int s = src[x * step];
  if (s < blen) {
    c = r[kSharedRp + s];
    leg = r[5 * kSharedRp + s];
#pragma unroll
    for (int k = 0; k < KD; ++k)
      if (s == ps[k]) c = pay[4 * k];
  } else if (s >= kFromInsert && s < kFromNothing) {
    c = (KD == 2 && s == kFromInsert + 1) ? pay[4 * (KD - 1)] : pay[0];
  }
}

// One row by one thread. The merged route is walked slot by slot in order:
// survivors keep their order and land at j + shift(j) (strictly
// increasing), an insert overwrites its slot, and nothing else is nonzero;
// so a cursor over the survivors, two insert positions and the running
// scans give every merged slot exactly as the reference's scatter does.
// Slots from `need` on hold the padding. Each slot's origin is recorded
// (`src`), and the output columns are looked up from it at the end.
template <bool TW, int KD>
__device__ __forceinline__ void walk_row(const Args& a, const int* r,
                                         int blen, const int4 (&pk)[8],
                                         uint8_t* src, int step,
                                         int (&misc)[8], int (&uo)[8],
                                         int (&vo)[8], int (&co)[8]) {
  constexpr int rp = kSharedRp;
  int sc[8], in[8], pay[8], el[8];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int4 x = pk[q], y = pk[2 + q], z = pk[4 + q], w = pk[6 + q];
    sc[4 * q] = x.x, sc[4 * q + 1] = x.y, sc[4 * q + 2] = x.z,
    sc[4 * q + 3] = x.w;
    in[4 * q] = y.x, in[4 * q + 1] = y.y, in[4 * q + 2] = y.z,
    in[4 * q + 3] = y.w;
    pay[4 * q] = z.x, pay[4 * q + 1] = z.y, pay[4 * q + 2] = z.z,
    pay[4 * q + 3] = z.w;
    el[4 * q] = w.x, el[4 * q + 1] = w.y, el[4 * q + 2] = w.z,
    el[4 * q + 3] = w.w;
  }
  int ps[KD], cs[KD];
  bool iflag[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    ps[k] = sc[k];
    cs[k] = sc[KD + k];
    iflag[k] = in[k] > 0;
  }
  const int length = sc[2 * KD + 2];
  const int need = min(rp, max(blen + KD, length) + 1);

  // insert positions: survivors ranked before each insert (an exact count;
  // slots from blen on hold sentinel stops, above every insert's row)
  int ip[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) ip[k] = in[2 * KD + k];
  for (int j = 0; j < blen; ++j) {
    const int st = r[j];
    bool cleared = false;
#pragma unroll
    for (int k = 0; k < KD; ++k) cleared |= j == cs[k];
#pragma unroll
    for (int k = 0; k < KD; ++k) ip[k] += (!cleared && in[KD + k] >= st);
  }

  // the survivor cursor: base slot j, its destination dj and its patched
  // payload; `removed` counts the cleared slots passed (rem_before(j)),
  // `row_k` is an insert's row, or above every stop when it has none
  int row_k[KD], at_k[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    row_k[k] = iflag[k] ? in[KD + k] : INT_MAX;
    at_k[k] = iflag[k] ? ip[k] : -1;
  }
  // the cleared slots in order (a slot cleared twice counts twice, as
  // rem_before does)
  int c_lo = cs[0], c_hi = -1, n_lo = 1;
  if (KD == 2) {
    c_lo = min(cs[0], cs[KD - 1]);
    c_hi = max(cs[0], cs[KD - 1]);
    if (c_lo == c_hi) n_lo = 2, c_hi = -1;
  }
  int j = -1, removed = 0, dj = -1;
  int vc = 0, vct = 0, vfl = 0, vce = 0, vleg = 0;
  const int w0 = sc[2 * KD];
  const int w1 = sc[2 * KD + 1];
  int p = 0, m = INT_MIN, post = 0, late = 0, chain = 0;
  for (int d = 0; d < need; ++d) {
    if (dj < d) {  // the cursor moves to the next survivor
      ++j;
      if (j == c_lo) ++j, removed += n_lo;
      if (KD == 2 && j == c_hi) ++j, ++removed;
      int stop = a.n_stops;
      vc = vct = vfl = vce = vleg = 0;
      if (j < blen) {
        stop = r[j];
        vc = r[rp + j];
        vleg = r[5 * rp + j];
        if (TW) {
          vct = r[2 * rp + j];
          vfl = r[3 * rp + j];
          vce = r[4 * rp + j];
        }
      }
      dj = j - removed;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        if (j == ps[k]) {  // later k wins, as in the reference
          vc = pay[4 * k];
          vct = pay[4 * k + 1];
          vfl = pay[4 * k + 2];
          vce = pay[4 * k + 3];
        }
        dj += row_k[k] < stop ? 1 : 0;
      }
    }
    const bool here = dj == d;
    int from = here ? j : kFromNothing;
    int ct = here ? vct : 0, fl = here ? vfl : 0, ce = here ? vce : 0;
    int leg = here ? vleg : 0;
#pragma unroll
    for (int k = 0; k < KD; ++k) {  // an insert overwrites its slot
      if (d == at_k[k]) {
        from = kFromInsert + k;
        ct = pay[4 * k + 1], fl = pay[4 * k + 2], ce = pay[4 * k + 3];
        leg = 0;
      }
    }
    src[d * step] = (uint8_t)from;
    const bool valid = d < length;
    if (TW) {
      // post = P + max(w0, cummax(floor - P)); floor is -2^30 and service
      // 0 beyond the valid prefix
      p += valid ? ct : 0;
      m = max(m, (valid ? fl : -kBig) - p);
      post = p + max(w0, m);
      if (valid) late += max(post - ce, 0);
    }
    if (d + 1 < length) chain += leg;
  }
  // `need` > length when length < rp, so the last post is slot rp - 1's
  const int late_total =
      TW ? late + (length > 0 ? max(post - w1, 0) : 0) : 0;

  // output columns: E1, E2 from `_pre`; E3, E4 at the insert positions
#pragma unroll
  for (int i = 0; i < 8; ++i) misc[i] = 0;
  misc[0] = late_total;
  misc[1] = chain;
  int leg_unused;
  merged_at<KD>(r, blen, src, step, 0, need, ps, pay, misc[2], leg_unused);
  if (length >= 1 && length <= rp)
    merged_at<KD>(r, blen, src, step, length - 1, need, ps, pay, misc[3],
                  leg_unused);
#pragma unroll
  for (int k = 0; k < KD; ++k) misc[4 + k] = iflag[k] ? ip[k] : -1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int col = -1;
    if (i < 2 * KD) {
      col = el[i];
    } else if (i < 4 * KD) {
      const int k = i < 3 * KD ? i - 2 * KD : i - 3 * KD;
      col = iflag[k] ? ip[k] - (i < 3 * KD ? 1 : 0) : -1;
    }
    merged_at<KD>(r, blen, src, step, col, need, ps, pay, uo[i], co[i]);
    vo[i] = 0;
    if (col >= 0)
      merged_at<KD>(r, blen, src, step, col + 1, need, ps, pay, vo[i],
                    leg_unused);
  }
}

// The rows of island i lie in blocks [i*G/I, (i+1)*G/I) of the grid, each
// block a contiguous range of them and one thread a row. A block copies the
// island's K routes into shared memory with TMA bulk copies completing on
// an mbarrier (one per route, to its padded place), finds each route's
// length once, then walks its rows.
template <bool TW, int KD>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    vrp_delta_shared(const Args a) {
  extern __shared__ __align__(128) int smem[];
  __shared__ __align__(8) uint64_t bar;
  constexpr int rp = kSharedRp;
  const int k_veh = a.k_veh;
  const int stride = 6 * rp + kRoutePad;
  int* blens = smem + k_veh * stride;
  // each thread's slot origins, slot-major so a warp's bytes are adjacent
  uint8_t* src = reinterpret_cast<uint8_t*>(blens + k_veh) + threadIdx.x;

  const int n_isl = a.n_rows / a.rows_per_island;
  const int g = gridDim.x, b = blockIdx.x;
  const int isl = (int)(((long long)(b + 1) * n_isl - 1) / g);
  const int b0 = (int)((long long)isl * g / n_isl);
  const int nb = (int)((long long)(isl + 1) * g / n_isl) - b0;
  const long long rpi = a.rows_per_island;
  const int first = (int)(isl * rpi + rpi * (b - b0) / nb);
  const int last = (int)(isl * rpi + rpi * (b - b0 + 1) / nb);

  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int* routes = a.ctx + (size_t)isl * k_veh * 6 * rp;
    const uint32_t bytes = 6u * rp * 4u;
    if (threadIdx.x == 0) mbar_expect_tx(&bar, bytes * k_veh);
    __syncwarp();
    for (int q = threadIdx.x; q < k_veh; q += 32)
      bulk_copy(smem + q * stride, routes + (size_t)q * 6 * rp, bytes, &bar);
  }

  // a warp walks 32 consecutive rows at a time, one a lane; the first
  // rows' columns load while the routes arrive
  const int lane = threadIdx.x & 31;
  int row0 = first + (threadIdx.x & ~31);
  int4 pk[8];
  int av = 0;
  if (row0 < last) fetch_rows(a, row0, last, lane, pk, av);
  mbar_wait(&bar, 0);

  // route lengths: the first sentinel stop, one warp a route
  for (int q = threadIdx.x >> 5; q < k_veh; q += blockDim.x >> 5) {
    int len = rp;
    for (int c0 = 0; c0 < rp; c0 += 32) {
      const unsigned m =
          __ballot_sync(kFull, smem[q * stride + c0 + lane] >= a.n_stops);
      if (m) {
        len = c0 + __ffs(m) - 1;
        break;
      }
    }
    if (lane == 0) blens[q] = len;
  }
  __syncthreads();

  for (; row0 < last; row0 += blockDim.x) {
    const int n = min(32, last - row0);
    int misc[8] = {}, uo[8] = {}, vo[8] = {}, co[8] = {};
    if (lane < n)
      walk_row<TW, KD>(a, smem + av * stride, blens[av], pk, src,
                       blockDim.x, misc, uo, vo, co);
    store_rows(a.out[0], row0, n, lane, misc);
    store_rows(a.out[1], row0, n, lane, uo);
    store_rows(a.out[2], row0, n, lane, vo);
    store_rows(a.out[3], row0, n, lane, co);
    if (row0 + (int)blockDim.x < last)
      fetch_rows(a, row0 + blockDim.x, last, lane, pk, av);
  }
}

template <bool TW, int KD, bool SHARED>
cudaError_t launch(const Args& a, int warps, int smem_bytes, int n_sms,
                   cudaStream_t stream) {
  const void* fn = SHARED ? (const void*)vrp_delta_shared<TW, KD>
                          : (const void*)vrp_delta_direct<TW, KD>;
  static int smem_set = 48 * 1024;  // the default a block may use
  if (smem_bytes > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    smem_set = smem_bytes;
  }
  long long grid;
  if (SHARED) {
    // about one block per SM, at least one per island, and no more than
    // the island's rows give its threads
    const long long n_isl = a.n_rows / a.rows_per_island;
    const long long per_isl = (a.rows_per_island + 32 * warps - 1) /
                              (32 * warps);
    grid = n_sms < n_isl * per_isl ? n_sms : n_isl * per_isl;
    if (grid < n_isl) grid = n_isl;
  } else {
    grid = ((long long)a.n_rows + warps - 1) / warps;
  }
  if (grid > (1LL << 30)) grid = 1LL << 30;
  void* args[] = {const_cast<Args*>(&a)};
  const cudaError_t e = cudaLaunchKernel(fn, dim3((unsigned)grid),
                                         dim3(32 * warps), args,
                                         (size_t)smem_bytes, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool SHARED>
cudaError_t dispatch(int tw, int kd, const Args& a, int warps, int smem_bytes,
                     int n_sms, cudaStream_t s) {
  if (tw && kd == 2)
    return launch<true, 2, SHARED>(a, warps, smem_bytes, n_sms, s);
  if (tw && kd == 1)
    return launch<true, 1, SHARED>(a, warps, smem_bytes, n_sms, s);
  if (!tw && kd == 2)
    return launch<false, 2, SHARED>(a, warps, smem_bytes, n_sms, s);
  if (!tw && kd == 1)
    return launch<false, 1, SHARED>(a, warps, smem_bytes, n_sms, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). ctx: i32 [I, K, 6*rp]; av: i32
// [n_rows]; sc / ins / pay / el and the four outputs: i32 [n_rows, 8], all
// contiguous and 16-byte aligned; rows ordered (island, neighbour, route).
// `route` (0 direct, 1 shared), `warps` and `smem_bytes` come from
// `_kernel_plan`; a `smem_bytes` below what the route's layout indexes is
// refused. `n_sms` is the card's SM count. Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int gj_vrp_delta(const int* ctx, const int* av, const int* sc,
                            const int* ins, const int* pay, const int* el,
                            int* misc, int* u, int* v, int* c, int n_rows,
                            int rows_per_island, int k_veh, int rp, int kd,
                            int tw, int n_stops, int route, int warps,
                            int smem_bytes, int n_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  if (rows_per_island <= 0 || n_rows % rows_per_island || k_veh <= 0 ||
      rp <= 0 || rp % 128 || route < 0 || route > 1 || warps < 1 ||
      warps > (route ? kMaxWarps : kDirectWarps) || n_sms < 1 ||
      smem_bytes < layout_bytes(route, tw, k_veh, rp, warps))
    return (int)cudaErrorInvalidValue;
  const Args a = {ctx, av, {sc, ins, pay, el}, {misc, u, v, c}, n_rows,
                  rows_per_island, k_veh, rp, n_stops};
  if (route == 1 && rp == kSharedRp)
    return (int)dispatch<true>(tw, kd, a, warps, smem_bytes, n_sms, s);
  if (route == 0)
    return (int)dispatch<false>(tw, kd, a, warps, smem_bytes, n_sms, s);
  return (int)cudaErrorInvalidValue;
}
