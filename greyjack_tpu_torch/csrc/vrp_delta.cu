// Fused VRP delta scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// greyjack_tpu/models/vrp/delta_pallas.py (launched there by `_call_kernel`).
// Python side: greyjack_tpu_torch/models/vrp/delta_kernel.py, whose
// `_kernel_reference` is the plain torch version of the same function.
//
// One row = one (island, neighbour, affected route). Per row the kernel
// fetches the base route (six i32 payload tables of the island's ctx),
// patches the stay rows, shifts survivors by (inserts before - removals
// before), places the inserted stops, runs the integer lateness prefix scan
//   post = P + max(w0, cummax(floor - P)),  P = cumsum(service),
// and extracts the chain-leg sum, the first / last customer and 4*kd
// dirty-pair (u, v, carried leg) values. Outputs: four i32 [rows, 8] blocks,
// bit-equal to the Pallas kernel's.
//
// What bounds it on the H100: at the flagship shape (8 islands x 4096
// neighbours x 3 routes = 98,304 rows, Rp = 128 slots) a row reads up to
// 6 x 512 B of route tables (L2-resident: the whole ctx table is
// 8 x 40 x 3 KB) plus 128 B of packed columns, writes 128 B, and does a few
// integer operations per slot. So it is bound by load / store traffic and
// instruction issue, not by arithmetic. The design:
//   * one warp per row, 32 lanes x S = Rp/32 contiguous slots each, so the
//     route loads are 16-byte vector loads and both prefix scans are a
//     serial pass inside a lane plus one __shfl_up_sync scan across lanes
//     (no log-depth lane rolls);
//   * the TPU's one-hot matmul row fetch becomes a direct row load;
//   * the merge is index arithmetic: survivor j lands at j + shift[j]
//     (|shift| <= kd, destinations distinct), dropped outside [0, Rp);
//     inserts land at their rank. Merged keys pass through one per-warp
//     shared-memory row, where the extractions read them directly;
//   * nothing but the four output blocks goes back to device memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int S>
__device__ __forceinline__ void load_slots(const int* __restrict__ src,
                                           int (&dst)[S]) {
  const int4* p = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const int4 v = __ldg(p + q);
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void load8(const int* __restrict__ src,
                                      int (&dst)[8]) {
  const int4* p = reinterpret_cast<const int4*>(src);
  const int4 a = __ldg(p);
  const int4 b = __ldg(p + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// S: route slots per lane (Rp = 32 * S); TW: time windows; KD: delta width.
template <int S, bool TW, int KD>
__global__ void vrp_delta_kernel(const int* __restrict__ ctx,
                                 const int* __restrict__ av,
                                 const int* __restrict__ sc_pack,
                                 const int* __restrict__ ins_pack,
                                 const int* __restrict__ pay_pack,
                                 const int* __restrict__ el_pack,
                                 int* __restrict__ misc_out,
                                 int* __restrict__ u_out,
                                 int* __restrict__ v_out,
                                 int* __restrict__ c_out,
                                 int n_rows, int rows_per_island, int k_veh) {
  constexpr int RP = 32 * S;
  constexpr int NK = TW ? 5 : 2;  // merged keys: c, leg (+ ct, floor, ce)
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int* buf = smem + warp * NK * RP;
  const int j0 = lane * S;

  for (int row = blockIdx.x * warps + warp; row < n_rows;
       row += gridDim.x * warps) {
    int sc[8], in[8], pay[8];
    load8(sc_pack + (size_t)row * 8, sc);
    load8(ins_pack + (size_t)row * 8, in);
    load8(pay_pack + (size_t)row * 8, pay);
    const int isl = row / rows_per_island;
    const int* base =
        ctx + ((size_t)isl * k_veh + __ldg(av + row)) * (6 * RP) + j0;

    int rs[S], rc[S], rleg[S], rct[S], rfl[S], rce[S];
    load_slots<S>(base, rs);
    load_slots<S>(base + RP, rc);
    load_slots<S>(base + 5 * RP, rleg);
    if (TW) {
      load_slots<S>(base + 2 * RP, rct);
      load_slots<S>(base + 3 * RP, rfl);
      load_slots<S>(base + 4 * RP, rce);
    }

    // patch stay rows' customer payloads (later k wins, as in the reference)
#pragma unroll
    for (int q = 0; q < S; ++q) {
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        if (j0 + q == sc[k]) {
          rc[q] = pay[4 * k];
          if (TW) {
            rct[q] = pay[4 * k + 1];
            rfl[q] = pay[4 * k + 2];
            rce[q] = pay[4 * k + 3];
          }
        }
      }
    }

    // clear this lane's part of the shared row
#pragma unroll
    for (int f = 0; f < NK; ++f) {
#pragma unroll
      for (int q = 0; q < S; ++q) buf[f * RP + j0 + q] = 0;
    }
    __syncwarp();

    // shift + scatter survivors; count survivors ranked before each insert
    int rank_cnt[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k) rank_cnt[k] = 0;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int j = j0 + q;
      bool cleared = false;
      int rem = 0, insb = 0;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const int cp = sc[KD + k];
        cleared |= (j == cp);
        rem += (cp >= 0 && cp < j) ? 1 : 0;
        insb += (in[k] > 0 && in[KD + k] < rs[q]) ? 1 : 0;
      }
      if (!cleared) {
#pragma unroll
        for (int k = 0; k < KD; ++k)
          rank_cnt[k] += (in[k] > 0 && in[KD + k] >= rs[q]) ? 1 : 0;
        const int d = j + insb - rem;
        if (d >= 0 && d < RP) {
          buf[d] = rc[q];
          buf[RP + d] = rleg[q];
          if (TW) {
            buf[2 * RP + d] = rct[q];
            buf[3 * RP + d] = rfl[q];
            buf[4 * RP + d] = rce[q];
          }
        }
      }
    }
    bool iflag[KD];
    int ins_pos[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      iflag[k] = in[k] > 0;
      ins_pos[k] = warp_sum(rank_cnt[k]) + in[2 * KD + k];
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const int ip = ins_pos[k];
        if (iflag[k] && ip >= 0 && ip < RP) {
          buf[ip] = pay[4 * k];
          buf[RP + ip] = 0;
          if (TW) {
            buf[2 * RP + ip] = pay[4 * k + 1];
            buf[3 * RP + ip] = pay[4 * k + 2];
            buf[4 * RP + ip] = pay[4 * k + 3];
          }
        }
      }
    }
    __syncwarp();

    const int length = sc[2 * KD + 2];
    const bool has = length > 0;

    // chain legs over valid adjacent pairs
    int chain_part = 0;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int j = j0 + q;
      if (j + 1 < length) chain_part += buf[RP + j];
    }
    const int chain = warp_sum(chain_part);

    int late_total = 0;
    if (TW) {
      const int w0 = sc[2 * KD];
      const int w1 = sc[2 * KD + 1];
      // P = inclusive prefix sum of service over the valid prefix
      int p[S];
      int run = 0;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int j = j0 + q;
        run += (j < length) ? buf[2 * RP + j] : 0;
        p[q] = run;
      }
      int incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int excl = incl - run;
      // cummax of (floor - P); floor is -2^30 beyond the valid prefix
      int cm[S];
      int lm = INT_MIN;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int j = j0 + q;
        p[q] += excl;
        const int fl = (j < length) ? buf[3 * RP + j] : -kBig;
        lm = max(lm, fl - p[q]);
        cm[q] = lm;
      }
      int incm = lm;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incm, o);
        if (lane >= o) incm = max(incm, t);
      }
      int exm = __shfl_up_sync(kFull, incm, 1);
      if (lane == 0) exm = -kBig;
      int late_part = 0;
      int post = 0;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int j = j0 + q;
        post = p[q] + max(w0, max(exm, cm[q]));
        if (j < length) late_part += max(post - buf[4 * RP + j], 0);
      }
      const int post_end = __shfl_sync(kFull, post, 31);
      late_total = warp_sum(late_part) + (has ? max(post_end - w1, 0) : 0);
    }

    // lanes 0..7 each write one column of the four output blocks
    if (lane < 8) {
      int col = -1;
      if (lane < 2 * KD) {
        col = __ldg(el_pack + (size_t)row * 8 + lane);
      } else if (lane < 3 * KD) {
        const int k = lane - 2 * KD;
        col = iflag[k == 0 ? 0 : KD - 1] ? ins_pos[k == 0 ? 0 : KD - 1] - 1
                                         : -1;
      } else if (lane < 4 * KD) {
        const int k = lane - 3 * KD;
        col = iflag[k == 0 ? 0 : KD - 1] ? ins_pos[k == 0 ? 0 : KD - 1] : -1;
      }
      const bool at = col >= 0 && col < RP;
      const bool right = col >= 0 && col + 1 < RP;
      const size_t o = (size_t)row * 8 + lane;
      u_out[o] = at ? buf[col] : 0;
      v_out[o] = right ? buf[col + 1] : 0;
      c_out[o] = at ? buf[RP + col] : 0;

      int m = 0;
      if (lane == 0) {
        m = late_total;
      } else if (lane == 1) {
        m = chain;
      } else if (lane == 2) {
        m = buf[0];
      } else if (lane == 3) {
        m = (length >= 1 && length <= RP) ? buf[length - 1] : 0;
      } else if (lane == 4) {
        m = iflag[0] ? ins_pos[0] : -1;
      } else if (lane == 5 && KD == 2) {
        m = iflag[KD - 1] ? ins_pos[KD - 1] : -1;
      }
      misc_out[o] = m;
    }
    __syncwarp();
  }
}

template <int S, bool TW, int KD>
cudaError_t launch(const int* ctx, const int* av, const int* sc,
                   const int* ins, const int* pay, const int* el, int* misc,
                   int* u, int* v, int* c, int n_rows, int rows_per_island,
                   int k_veh, cudaStream_t stream) {
  constexpr int NK = TW ? 5 : 2;
  constexpr int row_bytes = NK * 32 * S * (int)sizeof(int);
  // stay within the 48 KB of shared memory a block gets by default
  int warps = (48 * 1024) / row_bytes;
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  const long long blocks = ((long long)n_rows + warps - 1) / warps;
  const int grid = (int)(blocks < (1LL << 30) ? blocks : (1LL << 30));
  vrp_delta_kernel<S, TW, KD><<<grid, 32 * warps, warps * row_bytes, stream>>>(
      ctx, av, sc, ins, pay, el, misc, u, v, c, n_rows, rows_per_island,
      k_veh);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch_s(int tw, int kd, const int* ctx, const int* av,
                       const int* sc, const int* ins, const int* pay,
                       const int* el, int* misc, int* u, int* v, int* c,
                       int n_rows, int rows_per_island, int k_veh,
                       cudaStream_t stream) {
  if (tw && kd == 2)
    return launch<S, true, 2>(ctx, av, sc, ins, pay, el, misc, u, v, c,
                              n_rows, rows_per_island, k_veh, stream);
  if (tw && kd == 1)
    return launch<S, true, 1>(ctx, av, sc, ins, pay, el, misc, u, v, c,
                              n_rows, rows_per_island, k_veh, stream);
  if (!tw && kd == 2)
    return launch<S, false, 2>(ctx, av, sc, ins, pay, el, misc, u, v, c,
                               n_rows, rows_per_island, k_veh, stream);
  if (!tw && kd == 1)
    return launch<S, false, 1>(ctx, av, sc, ins, pay, el, misc, u, v, c,
                               n_rows, rows_per_island, k_veh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). ctx: i32 [I, K, 6*rp]; av: i32
// [n_rows]; sc / ins / pay / el and the four outputs: i32 [n_rows, 8], all
// contiguous and 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gj_vrp_delta(const int* ctx, const int* av, const int* sc,
                            const int* ins, const int* pay, const int* el,
                            int* misc, int* u, int* v, int* c, int n_rows,
                            int rows_per_island, int k_veh, int rp, int kd,
                            int tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  if (rows_per_island <= 0) return (int)cudaErrorInvalidValue;
  switch (rp) {
    case 128:
      return (int)dispatch_s<4>(tw, kd, ctx, av, sc, ins, pay, el, misc, u, v,
                                c, n_rows, rows_per_island, k_veh, s);
    case 256:
      return (int)dispatch_s<8>(tw, kd, ctx, av, sc, ins, pay, el, misc, u, v,
                                c, n_rows, rows_per_island, k_veh, s);
    case 384:
      return (int)dispatch_s<12>(tw, kd, ctx, av, sc, ins, pay, el, misc, u,
                                 v, c, n_rows, rows_per_island, k_veh, s);
    case 512:
      return (int)dispatch_s<16>(tw, kd, ctx, av, sc, ins, pay, el, misc, u,
                                 v, c, n_rows, rows_per_island, k_veh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
