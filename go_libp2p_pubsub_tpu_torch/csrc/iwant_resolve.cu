// Fused IWANT resolution for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/hopkernel.py:iwant_resolve_pallas
// (forward_tick's step 1, ops/propagate.py; gossipsub.go:698-739 and the
// broken-promise accounting of gossip_tracer.go:79-115).
//
// Per receiver n and slot k: the messages asked from slot k last tick
// (pend[n][m] == k, alive), the sender's answer row answers[nbr[n][k]],
// admission by data_ok[n][k]; got = asked & answer & ~have & admitted,
// broken = asked & ~answer. Outputs got_any / got_valid_any [W, N] and the
// per-(topic, slot) uint8 counts nv (valid pulls), ni (invalid pulls) and
// broken [K, N] (P7 broken promises), which wrap modulo 256 as the
// reference's uint8 casts do. All outputs are written in full.
//
// Layouts: answers is n-major [N_src, W] uint32 rows (the wrapper
// interleaves the caller's word-major table); pend [N, M] int32 (-1 none);
// have/vm/inv_n [W, N]; alive [W]; data_ok [N, K] uint8; topic_bits
// [T, W]; nbr [N, K] int32 pre-clipped (not bounds-checked).
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32, T=1, M=64,
// W=2 one call reads pend (26.2 MB), nbr (13.1 MB), data_ok (3.3 MB) and
// the [W, N] tables (~2.5 MB), and writes nv, ni, broken (9.8 MB) and two
// [W, N] tables (1.6 MB): ~57 MB, ~17 us. Only pend and the outputs are
// needed where nothing is pending (the headline's real ticks): ~38 MB,
// ~11 us. Beside those bytes, every asked slot looks up one random answer
// row, at the L2's random-sector rate (the 0.8 MB table stays in L2).
//
// Design: a warp takes one receiver at a time and lane l slot 32c + l of
// chunk c (any K). The pend row is read coalesced, lane b holding message
// 32i + b of word i, and a ballot per word finds the alive messages
// pending from some slot. A warp reads the pend rows of 8 receivers at
// once (all loads in flight together) and then resolves those with an
// alive ask one by one; a receiver with none is done, its counts zero,
// having read nothing else. For the others lane q first asks the L2 for
// receiver q's nbr and data_ok rows (Hopper's bulk prefetch), and each
// alive message's lane ORs its bit into its slot's word of a per-warp
// [W][32] shared array (a shared-memory atomicOr), chunk by chunk; lane l
// reads its slot's ask set and clears it. So there is no [K, M] temporary
// and no slot-index bit planes. A lane loads its answer row (one sector at
// W <= 8) only where its ask set is not empty; nbr and data_ok rows are
// read coalesced, have/vm/inv_n as one broadcast word per warp. got_any
// and got_valid_any are an OR over lanes in five __shfl_xor_sync steps. A
// block owns BR receivers (a power of two <= 64, the largest whose
// [(2T+1) * K][pitch] byte tile fits 32 KB, pitch = BR + 4 from BR = 8 up
// so that a warp's bytes of one receiver fall in 32 banks). It first asks
// the L2 for its pend rows and receiver words; the lanes put their counts
// in the zeroed tile, and each tile row goes out as a run of BR
// consecutive receivers, 4 bytes a thread (a lane-per-slot store would be
// strided by N). At W <= 2 a thread keeps at most 48 registers, so that 5
// blocks fit an SM. At T = 1 the launcher takes an instance compiled for
// one topic. Measured and dropped (PERF.md): __match_any_sync groups whose
// lowest lane deposits the group's mask (slower than the atomics), loading
// a receiver's inputs while the one before it is resolved, and blocks of
// 128 receivers.
//
// The launcher refuses W > 8, M > 32 W, a tile of counts too large for
// one receiver ((2T+1) * K > 32768) and a misaligned answer table with an
// error code; it runs on the caller's stream and returns
// cudaGetLastError().

#include "slot_warp.cuh"

#define MAXW 8
constexpr int MAXBR = 64;                 // receivers per block, at most
// blocks an SM keeps resident: at W <= 2 (the paths' W) 5, which caps a
// thread at 48 registers and measured faster than the compiler's own
// choice (~60); wider rows would spill under that cap
constexpr int min_blocks(int w) { return w <= 2 ? 5 : 1; }
constexpr int RB = 8;                     // receivers a warp reads at once
constexpr int TILE_MAX = 32 * 1024;       // bytes of the count tile

// The byte pitch of a tile row: BR, padded by a word where BR >= 8 so that
// the 32 lanes' bytes of one receiver (a row apart) fall in 32 banks
__host__ __device__ inline int tile_pitch(int br) {
  return br >= 8 ? br + 4 : br;
}

// Receivers per block: the largest power of two <= MAXBR whose
// [(2T+1) * K][pitch] tile fits TILE_MAX; 0 where one receiver's does not
static int block_rows(int t, int k) {
  int br = MAXBR;
  while (br && (long long)(2 * t + 1) * k * tile_pitch(br) > TILE_MAX)
    br /= 2;
  return br;
}

// the output row of tile row q: nv[tt][s], ni[tt][s] or broken[s]
__device__ __forceinline__ uint8_t* tile_row_dst(uint8_t* nv, uint8_t* ni,
                                                 uint8_t* broken, int q,
                                                 int t, int k, int n) {
  return q < t * k ? nv + (long long)q * n
         : q < 2 * t * k ? ni + (long long)(q - t * k) * n
                         : broken + (long long)(q - 2 * t * k) * n;
}

// TC: the topic count where it is known at compile time (1), else 0
template <int W, int TC>
__global__ void __launch_bounds__(32 * SLOT_WARPS, min_blocks(W))
iwant_resolve_kernel(const int32_t* __restrict__ pend,
                     const uint32_t* __restrict__ answers,
                     const uint32_t* __restrict__ have,
                     const uint32_t* __restrict__ vm,
                     const uint32_t* __restrict__ inv_n,
                     const uint32_t* __restrict__ alive,
                     const uint8_t* __restrict__ data_ok,
                     const uint32_t* __restrict__ topic_bits,
                     const int32_t* __restrict__ nbr,
                     uint32_t* __restrict__ got_any,
                     uint32_t* __restrict__ got_valid_any,
                     uint8_t* __restrict__ nv, uint8_t* __restrict__ ni,
                     uint8_t* __restrict__ broken, int n, int k, int t_arg,
                     int m, int br) {
  const int t = TC > 0 ? TC : t_arg;
  // [(2T+1) * K][pitch] counts: row tt * K + s of nv, (T + tt) * K + s of
  // ni, 2 * T * K + s of broken; byte rl of a row is receiver r0 + rl
  extern __shared__ __align__(16) uint8_t tile[];
  __shared__ uint32_t ask_sh[SLOT_WARPS][W][32];
  __shared__ uint32_t res[2][W][MAXBR];       // got_any, got_valid_any
  const int r0 = blockIdx.x * br;
  const int rows = min(br, n - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = (2 * t + 1) * k;              // tile rows
  const int pitch = tile_pitch(br);
  const int tile_bytes = nq * pitch;

  // the block's pend rows and receiver words, into the L2
  for (int q = threadIdx.x; q < 1 + 3 * W; q += blockDim.x) {
    if (q == 0) {
      prefetch_l2(pend + (long long)r0 * m, (long long)rows * m * 4);
    } else {
      const int i = (q - 1) % W, a = (q - 1) / W;
      const uint32_t* x = a == 0 ? have : a == 1 ? vm : inv_n;
      prefetch_l2(x + (long long)i * n + r0, (long long)rows * 4);
    }
  }
  for (int q = threadIdx.x; q < tile_bytes / 16; q += blockDim.x)
    reinterpret_cast<uint4*>(tile)[q] = make_uint4(0, 0, 0, 0);
  for (int q = tile_bytes / 16 * 16 + threadIdx.x; q < tile_bytes;
       q += blockDim.x)
    tile[q] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) ask_sh[warp][i][lane] = 0;
  uint32_t al[W];
#pragma unroll
  for (int i = 0; i < W; ++i) al[i] = __ldg(alive + i);
  __syncthreads();

  const int nch = (k + 31) / 32;
  // a warp's receivers rl = rb + 8q, q < RB, in batches: first every pend
  // row of the batch is read (all loads in flight together) to find the
  // receivers with an alive ask, whose nbr and data_ok rows lane q then
  // asks the L2 for; then the receivers are resolved one by one, the
  // others skipped
  for (int rb = warp; rb < rows; rb += SLOT_WARPS * RB) {
    uint32_t lives = 0;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int rl = rb + SLOT_WARPS * q;
      uint32_t live = 0;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int mm = 32 * i + lane;
        const int v = rl < rows && mm < m
                          ? __ldg(pend + (long long)(r0 + rl) * m + mm) : -1;
        live |= __ballot_sync(FULL_WARP, v >= 0 && v < k) & al[i];
      }
      if (live) lives |= 1u << q;
    }
    if (lane < RB && ((lives >> lane) & 1u)) {
      const long long e = (long long)(r0 + rb + SLOT_WARPS * lane) * k;
      prefetch_l2(nbr + e, (long long)k * 4);
      prefetch_l2(data_ok + e, k);
    }
    for (int q = 0; q < RB; ++q) {
      const int rl = rb + SLOT_WARPS * q;
      if (rl >= rows) break;
      const int r = r0 + rl;
      uint32_t ga[W], gva[W];
#pragma unroll
      for (int i = 0; i < W; ++i) ga[i] = gva[i] = 0;
      if ((lives >> q) & 1u) {                   // warp-uniform
        int v[W];
        uint32_t hv[W], vmv[W], inv[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int mm = 32 * i + lane;
          v[i] = mm < m ? __ldg(pend + (long long)r * m + mm) : -1;
          const long long o = (long long)i * n + r;
          hv[i] = __ldg(have + o);
          vmv[i] = __ldg(vm + o);
          inv[i] = __ldg(inv_n + o);
        }
        for (int c = 0; c < nch; ++c) {
          const int s = 32 * c + lane;
          const long long e = (long long)r * k + s;
          const int j = s < k ? __ldg(nbr + e) : 0;
          const uint8_t ok = s < k ? __ldg(data_ok + e) : 0;
          // each alive message's lane sets its bit in its slot's ask set
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const int d = v[i] - 32 * c;
            if (v[i] < k && d >= 0 && d < 32 && ((al[i] >> lane) & 1u))
              atomicOr(&ask_sh[warp][i][d], 1u << lane);
          }
          __syncwarp();
          uint32_t ask[W];
          bool any = false;
#pragma unroll
          for (int i = 0; i < W; ++i) {
            ask[i] = ask_sh[warp][i][lane];
            ask_sh[warp][i][lane] = 0;
            any |= ask[i] != 0;
          }
          __syncwarp();
          if (!any) continue;
          uint32_t ans[W], got[W];
          load_row<W>(answers, j, ans);
          const uint32_t adm = ok ? 0xFFFFFFFFu : 0u;
          int bk = 0;
#pragma unroll
          for (int i = 0; i < W; ++i) {
            got[i] = ask[i] & ans[i] & ~hv[i] & adm;
            bk += __popc(ask[i] & ~ans[i]);
            ga[i] |= got[i];
            gva[i] |= got[i] & vmv[i];
          }
          tile[(2 * t * k + s) * pitch + rl] = (uint8_t)bk;
          for (int tt = 0; tt < t; ++tt) {
            int cnv = 0, cni = 0;
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const uint32_t tw = __ldg(topic_bits + tt * W + i);
              cnv += __popc(got[i] & vmv[i] & tw);
              cni += __popc(got[i] & inv[i] & tw);
            }
            tile[(tt * k + s) * pitch + rl] = (uint8_t)cnv;
            tile[((t + tt) * k + s) * pitch + rl] = (uint8_t)cni;
          }
        }
#pragma unroll
        for (int i = 0; i < W; ++i) {
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) {
            ga[i] |= __shfl_xor_sync(FULL_WARP, ga[i], d);
            gva[i] |= __shfl_xor_sync(FULL_WARP, gva[i], d);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          res[0][i][rl] = ga[i];
          res[1][i][rl] = gva[i];
        }
      }
    }
  }
  __syncthreads();

  // each tile row out as a run of the block's receivers: 4 bytes a thread
  // where the block is whole and the rows are 4-byte aligned, else a warp
  // per row, a byte a lane
  if (rows == br && br % 4 == 0 && n % 4 == 0) {
    const int wpr = br / 4, shift = __ffs(wpr) - 1;   // words a row
    for (int e = threadIdx.x; e < nq * wpr; e += blockDim.x) {
      const int q = e >> shift, wd = e & (wpr - 1);
      uint8_t* dst = tile_row_dst(nv, ni, broken, q, t, k, n);
      *reinterpret_cast<uint32_t*>(dst + r0 + 4 * wd) =
          *reinterpret_cast<const uint32_t*>(tile + q * pitch + 4 * wd);
    }
  } else {
    for (int q = warp; q < nq; q += SLOT_WARPS) {
      uint8_t* dst = tile_row_dst(nv, ni, broken, q, t, k, n);
      for (int b = lane; b < rows; b += 32) dst[r0 + b] = tile[q * pitch + b];
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    for (int rl = threadIdx.x; rl < rows; rl += blockDim.x) {
      const long long o = (long long)i * n + r0 + rl;
      got_any[o] = res[0][i][rl];
      got_valid_any[o] = res[1][i][rl];
    }
  }
}

template <int W>
static int launch(const void* pend, const void* answers, const void* have,
                  const void* vm, const void* inv_n, const void* alive,
                  const void* data_ok, const void* topic_bits,
                  const void* nbr, void* got_any, void* got_valid_any,
                  void* nv, void* ni, void* broken, int n, int k, int t,
                  int m, int br, cudaStream_t stream) {
  if (!row_aligned<W>(answers)) return (int)cudaErrorMisalignedAddress;
  const unsigned blocks = (unsigned)((n + br - 1) / br);
  const size_t smem = (size_t)(2 * t + 1) * k * tile_pitch(br);
  auto kernel = t == 1 ? iwant_resolve_kernel<W, 1>
                       : iwant_resolve_kernel<W, 0>;
  kernel<<<blocks, 32 * SLOT_WARPS, smem, stream>>>(
      (const int32_t*)pend, (const uint32_t*)answers, (const uint32_t*)have,
      (const uint32_t*)vm, (const uint32_t*)inv_n, (const uint32_t*)alive,
      (const uint8_t*)data_ok, (const uint32_t*)topic_bits,
      (const int32_t*)nbr, (uint32_t*)got_any, (uint32_t*)got_valid_any,
      (uint8_t*)nv, (uint8_t*)ni, (uint8_t*)broken, n, k, t, m, br);
  return 0;
}

extern "C" int iwant_resolve_launch(
    const void* pend, const void* answers, const void* have, const void* vm,
    const void* inv_n, const void* alive, const void* data_ok,
    const void* topic_bits, const void* nbr, void* got_any,
    void* got_valid_any, void* nv, void* ni, void* broken, int n, int k,
    int t, int w, int m, void* stream) {
  const int br = k >= 1 && t >= 1 ? block_rows(t, k) : 0;
  if (w < 1 || w > MAXW || m > 32 * w || br == 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
#define RESOLVE_CASE(WW)                                                     \
  case WW: {                                                                 \
    const int err = launch<WW>(pend, answers, have, vm, inv_n, alive,       \
                               data_ok, topic_bits, nbr, got_any,            \
                               got_valid_any, nv, ni, broken, n, k, t, m,    \
                               br, (cudaStream_t)stream);                    \
    if (err) return err;                                                     \
    break;                                                                   \
  }
  switch (w) {
    RESOLVE_CASE(1) RESOLVE_CASE(2) RESOLVE_CASE(3) RESOLVE_CASE(4)
    RESOLVE_CASE(5) RESOLVE_CASE(6) RESOLVE_CASE(7) RESOLVE_CASE(8)
  }
#undef RESOLVE_CASE
  return (int)cudaGetLastError();
}
