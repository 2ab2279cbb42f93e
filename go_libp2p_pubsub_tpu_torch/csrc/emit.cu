// Fused IHAVE -> IWANT chooser for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/hopkernel.py:emit_pallas (forward_tick's
// step 3, ops/propagate.py; gossipsub.go:654-676 MaxIHaveLength).
//
// Per receiver n, in slot order k = 0..K-1: the sender's gossip-window row
// window[nbr[n][k]] masked by the topic expansion of the gossip plane
// gossip[n][:][k] are the ids slot k offers; of those not yet seen or
// assigned, the first `budget` in message order are asked from slot k
// (the inclusive prefix count <= budget of the reference), which marks them
// assigned. Output out[n][m] is the chosen slot, -1 for none.
//
// Layouts: window is n-major [N_src, W] uint32 rows (the wrapper
// interleaves the caller's word-major table); have [W, N]; gossip
// [N, T, K] uint8 bools; topic_bits [T, W]; nbr [N, K] int32 pre-clipped
// (not bounds-checked); out [N, M] int32.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32, T=1, M=64,
// W=2 one call reads nbr (13.1 MB), the gossip plane (3.3 MB) and the
// [W, N] tables (1.6 MB) and writes out (26.2 MB): ~44 MB, ~13 us. Beside
// those bytes, the window lookups are random 32-byte L2 sectors (the
// 0.8 MB table stays in the 50 MB L2).
//
// Design: a warp takes one receiver at a time and lane l slot 32c + l of
// chunk c (the assigned set carried across chunks; lanes past K idle), so
// the nbr and gossip rows are coalesced reads. A lane loads its sender's
// window row once, as one n-major row (one sector at W <= 8), and only
// where its gossip plane allows a topic. With budget >= M (the headline's
// case) every offer is taken by its lowest offering slot: masked &
// ~exclusive prefix-OR over lanes, by shuffles. With budget < M the
// offering lanes (a ballot) take turns in slot order: lane s takes the
// first `budget` bits of masked & ~assigned and the warp ORs them into
// assigned by a shuffle. A block owns BR = 32 receivers (8 warps, 4
// receivers each): their [BR, M] choices are staged in shared memory as
// int8 slots (int16 where K > 128, int32 where K > 32768; at most 32 KB),
// filled with -1, and written out as one contiguous run of int32 rows by
// 16-byte stores. At T = 1 the launcher takes an instance compiled for
// one topic.
//
// On the card the kernel stays above its byte bound (PERF.md): a warp
// walks its receivers one after another, each a chain of dependent reads
// and warp-wide steps. The launcher refuses W > 8, M > 32 W, a slot type
// too narrow for K and a misaligned table with an error code; it runs on
// the caller's stream and returns cudaGetLastError().

#include "slot_warp.cuh"

#define MAXW 8
constexpr int BR = 32;  // receivers per block: 8 warps, 4 receivers each

// The first `budget` set bits of x (message order: word 0 bit 0 first).
template <int W>
__device__ __forceinline__ void first_bits(const uint32_t (&x)[W], int budget,
                                           uint32_t (&take)[W]) {
  int left = budget;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    take[i] = 0;
    if (left > 0 && x[i]) {
      const int c = __popc(x[i]);
      if (c <= left) {
        take[i] = x[i];
        left -= c;
      } else {
        uint32_t v = x[i];
        for (int q = 0; q < left; ++q) {
          const uint32_t low = v & (~v + 1u);
          take[i] |= low;
          v ^= low;
        }
        left = 0;
      }
    }
  }
}

// TC: the topic count where it is known at compile time (1), else 0
template <int W, typename S, int TC>
__global__ void __launch_bounds__(32 * SLOT_WARPS)
emit_kernel(const uint32_t* __restrict__ window,
            const uint32_t* __restrict__ have,
            const uint8_t* __restrict__ gossip,
            const uint32_t* __restrict__ topic_bits,
            const int32_t* __restrict__ nbr, int32_t* __restrict__ out, int n,
            int k, int t_arg, int m, int budget) {
  const int t = TC > 0 ? TC : t_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tile = reinterpret_cast<S*>(smem_raw);               // [BR][M]
  const int r0 = blockIdx.x * BR;
  const int rows = min(BR, n - r0);
  const int total = rows * m;
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < total; e += blockDim.x) tile[e] = (S)-1;
  __syncthreads();

  const int nch = (k + 31) / 32;
  uint32_t valid[W];                              // message ids in word i
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int rem = m - 32 * i;
    valid[i] = rem >= 32 ? 0xFFFFFFFFu : (rem > 0 ? (1u << rem) - 1u : 0u);
  }
  for (int rl = threadIdx.x >> 5; rl < rows; rl += SLOT_WARPS) {
    const int r = r0 + rl;
    const int32_t* nb = nbr + (long long)r * k;
    const uint8_t* gs = gossip + (long long)r * t * k;
    uint32_t asg[W], carry[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      asg[i] = __ldg(have + (long long)i * n + r);
      carry[i] = 0;
    }
    for (int c = 0; c < nch; ++c) {
      const int s = 32 * c + lane;
      uint32_t allowed[W], row[W], masked[W], take[W];
      bool any = false;
      const long long j = s < k ? __ldg(nb + s) : 0;
#pragma unroll
      for (int i = 0; i < W; ++i) allowed[i] = row[i] = 0;
      if (s < k) {
        expand_topics<W>(gs, topic_bits, s, k, t, allowed);
#pragma unroll
        for (int i = 0; i < W; ++i) any |= allowed[i] != 0;
      }
      if (any) load_row<W>(window, j, row);
#pragma unroll
      for (int i = 0; i < W; ++i)
        masked[i] = row[i] & allowed[i] & ~asg[i] & valid[i];
      if (budget >= m) {
        // the budget cannot bind: the lowest offering slot takes each id
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const uint32_t incl = prefix_or(masked[i], lane);
          take[i] = masked[i] & ~(exclusive_of(incl, lane) | carry[i]);
          carry[i] |= __shfl_sync(FULL_WARP, incl, 31);
        }
      } else {
        // slot order: lane l takes its first `budget` unassigned offers,
        // then every lane adds them to the assigned set. A lane with no
        // offer takes nothing, so only the offering lanes take turns.
        bool offers = false;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          take[i] = 0;
          offers |= masked[i] != 0;
        }
        for (unsigned turn = __ballot_sync(FULL_WARP, offers); turn;
             turn &= turn - 1u) {
          const int l = __ffs(turn) - 1;
          if (lane == l) {
            uint32_t x[W];
#pragma unroll
            for (int i = 0; i < W; ++i) x[i] = masked[i] & ~asg[i];
            first_bits<W>(x, budget, take);
          }
#pragma unroll
          for (int i = 0; i < W; ++i)
            asg[i] |= __shfl_sync(FULL_WARP, take[i], l);
        }
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        uint32_t x = take[i];
        while (x) {
          const int b = __ffs(x) - 1;
          x &= x - 1u;
          tile[rl * m + 32 * i + b] = (S)s;
        }
      }
    }
  }
  __syncthreads();

  // the block's rows are one contiguous run of out: 16-byte stores
  int32_t* o = out + (long long)r0 * m;
  const int nvec = (uintptr_t)o % 16 == 0 ? total / 4 : 0;
  for (int e = threadIdx.x; e < nvec; e += blockDim.x) {
    const S* p = tile + 4 * e;
    reinterpret_cast<int4*>(o)[e] =
        make_int4((int)p[0], (int)p[1], (int)p[2], (int)p[3]);
  }
  for (int e = 4 * nvec + threadIdx.x; e < total; e += blockDim.x)
    o[e] = (int)tile[e];
}

template <int W, typename S>
static void launch_emit(const void* window, const void* have,
                        const void* gossip, const void* topic_bits,
                        const void* nbr, void* out, int n, int k, int t, int m,
                        int budget, size_t smem, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + BR - 1) / BR);
  auto kernel = t == 1 ? emit_kernel<W, S, 1> : emit_kernel<W, S, 0>;
  kernel<<<blocks, 32 * SLOT_WARPS, smem, stream>>>(
      (const uint32_t*)window, (const uint32_t*)have,
      (const uint8_t*)gossip, (const uint32_t*)topic_bits,
      (const int32_t*)nbr, (int32_t*)out, n, k, t, m, budget);
}

template <int W>
static int launch(const void* window, const void* have, const void* gossip,
                  const void* topic_bits, const void* nbr, void* out, int n,
                  int k, int t, int m, int budget, int slot_bytes,
                  size_t smem, cudaStream_t stream) {
  if (!row_aligned<W>(window)) return (int)cudaErrorMisalignedAddress;
  switch (slot_bytes) {
    case 1: launch_emit<W, int8_t>(window, have, gossip, topic_bits, nbr, out,
                                   n, k, t, m, budget, smem, stream); break;
    case 2: launch_emit<W, int16_t>(window, have, gossip, topic_bits, nbr, out,
                                    n, k, t, m, budget, smem, stream); break;
    default: launch_emit<W, int32_t>(window, have, gossip, topic_bits, nbr,
                                     out, n, k, t, m, budget, smem, stream);
  }
  return 0;
}

extern "C" int emit_launch(const void* window, const void* have,
                           const void* gossip, const void* topic_bits,
                           const void* nbr, void* out, int n, int k, int t,
                           int w, int m, int budget, int slot_bytes,
                           void* stream) {
  const long long max_slot = slot_bytes == 1 ? 127 : (slot_bytes == 2 ? 32767
                                                      : 2147483647LL);
  if (w < 1 || w > MAXW || m > 32 * w
      || (slot_bytes != 1 && slot_bytes != 2 && slot_bytes != 4)
      || (long long)k - 1 > max_slot)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BR * m * slot_bytes;   // <= 32 KB
  if (n <= 0) return (int)cudaGetLastError();
#define EMIT_CASE(WW)                                                        \
  case WW: {                                                                 \
    const int err = launch<WW>(window, have, gossip, topic_bits, nbr, out,   \
                               n, k, t, m, budget, slot_bytes, smem,         \
                               (cudaStream_t)stream);                        \
    if (err) return err;                                                     \
    break;                                                                   \
  }
  switch (w) {
    EMIT_CASE(1) EMIT_CASE(2) EMIT_CASE(3) EMIT_CASE(4)
    EMIT_CASE(5) EMIT_CASE(6) EMIT_CASE(7) EMIT_CASE(8)
  }
#undef EMIT_CASE
  return (int)cudaGetLastError();
}
