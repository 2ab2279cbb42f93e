// One fused forwarding hop for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/hopkernel.py:hop_pallas (one hop of
// forward_tick's frontier loop, ops/propagate.py).
//
// Per receiver n, in slot order k = 0..K-1: the sender's frontier row
// frontier[nbr[n][k]] masked by the topic expansion of the forward plane
// fwd[n][:][k] (off); the lowest-slot winner of each new message
// (off & ~excl & ~have, excl = OR of lower slots' offers) adds its
// popcounts per topic into nv (valid) and ni (invalid). A second pass adds
// the mesh-duplicate counts (off & mesh expansion & elig) into dup, with
// the eligibility of the WHOLE hop's new deliveries (hopkernel.py:422-434).
//
// Layouts: frontier is n-major [N_src, W] uint32 rows (the wrapper
// interleaves the caller's word-major table); have/dlv/dlv_new/vm/inv_n/
// window_old/new_valid are [W, N] (word-major, peer-minor); valid_msg [W];
// nbr [N, K] int32 pre-clipped (not bounds-checked); fwd/mesh [N, T, K]
// uint8 bools; topic_bits [T, W]; nv/ni/dup [T, K, N] uint8 counters that
// wrap as JAX's uint8 adds do. In place, as the Pallas aliases
// (hopkernel.py:485): have, dlv, dlv_new, nv, ni and dup; new_valid is a
// separate buffer, since the frontier is read by every receiver.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32, T=1, W=2 a
// hop reads nbr (13.1 MB), fwd and mesh (6.6 MB), nv/ni/dup (9.8 MB) and
// the [W, N] tables (~5.7 MB), and writes nv/ni/dup (9.8 MB) and four
// [W, N] tables (3.3 MB): ~48 MB, ~14 us. Beside those bytes, the N*K
// frontier lookups are random 32-byte L2 sectors (the 0.8 MB table stays
// in the 50 MB L2), at the L2's sector rate.
//
// Design: a warp takes one receiver at a time and lane l slot 32c + l of
// chunk c (K > 32 runs as chunks with the OR of earlier chunks carried;
// lanes past K idle), so the nbr, fwd and mesh rows are coalesced reads.
// excl is an exclusive prefix-OR over lanes by shuffles, new_any the
// carried OR. A lane loads its sender's frontier row once, as one n-major
// row (one sector at W <= 8), and only where its fwd plane allows a topic;
// it keeps off & mesh in registers for the duplicate pass, which reads no
// frontier and no nbr (at K > 32 the duplicate pass loads each chunk's
// rows again). A lane adds its counts into the global [T, K, N] counters
// in place, and only where they are not zero: each (t, k, r) byte belongs
// to one lane, so no atomics are needed and the sums stay exact. (Staging
// a block's counter tiles in shared memory, read and written back whole
// as coalesced words, was measured and was slower: most counts of a hop
// are zero, so the in-place adds touch far fewer bytes than the tiles.)
// A block owns BR = 64 receivers; it first asks the L2 for all their rows
// (Hopper's bulk prefetch, one instruction per contiguous run), and a warp
// reads a receiver's words in one round up front. The per-receiver
// results go to shared memory and out as coalesced [W, BR] runs. At T = 1
// (the headline's) the launcher takes an instance compiled for one topic,
// whose topic loops unroll and whose topic words stay in registers.
//
// On the card the kernel stays well above its byte bound (PERF.md): a
// warp walks its receivers one after another, each a chain of dependent
// reads and warp-wide steps. A thread per receiver walking its slots in
// order, with its rows staged in shared memory, was measured too and was
// slower. The launcher refuses W > 8 and a misaligned table with an error
// code; it runs on the caller's stream and returns cudaGetLastError().

#include "slot_warp.cuh"

#define MAXW 8
constexpr int BR = 64;  // receivers per block: 8 warps, 8 receivers each

// One lane's edge: off = frontier row & fwd expansion, offm = off & mesh
// expansion. The nbr entry is read beside the planes (the warp's row is
// one coalesced read either way); the frontier row only where the fwd
// plane allows a topic.
template <int W>
__device__ __forceinline__ void edge_offer(
    const uint32_t* __restrict__ frontier, const int32_t* __restrict__ nb,
    const uint8_t* __restrict__ fw, const uint8_t* __restrict__ ms,
    const uint32_t* __restrict__ tb, int s, int k, int t, uint32_t (&off)[W],
    uint32_t (&offm)[W]) {
  uint32_t allowed[W], meb[W], row[W];
  bool any = false;
  const long long j = s < k ? __ldg(nb + s) : 0;
#pragma unroll
  for (int i = 0; i < W; ++i) allowed[i] = meb[i] = row[i] = 0;
  if (s < k) {
    expand_topics<W>(fw, tb, s, k, t, allowed);
    expand_topics<W>(ms, tb, s, k, t, meb);
#pragma unroll
    for (int i = 0; i < W; ++i) any |= allowed[i] != 0;
  }
  if (any) load_row<W>(frontier, j, row);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    off[i] = row[i] & allowed[i];
    offm[i] = off[i] & meb[i];
  }
}

// TC: the topic count where it is known at compile time (1), else 0
template <int W, int TC>
__global__ void __launch_bounds__(32 * SLOT_WARPS)
hop_kernel(const uint32_t* __restrict__ frontier, uint32_t* have,
           uint32_t* dlv, uint32_t* dlv_new, const uint32_t* __restrict__ vm,
           const uint32_t* __restrict__ inv_n,
           const uint32_t* __restrict__ window_old,
           const uint32_t* __restrict__ valid_msg,
           const int32_t* __restrict__ nbr, const uint8_t* __restrict__ fwd,
           const uint8_t* __restrict__ mesh,
           const uint32_t* __restrict__ topic_bits, uint8_t* nv, uint8_t* ni,
           uint8_t* dup, uint32_t* __restrict__ new_valid, int n, int k,
           int t_arg) {
  const int t = TC > 0 ? TC : t_arg;
  __shared__ uint32_t res[2][W][BR];            // new_valid, new_any
  const int r0 = blockIdx.x * BR;
  const int rows = min(BR, n - r0);
  const int tk = t * k;
  const int lane = threadIdx.x & 31;
  // the block's receiver rows of every per-receiver input, into the L2
  for (int q = threadIdx.x; q < 3 + 6 * W; q += blockDim.x) {
    if (q < 3) {
      const uint8_t* p = q == 0 ? reinterpret_cast<const uint8_t*>(nbr)
                                    + (long long)r0 * k * 4
                         : (q == 1 ? fwd : mesh) + (long long)r0 * tk;
      prefetch_l2(p, (long long)rows * (q == 0 ? 4 * k : tk));
    } else {
      const int i = (q - 3) % W, a = (q - 3) / W;
      const uint32_t* x = a == 0 ? have : a == 1 ? vm : a == 2 ? inv_n
                          : a == 3 ? window_old : a == 4 ? dlv_new : dlv;
      prefetch_l2(x + (long long)i * n + r0, (long long)rows * 4);
    }
  }

  const int nch = (k + 31) / 32;
  for (int rl = threadIdx.x >> 5; rl < rows; rl += SLOT_WARPS) {
    const int r = r0 + rl;
    const int32_t* nb = nbr + (long long)r * k;
    const uint8_t* fw = fwd + (long long)r * tk;
    const uint8_t* ms = mesh + (long long)r * tk;
    // every per-receiver word is read up front, in one round of loads
    uint32_t hv[W], vmv[W], inv[W], old_new[W], carry[W], off[W], offm[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const long long o = (long long)i * n + r;
      hv[i] = have[o];
      vmv[i] = __ldg(vm + o);
      inv[i] = __ldg(inv_n + o);
      old_new[i] = __ldg(window_old + o) | dlv_new[o];
      carry[i] = 0;
    }

    // pass 1: lowest-slot winners and their first-delivery / invalid counts
    for (int c = 0; c < nch; ++c) {
      const int s = 32 * c + lane;
      edge_offer<W>(frontier, nb, fw, ms, topic_bits, s, k, t, off, offm);
      uint32_t nf[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t incl = prefix_or(off[i], lane);
        nf[i] = off[i] & ~(exclusive_of(incl, lane) | carry[i]) & ~hv[i];
        carry[i] |= __shfl_sync(FULL_WARP, incl, 31);
      }
      if (s < k) {
        for (int tt = 0; tt < t; ++tt) {
          int cnv = 0, cni = 0;
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const uint32_t tw = __ldg(topic_bits + tt * W + i);
            cnv += __popc(nf[i] & vmv[i] & tw);
            cni += __popc(nf[i] & inv[i] & tw);
          }
          const long long o = (long long)(tt * k + s) * n + r;
          if (cnv) nv[o] = (uint8_t)(nv[o] + cnv);
          if (cni) ni[o] = (uint8_t)(ni[o] + cni);
        }
      }
    }

    uint32_t nval[W], new_any[W], elig[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      new_any[i] = carry[i] & ~hv[i];
      nval[i] = new_any[i] & vmv[i];
      elig[i] = (old_new[i] | nval[i]) & __ldg(valid_msg + i);
    }

    // pass 2: mesh-duplicate credit, eligibility from the whole hop
    for (int c = 0; c < nch; ++c) {
      const int s = 32 * c + lane;
      if (nch > 1) edge_offer<W>(frontier, nb, fw, ms, topic_bits, s, k, t,
                                 off, offm);
      if (s >= k) continue;
      for (int tt = 0; tt < t; ++tt) {
        int d = 0;
#pragma unroll
        for (int i = 0; i < W; ++i)
          d += __popc(offm[i] & elig[i] & __ldg(topic_bits + tt * W + i));
        const long long o = (long long)(tt * k + s) * n + r;
        if (d) dup[o] = (uint8_t)(dup[o] + d);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        res[0][i][rl] = nval[i];
        res[1][i][rl] = new_any[i];
      }
    }
  }
  __syncthreads();

  // the block's [W, BR] results as coalesced runs of consecutive receivers
#pragma unroll
  for (int i = 0; i < W; ++i) {
    for (int rl = threadIdx.x; rl < rows; rl += blockDim.x) {
      const long long o = (long long)i * n + r0 + rl;
      const uint32_t nvl = res[0][i][rl];
      new_valid[o] = nvl;
      have[o] |= res[1][i][rl];
      dlv[o] |= nvl;
      dlv_new[o] |= nvl;
    }
  }
}

template <int W>
static int launch(const void* frontier, void* have, void* dlv, void* dlv_new,
                  const void* vm, const void* inv_n, const void* window_old,
                  const void* valid_msg, const void* nbr, const void* fwd,
                  const void* mesh, const void* topic_bits, void* nv, void* ni,
                  void* dup, void* new_valid, int n, int k, int t,
                  cudaStream_t stream) {
  if (!row_aligned<W>(frontier)) return (int)cudaErrorMisalignedAddress;
  const unsigned blocks = (unsigned)((n + BR - 1) / BR);
  auto kernel = t == 1 ? hop_kernel<W, 1> : hop_kernel<W, 0>;
  kernel<<<blocks, 32 * SLOT_WARPS, 0, stream>>>(
      (const uint32_t*)frontier, (uint32_t*)have, (uint32_t*)dlv,
      (uint32_t*)dlv_new, (const uint32_t*)vm, (const uint32_t*)inv_n,
      (const uint32_t*)window_old, (const uint32_t*)valid_msg,
      (const int32_t*)nbr, (const uint8_t*)fwd, (const uint8_t*)mesh,
      (const uint32_t*)topic_bits, (uint8_t*)nv, (uint8_t*)ni,
      (uint8_t*)dup, (uint32_t*)new_valid, n, k, t);
  return 0;
}

extern "C" int hop_launch(const void* frontier, void* have, void* dlv,
                          void* dlv_new, const void* vm, const void* inv_n,
                          const void* window_old, const void* valid_msg,
                          const void* nbr, const void* fwd, const void* mesh,
                          const void* topic_bits, void* nv, void* ni,
                          void* dup, void* new_valid, int n, int k, int t,
                          int w, void* stream) {
  if (w < 1 || w > MAXW) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
#define HOP_CASE(WW)                                                         \
  case WW: {                                                                 \
    const int err = launch<WW>(frontier, have, dlv, dlv_new, vm, inv_n,      \
                               window_old, valid_msg, nbr, fwd, mesh,        \
                               topic_bits, nv, ni, dup, new_valid, n, k, t,  \
                               (cudaStream_t)stream);                        \
    if (err) return err;                                                     \
    break;                                                                   \
  }
  switch (w) {
    HOP_CASE(1) HOP_CASE(2) HOP_CASE(3) HOP_CASE(4)
    HOP_CASE(5) HOP_CASE(6) HOP_CASE(7) HOP_CASE(8)
  }
#undef HOP_CASE
  return (int)cudaGetLastError();
}
