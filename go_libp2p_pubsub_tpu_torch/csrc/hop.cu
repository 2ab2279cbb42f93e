// One fused forwarding hop for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/hopkernel.py:hop_pallas (one hop of
// forward_tick's frontier loop, ops/propagate.py).
//
// Per receiver n, in slot order k = 0..K-1: gather the sender frontier
// words frontier[:, nbr[n][k]], mask them by the topic expansion of the
// forward plane fwd[n][:][k] (off), pick the lowest-slot winner of each new
// message (off & ~excl & ~have, excl = OR of lower slots' offers), and add
// the winner's popcounts per topic into nv (valid) and ni (invalid). A
// second pass over K adds the mesh-duplicate counts into dup with the
// eligibility of the WHOLE hop's new deliveries (hopkernel.py:422-434).
//
// Layouts: frontier/have/dlv/dlv_new/vm/inv_n/window_old/new_valid are
// [W, N] uint32 (word-major, peer-minor); valid_msg [W]; nbr [N, K] int32
// pre-clipped; fwd/mesh [N, T, K] uint8 bools; topic_bits [T, W];
// nv/ni/dup [T, K, N] uint8 counters that wrap as JAX's uint8 adds do.
//
// In place, as the Pallas aliases (hopkernel.py:485): have, dlv, dlv_new,
// nv, ni and dup are read and written by the thread of their own column
// only. frontier is sender-indexed and read by every receiver, so the next
// frontier (new_valid) goes to a separate buffer and must not alias it.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32, T=1, W=2 a
// hop reads nbr (13.1 MB), fwd and mesh (6.6 MB), nv/ni/dup (9.8 MB) and
// the [W, N] tables (~5.7 MB), and writes nv/ni/dup (9.8 MB) and four
// [W, N] tables (3.3 MB): ~48 MB, ~14 us.
//
// Design: one thread per receiver row; the 0.8 MB frontier table is read
// through the read-only cache and stays in L2. W is bounded by MAXW so the
// per-row words live in registers. The nbr, fwd and mesh rows are read
// with a stride of K (resp. T*K) bytes between neighbouring threads, which
// is not coalesced: a later change should stage them through shared memory
// or store them slot-major.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXW 8

__global__ void hop_kernel(const uint32_t* __restrict__ frontier,
                           uint32_t* have, uint32_t* dlv, uint32_t* dlv_new,
                           const uint32_t* __restrict__ vm,
                           const uint32_t* __restrict__ inv_n,
                           const uint32_t* __restrict__ window_old,
                           const uint32_t* __restrict__ valid_msg,
                           const int32_t* __restrict__ nbr,
                           const uint8_t* __restrict__ fwd,
                           const uint8_t* __restrict__ mesh,
                           const uint32_t* __restrict__ topic_bits,
                           uint8_t* nv, uint8_t* ni, uint8_t* dup,
                           uint32_t* __restrict__ new_valid,
                           int n_src, int n, int k, int t, int w) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  uint32_t hv[MAXW], vmv[MAXW], inv[MAXW], excl[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    hv[i] = vmv[i] = inv[i] = excl[i] = 0;
    if (i < w) {
      hv[i] = have[(long long)i * n + r];
      vmv[i] = vm[(long long)i * n + r];
      inv[i] = inv_n[(long long)i * n + r];
    }
  }
  const int32_t* nb = nbr + (long long)r * k;
  const uint8_t* fw = fwd + (long long)r * t * k;
  const uint8_t* ms = mesh + (long long)r * t * k;

  // pass 1: lowest-slot winners and their first-delivery / invalid counts
  for (int s = 0; s < k; ++s) {
    const long long j = nb[s];
    uint32_t nf[MAXW];
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      nf[i] = 0;
      if (i < w) {
        uint32_t allowed = 0;
        for (int tt = 0; tt < t; ++tt)
          if (fw[tt * k + s]) allowed |= __ldg(topic_bits + tt * w + i);
        const uint32_t off = __ldg(frontier + (long long)i * n_src + j) & allowed;
        nf[i] = off & ~excl[i] & ~hv[i];
        excl[i] |= off;
      }
    }
    for (int tt = 0; tt < t; ++tt) {
      int cnv = 0, cni = 0;
#pragma unroll
      for (int i = 0; i < MAXW; ++i) {
        if (i < w) {
          const uint32_t tw = __ldg(topic_bits + tt * w + i);
          cnv += __popc(nf[i] & vmv[i] & tw);
          cni += __popc(nf[i] & inv[i] & tw);
        }
      }
      const long long o = ((long long)tt * k + s) * n + r;
      if (cnv) nv[o] = (uint8_t)(nv[o] + cnv);
      if (cni) ni[o] = (uint8_t)(ni[o] + cni);
    }
  }

  uint32_t nval[MAXW], elig[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    nval[i] = elig[i] = 0;
    if (i < w) {
      const uint32_t new_any = excl[i] & ~hv[i];
      nval[i] = new_any & vmv[i];
      elig[i] = (window_old[(long long)i * n + r] | dlv_new[(long long)i * n + r]
                 | nval[i]) & valid_msg[i];
      excl[i] = new_any;                      // reused below for have
    }
  }

  // pass 2: mesh-duplicate credit, eligibility from the whole hop
  for (int s = 0; s < k; ++s) {
    const long long j = nb[s];
    uint32_t dk[MAXW];
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      dk[i] = 0;
      if (i < w) {
        uint32_t allowed = 0, meb = 0;
        for (int tt = 0; tt < t; ++tt) {
          const uint32_t tw = __ldg(topic_bits + tt * w + i);
          if (fw[tt * k + s]) allowed |= tw;
          if (ms[tt * k + s]) meb |= tw;
        }
        const uint32_t off = __ldg(frontier + (long long)i * n_src + j) & allowed;
        dk[i] = off & meb & elig[i];
      }
    }
    for (int tt = 0; tt < t; ++tt) {
      int c = 0;
#pragma unroll
      for (int i = 0; i < MAXW; ++i)
        if (i < w) c += __popc(dk[i] & __ldg(topic_bits + tt * w + i));
      if (c) {
        const long long o = ((long long)tt * k + s) * n + r;
        dup[o] = (uint8_t)(dup[o] + c);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < w) {
      const long long o = (long long)i * n + r;
      new_valid[o] = nval[i];
      have[o] = hv[i] | excl[i];
      dlv[o] = dlv[o] | nval[i];
      dlv_new[o] = dlv_new[o] | nval[i];
    }
  }
}

extern "C" int hop_launch(const void* frontier, void* have, void* dlv,
                          void* dlv_new, const void* vm, const void* inv_n,
                          const void* window_old, const void* valid_msg,
                          const void* nbr, const void* fwd, const void* mesh,
                          const void* topic_bits, void* nv, void* ni,
                          void* dup, void* new_valid, int n_src, int n, int k,
                          int t, int w, void* stream) {
  if (w > MAXW) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    hop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)frontier, (uint32_t*)have, (uint32_t*)dlv,
        (uint32_t*)dlv_new, (const uint32_t*)vm, (const uint32_t*)inv_n,
        (const uint32_t*)window_old, (const uint32_t*)valid_msg,
        (const int32_t*)nbr, (const uint8_t*)fwd, (const uint8_t*)mesh,
        (const uint32_t*)topic_bits, (uint8_t*)nv, (uint8_t*)ni,
        (uint8_t*)dup, (uint32_t*)new_valid, n_src, n, k, t, w);
  }
  return (int)cudaGetLastError();
}
