// Fused IWANT resolution for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/hopkernel.py:iwant_resolve_pallas
// (forward_tick's step 1, ops/propagate.py; gossipsub.go:698-739 and the
// broken-promise accounting of gossip_tracer.go:79-115).
//
// Per receiver n and slot k: the messages asked from slot k last tick
// (pend[n][m] == k, alive), the sender's answer words answers[:, nbr[n][k]],
// admission by data_ok[n][k]; got = asked & answer & ~have & admitted,
// broken = asked & ~answer. Outputs got_any / got_valid_any [W, N] and the
// per-(topic, slot) uint8 counts nv (valid pulls), ni (invalid pulls) and
// broken [K, N] (P7 broken promises). All outputs are written in full.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32, T=1, M=64,
// W=2 one call reads pend (26.2 MB), nbr (13.1 MB), data_ok (3.3 MB) and
// the [W, N] tables (~3.3 MB), and writes nv, ni, broken (9.8 MB) and two
// [W, N] tables (1.6 MB): ~58 MB, ~17 us.
//
// Design: one thread per receiver row. The row's pending-pull slots are
// read once into slot-index bit planes (bit p of pend per message, plus an
// in-range mask), from which each slot's ask set is an AND of planes, so
// no [K, M] temporary exists. The 0.8 MB answer table is read through the
// read-only cache and stays in L2. pend and nbr rows are read with a row
// stride between neighbouring threads (not coalesced): a later change
// should stage them through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXW 8
#define MAXNB 7   // slot-index bit planes: K <= 128

__global__ void iwant_resolve_kernel(
    const int32_t* __restrict__ pend, const uint32_t* __restrict__ answers,
    const uint32_t* __restrict__ have, const uint32_t* __restrict__ vm,
    const uint32_t* __restrict__ inv_n, const uint32_t* __restrict__ alive,
    const uint8_t* __restrict__ data_ok,
    const uint32_t* __restrict__ topic_bits, const int32_t* __restrict__ nbr,
    uint32_t* __restrict__ got_any, uint32_t* __restrict__ got_valid_any,
    uint8_t* __restrict__ nv, uint8_t* __restrict__ ni,
    uint8_t* __restrict__ broken, int n_src, int n, int k, int t, int w,
    int m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int32_t* pr = pend + (long long)r * m;
  uint32_t inr[MAXW], hv[MAXW], vmv[MAXW], inv[MAXW];
  uint32_t pl[MAXNB][MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    inr[i] = hv[i] = vmv[i] = inv[i] = 0;
#pragma unroll
    for (int p = 0; p < MAXNB; ++p) pl[p][i] = 0;
    if (i < w) {
      uint32_t in_w = 0;
      uint32_t pw[MAXNB];
#pragma unroll
      for (int p = 0; p < MAXNB; ++p) pw[p] = 0;
      for (int b = 0; b < 32; ++b) {
        const int mm = i * 32 + b;
        if (mm >= m) break;
        const int s = pr[mm];
        if (s >= 0 && s < k) {
          in_w |= 1u << b;
#pragma unroll
          for (int p = 0; p < MAXNB; ++p)
            if ((s >> p) & 1) pw[p] |= 1u << b;
        }
      }
      inr[i] = in_w & alive[i];
#pragma unroll
      for (int p = 0; p < MAXNB; ++p) pl[p][i] = pw[p];
      hv[i] = have[(long long)i * n + r];
      vmv[i] = vm[(long long)i * n + r];
      inv[i] = inv_n[(long long)i * n + r];
    }
  }

  uint32_t ga[MAXW], gva[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) ga[i] = gva[i] = 0;

  for (int s = 0; s < k; ++s) {
    const long long j = nbr[(long long)r * k + s];
    const uint32_t adm = data_ok[(long long)r * k + s] ? 0xFFFFFFFFu : 0u;
    uint32_t got[MAXW], gv[MAXW];
    int bk = 0;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      got[i] = gv[i] = 0;
      if (i < w) {
        uint32_t asked = inr[i];
#pragma unroll
        for (int p = 0; p < MAXNB; ++p)
          asked &= ((s >> p) & 1) ? pl[p][i] : ~pl[p][i];
        const uint32_t ans = __ldg(answers + (long long)i * n_src + j);
        got[i] = asked & ans & ~hv[i] & adm;
        gv[i] = got[i] & vmv[i];
        bk += __popc(asked & ~ans);
        ga[i] |= got[i];
        gva[i] |= gv[i];
      }
    }
    broken[(long long)s * n + r] = (uint8_t)bk;
    for (int tt = 0; tt < t; ++tt) {
      int cnv = 0, cni = 0;
#pragma unroll
      for (int i = 0; i < MAXW; ++i) {
        if (i < w) {
          const uint32_t tw = __ldg(topic_bits + tt * w + i);
          cnv += __popc(gv[i] & tw);
          cni += __popc(got[i] & inv[i] & tw);
        }
      }
      const long long o = ((long long)tt * k + s) * n + r;
      nv[o] = (uint8_t)cnv;
      ni[o] = (uint8_t)cni;
    }
  }
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < w) {
      got_any[(long long)i * n + r] = ga[i];
      got_valid_any[(long long)i * n + r] = gva[i];
    }
  }
}

extern "C" int iwant_resolve_launch(
    const void* pend, const void* answers, const void* have, const void* vm,
    const void* inv_n, const void* alive, const void* data_ok,
    const void* topic_bits, const void* nbr, void* got_any,
    void* got_valid_any, void* nv, void* ni, void* broken, int n_src, int n,
    int k, int t, int w, int m, void* stream) {
  if (w > MAXW || k > (1 << MAXNB) || m > 32 * w) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    iwant_resolve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pend, (const uint32_t*)answers,
        (const uint32_t*)have, (const uint32_t*)vm, (const uint32_t*)inv_n,
        (const uint32_t*)alive, (const uint8_t*)data_ok,
        (const uint32_t*)topic_bits, (const int32_t*)nbr,
        (uint32_t*)got_any, (uint32_t*)got_valid_any, (uint8_t*)nv,
        (uint8_t*)ni, (uint8_t*)broken, n_src, n, k, t, w, m);
  }
  return (int)cudaGetLastError();
}
