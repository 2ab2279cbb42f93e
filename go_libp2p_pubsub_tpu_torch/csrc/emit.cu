// Fused IHAVE -> IWANT chooser for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/hopkernel.py:emit_pallas (forward_tick's
// step 3, ops/propagate.py; gossipsub.go:654-676 MaxIHaveLength).
//
// Per receiver n, in slot order k = 0..K-1: the sender's gossip-window words
// window[:, nbr[n][k]] masked by the topic expansion of the gossip plane
// gossip[n][:][k] are the ids slot k offers; of those not yet seen or
// assigned, the first `budget` in message order are asked from slot k
// (the inclusive prefix count <= budget of the reference), which marks them
// assigned. Output out[n][m] is the chosen slot, -1 for none. A budget >= M
// reduces to the lowest-offering-slot choice.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32, T=1, M=64,
// W=2 one call reads nbr (13.1 MB), the gossip plane (3.3 MB) and the
// [W, N] tables (1.6 MB) and writes out (26.2 MB): ~44 MB, ~13 us.
//
// Design: one thread per receiver row; the 0.8 MB window table is read
// through the read-only cache and stays in L2. The budget scan is a
// popcount per word plus, only where a word straddles the budget, a loop
// that peels its lowest set bits. Each thread writes its own [M] output
// row (contiguous per thread, strided between threads): a later change
// should stage the rows through shared memory for coalesced stores, and
// read nbr slot-major.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXW 8

__global__ void emit_kernel(const uint32_t* __restrict__ window,
                            const uint32_t* __restrict__ have,
                            const uint8_t* __restrict__ gossip,
                            const uint32_t* __restrict__ topic_bits,
                            const int32_t* __restrict__ nbr,
                            int32_t* __restrict__ out, int n_src, int n,
                            int k, int t, int w, int m, int budget) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int32_t* orow = out + (long long)r * m;
  for (int mm = 0; mm < m; ++mm) orow[mm] = -1;
  uint32_t asg[MAXW], valid[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    asg[i] = valid[i] = 0;
    if (i < w) {
      asg[i] = have[(long long)i * n + r];
      const int rem = m - 32 * i;                 // message ids in word i
      valid[i] = rem >= 32 ? 0xFFFFFFFFu : (rem > 0 ? (1u << rem) - 1u : 0u);
    }
  }
  const int32_t* nb = nbr + (long long)r * k;
  const uint8_t* gs = gossip + (long long)r * t * k;
  for (int s = 0; s < k; ++s) {
    const long long j = nb[s];
    int left = budget;                            // per-slot iasked budget
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < w) {
        uint32_t allowed = 0;
        for (int tt = 0; tt < t; ++tt)
          if (gs[tt * k + s]) allowed |= __ldg(topic_bits + tt * w + i);
        const uint32_t masked =
            __ldg(window + (long long)i * n_src + j) & allowed & ~asg[i] & valid[i];
        uint32_t take = 0;
        if (left > 0 && masked) {
          const int c = __popc(masked);
          if (c <= left) {
            take = masked;
            left -= c;
          } else {
            uint32_t x = masked;
            for (int q = 0; q < left; ++q) {
              const uint32_t low = x & (~x + 1u);
              take |= low;
              x ^= low;
            }
            left = 0;
          }
        }
        asg[i] |= take;
        while (take) {
          const int b = __ffs(take) - 1;
          take &= take - 1u;
          orow[32 * i + b] = s;
        }
      }
    }
  }
}

extern "C" int emit_launch(const void* window, const void* have,
                           const void* gossip, const void* topic_bits,
                           const void* nbr, void* out, int n_src, int n, int k,
                           int t, int w, int m, int budget, void* stream) {
  if (w > MAXW || m > 32 * w) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    emit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)window, (const uint32_t*)have,
        (const uint8_t*)gossip, (const uint32_t*)topic_bits,
        (const int32_t*)nbr, (int32_t*)out, n_src, n, k, t, w, m, budget);
  }
  return (int)cudaGetLastError();
}
