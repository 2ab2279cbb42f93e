// Reverse-edge permutation gather of a 4-byte payload for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/permgather.py:_gather_pallas, the
// payload permute behind permutation_gather (ops/churn.py's symmetric
// exchanges: the packed churn decision bits).
//
// out[n][k] = payload[jn[n][k]][rk[n][k]]: payload is [N_src, K_src] of any
// 4-byte type, carried as uint32 bits (a float32 payload is never
// converted); jn [N, K] int32 in [0, N_src) and rk [N, K] int32 in
// [0, K_src), both pre-clipped by the caller. Indices are not bounds-checked.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=51200, K=32 one call reads
// jn, rk and the payload (3 x 6.6 MB) and writes out (6.6 MB): ~26 MB,
// ~8 us. There is no arithmetic beyond addressing. Beside those bytes each
// edge makes one random 4-byte payload read, served by the L2 at its rate
// for random requests (~91-115 G a second on an H100 80GB HBM3 at 700 W,
// as measured for edge_table, PERF.md): 1.64 M reads a call need ~14-18
// us, so no design that makes one L2 request an edge reaches the bound.
//
// Design: one thread per flat (n, k) edge, so the jn/rk reads and the out
// writes are coalesced, at any alignment and edge count. The payload is
// read at random through the read-only cache; at 6.6 MB it stays in the
// 50 MB L2 across blocks. edge_table.cu's design (four edges a thread,
// 16-byte jn/rk loads and out stores, four payload reads in flight) was
// measured 6% slower here at the churn shape (PERF.md) and dropped.
// Nothing is allocated here; the launcher runs on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void permutation_gather_kernel(const uint32_t* __restrict__ payload,
                                          const int32_t* __restrict__ jn,
                                          const int32_t* __restrict__ rk,
                                          uint32_t* __restrict__ out,
                                          long long nk, int k_src) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nk) return;
  out[e] = __ldg(payload + (long long)jn[e] * k_src + rk[e]);
}

extern "C" int permutation_gather_launch(const void* payload, const void* jn,
                                         const void* rk, void* out, int n,
                                         int k, int k_src, void* stream) {
  const long long nk = (long long)n * k;
  if (nk > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((nk + threads - 1) / threads);
    permutation_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)payload, (const int32_t*)jn, (const int32_t*)rk,
        (uint32_t*)out, nk, k_src);
  }
  return (int)cudaGetLastError();
}
