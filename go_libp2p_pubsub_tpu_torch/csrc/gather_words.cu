// Neighbour gather of a packed message table for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/permgather.py:_gather_words_pallas, the
// non-fused data path's words gather (ops/bits.gather_words_rows: the IWANT
// answer table, every forwarding hop's frontier, the IHAVE offer table).
//
// out[w][k][n] = x[w][nbr[n][k]]: x is [W, N_src] uint32 (word-major,
// peer-minor), nbr [N, K] int32 pre-clipped to [0, N_src), out [W, K, N]
// (k-major receiver view). Indices are not bounds-checked.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=51200, K=32, W=2 one call
// reads nbr (6.6 MB) and the table (0.4 MB) and writes the [W, K, N] words
// (13.1 MB): ~20 MB, ~6 us. There is no arithmetic beyond addressing.
//
// Design: one thread per (k, n), n fastest. A warp's 32 lanes write 32
// consecutive n of out[w][k], a coalesced 128-byte store per word row. The
// nbr[n][k] reads are strided by K across the warp (each lane reads its own
// 128-byte row; the 32 slots of a row are read by 32 different warps, which
// mostly find the row in L2). The table is read through the read-only cache
// and is small enough to stay in the 50 MB L2. Nothing is allocated here;
// the launcher runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_words_kernel(const uint32_t* __restrict__ x,
                                    const int32_t* __restrict__ nbr,
                                    uint32_t* __restrict__ out,
                                    long long n_src, long long n, int k,
                                    int w) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)k * n) return;
  const long long s = e / n;  // slot k
  const long long i = e - s * n;  // receiver n
  const long long j = nbr[i * k + s];
  for (int wi = 0; wi < w; ++wi) {
    out[wi * k * n + e] = __ldg(x + wi * n_src + j);
  }
}

extern "C" int gather_words_launch(const void* x, const void* nbr, void* out,
                                   int n_src, int n, int k, int w,
                                   void* stream) {
  if (n > 0 && k > 0 && w > 0) {
    const int threads = 256;
    const unsigned blocks =
        (unsigned)(((long long)n * k + threads - 1) / threads);
    gather_words_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const int32_t*)nbr, (uint32_t*)out, n_src, n, k,
        w);
  }
  return (int)cudaGetLastError();
}
