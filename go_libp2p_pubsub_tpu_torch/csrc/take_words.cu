// Flat-index take from a word table for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/mxutake.py:take_words_twolevel (its
// Pallas body _kernel), every gather of edge_gather_mode="mxu": the words
// gather, the bit-table edge exchange with its ride-along word rows, and
// the payload permute seen as a [1, N*K] table.
//
// out[w][r] = x[w][idx[r]]: x is [W, N_src] uint32, idx [R] int32
// pre-clipped to [0, N_src), out [W, R]. Indices are not bounds-checked.
// On the TPU this was a one-hot bf16 matrix product over u8 chunk planes,
// a way around Mosaic's gather wall; Hopper gathers directly, so the chunk
// planes, the block one-hot and the R padding are not carried over.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=51200, K=32, R=N*K: the
// words gather (W=2) reads idx (6.6 MB) and the table (0.4 MB) and writes
// 13.1 MB, ~6 us; the bit-table exchange with the answer rows (W=10)
// writes 65.5 MB, ~22 us; the payload take (W=1, a 6.6 MB table) moves
// ~20 MB, ~6 us. There is no arithmetic beyond addressing.
//
// Design: one thread per r with a loop over the W rows, so the idx reads
// and each row's out writes are coalesced; the table is read through the
// read-only cache and stays in the 50 MB L2. Nothing is allocated here;
// the launcher runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void take_words_kernel(const uint32_t* __restrict__ x,
                                  const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, long long n_src,
                                  long long r, int w) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= r) return;
  const long long j = idx[e];
  for (int wi = 0; wi < w; ++wi) {
    out[wi * r + e] = __ldg(x + wi * n_src + j);
  }
}

extern "C" int take_words_launch(const void* x, const void* idx, void* out,
                                 int n_src, int r, int w, void* stream) {
  if (r > 0 && w > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)(((long long)r + threads - 1) / threads);
    take_words_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const int32_t*)idx, (uint32_t*)out, n_src, r, w);
  }
  return (int)cudaGetLastError();
}
