// Bit-table edge exchange for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/permgather.py:_edge_table_pallas, the
// heartbeat's three packed edge exchanges (ops/heartbeat.edge_gather_packed).
//
// out[g][n][k] bit (b % 32), for plane b in group g = b / 32, is bit
// (b * K + rk[n][k]) of table row jn[n][k]. The table is [N, WB] uint32,
// row-major (the Pallas kernel's table.T layout is a TPU artefact).
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32 one call reads
// jn and rk (2 x 13.1 MB) and the table (0.8 MB at WB=2) and writes the
// [N, K] words (13.1 MB): ~40 MB, ~12 us. The arithmetic is a few integer
// ops per plane and edge.
//
// Design: one thread per (n, k) edge, so the jn/rk reads and the output
// writes are coalesced. The table is read through the read-only cache; at
// 0.8 MB it stays resident in the 50 MB L2 across all blocks. Nothing is
// allocated here; the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void edge_table_kernel(const uint32_t* __restrict__ table,
                                  const int32_t* __restrict__ jn,
                                  const int32_t* __restrict__ rk,
                                  uint32_t* __restrict__ out,
                                  int n, int k, int wb, int b_planes) {
  const long long nk = (long long)n * k;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nk) return;
  const uint32_t* row = table + (long long)jn[e] * wb;
  const int r = rk[e];
  const int groups = (b_planes + 31) / 32;
  for (int g = 0; g < groups; ++g) {
    uint32_t acc = 0;
    const int b_end = min(b_planes, 32 * (g + 1));
    for (int b = 32 * g; b < b_end; ++b) {
      const int pos = b * k + r;
      const uint32_t word = __ldg(row + (pos >> 5));
      acc |= ((word >> (pos & 31)) & 1u) << (b & 31);
    }
    out[(long long)g * nk + e] = acc;
  }
}

extern "C" int edge_table_launch(const void* table, const void* jn,
                                 const void* rk, void* out, int n, int k,
                                 int wb, int b_planes, void* stream) {
  const long long nk = (long long)n * k;
  if (nk > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((nk + threads - 1) / threads);
    edge_table_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)jn, (const int32_t*)rk,
        (uint32_t*)out, n, k, wb, b_planes);
  }
  return (int)cudaGetLastError();
}
