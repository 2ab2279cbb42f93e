// Bit-table edge exchange for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/permgather.py:_edge_table_pallas, the
// heartbeat's three packed edge exchanges (ops/heartbeat.edge_gather_packed).
//
// out[g][e] bit (b % 32), for plane b in group g = b / 32, is bit
// (b * K + rk[e]) of table row jn[e], e = n * K + k. The table is
// [N_src, PW] uint32, row-major: the caller's [N_src, WB] rows, padded by
// the wrapper to PW = WB for WB <= 2, else to a multiple of 4 words
// (ops/permgather.edge_table_row_words), so that a row is aligned to its
// vector width and spans no more 32-byte sectors than its bytes need (the
// Pallas kernel's table.T layout is a TPU artefact).
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=102400, K=32, B=2 one call
// reads jn and rk (2 x 13.1 MB) and the table (0.8 MB) and writes the
// [N, K] words (13.1 MB): ~40 MB, ~12 us. The arithmetic is a few integer
// ops per plane and edge. Beside those bytes, each edge looks up one
// random table row: 3.3 M lookups a call at the headline's shape, served
// by the L2 (the table stays in its 50 MB) at its rate for random
// sectors, which is what holds the kernel above the byte bound (PERF.md).
//
// Design: the table stays in the L2, and a thread walks the edges four at
// a time: it reads jn and rk as 16-byte vectors (streaming loads, so they
// do not evict the table from the L2), issues its four row lookups before
// using any, each row as one vector of PW words (two at PW = 8; load_row,
// slot_warp.cuh), and writes each group's four output words as one
// 16-byte store. Where the edge count is no multiple of 4 or a pointer is
// not 16-byte aligned, edges go one at a time. Rows wider than 8 words are
// read 4 words at a time, in plane order. K = 32 (both paths' K) takes
// plane b's bit from row word b directly; other K select word
// (b * K + rk) / 32 of the row in registers.
//
// Two designs that keep the table in a thread-block cluster's shared
// memory (the nearest thing on Hopper to the TPU kernel's table in VMEM:
// up to 8 CTAs x 227 KB) were built and measured slower at every path
// shape (PERF.md): random lookups into the other CTAs' shared memory run
// at a lower rate than the L2's, and CTAs that each look up their own slab
// must all read every edge of the cluster.
//
// The launcher refuses an unknown PW, B * K beyond 32 * PW and a table
// not aligned to its row vectors with an error code. Nothing is allocated
// here; the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include "slot_warp.cuh"

constexpr int THREADS = 256;

// --- bit extraction ----------------------------------------------------------

// word s of a row held in registers, s < PW (unrolled selects, no local
// memory)
template <int PW>
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[PW], int s) {
  uint32_t w = v[0];
#pragma unroll
  for (int q = 1; q < PW; ++q)
    if (s == q) w = v[q];
  return w;
}

__device__ __forceinline__ uint32_t pick4(uint4 v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// group g's word of one edge from its row in registers (PW <= 8)
template <int PW>
__device__ __forceinline__ uint32_t extract(const uint32_t (&v)[PW], int r,
                                            int g, int k, int b_planes) {
  uint32_t acc = 0;
  if (k == 32) {
    // plane b is word b, bit r: g = 0 holds every plane (B <= PW)
#pragma unroll
    for (int b = 0; b < PW; ++b)
      if (b < b_planes) acc |= ((v[b] >> r) & 1u) << b;
    return acc;
  }
  const int b_end = min(b_planes, 32 * (g + 1));
  for (int b = 32 * g; b < b_end; ++b) {
    const int pos = b * k + r;
    acc |= ((pick<PW>(v, pos >> 5) >> (pos & 31)) & 1u) << (b & 31);
  }
  return acc;
}

// one edge of a row wider than 8 words: read 4 words at a time, in plane
// order (the bit positions b * K + r grow with b)
__device__ __forceinline__ void edge_wide(const uint32_t* __restrict__ table,
                                          int pw, int j, int r, int k,
                                          int b_planes, long long e,
                                          long long nk, uint32_t* out) {
  const uint4* row = reinterpret_cast<const uint4*>(table + (long long)j * pw);
  int cur = -1;
  uint4 quad = make_uint4(0, 0, 0, 0);
  uint32_t acc = 0;
  for (int b = 0; b < b_planes; ++b) {
    const int pos = b * k + r;
    if ((pos >> 7) != cur) {
      cur = pos >> 7;
      quad = __ldg(row + cur);
    }
    acc |= ((pick4(quad, (pos >> 5) & 3) >> (pos & 31)) & 1u) << (b & 31);
    if ((b & 31) == 31 || b == b_planes - 1) {
      __stcs(out + (long long)(b >> 5) * nk + e, acc);
      acc = 0;
    }
  }
}

// --- the kernel --------------------------------------------------------------

// PW: the padded row width (1, 2, 4 or 8; 0 for any multiple of 4 above 8,
// read 4 words at a time)
template <int PW>
__global__ void __launch_bounds__(THREADS)
edge_table_kernel(const uint32_t* __restrict__ table,
                  const int32_t* __restrict__ jn,
                  const int32_t* __restrict__ rk, uint32_t* __restrict__ out,
                  int pw, long long nk, int k, int b_planes, int vec) {
  const int groups = (b_planes + 31) / 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec ? nk / 4 : 0;
  for (long long v = tid; v < nvec; v += stride) {
    const int4 jv = __ldcs(reinterpret_cast<const int4*>(jn) + v);
    const int4 rv = __ldcs(reinterpret_cast<const int4*>(rk) + v);
    const int j4[4] = {jv.x, jv.y, jv.z, jv.w};
    const int r4[4] = {rv.x, rv.y, rv.z, rv.w};
    if constexpr (PW > 0) {
      uint32_t row[4][PW];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_row<PW>(table, j4[u], row[u]);
      for (int g = 0; g < groups; ++g) {
        uint4 o;
        o.x = extract<PW>(row[0], r4[0], g, k, b_planes);
        o.y = extract<PW>(row[1], r4[1], g, k, b_planes);
        o.z = extract<PW>(row[2], r4[2], g, k, b_planes);
        o.w = extract<PW>(row[3], r4[3], g, k, b_planes);
        __stcs(reinterpret_cast<uint4*>(out + (long long)g * nk) + v, o);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        edge_wide(table, pw, j4[u], r4[u], k, b_planes, 4 * v + u, nk, out);
    }
  }
  for (long long e = 4 * nvec + tid; e < nk; e += stride) {
    const int j = __ldcs(jn + e), r = __ldcs(rk + e);
    if constexpr (PW > 0) {
      uint32_t row[PW];
      load_row<PW>(table, j, row);
      for (int g = 0; g < groups; ++g)
        __stcs(out + (long long)g * nk + e,
               extract<PW>(row, r, g, k, b_planes));
    } else {
      edge_wide(table, pw, j, r, k, b_planes, e, nk, out);
    }
  }
}

// --- launch ------------------------------------------------------------------

static bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int PW>
static void launch(const uint32_t* table, const int32_t* jn,
                   const int32_t* rk, uint32_t* out, int pw, long long nk,
                   int k, int b_planes, int vec, cudaStream_t stream) {
  const long long work = vec ? (nk + 3) / 4 : nk;   // threads' items
  const long long blocks = (work + THREADS - 1) / THREADS;
  edge_table_kernel<PW><<<(unsigned)blocks, THREADS, 0, stream>>>(
      table, jn, rk, out, pw, nk, k, b_planes, vec);
}

extern "C" int edge_table_launch(const void* table, const void* jn,
                                 const void* rk, void* out, int n, int k,
                                 int pw, int b_planes, void* stream) {
  const bool known = pw == 1 || pw == 2 || (pw > 2 && pw % 4 == 0);
  if (!known || b_planes < 1 || k < 1 || (long long)b_planes * k > 32LL * pw)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)table % (4 * (pw >= 4 ? 4 : pw)) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long nk = (long long)n * k;
  if (nk > 0) {
    const int vec = nk % 4 == 0 && aligned16(jn) && aligned16(rk) &&
                    aligned16(out);
    const uint32_t* t = (const uint32_t*)table;
    const int32_t* j = (const int32_t*)jn;
    const int32_t* r = (const int32_t*)rk;
    uint32_t* o = (uint32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (pw) {
      case 1: launch<1>(t, j, r, o, pw, nk, k, b_planes, vec, s); break;
      case 2: launch<2>(t, j, r, o, pw, nk, k, b_planes, vec, s); break;
      case 4: launch<4>(t, j, r, o, pw, nk, k, b_planes, vec, s); break;
      case 8: launch<8>(t, j, r, o, pw, nk, k, b_planes, vec, s); break;
      default: launch<0>(t, j, r, o, pw, nk, k, b_planes, vec, s);
    }
  }
  return (int)cudaGetLastError();
}
