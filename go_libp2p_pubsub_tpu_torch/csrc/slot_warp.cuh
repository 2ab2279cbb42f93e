// Warp primitives shared by the slot-parallel kernels (hop.cu, emit.cu): a
// warp takes one receiver, lane l takes slot 32 * c + l of its chunk c.

#pragma once

#include "gather_rows.cuh"

constexpr unsigned FULL_WARP = 0xFFFFFFFFu;
constexpr int SLOT_WARPS = 8;   // warps per block of the slot-parallel kernels

// The vector width (in words) of an n-major row of W words: the widest of
// 4, 2, 1 that divides W. The table's address must be aligned to it.
template <int W>
struct RowVec {
  static constexpr int VW = W % 4 == 0 ? 4 : (W % 2 == 0 ? 2 : 1);
};

// Row j of an n-major [N_src, W] table: W / VW vector loads of one row,
// one 32-byte sector while 4 * W <= 32.
template <int W>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ x,
                                         long long j, uint32_t (&v)[W]) {
  constexpr int VW = RowVec<W>::VW;
  typedef typename Vec<VW>::T V;
  const V* p = reinterpret_cast<const V*>(x + j * W);
#pragma unroll
  for (int q = 0; q < W / VW; ++q) {
    const V e = __ldg(p + q);
    const uint32_t* c = reinterpret_cast<const uint32_t*>(&e);
#pragma unroll
    for (int u = 0; u < VW; ++u) v[q * VW + u] = c[u];
  }
}

// Inclusive prefix-OR over the warp's lanes (lane l: OR of lanes 0..l),
// five shuffle steps: the reference's exclusive_prefix_or over slots,
// one chunk of 32 slots at a time.
__device__ __forceinline__ uint32_t prefix_or(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(FULL_WARP, v, d);
    if (lane >= d) v |= u;
  }
  return v;
}

// The OR of lanes below this one, from the inclusive prefix-OR.
__device__ __forceinline__ uint32_t exclusive_of(uint32_t incl, int lane) {
  const uint32_t u = __shfl_up_sync(FULL_WARP, incl, 1);
  return lane == 0 ? 0u : u;
}

// The topic expansion of one edge's bool planes: the OR of the message
// sets topic_bits[tt] of the topics tt whose plane byte p[tt * K + s] is
// set (p: a receiver's [T, K] row).
template <int W>
__device__ __forceinline__ void expand_topics(const uint8_t* p,
                                              const uint32_t* __restrict__ tb,
                                              int s, int k, int t,
                                              uint32_t (&out)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = 0;
  for (int tt = 0; tt < t; ++tt) {
    if (p[tt * k + s]) {
#pragma unroll
      for (int i = 0; i < W; ++i) out[i] |= __ldg(tb + tt * W + i);
    }
  }
}

// Asks the L2 to fetch the 16-byte-aligned interior of [p, p + bytes)
// (Hopper's bulk prefetch, one instruction for a contiguous run), so that
// a block's first reads of its rows hit the L2 instead of waiting on DRAM.
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  const uintptr_t a = ((uintptr_t)p + 15) & ~(uintptr_t)15;
  const uintptr_t end = ((uintptr_t)p + bytes) & ~(uintptr_t)15;
  if (end > a) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(a),
                 "r"((unsigned)(end - a))
                 : "memory");
  }
}

// A launcher's check that load_row may read the table: its address is
// aligned to RowVec<W>::VW words.
template <int W>
static inline bool row_aligned(const void* x) {
  return (uintptr_t)x % (RowVec<W>::VW * sizeof(uint32_t)) == 0;
}
