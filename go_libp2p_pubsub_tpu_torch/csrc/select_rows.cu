// Masked top-count selection over a row's K slots for Hopper (sm_90a): the
// heartbeat's select_random, select_top and masked_median in one kernel.
//
// Replaces: no Pallas kernel. The reference computes these selections in
// jnp (go_libp2p_pubsub_tpu/ops/selection.py: the "ranks" formulation's
// comparison-count ranks, select_random's jax.random.uniform draw,
// select_top's tie-broken keys, masked_median's sort), and the port's plain
// twins (ops/selection.py) do the same in torch: the threefry draw as ~130
// int64 elementwise kernels over [rows, K], the ranks as [rows, K, K]
// comparison tensors summed in int64. Here the draw and the ranks live in
// registers and only the mask, the counts and the result touch memory.
//
// Modes (one launch each): 0 random, key = mask ? uniform : -1e30 with the
// uniform drawn by threefry-2x32 from the [2] key in device memory at the
// counter base + row * K + s (rng._counts; a captured graph replays it with
// no host read); 1 noise, key = mask ? vals[row][s] : -1e30; 2 top, key =
// mask ? vals[row / rep][s] + (-s * 1e-9) : -1e30 in two rounded float32
// ops (torch's unfused add of the tie-break); then rank_s = #{j : key_j >
// key_s or (key_j == key_s and j < s)} (ops/selection.ranks_desc's float
// comparisons, NaN and signed zeros included) and sel_s = mask_s and
// rank_s < count[row], written as bytes. 3 median: v = mask ? vals[row /
// rep][s] : 1e30, each slot's ascending rank in torch.sort's order (NaN
// last, ties toward the lower slot), and the slot ranked min(n / 2, K - 1)
// writes out[row], n the row's mask count. ``rep`` reads a [R / rep, K]
// plane broadcast over the topic axis without its [R, K] copy.
//
// Bound on an H100 (3.35 TB/s HBM, ~16.7 T int32 ops/s at 700 W): bytes
// where rows are skipped, integer ops where the draw runs. A call reads
// the [R, K] mask bytes and the [R] int64 counts and writes [R, K] bytes:
// 7.4 MB at R = 102400, K = 32 (2.2 us), 14.7 MB at R = 204800 (4.4 us).
// A drawn slot costs 68 32-bit integer instructions in sm_90a's SASS (the
// 20 rounds' adds, funnel-shift rotates and xors, the key injections folded
// into three-input adds, the float assembly; cuobjdump -sass of a kernel
// that draws once, less one that does not), ~13 us for every slot of
// R = 102400.
//
// Design: one warp per row, 8 warps a block; lane l holds slots 32 q + l,
// q < SPL = ceil(K / 32) (a template over SPL, chosen from the K the
// wrapper observes, K <= 1024), so mask bytes and results move as whole
// 32-byte sectors. A row whose count is <= 0, or whose mask ballot is
// empty, writes zeros and draws nothing: the generator is counter-based,
// so skipping a row changes no other row's bits, and most rows of most of
// the heartbeat's calls select nothing. The ranks come from K warp
// shuffles of the keys, each lane comparing the broadcast key with its
// own SPL keys. Nothing is allocated here; the launcher runs on the
// caller's stream and returns cudaGetLastError().

#include "slot_warp.cuh"

constexpr float NEG_KEY = -1e30f;   // ops/selection.NEG_INF
constexpr float PAD = 1e30f;        // masked_median's padding
constexpr float TIE = 1e-9f;        // select_top's tie-break step
enum { RANDOM = 0, NOISE = 1, TOP = 2, MEDIAN = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Four rounds of threefry-2x32 with the given rotations.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// jax's threefry2x32 of the counter pair (x0, x1) under (k1, k2), folded to
// 32 bits as random_bits does: rng.threefry2x32, 20 rounds, the key
// injected after every four.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x0 += k1;
  x1 += k2;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k3 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k3;
  x1 += k1 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k3 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k3;
  x1 += k1 + 5u;
  return x0 ^ x1;
}

// torch.sort's ascending order of float32: NaN (x != x) after everything.
__device__ __forceinline__ bool sorts_before(float a, float b) {
  return a == a && (b != b || a < b);
}

// A row that selects nothing: every slot's byte cleared.
template <int SPL>
__device__ __forceinline__ void clear_row(uint8_t* sel, int k, int lane) {
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    if (32 * q + lane < k) sel[32 * q + lane] = 0;
  }
}

template <int SPL>
__global__ void __launch_bounds__(32 * SLOT_WARPS)
select_rows_kernel(const uint8_t* __restrict__ mask,
                   const long long* __restrict__ count,
                   const long long* __restrict__ key,
                   const float* __restrict__ vals, void* __restrict__ out,
                   int rows, int k, int rep, uint64_t base, int mode) {
  const long long row = (long long)blockIdx.x * SLOT_WARPS + threadIdx.y;
  if (row >= rows) return;                    // the whole warp leaves
  const int lane = threadIdx.x;
  uint8_t* sel = static_cast<uint8_t*>(out) + row * k;
  if (mode != MEDIAN && __ldg(count + row) <= 0) {
    clear_row<SPL>(sel, k, lane);
    return;
  }
  const uint8_t* m = mask + row * k;
  bool in[SPL];
  int n = 0;
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = 32 * q + lane;
    in[q] = s < k && m[s] != 0;
    n += __popc(__ballot_sync(FULL_WARP, in[q]));
  }
  if (n == 0) {
    if (mode != MEDIAN) {
      clear_row<SPL>(sel, k, lane);
    } else if (lane == 0) {
      static_cast<float*>(out)[row] = PAD;
    }
    return;
  }

  float x[SPL];
  if (mode == RANDOM) {
    const uint32_t k1 = (uint32_t)__ldg(key), k2 = (uint32_t)__ldg(key + 1);
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      x[q] = NEG_KEY;
      if (in[q]) {
        const uint64_t c = base + (uint64_t)row * k + 32 * q + lane;
        const uint32_t bits =
            threefry_bits(k1, k2, (uint32_t)(c >> 32), (uint32_t)c);
        x[q] = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      }
    }
  } else {
    const float* v = vals + (row / rep) * k;
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      const int s = 32 * q + lane;
      const float pad = mode == MEDIAN ? PAD : NEG_KEY;
      x[q] = in[q] ? __ldg(v + s) : pad;
      if (in[q] && mode == TOP) {
        x[q] = __fadd_rn(x[q], __fmul_rn(-(float)s, TIE));
      }
    }
  }

  // rank of each own slot against the row's K keys, one shuffle a key
  int rank[SPL];
#pragma unroll
  for (int q = 0; q < SPL; ++q) rank[q] = 0;
#pragma unroll
  for (int q2 = 0; q2 < SPL; ++q2) {
    for (int l2 = 0; l2 < 32; ++l2) {
      const int j = 32 * q2 + l2;
      if (j >= k) break;                      // the same for every lane
      const float xj = __shfl_sync(FULL_WARP, x[q2], l2);
#pragma unroll
      for (int q = 0; q < SPL; ++q) {
        const int s = 32 * q + lane;
        const bool before =
            mode == MEDIAN
                ? sorts_before(xj, x[q]) ||
                      (!sorts_before(x[q], xj) && j < s)
                : xj > x[q] || (xj == x[q] && j < s);
        rank[q] += before;
      }
    }
  }

  if (mode == MEDIAN) {
    const int at = min(n / 2, k - 1);
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      if (32 * q + lane < k && rank[q] == at) {
        static_cast<float*>(out)[row] = x[q];
      }
    }
    return;
  }
  const long long c = __ldg(count + row);
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = 32 * q + lane;
    if (s < k) sel[s] = in[q] && (long long)rank[q] < c;
  }
}

template <int SPL>
static void launch(const void* mask, const void* count, const void* key,
                   const void* vals, void* out, int rows, int k, int rep,
                   uint64_t base, int mode, cudaStream_t stream) {
  const dim3 block(32, SLOT_WARPS);
  const unsigned blocks = (unsigned)((rows + SLOT_WARPS - 1) / SLOT_WARPS);
  select_rows_kernel<SPL><<<blocks, block, 0, stream>>>(
      (const uint8_t*)mask, (const long long*)count, (const long long*)key,
      (const float*)vals, out, rows, k, rep, base, mode);
}

// base_hi/base_lo: the halves of the first row's counter base (random
// mode); rep: rows per row of vals (top and median modes; 1 for noise).
extern "C" int select_rows_launch(const void* mask, const void* count,
                                  const void* key, const void* vals,
                                  void* out, int rows, int k, int rep,
                                  int base_hi, int base_lo, int mode,
                                  void* stream) {
  if (rows > 0 && k > 0 && k <= 1024) {
    const cudaStream_t s = (cudaStream_t)stream;
    const uint64_t base =
        ((uint64_t)(uint32_t)base_hi << 32) | (uint32_t)base_lo;
    const int spl = (k + 31) / 32;
    if (spl <= 1) {
      launch<1>(mask, count, key, vals, out, rows, k, rep, base, mode, s);
    } else if (spl <= 2) {
      launch<2>(mask, count, key, vals, out, rows, k, rep, base, mode, s);
    } else if (spl <= 4) {
      launch<4>(mask, count, key, vals, out, rows, k, rep, base, mode, s);
    } else if (spl <= 8) {
      launch<8>(mask, count, key, vals, out, rows, k, rep, base, mode, s);
    } else if (spl <= 16) {
      launch<16>(mask, count, key, vals, out, rows, k, rep, base, mode, s);
    } else {
      launch<32>(mask, count, key, vals, out, rows, k, rep, base, mode, s);
    }
  }
  return (int)cudaGetLastError();
}
