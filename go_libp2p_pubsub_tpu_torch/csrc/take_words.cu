// Flat-index take from a word table for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/mxutake.py:take_words_twolevel (its
// Pallas body _kernel), every gather of edge_gather_mode="mxu": the words
// gather, the bit-table edge exchange with its ride-along word rows, and
// the payload permute seen as a [N*K, 1] table.
//
// out[r * os_r + w * os_w] = x[idx[r]][w] for r < R, w < W: x is the table
// n-major, [N_src, W] int32 rows, idx [R] int32 pre-clipped to [0, N_src)
// (not bounds-checked). The output is addressed by element strides, so one
// kernel writes n-major [R, W] rows (ops/permgather._edge_table_mxu, the
// payload take) or the word-major [W, R] of take_words' contract (whose
// wrapper interleaves its word-major table into rows first). On the TPU
// this was a one-hot bf16 matrix product over u8 chunk planes, a way
// around Mosaic's gather wall; Hopper gathers directly, so the chunk
// planes, the block one-hot and the R padding are not carried over. There
// is no arithmetic beyond addressing, so the tensor cores have no part in
// it.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=51200, K=32, R=N*K the
// words take (W=2) reads idx (6.6 MB) and the table (0.4 MB) and writes
// 13.1 MB, ~6 us; the bit-table exchange with the answer rows (W=10)
// writes 65.5 MB, ~22 us. The wall is not those bytes but the L2's rate
// for random 32-byte sectors (~4.1 TB/s of sectors on an H100 80GB HBM3 at
// 700 W, the same for every shape of the earlier one-thread-per-r kernel):
// the table fits the 50 MB L2, and the earlier word-major table made each
// lookup touch W sectors to use 4 bytes of each.
//
// Design: the table is n-major, so a lookup's W words are one row, inside
// one sector while 4*W <= 32 and the row is aligned to its width (W = 1,
// 2, 4, 8; W = 10 touches two or three). The row is read as W / VW
// vectors of VW = 4, 2 or 1 words (the widest that W and the table's
// address allow), one lane per vector: a block is (min(W / VW, 128), 128 /
// that) threads, so a warp reads whole rows, one sector request per row,
// and for n-major output stores whole rows as vectors too, 32 consecutive
// vectors a warp. Each thread keeps ILP rows in flight: it reads their
// indices, issues their loads, then stores. Nothing is allocated here; the
// launcher runs on the caller's stream and returns cudaGetLastError().

#include "gather_rows.cuh"

constexpr int ILP = 4;        // rows in flight per thread
constexpr int THREADS = 128;  // per block

template <int VW>
__global__ void take_words_kernel(const uint32_t* __restrict__ x,
                                  const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, int r_total,
                                  int w, long long os_r, long long os_w,
                                  bool vec_store) {
  typedef typename Vec<VW>::T V;
  const int nvec = w / VW;
  const long long r0 =
      (long long)blockIdx.x * blockDim.y * ILP + threadIdx.y;
  long long j[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
    const long long r = r0 + (long long)i * blockDim.y;
    j[i] = r < r_total ? (long long)__ldg(idx + r) : -1;
  }
  for (int q = threadIdx.x; q < nvec; q += blockDim.x) {
    const int w0 = q * VW;
    V v[ILP];
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      if (j[i] >= 0) {
        v[i] = __ldg(reinterpret_cast<const V*>(x + j[i] * w + w0));
      }
    }
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      if (j[i] < 0) continue;
      const long long r = r0 + (long long)i * blockDim.y;
      if (vec_store) {
        *reinterpret_cast<V*>(out + r * os_r + w0) = v[i];
      } else {
        const uint32_t* c = reinterpret_cast<const uint32_t*>(&v[i]);
#pragma unroll
        for (int e = 0; e < VW; ++e) out[r * os_r + (w0 + e) * os_w] = c[e];
      }
    }
  }
}

template <int VW>
static void launch(const void* x, const void* idx, void* out, int r, int w,
                   int os_r, int os_w, cudaStream_t stream) {
  const int nvec = w / VW;
  const int bx = nvec < THREADS ? nvec : THREADS;
  const dim3 block(bx, THREADS / bx);
  const long long rows = (long long)block.y * ILP;
  const unsigned blocks = (unsigned)((r + rows - 1) / rows);
  const bool vec_store = os_w == 1 && os_r % VW == 0 &&
                         (uintptr_t)out % (VW * sizeof(uint32_t)) == 0;
  take_words_kernel<VW><<<blocks, block, 0, stream>>>(
      (const uint32_t*)x, (const int32_t*)idx, (uint32_t*)out, r, w, os_r,
      os_w, vec_store);
}

extern "C" int take_words_launch(const void* x, const void* idx, void* out,
                                 int r, int w, int os_r, int os_w,
                                 void* stream) {
  if (r > 0 && w > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (vector_words(x, w)) {
      case 4: launch<4>(x, idx, out, r, w, os_r, os_w, s); break;
      case 2: launch<2>(x, idx, out, r, w, os_r, os_w, s); break;
      default: launch<1>(x, idx, out, r, w, os_r, os_w, s);
    }
  }
  return (int)cudaGetLastError();
}
