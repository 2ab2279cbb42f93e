// Neighbour gather of a packed message table for Hopper (sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/permgather.py:_gather_words_pallas, the
// non-fused data path's words gather (ops/bits.gather_words_rows: the IWANT
// answer table, every forwarding hop's frontier, the IHAVE offer table).
//
// out[w][k][n] = x[nbr[n][k]][w]: x is the table n-major, [N_src, W]
// uint32 rows (the wrapper interleaves the caller's word-major [W, N_src]
// into it), nbr [N, K] int32 pre-clipped to [0, N_src) (not bounds-checked),
// out [W, K, N] (k-major receiver view). There is no arithmetic beyond
// addressing, so the tensor cores have no part in it.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. At N=51200, K=32, W=2 one call
// reads nbr (6.6 MB) and the table (0.4 MB) and writes the [W, K, N] words
// (13.1 MB): ~20 MB, ~6 us. The wall is not those bytes but the L2's rate
// for random 32-byte sectors (~4.1 TB/s of sectors on an H100 80GB HBM3 at
// 700 W for the earlier one-thread-per-(k, n) kernel): the table fits the
// 50 MB L2, a word-major table made each lookup touch W sectors, and
// reading nbr[n][k] with a stride of K across a warp touched one more.
//
// Design: a block owns BN = 32 receivers. It stages their nbr rows into
// shared memory with 4-byte cp.async copies, a warp per row, one chunk of
// at most KC slots at a time, into a [BN, KC + 1] tile (padded a word a
// row so that the transposed read below is free of bank conflicts). For
// each chunk it waits for the copies, syncs, gathers the chunk's slots and
// syncs again before the next chunk overwrites the tile. Each source row
// is read as W / VW vectors of VW = 4, 2 or 1 words (the widest that W and
// the table's address allow), one lane per vector: the block is (bx, BN,
// bz) threads with bx = min(W / VW, 8) and bz = min(512 / (32 * bx),
// ceil(KC / ILP)), so that every z has slots to take. A warp reads whole
// rows, one sector request per row while 4*W <= 32, and writes each
// out[w][k] as a run of consecutive n (at W = 2 one lane reads its
// source's row as one 8-byte load and a warp stores two 128-byte runs).
// Thread z takes ILP slots at a time, issuing their loads before any
// store.
//
// The tile is dynamic shared memory within the 48 KB a block has without
// an opt-in. A K up to TILE_K = 383 is one chunk, KC = K: the tile is
// 32 * (K + 1) * 4 bytes (48 KB at K = 383), whole rows staged at once.
// A larger K goes in chunks of KC = 382 slots, the last one ragged: the
// tile is 32 * 383 * 4 = 49,024 bytes, and its odd pitch keeps the
// transposed read free of bank conflicts. So any K runs. Nothing is
// allocated here; the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include "gather_rows.cuh"

constexpr int BN = 32;        // receivers per block
constexpr int ILP = 4;        // slots in flight per thread
constexpr int THREADS = 512;  // per block, at most
constexpr int TILE_K = 383;   // the largest K staged as one chunk (48 KB)
constexpr int CHUNK_K = 382;  // slots per chunk beyond it (odd pitch 383)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Slots per staged chunk: all of K up to TILE_K, else CHUNK_K.
static inline int chunk_slots(int k) { return k <= TILE_K ? k : CHUNK_K; }

template <int VW>
__global__ void gather_words_kernel(const uint32_t* __restrict__ x,
                                    const int32_t* __restrict__ nbr,
                                    uint32_t* __restrict__ out, int n, int k,
                                    int w, int kc) {
  typedef typename Vec<VW>::T V;
  extern __shared__ int32_t tile[];  // [BN][kc + 1]
  const int ld = kc + 1;
  const int n0 = blockIdx.x * BN;
  const int rows = min(BN, n - n0);
  const int tid =
      threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int lane = tid & 31;
  const int nwarps = blockDim.x * blockDim.y * blockDim.z / 32;
  const int i = threadIdx.y;
  const int nvec = w / VW;
  const long long plane = (long long)k * n;
  for (int c0 = 0; c0 < k; c0 += kc) {
    const int cn = min(kc, k - c0);  // this chunk's slots
    for (int row = tid >> 5; row < rows; row += nwarps) {
      for (int c = lane; c < cn; c += 32) {
        cp_async4(tile + row * ld + c,
                  nbr + (long long)(n0 + row) * k + c0 + c);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    if (i < rows) {
      for (int s0 = threadIdx.z * ILP; s0 < cn; s0 += blockDim.z * ILP) {
        long long j[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          j[u] = s0 + u < cn ? (long long)tile[i * ld + s0 + u] : -1;
        }
        for (int q = threadIdx.x; q < nvec; q += blockDim.x) {
          const int w0 = q * VW;
          V v[ILP];
#pragma unroll
          for (int u = 0; u < ILP; ++u) {
            if (j[u] >= 0) {
              v[u] = __ldg(reinterpret_cast<const V*>(x + j[u] * w + w0));
            }
          }
#pragma unroll
          for (int u = 0; u < ILP; ++u) {
            if (j[u] < 0) continue;
            const uint32_t* c = reinterpret_cast<const uint32_t*>(&v[u]);
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              out[(w0 + e) * plane + (long long)(c0 + s0 + u) * n + n0 + i] =
                  c[e];
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the tile
  }
}

template <int VW>
static void launch(const void* x, const void* nbr, void* out, int n, int k,
                   int w, int kc, cudaStream_t stream) {
  const int nvec = w / VW;
  const int bx = nvec < 8 ? nvec : 8;
  const int slots = (kc + ILP - 1) / ILP;
  int bz = THREADS / (BN * bx);
  bz = bz < slots ? bz : slots;
  const dim3 block(bx, BN, bz > 0 ? bz : 1);
  const unsigned blocks = (unsigned)((n + BN - 1) / BN);
  const size_t smem = (size_t)BN * (kc + 1) * sizeof(int32_t);  // <= 48 KB
  gather_words_kernel<VW><<<blocks, block, smem, stream>>>(
      (const uint32_t*)x, (const int32_t*)nbr, (uint32_t*)out, n, k, w, kc);
}

extern "C" int gather_words_launch(const void* x, const void* nbr, void* out,
                                   int n, int k, int w, void* stream) {
  if (n > 0 && k > 0 && w > 0) {
    const int kc = chunk_slots(k);
    const cudaStream_t s = (cudaStream_t)stream;
    switch (vector_words(x, w)) {
      case 4: launch<4>(x, nbr, out, n, k, w, kc, s); break;
      case 2: launch<2>(x, nbr, out, n, k, w, kc, s); break;
      default: launch<1>(x, nbr, out, n, k, w, kc, s);
    }
  }
  return (int)cudaGetLastError();
}
