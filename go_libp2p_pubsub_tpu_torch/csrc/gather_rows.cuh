// Row fetch shared by the gather kernels (gather_words.cu, take_words.cu):
// a lookup's table row of W words is read as vectors of VW = 4, 2 or 1
// words from an n-major [N_src, W] table.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

template <int VW> struct Vec;
template <> struct Vec<1> { typedef uint32_t T; };
template <> struct Vec<2> { typedef uint2 T; };
template <> struct Vec<4> { typedef uint4 T; };

// The widest vector (in words) that a row of W words can be read in: it
// must divide W (the row stride) and the table's address must be aligned
// to it.
static inline int vector_words(const void* x, int w) {
  for (int vw = 4; vw > 1; vw /= 2) {
    if (w % vw == 0 && (uintptr_t)x % (vw * sizeof(uint32_t)) == 0) {
      return vw;
    }
  }
  return 1;
}
