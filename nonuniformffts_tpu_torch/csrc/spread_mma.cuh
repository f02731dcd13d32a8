// The FP64 tensor-core product and the flush's global reductions shared by
// the 2D and 3D spread kernels (spread_2d.cu, spread_3d.cu): a block's sum
// is a dense product G += A B on mma.sync .f64 tiles, kept in registers, and
// added into the grid with Hopper's vector reductions.
#pragma once

#include <cuda_runtime.h>

namespace nufft {

// D += A B on the FP64 tensor cores, m16n8k8 (sm_90).  Lane (g, t) =
// (lane / 4, lane % 4) holds A[g + 8h][t + 4q] as a[2q + h], B[t + 4q][g]
// as b[q], and D[g + 8h][2t + e] as d[2h + e], h, q = 0, 1.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Hopper's vector reduction into global memory (sm_90, global only): one
// instruction adds two floats, a complex64 cell or two float32 cells.
__device__ __forceinline__ void red_v2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(__cvta_generic_to_global(p)),
               "f"(a), "f"(b)
               : "memory");
}

// Adds a complex cell's sums (re, im) into the grid at p.
__device__ __forceinline__ void add_complex(float* p, double re, double im) {
  red_v2(p, float(re), float(im));
}
__device__ __forceinline__ void add_complex(double* p, double re, double im) {
  atomicAdd(p, re);
  atomicAdd(p + 1, im);
}

}  // namespace nufft
