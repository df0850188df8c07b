// Shared definitions of the two banded-NW kernels (wavefront_fwd.cu and
// wavefront_trace.cu).
//
// Geometry.  A pair (a, b) of lengths la, lb is aligned inside the
// diagonal band dlo <= D* <= dhi, D* = la - i + j (the reference's
// convention, align/oracle.py), bw = dhi - dlo + 1.  Cell (i, j) lies on
// anti-diagonal t = i + j.  On anti-diagonal t the band cells have
// D* = dlo + rho + 2u with rho = (la - t - dlo) & 1 and lane
// u = 0 .. (bw - 1 - rho) / 2, so a pair has at most
// nlane = (bw + 1) / 2 lanes per anti-diagonal.
//
// Traceback layout (written by the forward kernel, read by the trace
// kernel).  Pair p owns (la + lb) * nb bytes starting at tb_off[p],
// nb = (nlane + 1) / 2: anti-diagonal t is the run of nb bytes at
// tb_off[p] + t * nb, and lane u is the nibble (u & 1) * 4 of byte
// u >> 1.  Anti-diagonal t = i + lb holds, at the lane of D* = la - i + lb,
// the bits of the right column Drow[LB] for row i (0 or TB_MD).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define UT_NEG (-9e9f)   // align/oracle.py MINUS_INFINITY, float32
#define UT_TB_DM 1
#define UT_TB_IM 2
#define UT_TB_MD 4
#define UT_TB_MI 8

// gap parameter vector, layout of WavefrontNWDevice.gp
enum {
  GP_OPEN_A = 0, GP_OPEN_B, GP_EXT_A, GP_EXT_B,
  GP_L_OPEN_A, GP_L_OPEN_B, GP_R_OPEN_A, GP_R_OPEN_B,
  GP_L_EXT_A, GP_L_EXT_B, GP_R_EXT_A, GP_R_EXT_B
};

__host__ __device__ inline int ut_nlane(int bw) { return (bw + 1) >> 1; }
__host__ __device__ inline int ut_nbytes(int bw) {
  return (ut_nlane(bw) + 1) >> 1;
}
