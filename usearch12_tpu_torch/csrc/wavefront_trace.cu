// Traceback of the banded NW DP over the forward kernel's bits.
//
// Replaces the Pallas TPU kernel usearch12_tpu/ops/wavefront_trace.py
// (_make_chase_kernel, launched by _chase_run.run) together with the XLA
// prologue of _make_trace_stage (stage A).  Semantics of
// align/oracle.py (reference viterbifastbandmem.cpp final row and
// tracebackbitmem.cpp): the final DPI row, the final score and start
// state at (la, lb) with ties M, then D if '>', then I if '>'; then the
// pointer chase with state priority M->D if TB_DM, else I if TB_IM, else
// M; D->M if TB_MD; I->M if TB_MI.  Special cells: the final DPI row
// (i == la), the Drow[LB] column (j == lb; TB_MD outside the stored
// lanes) and the band edge k == -1 (TB_IM).
//
// The final DPI row is one sequential float32 recurrence per pair,
// i1 = max(M(la-1, j-1) + r_open_a, i1 + r_ext_a), in the oracle's order.
// The TPU prologue computed it with a log-doubling max-plus scan, which
// is exact only for dyadic penalties; the sequential form needs no such
// precondition.  The chase only ever reads that row leftwards from
// j = lb - 1 in state I, stopping at the first set bit, so the prologue
// keeps just the last j whose bit is set.
//
// What bounds it on the card: one dependent byte load from the traceback
// per alignment column, la + lb steps per pair, so latency of dependent
// loads, not bandwidth.  Design: one thread per pair, all pairs of a
// launch in flight at once; each thread writes its path as 2-bit codes
// (1 = M, 2 = D, 3 = I, emitted from the end of the alignment back to
// its start, 4 per byte from the low bits up) and its length.

#include "wavefront.cuh"

enum { ST_M = 0, ST_D = 1, ST_I = 2 };

__global__ void wavefront_trace_kernel(
    const uint8_t* __restrict__ tb, const long long* __restrict__ tb_off,
    const float* __restrict__ mlast, int bmax,
    const float* __restrict__ dlb,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const float* __restrict__ gp, int n_pairs,
    float* __restrict__ scores, uint8_t* __restrict__ ops, int ops_stride,
    int* __restrict__ lens) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int la = la_v[p], lb = lb_v[p], dlo = dlo_v[p], bw = bw_v[p];
  const int nlane = ut_nlane(bw);
  const int nb = ut_nbytes(bw);
  const float r_open_a = gp[GP_R_OPEN_A], r_ext_a = gp[GP_R_EXT_A];
  const float* ML = mlast + (size_t)p * bmax;
  const uint8_t* T = tb + tb_off[p];

  // final DPI row over the band of row la-1 (DiagBox::GetRange_j)
  int startj = dlo - 1 >= 0 ? dlo - 1 : 0;
  if (startj >= lb) startj = lb - 1;
  float i1 = UT_NEG;
  int jstar = -1;           // last j of the row whose bit is TB_MI
  for (int j = startj; j < lb; ++j) {
    const float mi = (j == startj ? UT_NEG : ML[j - 1]) + r_open_a;
    i1 = i1 + r_ext_a;
    if (mi > i1) {
      i1 = mi;
      jstar = j;
    }
  }
  float score = ML[lb - 1];
  int st = ST_M;
  const float fin_d = dlb[p];
  if (fin_d > score) {
    score = fin_d;
    st = ST_D;
  }
  if (i1 > score) {
    score = i1;
    st = ST_I;
  }
  scores[p] = score;

  uint8_t* O = ops + (size_t)p * ops_stride;
  int i = la, j = lb, n = 0;
  unsigned acc = 0;
  while ((i > 0 || j > 0) && i >= 0 && j >= 0) {
    acc |= (unsigned)(st + 1) << (2 * (n & 3));
    if ((n & 3) == 3) {
      O[n >> 2] = (uint8_t)acc;
      acc = 0;
    }
    ++n;
    // the cell whose bits decide the next state is where the move lands
    const int ri = st == ST_I ? i : i - 1;
    const int rj = st == ST_D ? j : j - 1;
    int bits = 0;
    if (ri >= 0 && rj >= 0) {
      if (ri == la) {
        bits = rj == jstar ? UT_TB_MI : 0;
      } else {
        const int k = la - ri + rj - dlo;    // D* - dlo
        const int t = ri + rj;
        if (rj == lb) {
          bits = (k >> 1) < nlane
                     ? (T[(size_t)t * nb + (k >> 2)] >> ((k >> 1 & 1) * 4)) & 15
                     : UT_TB_MD;
        } else if (k == -1) {
          bits = UT_TB_IM;
        } else if (k >= 0 && k < bw) {
          bits = (T[(size_t)t * nb + (k >> 2)] >> ((k >> 1 & 1) * 4)) & 15;
        }
      }
    }
    if (st == ST_M)
      st = bits & UT_TB_DM ? ST_D : (bits & UT_TB_IM ? ST_I : ST_M);
    else if (st == ST_D)
      st = bits & UT_TB_MD ? ST_M : ST_D;
    else
      st = bits & UT_TB_MI ? ST_M : ST_I;
    i = ri;
    j = rj;
  }
  if (n & 3) O[n >> 2] = (uint8_t)acc;
  lens[p] = n;
}

extern "C" int wavefront_trace_launch(
    const void* tb, const void* tb_off, const void* mlast, int bmax,
    const void* dlb, const void* la, const void* lb, const void* dlo,
    const void* bw, const void* gp, int n_pairs, void* scores, void* ops,
    int ops_stride, void* lens, void* stream) {
  if (n_pairs <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_pairs + threads - 1) / threads;
  wavefront_trace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const long long*)tb_off, (const float*)mlast,
      bmax, (const float*)dlb, (const int*)la, (const int*)lb,
      (const int*)dlo, (const int*)bw, (const float*)gp, n_pairs,
      (float*)scores, (uint8_t*)ops, ops_stride, (int*)lens);
  return (int)cudaGetLastError();
}
