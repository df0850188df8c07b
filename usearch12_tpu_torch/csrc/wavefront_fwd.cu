// Forward pass of the banded affine-gap global Needleman-Wunsch DP.
//
// Replaces the Pallas TPU kernel usearch12_tpu/ops/wavefront_nw.py
// (_make_kernel, launched by _make_run.run).  Same cell semantics and
// float32 operation order as align/oracle.py:banded_nw (reference
// viterbifastbandmem.cpp): states M, D, I; the 12-penalty terminal-gap
// model; the right column Drow[LB]; ties '>' when M takes from D or I,
// '>=' favouring the gap open for D and I.  Nucleotide scoring: letter
// classes 0..3 score match / mismatch, class 4 (N and anything else)
// scores 0.
//
// What bounds it on the card: each pair is a chain of la + lb dependent
// anti-diagonals of a handful of float adds and compares per cell.  It
// writes half a byte of traceback per band cell, far below the card's
// memory bandwidth, so the limit is the latency of one anti-diagonal
// step and the instructions per cell, not bytes.  A launch with few long
// pairs runs one pair per SM, where a step costs the sum of its
// instructions' latencies; so the design cuts the instructions of a step.
//
// Design: one block per pair, ceil(nlane / 32) warps, one thread per
// band lane.  Each thread keeps its lane's M of anti-diagonals t-1 and
// t-2 and its D and I of t-1 in registers.  On a step of parity 1 the
// cell takes D from lane u+1, on parity 0 I from lane u-1: one warp
// shuffle, and at a warp boundary one shared slot per warp, written by
// the warp's first (D) or last (I) lane before the step's barrier and
// read after it.  Steps run in pairs, so the parity is known at compile
// time; a lane's cell moves by fixed rules (j + 1 after parity 0, i + 1
// after parity 1), so the thread loads one new letter per step into
// registers; the row-0 and column-0 terms are taken only on the first
// steps, until every lane's cell has left row 0 and column 0.  Pairs are
// taken longest first.  (Four one-warp pairs a block with no block
// barrier, for bands up to 63, measured slower than one-warp blocks.)
// None of the TPU layout carries over (pairs per vector row, lane rolls,
// packed insert tiles, interior-chunk flags).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (see
// usearch12_tpu_torch/_build.py).  -fmad=false keeps every add a single
// rounded float32 add, as in the oracle.

#include "wavefront.cuh"

#define FULL_MASK 0xffffffffu

// One thread's lane of one pair: constants, the lane's cell (i, j) and
// letters on the current anti-diagonal, and M, D, I of the last ones.
struct Lane {
  int la, lb, nb, u, lane, warp;
  bool in_band, ok0, ok1;        // u < nlane; a band lane at parity 0, 1
  float open_a, open_b, ext_a, ext_b, l_open_a, l_open_b, l_ext_a, l_ext_b;
  float r_open_b, r_ext_b, match, mismatch;
  const uint8_t* A;
  const uint8_t* B;
  uint8_t* T;                    // the current anti-diagonal's bytes
  float* ML;
  float* xd;                     // xd[w], D of warp w's lane 0
  float* xi;                     // xi[w + 1], I of warp w's lane 31
  float* dlb;                    // Drow[LB], carried row to row
  int i, j, ca, cb;
  float m1, m2, d1, i1;          // M(t-1), M(t-2), D(t-1), I(t-1)

  // anti-diagonal t of parity RHO; BORDER: some lane may be on row 0 or
  // column 0
  template <int RHO, bool BORDER>
  __device__ __forceinline__ void step() {
    float d_in, i_in;
    if (RHO) {                                   // D(i-1, j) of lane u+1
      d_in = __shfl_down_sync(FULL_MASK, d1, 1);
      if (lane == 31) d_in = xd[warp + 1];
      i_in = i1;                                 // I(i, j-1) of lane u
    } else {
      d_in = d1;                                 // D(i-1, j) of lane u
      i_in = __shfl_up_sync(FULL_MASK, i1, 1);   // I(i, j-1) of lane u-1
      if (lane == 0) i_in = xi[warp];
    }
    float m_in = m2;                             // M(i-1, j-1)
    if (BORDER && i == 0 && j == 0) m_in = 0.0f; // DPM[0][0]
    const bool valid = (RHO ? ok1 : ok0) && (unsigned)i < (unsigned)la &&
                       (unsigned)j < (unsigned)lb;
    const float sub =
        (ca < 4 && cb < 4) ? (ca == cb ? match : mismatch) : 0.0f;
    const float oa = BORDER && i == 0 ? l_open_a : open_a;
    const float ea = BORDER && i == 0 ? l_ext_a : ext_a;
    const float ob = BORDER && j == 0 ? l_open_b : open_b;
    const float eb = BORDER && j == 0 ? l_ext_b : ext_b;

    // MATCH: priority M, then D if '>', then I if '>'
    float xm = m_in;
    const bool take_d = d_in > xm;
    if (take_d) xm = d_in;
    const bool take_i = i_in > xm;
    if (take_i) xm = i_in;
    // DELETE and INSERT: '>=' favours the open
    const float md = m_in + ob;
    const float de = d_in + eb;
    const bool take_open = md >= de;
    const float mi = m_in + oa;
    const float ie = i_in + ea;
    const bool take_iopen = mi >= ie;

    int bits = 0;
    float m_out = UT_NEG, d_out = UT_NEG, i_out = UT_NEG;
    if (valid) {
      m_out = xm + sub;
      d_out = take_open ? md : de;
      i_out = take_iopen ? mi : ie;
      bits = (take_i ? UT_TB_IM : (take_d ? UT_TB_DM : 0)) |
             (take_open ? UT_TB_MD : 0) | (take_iopen ? UT_TB_MI : 0);
      if (i == la - 1) ML[j] = m_out;
    }
    // Drow[LB] for row i rides the lane whose j == lb (its regular cell
    // lies outside the rectangle, so the lane is otherwise idle)
    if (j == lb && (BORDER ? (unsigned)i < (unsigned)la : i < la) &&
        in_band) {
      const float md_lb = m_in + r_open_b;
      const float de_lb = *dlb + r_ext_b;
      const bool take_lb = md_lb >= de_lb;
      *dlb = take_lb ? md_lb : de_lb;
      bits = take_lb ? UT_TB_MD : 0;
    }
    m2 = m1;
    m1 = m_out;
    d1 = d_out;
    i1 = i_out;
    const int hi = __shfl_down_sync(FULL_MASK, bits, 1);
    if ((u & 1) == 0 && in_band) T[u >> 1] = (uint8_t)(bits | (hi << 4));
    T += nb;

    // the lane's next cell and its new letter
    if (RHO == 0) {
      ++j;
      cb = (unsigned)j < (unsigned)lb ? __ldg(B + j) : 4;
    } else {
      ++i;
      ca = (unsigned)i < (unsigned)la ? __ldg(A + i) : 4;
    }
    // the value the next step takes across this warp's boundary
    if (RHO == 0 && lane == 0) xd[warp] = d_out;
    if (RHO == 1 && lane == 31) xi[warp + 1] = i_out;
    __syncthreads();
  }

  // steps t .. t_end-1; the parity of step t is (t + s) & 1
  template <bool BORDER>
  __device__ __forceinline__ void run(int t, int t_end, int s) {
    if (t < t_end && ((t + s) & 1)) {
      step<1, BORDER>();
      ++t;
    }
    for (; t + 1 < t_end; t += 2) {
      step<0, BORDER>();
      step<1, BORDER>();
    }
    if (t < t_end) step<0, BORDER>();
  }
};

__global__ void wavefront_fwd_kernel(
    const uint8_t* __restrict__ a_let, const uint8_t* __restrict__ b_let,
    int amax, int bmax,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const long long* __restrict__ tb_off, const int* __restrict__ order,
    const float* __restrict__ gp, float match, float mismatch,
    uint8_t* __restrict__ tb, float* __restrict__ mlast,
    float* __restrict__ dlb_out) {
  extern __shared__ float smem[];  // xd[nwarps + 1], xi[nwarps + 1], Drow[LB]
  Lane s;
  s.u = threadIdx.x;
  s.lane = threadIdx.x & 31;
  s.warp = threadIdx.x >> 5;
  const int width = blockDim.x;
  const int nwarps = width >> 5;
  const int p = order[blockIdx.x];

  s.la = la_v[p];
  s.lb = lb_v[p];
  const int dlo = dlo_v[p], bw = bw_v[p];
  const int nlane = ut_nlane(bw);
  s.nb = ut_nbytes(bw);
  s.in_band = s.u < nlane;
  s.ok0 = s.u <= (bw - 1) >> 1;
  s.ok1 = s.u <= (bw - 2) >> 1;
  s.open_a = gp[GP_OPEN_A];
  s.open_b = gp[GP_OPEN_B];
  s.ext_a = gp[GP_EXT_A];
  s.ext_b = gp[GP_EXT_B];
  s.l_open_a = gp[GP_L_OPEN_A];
  s.l_open_b = gp[GP_L_OPEN_B];
  s.l_ext_a = gp[GP_L_EXT_A];
  s.l_ext_b = gp[GP_L_EXT_B];
  s.r_open_b = gp[GP_R_OPEN_B];
  s.r_ext_b = gp[GP_R_EXT_B];
  s.match = match;
  s.mismatch = mismatch;
  s.A = a_let + (size_t)p * amax;
  s.B = b_let + (size_t)p * bmax;
  s.T = tb + tb_off[p];
  s.ML = mlast + (size_t)p * bmax;
  s.xd = smem;
  s.xi = smem + nwarps + 1;
  s.dlb = smem + 2 * (nwarps + 1);
  for (int k = s.u; k < 2 * (nwarps + 1) + 1; k += width) smem[k] = UT_NEG;

  // row la-1 holds D* = 1 + j: NEG where its band does not reach
  const int jlo = max(dlo - 1, 0), jhi = min(dlo + bw - 2, s.lb - 1);
  for (int j = s.u; j < bmax; j += width)
    if (j < jlo || j > jhi) s.ML[j] = UT_NEG;

  // on anti-diagonal t lane u holds j = ceil((t + sh) / 2) + u, i = t - j,
  // sh = dlo - la, and the step's parity is (t + sh) & 1
  const int sh = dlo - s.la;
  s.j = ((sh + (sh & 1)) >> 1) + s.u;
  s.i = -s.j;
  s.ca = (unsigned)s.i < (unsigned)s.la ? __ldg(s.A + s.i) : 4;
  s.cb = (unsigned)s.j < (unsigned)s.lb ? __ldg(s.B + s.j) : 4;
  s.m1 = s.m2 = s.d1 = s.i1 = UT_NEG;
  __syncthreads();

  // from step t_in on, every lane of the pair has j >= 1 (t + sh >= 1)
  // and i >= 1 (t - sh >= 2 * width)
  const int steps = s.la + s.lb;  // last cell at la+lb-2, Drow[LB] at la-1+lb
  const int t_in = min(steps, max(0, max(1 - sh, 2 * width + sh)));
  s.run<true>(0, t_in, sh);
  s.run<false>(t_in, steps, sh);
  if (s.u == 0) dlb_out[p] = *s.dlb;
}

extern "C" int wavefront_fwd_launch(
    const void* a_let, const void* b_let, int amax, int bmax,
    const void* la, const void* lb, const void* dlo, const void* bw,
    const void* tb_off, const void* order, const void* gp, float match,
    float mismatch, int n_pairs, int lanes, void* tb, void* mlast,
    void* dlb, void* stream) {
  if (n_pairs <= 0) return 0;
  if (lanes < 32 || lanes > 1024 || lanes % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)(lanes / 32 + 1) + 1) * sizeof(float);
  wavefront_fwd_kernel<<<n_pairs, lanes, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)a_let, (const uint8_t*)b_let, amax, bmax,
      (const int*)la, (const int*)lb, (const int*)dlo, (const int*)bw,
      (const long long*)tb_off, (const int*)order, (const float*)gp, match,
      mismatch, (uint8_t*)tb, (float*)mlast, (float*)dlb);
  return (int)cudaGetLastError();
}

extern "C" const char* wavefront_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
