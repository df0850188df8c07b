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
// anti-diagonals, each a handful of float adds per cell and one block
// barrier.  It writes half a byte of traceback per band cell and reads
// a letter pair per cell, far below the card's memory bandwidth, so the
// limit is barrier latency and instruction throughput, not bytes.
//
// Design: one thread block per pair, one thread per band lane (at most
// (bw + 1) / 2 of them).  The M, D and I values of anti-diagonals t-1
// and t-2 live in shared memory (a few KB per block), so many blocks
// share an SM and hide each other's barrier latency.  One __syncthreads
// per anti-diagonal.  Neighbouring lanes pack their two nibbles with a
// warp shuffle, so each traceback byte is written by one thread.  None
// of the TPU layout carries over (pairs per vector row, lane rolls,
// packed insert tiles, interior-chunk flags): each thread addresses its
// letters and its neighbours directly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (see
// usearch12_tpu_torch/_build.py).  -fmad=false keeps every add a single
// rounded float32 add, as in the oracle.

#include "wavefront.cuh"

__global__ void wavefront_fwd_kernel(
    const uint8_t* __restrict__ a_let, const uint8_t* __restrict__ b_let,
    int amax, int bmax,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const long long* __restrict__ tb_off, const float* __restrict__ gp,
    float match, float mismatch,
    uint8_t* __restrict__ tb, float* __restrict__ mlast,
    float* __restrict__ dlb_out) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int u = threadIdx.x;
  const int W = blockDim.x;          // lanes in this launch, multiple of 32
  const int S = W + 2;               // one NEG guard slot on each side
  // ring buffers, index [t & 1]: M holds M(t-2) on entry to step t and
  // M(t) on exit; D and I hold step t-1 in slot (t-1) & 1
  float* Ms = smem;
  float* Ds = smem + 2 * S;
  float* Is = smem + 4 * S;
  float* dlb_s = smem + 6 * S;       // the Drow[LB] value carried row to row

  const int la = la_v[p], lb = lb_v[p], dlo = dlo_v[p], bw = bw_v[p];
  const int nlane = ut_nlane(bw);
  const int nb = ut_nbytes(bw);
  const float open_a = gp[GP_OPEN_A], open_b = gp[GP_OPEN_B];
  const float ext_a = gp[GP_EXT_A], ext_b = gp[GP_EXT_B];
  const float l_open_a = gp[GP_L_OPEN_A], l_open_b = gp[GP_L_OPEN_B];
  const float l_ext_a = gp[GP_L_EXT_A], l_ext_b = gp[GP_L_EXT_B];
  const float r_open_b = gp[GP_R_OPEN_B], r_ext_b = gp[GP_R_EXT_B];

  const uint8_t* A = a_let + (size_t)p * amax;
  const uint8_t* B = b_let + (size_t)p * bmax;
  uint8_t* T = tb + tb_off[p];
  float* ML = mlast + (size_t)p * bmax;

  for (int k = u; k < 6 * S + 1; k += W) smem[k] = UT_NEG;
  for (int j = u; j < bmax; j += W) ML[j] = UT_NEG;
  __syncthreads();

  const int steps = la + lb;   // last cell at la+lb-2, last Drow[LB] at la-1+lb
  for (int t = 0; t < steps; ++t) {
    const int rho = (la - t - dlo) & 1;
    const int dstar = dlo + rho + 2 * u;
    const int j = (dstar - la + t) >> 1;     // exact: the numerator is even
    const int i = t - j;
    const int umax = (bw - 1 - rho) >> 1;
    const bool valid = u <= umax && i >= 0 && i < la && j >= 0 && j < lb;

    float* Mc = Ms + (t & 1) * S + 1;
    const float* Dp = Ds + ((t + 1) & 1) * S + 1;
    const float* Ip = Is + ((t + 1) & 1) * S + 1;
    float* Dc = Ds + (t & 1) * S + 1;
    float* Ic = Is + (t & 1) * S + 1;

    float m_in = Mc[u];                   // M(i-1, j-1)
    if (i == 0 && j == 0) m_in = 0.0f;    // DPM[0][0]
    const float d_in = Dp[u + rho];       // D(i-1, j)
    const float i_in = Ip[u + rho - 1];   // I(i, j-1)

    float sub = 0.0f;
    if (valid) {
      const int ca = A[i], cb = B[j];
      if (ca < 4 && cb < 4) sub = ca == cb ? match : mismatch;
    }
    const float oa = i == 0 ? l_open_a : open_a;
    const float ea = i == 0 ? l_ext_a : ext_a;
    const float ob = j == 0 ? l_open_b : open_b;
    const float eb = j == 0 ? l_ext_b : ext_b;

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
      bits = (take_i ? UT_TB_IM : (take_d ? UT_TB_DM : 0))
             | (take_open ? UT_TB_MD : 0) | (take_iopen ? UT_TB_MI : 0);
      if (i == la - 1) ML[j] = m_out;
    }
    // Drow[LB] for row i rides the lane whose j == lb (its regular cell
    // lies outside the rectangle, so the lane is otherwise idle)
    if (j == lb && i >= 0 && i < la && u < nlane) {
      const float md_lb = m_in + r_open_b;
      const float de_lb = *dlb_s + r_ext_b;
      const bool take_lb = md_lb >= de_lb;
      *dlb_s = take_lb ? md_lb : de_lb;
      bits = take_lb ? UT_TB_MD : 0;
    }
    Mc[u] = m_out;
    Dc[u] = d_out;
    Ic[u] = i_out;

    const int hi = __shfl_down_sync(0xffffffffu, bits, 1);
    if ((u & 1) == 0 && u < nlane)
      T[(size_t)t * nb + (u >> 1)] = (uint8_t)(bits | (hi << 4));
    __syncthreads();
  }
  if (u == 0) dlb_out[p] = *dlb_s;
}

extern "C" int wavefront_fwd_launch(
    const void* a_let, const void* b_let, int amax, int bmax,
    const void* la, const void* lb, const void* dlo, const void* bw,
    const void* tb_off, const void* gp, float match, float mismatch,
    int n_pairs, int lanes, void* tb, void* mlast, void* dlb,
    void* stream) {
  if (n_pairs <= 0) return 0;
  const size_t smem = (6 * (size_t)(lanes + 2) + 1) * sizeof(float);
  wavefront_fwd_kernel<<<n_pairs, lanes, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)a_let, (const uint8_t*)b_let, amax, bmax,
      (const int*)la, (const int*)lb, (const int*)dlo, (const int*)bw,
      (const long long*)tb_off, (const float*)gp, match, mismatch,
      (uint8_t*)tb, (float*)mlast, (float*)dlb);
  return (int)cudaGetLastError();
}

extern "C" const char* wavefront_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
