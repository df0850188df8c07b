// Row-sweep banded affine-gap global NW: forward DP and traceback.
//
// banded_nw_fwd replaces the Pallas TPU kernel
// usearch12_tpu/ops/banded_nw.py (_make_kernel, launched by _compiled.run);
// banded_nw_chase replaces the XLA post-processing of _compiled.run (final
// DPI row, final state) and the jnp pointer chase _traceback_compiled.
// Cell semantics and float32 operation order are those of
// align/oracle.py:banded_nw (reference viterbifastbandmem.cpp and
// tracebackbitmem.cpp), sweeping rows i = 0 .. la-1 and, within a row,
// the band cells from left to right: ties '>' when M takes from D or I,
// '>=' favouring the gap open for D and I, '>' in the final DPI row; the
// 12-penalty terminal-gap model; the right column Drow[LB] updated every
// row.  The insert state within a row is the oracle's sequential
// recurrence i0 = i0 + ext; if (mi >= i0) i0 = mi.  (The TPU kernel used
// a log-doubling max-plus scan there, exact only for dyadic penalties.)
// Nucleotide scoring: letter classes 0..3 score match / mismatch, class 4
// (N and anything else) scores 0.
//
// Geometry.  Pair p aligns a (la) with b (lb) in the diagonal band
// dlo <= D* <= dlo + bw - 1, D* = la - i + j, with 1 <= dlo <= min(la, lb)
// and dlo + bw - 1 >= max(la, lb) (the wrapper checks this), bw <= W.
// Band cell k of row i is column j = dlo + i - la + k.
//
// Layouts (W = the launch's band width, the widest pair's bw):
//   tb     (amax, W + 1, P) uint8: tb[i][k][p] holds the 4-bit code of
//          band cell k of row i (0 outside the matrix and for k >= bw);
//          tb[i][W][p] holds the Drow[LB] bit of row i (0 or TB_MD).
//          Pair-minor, so a warp's 32 threads store neighbouring bytes.
//          Rows i >= la are 0 (the wrapper zeroes the buffer).
//   mlast  (P, W) float32: M of row la-1, mlast[p][k] = M(la-1, dlo-1+k),
//          NEG outside the matrix and for k >= bw.
//   dlb    (P,) float32: Drow[LB] after row la-1 (the final D score).
//   tblast (P, W) uint8: the final DPI row's bits, tblast[p][k] for
//          j = dlo - 1 + k (the JAX package's un-rotated tblast).
//   ops    (P, stride) uint8: the path as 2-bit codes OP_M/D/I = 0/1/2
//          from the end of the alignment to its start, 4 per byte from the
//          low bits up, OP_PAD = 3 after the end (the JAX package's
//          decode_packed_ops format).
//
// What bounds it on the card: each pair is a chain of la rows of bw
// dependent cells (the I state runs through the row), a dozen float ops
// per cell and a byte of traceback.  Design: one thread per pair, as the
// host nw_band does it.  The pair's M and D rows (at most 127 floats
// each) live in shared memory, slot k of thread t at [k * 32 + t], so the
// 32 threads of a block hit 32 distinct banks whatever their k.  Updated
// in place from left to right: cell k reads M[k] (diagonal) and D[k + 1]
// (up) of the previous row before it writes M[k] and D[k].  Blocks of 32
// threads (32.5 KB of shared memory at W = 126) keep many blocks on each
// SM.  The traceback kernel is one thread per pair too: the final row is a
// sequential recurrence and the chase a chain of dependent byte loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (see
// usearch12_tpu_torch/_build.py).  -fmad=false keeps every add a single
// rounded float32 add, as in the oracle.

#include "wavefront.cuh"

#define BNW_THREADS 32
enum { OP_M = 0, OP_D = 1, OP_I = 2, OP_PAD = 3 };

__global__ void banded_nw_fwd_kernel(
    const uint8_t* __restrict__ a_let, const uint8_t* __restrict__ b_let,
    int amax, int bmax,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const float* __restrict__ gp, float match, float mismatch,
    int n_pairs, int W,
    uint8_t* __restrict__ tb, float* __restrict__ mlast,
    float* __restrict__ dlb_out) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int p = blockIdx.x * BNW_THREADS + t;
  if (p >= n_pairs) return;           // no barriers below
  float* M = smem + t;                       // slot k at M[k * BNW_THREADS]
  float* D = smem + (W + 1) * BNW_THREADS + t;
  const int la = la_v[p], lb = lb_v[p], dlo = dlo_v[p], bw = bw_v[p];
  const float open_a = gp[GP_OPEN_A], open_b = gp[GP_OPEN_B];
  const float ext_a = gp[GP_EXT_A], ext_b = gp[GP_EXT_B];
  const float l_open_a = gp[GP_L_OPEN_A], l_open_b = gp[GP_L_OPEN_B];
  const float l_ext_a = gp[GP_L_EXT_A], l_ext_b = gp[GP_L_EXT_B];
  const float r_open_b = gp[GP_R_OPEN_B], r_ext_b = gp[GP_R_EXT_B];
  const uint8_t* A = a_let + (size_t)p * amax;
  const uint8_t* B = b_let + (size_t)p * bmax;
  const size_t P = (size_t)n_pairs;
  const size_t row_stride = (size_t)(W + 1) * P;

  for (int k = 0; k <= W; ++k) {
    M[k * BNW_THREADS] = UT_NEG;
    D[k * BNW_THREADS] = UT_NEG;
  }
  M[(la - dlo) * BNW_THREADS] = 0.0f;        // DPM[0][0]: cell (0, 0)
  float dlb = UT_NEG;

  for (int i = 0; i < la; ++i) {
    const float oa = i == 0 ? l_open_a : open_a;
    const float ea = i == 0 ? l_ext_a : ext_a;
    // Drow[LB]: from M(i-1, lb-1), the previous row's slot k_lb, read
    // before this row overwrites it; NEG when the band missed lb - 1
    const int k_lb = lb - dlo - i + la;
    const float m_end = k_lb < bw ? M[k_lb * BNW_THREADS] : UT_NEG;
    const float md_lb = m_end + r_open_b;
    const float de_lb = dlb + r_ext_b;
    const bool take_lb = md_lb >= de_lb;
    dlb = take_lb ? md_lb : de_lb;
    uint8_t* T = tb ? tb + i * row_stride + p : nullptr;
    if (T) T[(size_t)W * P] = take_lb ? UT_TB_MD : 0;

    const int jbase = dlo + i - la;
    const int kstart = jbase < 0 ? -jbase : 0;
    const int kend = lb - jbase < bw ? lb - jbase : bw;
    const int ca = A[i];
    float i0 = UT_NEG;
    for (int k = kstart; k < kend; ++k) {
      const int j = jbase + k;
      const int cb = B[j];
      const float sub = (ca < 4 && cb < 4) ? (ca == cb ? match : mismatch)
                                           : 0.0f;
      const float ob = j == 0 ? l_open_b : open_b;
      const float eb = j == 0 ? l_ext_b : ext_b;
      const float m_diag = M[k * BNW_THREADS];
      const float d_up = D[(k + 1) * BNW_THREADS];
      // MATCH: priority M, then D if '>', then I if '>'
      float xm = m_diag;
      const bool take_d = d_up > xm;
      if (take_d) xm = d_up;
      const bool take_i = i0 > xm;
      if (take_i) xm = i0;
      M[k * BNW_THREADS] = xm + sub;
      // DELETE: '>=' favours the open
      const float md = m_diag + ob;
      const float de = d_up + eb;
      const bool take_open = md >= de;
      D[k * BNW_THREADS] = take_open ? md : de;
      // INSERT: the oracle's sequential recurrence, '>=' favours the open
      const float mi = m_diag + oa;
      i0 = i0 + ea;
      const bool take_iopen = mi >= i0;
      if (take_iopen) i0 = mi;
      if (T)
        T[(size_t)k * P] = (uint8_t)(
            (take_i ? UT_TB_IM : (take_d ? UT_TB_DM : 0))
            | (take_open ? UT_TB_MD : 0) | (take_iopen ? UT_TB_MI : 0));
    }
    if (i == la - 1) {
      float* ML = mlast + (size_t)p * W;
      for (int k = 0; k < W; ++k)
        ML[k] = k < kend ? M[k * BNW_THREADS] : UT_NEG;
    }
  }
  dlb_out[p] = dlb;
}

__global__ void banded_nw_chase_kernel(
    const uint8_t* __restrict__ tb, int amax,
    const float* __restrict__ mlast, int W, const float* __restrict__ dlb,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const float* __restrict__ gp, int n_pairs,
    float* __restrict__ scores, uint8_t* __restrict__ states,
    uint8_t* __restrict__ tblast, uint8_t* __restrict__ ops, int stride) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int la = la_v[p], lb = lb_v[p], dlo = dlo_v[p], bw = bw_v[p];
  const float r_open_a = gp[GP_R_OPEN_A], r_ext_a = gp[GP_R_EXT_A];
  const float* ML = mlast + (size_t)p * W;
  uint8_t* TL = tblast + (size_t)p * W;

  // final DPI row (i = la) over the band of row la-1: cell k is column
  // j = dlo - 1 + k, from j = dlo - 1 to lb - 1; Mrow[startj-1] is NEG
  float i1 = UT_NEG;
  const int n_last = lb - dlo + 1;
  for (int k = 0; k < W; ++k) {
    uint8_t bit = 0;
    if (k < n_last) {
      const float mi = (k == 0 ? UT_NEG : ML[k - 1]) + r_open_a;
      i1 = i1 + r_ext_a;
      if (mi > i1) {
        i1 = mi;
        bit = UT_TB_MI;
      }
    }
    TL[k] = bit;
  }
  float score = ML[lb - dlo];                  // M(la-1, lb-1)
  int st = OP_M;
  if (dlb[p] > score) {
    score = dlb[p];
    st = OP_D;
  }
  if (i1 > score) {
    score = i1;
    st = OP_I;
  }
  scores[p] = score;
  states[p] = (uint8_t)st;
  if (tb == nullptr) return;

  const size_t P = (size_t)n_pairs;
  uint8_t* O = ops + (size_t)p * stride;
  int i = la, j = lb, n = 0;
  unsigned acc = 0;
  while ((i > 0 || j > 0) && i >= 0 && j >= 0 && n < 4 * stride) {
    acc |= (unsigned)st << (2 * (n & 3));
    if ((n & 3) == 3) {
      O[n >> 2] = (uint8_t)acc;
      acc = 0;
    }
    ++n;
    // the cell whose bits decide the next state is where the move lands
    const int ri = st == OP_I ? i : i - 1;
    const int rj = st == OP_D ? j : j - 1;
    int bits = 0;
    if (ri >= 0 && rj >= 0) {
      if (ri == la) {
        const int k = rj - dlo + 1;
        bits = k >= 0 && k < W ? TL[k] : 0;
      } else if (ri < amax) {
        const uint8_t* T = tb + (size_t)ri * (W + 1) * P + p;
        const int k = rj - (dlo + ri - la);
        if (rj == lb)
          bits = T[(size_t)W * P];
        else if (k == -1)
          bits = UT_TB_IM;     // the reference's marker TB[i][startj-1]
        else if (k >= 0 && k < bw)
          bits = T[(size_t)k * P];
      }
    }
    if (st == OP_M)
      st = bits & UT_TB_DM ? OP_D : (bits & UT_TB_IM ? OP_I : OP_M);
    else if (st == OP_D)
      st = bits & UT_TB_MD ? OP_M : OP_D;
    else
      st = bits & UT_TB_MI ? OP_M : OP_I;
    i = ri;
    j = rj;
  }
  if (n & 3) {
    for (int r = n & 3; r < 4; ++r) acc |= (unsigned)OP_PAD << (2 * r);
    O[n >> 2] = (uint8_t)acc;
  }
}

extern "C" int banded_nw_fwd_launch(
    const void* a_let, const void* b_let, int amax, int bmax,
    const void* la, const void* lb, const void* dlo, const void* bw,
    const void* gp, float match, float mismatch, int n_pairs, int W,
    void* tb, void* mlast, void* dlb, void* stream) {
  if (n_pairs <= 0) return 0;
  const size_t smem = 2 * (size_t)(W + 1) * BNW_THREADS * sizeof(float);
  const int blocks = (n_pairs + BNW_THREADS - 1) / BNW_THREADS;
  banded_nw_fwd_kernel<<<blocks, BNW_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)a_let, (const uint8_t*)b_let, amax, bmax,
      (const int*)la, (const int*)lb, (const int*)dlo, (const int*)bw,
      (const float*)gp, match, mismatch, n_pairs, W, (uint8_t*)tb,
      (float*)mlast, (float*)dlb);
  return (int)cudaGetLastError();
}

extern "C" int banded_nw_chase_launch(
    const void* tb, int amax, const void* mlast, int W, const void* dlb,
    const void* la, const void* lb, const void* dlo, const void* bw,
    const void* gp, int n_pairs, void* scores, void* states, void* tblast,
    void* ops, int stride, void* stream) {
  if (n_pairs <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_pairs + threads - 1) / threads;
  banded_nw_chase_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, amax, (const float*)mlast, W, (const float*)dlb,
      (const int*)la, (const int*)lb, (const int*)dlo, (const int*)bw,
      (const float*)gp, n_pairs, (float*)scores, (uint8_t*)states,
      (uint8_t*)tblast, (uint8_t*)ops, stride);
  return (int)cudaGetLastError();
}
