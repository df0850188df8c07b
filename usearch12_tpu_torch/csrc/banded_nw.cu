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
// Band cell k of row i is column j = dlo + i - la + k.  The row sweep
// keeps one M and one D slot a band cell (and a slot W, never written),
// updated in place: cell k of row i reads M[k] (the diagonal) and
// D[k + 1] (up) as row i - 1 left them, and a slot that a row does not
// write keeps its value (NEG from the start, 0 in slot la - dlo for cell
// (0, 0)).
//
// Layouts (W = the launch's band width, the widest pair's bw):
//   tb     (P, amax, W + 1) uint8: tb[p][i][k] holds the 4-bit code of
//          band cell k of row i (0 outside the matrix and for k >= bw);
//          tb[p][i][W] holds the Drow[LB] bit of row i (0 or TB_MD).
//          Rows i >= la are 0.  Pair-major, so that the forward kernel
//          writes each pair's rows as one contiguous run.  It was
//          pair-minor, (amax, W + 1, P), while the forward kernel was one
//          thread a pair.  Measured effect (chip_smoke.py --against the
//          pair-minor version, kernels alone, H100 80GB HBM3 at 700 W):
//          the chase, still one thread a pair, went from 0.20 to 0.45 ms
//          on 65,536 pairs of 250 nt and from 0.40 to 0.70 ms on 2,048
//          pairs of 1 kb, as each thread now reads a region of its own;
//          with the forward pass (3.44 to 2.15 and 10.07 to 0.97 ms) both
//          kernels together take 2.60 and 1.66 ms where they took 3.64
//          and 10.47.
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
// banded_nw_fwd.  What bounds it on the card: each pair is a chain of la
// rows of bw dependent cells (the I state runs along the row), a dozen
// float ops a cell and a byte of traceback, which dominates the bytes.
// Design: a group of L lanes of one warp a pair, with a warp holding
// G = 32 / L pairs.  The band's cells are cut into 2 L parts of CV cells
// (a template argument, banded_nw_fwd_cells(): 6, or 4 for bands wider
// than BNW_CV6_MAX): lane l owns parts 2l and 2l + 1, and keeps their M
// and D slots in registers.  Part v computes row i at step 2i + v: lane
// l does row s - l at super-step s, part 2l, then part 2l + 1.  So every
// predecessor of a cell is done at an earlier step: the diagonal and the
// up cell of the part's own slots and the up cell of part 2l (part 2l + 1's
// first slot) are in the lane; the up cell of part 2l + 1 is lane l + 1's
// first D slot, which lane l + 1 computed for row i - 1 in the same
// super-step, and the I state entering part 2l is lane l - 1's after its
// part 2l - 1 of row i (the super-step before), both by warp shuffle.
// The cells, their float operations and the order of each cell's reads
// are the row sweep's, so are the bits.  The Drow[LB] chain of row i
// reads M(i - 1, lb - 1), the slot k_lb = lb - dlo - i + la, before row i
// overwrites it: the part that holds k_lb (capped at the last part when
// the band misses lb - 1) carries the chain for that row, at the start of
// its row; k_lb moves one slot left a row, so the chain passes to the
// left, from lane l + 1 to lane l by a shuffle.  A pair takes la + L - 1
// super-steps of 2 CV cells a lane, where a thread a pair took la x bw.
// Traceback: each group writes its rows' codes into a ring of R rows in
// shared memory; every BNW_FLUSH rows, once lane L - 1 has finished them,
// the warp copies them to tb as one contiguous run a pair (and writes
// rows la .. amax - 1 as zeros, so tb needs no clearing).
//
// banded_nw_chase.  What bounds it on the card: the chase is a chain of
// dependent reads, one or two a row, and each lands in a row of its own
// W + 1 bytes of the pair-major tb, so the path sweeps the pair's whole
// traceback at the 32-byte sectors device memory delivers (chip_smoke.py
// prints that floor beside the kernel's time).  One thread a pair made
// each step a device-memory latency, with each thread reading a region
// of its own.  Design: a warp for G pairs (G = 32 down to 1, so that a
// launch of few pairs still has BNC_MIN_WARPS warps), a lane chasing
// each.  The lane streams its pair's rows, top down, into a ring of
// BNC_SLOTS windows of R rows in shared memory, one bulk copy (the TMA)
// a window completing on an mbarrier, the next BNC_SLOTS - 1 windows in
// flight while it chases in the current one; a lane that reaches the row
// below its window waits for the others, then every pair moves to its
// next window.  (Copies of 16 bytes a thread, by the chasing lane or by
// the whole warp pair after pair, moved the same bytes more slowly on an
// H100.)  A step is then a shared-memory load: inside the matrix, off the
// final row and the Drow[LB] column, the band cell and the row move by
// fixed steps and the next state comes from a 2-bit table.  The final
// DPI row: the warp stages its pairs' mlast rows in shared memory,
// coalesced, and each chasing lane runs its pair's recurrence in the
// oracle's order; the chase reads that row only leftwards from lb - 1 in
// state I, stopping at the first set bit, so the lane keeps only the last
// column whose bit is set.  tblast and the path codes are staged in
// shared memory and written out as one contiguous run a warp (every byte
// of ops: OP_PAD past the path).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (see
// usearch12_tpu_torch/_build.py).  -fmad=false keeps every add a single
// rounded float32 add, as in the oracle.

#include "wavefront.cuh"

#define BNW_WARPS 4          // warps a block of the forward kernel
#define BNW_FLUSH 16         // traceback rows copied out at a time
#define BNW_FULL 0xffffffffu
// Widest band at 6 cells a part.  Wider bands take 4: a group of 6-cell
// parts is then 11 lanes, two pairs a warp with 10 lanes idle, where a
// group of 4-cell parts (16 lanes) fills the warp with 8 cells a lane, not
// 12.  Timed on an H100, 6 was the faster at band 41 and 4 at band 125.
#define BNW_CV6_MAX 120
// banded_nw_chase: windows in each pair's ring, the most bytes of a
// window's slot and of a warp's rings, the fewest warps a launch is cut
// into while pairs a warp can halve, and the most shared memory a block
#define BNC_SLOTS 3
#define BNC_SLOT_MAX 4096
#define BNC_RING_WARP 49152
#define BNC_MIN_WARPS 1024
#define BNC_SMEM_MAX (160 * 1024)
enum { OP_M = 0, OP_D = 1, OP_I = 2, OP_PAD = 3 };

// Interface of this file's entry points, for tools that time two
// versions of it: 2 = the pair-major tb (the arguments are unchanged).
extern "C" int banded_nw_interface() { return 2; }

// The cells a part that the forward kernel takes at launch width W.
extern "C" int banded_nw_fwd_cells(int W) { return W > BNW_CV6_MAX ? 4 : 6; }

struct BnwRow {
  int jbase, kstart, kend, ca;
  float oa, ea;
  float sm, sx;         // the row's match / mismatch score (0 for ca = N)
  uint8_t* trow;
};

struct BnwGaps {
  float open_b, ext_b, l_open_b, l_ext_b, r_open_b, r_ext_b;
};

// One part's CV cells of one row, left to right, as the row sweep does
// them: M[c], D[c] are slots kp + c; up is the D slot kp + CV (the next
// part's first); i0 the I state entering the part, left as it leaves it.
// lt[c] holds b's letter at column jbase + kp + c of the row before; the
// letters move one slot left a row (a column keeps its letter), next is
// the one entering at the right (the next part's first of the row before).
template <int CV>
__device__ __forceinline__ void bnw_cells(
    float (&M)[CV], float (&D)[CV], int (&lt)[CV], int next, int kp,
    float up, float& i0, const BnwRow& r, const BnwGaps& g, int W) {
#pragma unroll
  for (int c = 0; c + 1 < CV; ++c) lt[c] = lt[c + 1];
  lt[CV - 1] = next;
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    const int k = kp + c;
    uint8_t bits = 0;
    if (k >= r.kstart && k < r.kend) {
      const int j = r.jbase + k;
      const int cb = lt[c];
      const float sub = cb < 4 ? (r.ca == cb ? r.sm : r.sx) : 0.0f;
      const float ob = j == 0 ? g.l_open_b : g.open_b;
      const float eb = j == 0 ? g.l_ext_b : g.ext_b;
      const float m_diag = M[c];
      const float d_up = c + 1 < CV ? D[c + 1] : up;
      // MATCH: priority M, then D if '>', then I if '>'
      float xm = m_diag;
      const bool take_d = d_up > xm;
      if (take_d) xm = d_up;
      const bool take_i = i0 > xm;
      if (take_i) xm = i0;
      M[c] = xm + sub;
      // DELETE: '>=' favours the open
      const float md = m_diag + ob;
      const float de = d_up + eb;
      const bool take_open = md >= de;
      D[c] = take_open ? md : de;
      // INSERT: the oracle's sequential recurrence, '>=' favours the open
      const float mi = m_diag + r.oa;
      i0 = i0 + r.ea;
      const bool take_iopen = mi >= i0;
      if (take_iopen) i0 = mi;
      bits = (uint8_t)((take_i ? UT_TB_IM : (take_d ? UT_TB_DM : 0))
                       | (take_open ? UT_TB_MD : 0)
                       | (take_iopen ? UT_TB_MI : 0));
    }
    if (k < W) r.trow[k] = bits;
  }
}

// The Drow[LB] chain for row i, carried by the part whose slots start at
// kp: m_end = M(i - 1, lb - 1), slot k_lb of M as row i - 1 left it (NEG
// when the band missed lb - 1); prev is Drow[LB] after row i - 1.
template <int CV>
__device__ __forceinline__ float bnw_chain(
    const float (&M)[CV], int kp, int k_lb, int bw, float prev,
    const BnwGaps& g, const BnwRow& r, int W) {
  float m_end = UT_NEG;
#pragma unroll
  for (int c = 0; c < CV; ++c)
    if (kp + c == k_lb && k_lb < bw) m_end = M[c];
  const float md_lb = m_end + g.r_open_b;
  const float de_lb = prev + g.r_ext_b;
  const bool take_lb = md_lb >= de_lb;
  r.trow[W] = take_lb ? UT_TB_MD : 0;
  return take_lb ? md_lb : de_lb;
}

template <int CV>
__device__ __forceinline__ void bnw_mlast(
    const float (&M)[CV], int kp, int kend, int W, float* __restrict__ ML) {
#pragma unroll
  for (int c = 0; c < CV; ++c)
    if (kp + c < W) ML[kp + c] = kp + c < kend ? M[c] : UT_NEG;
}

// Rows q * BNW_FLUSH .. + BNW_FLUSH - 1 (below amax) of the warp's G pairs
// from their rings to tb: each pair's rows are one contiguous run; rows
// at or past its la are written as zeros.
__device__ __forceinline__ void bnw_flush(
    int q, int lane, const uint8_t* ring_w, int R, int G, long long p0,
    int n_pairs, int amax, int W, int la, int L, uint8_t* __restrict__ tb) {
  const int r0 = q * BNW_FLUSH;
  const int rows = min(BNW_FLUSH, amax - r0);
  const int row_bytes = W + 1;
  for (int g = 0; g < G; ++g) {
    const int la_g = __shfl_sync(BNW_FULL, la, g * L);
    if (p0 + g >= n_pairs) break;
    const int n = rows * row_bytes;
    const int n_live = max(0, min(la_g - r0, rows)) * row_bytes;
    const uint8_t* src = ring_w + ((size_t)g * R + r0 % R) * row_bytes;
    uint8_t* dst = tb + ((size_t)(p0 + g) * amax + r0) * row_bytes;
    for (int x = lane; x < n; x += 32) dst[x] = x < n_live ? src[x] : 0;
  }
}

template <int CV>
__global__ void __launch_bounds__(32 * BNW_WARPS) banded_nw_fwd_kernel(
    const uint8_t* __restrict__ a_let, const uint8_t* __restrict__ b_let,
    int amax, int bmax,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const float* __restrict__ gp, float match, float mismatch,
    int n_pairs, int W, int L, int G, int R,
    uint8_t* __restrict__ tb, float* __restrict__ mlast,
    float* __restrict__ dlb_out) {
  extern __shared__ uint8_t bnw_ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / L, l = lane - g * L;
  const int row_bytes = W + 1;
  uint8_t* ring_w = bnw_ring + (size_t)warp * G * R * row_bytes;
  const long long p0 = ((long long)blockIdx.x * BNW_WARPS + warp) * G;
  if (p0 >= n_pairs) return;                    // the whole warp
  const bool live = g < G && p0 + g < n_pairs;
  const int p = live ? (int)(p0 + g) : 0;
  const int la = live ? la_v[p] : 0;
  const int lb = live ? lb_v[p] : 1, dlo = live ? dlo_v[p] : 1;
  const int bw = live ? bw_v[p] : 1;
  BnwGaps gaps;
  gaps.open_b = gp[GP_OPEN_B];
  gaps.ext_b = gp[GP_EXT_B];
  gaps.l_open_b = gp[GP_L_OPEN_B];
  gaps.l_ext_b = gp[GP_L_EXT_B];
  gaps.r_open_b = gp[GP_R_OPEN_B];
  gaps.r_ext_b = gp[GP_R_EXT_B];
  const float open_a = gp[GP_OPEN_A], ext_a = gp[GP_EXT_A];
  const float l_open_a = gp[GP_L_OPEN_A], l_ext_a = gp[GP_L_EXT_A];
  const uint8_t* A = a_let + (size_t)p * amax;
  const uint8_t* B = b_let + (size_t)p * bmax;
  uint8_t* ring = ring_w + (size_t)(live ? g : 0) * R * row_bytes;

  // slots k0 .. k0 + CV - 1 (part 2l) and k1 .. (part 2l + 1)
  const int k0 = 2 * l * CV, k1 = k0 + CV;
  const int n_slots = 2 * L * CV;
  float M0[CV], D0[CV], M1[CV], D1[CV];
  int lt0[CV], lt1[CV];       // b's letters, as of the row before row 0
  const int jb0 = dlo - la - 1;
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    M0[c] = k0 + c == la - dlo ? 0.0f : UT_NEG;  // DPM[0][0]: cell (0, 0)
    M1[c] = k1 + c == la - dlo ? 0.0f : UT_NEG;
    D0[c] = UT_NEG;
    D1[c] = UT_NEG;
    lt0[c] = B[min(max(jb0 + k0 + c, 0), bmax - 1)];
    lt1[c] = B[min(max(jb0 + k1 + c, 0), bmax - 1)];
  }
  float dlb = UT_NEG;         // Drow[LB] after the last row this lane carried
  float i_out = UT_NEG;       // I state after part 2l + 1 of the last row
  const int la_max = __reduce_max_sync(BNW_FULL, la);
  const int s_end = la_max + L - 2;
  const int n_chunks = (amax + BNW_FLUSH - 1) / BNW_FLUSH;
  int q = 0;
  int flush_at = BNW_FLUSH + L - 2;              // the super-step of chunk q
  int ring_i = l == 0 ? 0 : R - l;               // (s - l) mod R
  for (int s = 0; s <= s_end; ++s) {
    const int i = s - l;
    const bool act = live && i >= 0 && i < la;
    // the I state entering part 2l: lane l - 1's after row i
    float i0 = __shfl_up_sync(BNW_FULL, i_out, 1);
    if (l == 0) i0 = UT_NEG;
    BnwRow r;
    int k_lb = 0, own = -1;
    if (act) {
      r.jbase = dlo + i - la;
      r.kstart = r.jbase < 0 ? -r.jbase : 0;
      r.kend = lb - r.jbase < bw ? lb - r.jbase : bw;
      r.ca = A[i];
      r.sm = r.ca < 4 ? match : 0.0f;
      r.sx = r.ca < 4 ? mismatch : 0.0f;
      r.oa = i == 0 ? l_open_a : open_a;
      r.ea = i == 0 ? l_ext_a : ext_a;
      r.trow = ring + ring_i * row_bytes;
      k_lb = lb - dlo - i + la;
      own = min(k_lb, n_slots - 1) / CV;         // the part carrying Drow[LB]
      if (own == 2 * l) {
        dlb = bnw_chain<CV>(M0, k0, k_lb, bw, dlb, gaps, r, W);
        if (i == la - 1) dlb_out[p] = dlb;
      }
      bnw_cells<CV>(M0, D0, lt0, lt1[0], k0, D1[0], i0, r, gaps, W);
      if (i == la - 1) bnw_mlast<CV>(M0, k0, r.kend, W,
                                     mlast + (size_t)p * W);
    }
    // part 2l + 1: lane l + 1's first D slot and its Drow[LB], both as
    // its part 2l + 2 of row i - 1 left them just now
    float up = __shfl_down_sync(BNW_FULL, D0[0], 1);
    const float dlb_right = __shfl_down_sync(BNW_FULL, dlb, 1);
    int next = __shfl_down_sync(BNW_FULL, lt0[0], 1);
    if (l == L - 1) {
      up = UT_NEG;                               // slot 2 L CV: never written
      if (act) next = B[min(r.jbase + n_slots - 1, bmax - 1)];
    }
    if (act) {
      if (own == 2 * l + 1) {
        const int own_prev = min(k_lb + 1, n_slots - 1) / CV;
        const float prev = own_prev == 2 * l + 2 ? dlb_right : dlb;
        dlb = bnw_chain<CV>(M1, k1, k_lb, bw, prev, gaps, r, W);
        if (i == la - 1) dlb_out[p] = dlb;
      }
      bnw_cells<CV>(M1, D1, lt1, next, k1, up, i0, r, gaps, W);
      i_out = i0;
      if (i == la - 1) bnw_mlast<CV>(M1, k1, r.kend, W,
                                     mlast + (size_t)p * W);
    }
    // rows q * BNW_FLUSH .. + BNW_FLUSH - 1 are done once lane L - 1 has
    // done the last of them
    if (tb && q < n_chunks && s == flush_at) {
      __syncwarp();
      bnw_flush(q, lane, ring_w, R, G, p0, n_pairs, amax, W, la, L, tb);
      __syncwarp();
      ++q;
      flush_at += BNW_FLUSH;
    }
    ring_i = ring_i + 1 == R ? 0 : ring_i + 1;
  }
  __syncwarp();
  for (; tb && q < n_chunks; ++q)
    bnw_flush(q, lane, ring_w, R, G, p0, n_pairs, amax, W, la, L, tb);
}

__device__ __forceinline__ int bnc_lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return (int)v;
}

__device__ __forceinline__ void bnc_bulk(uint32_t dst, const void* src,
                                         int bytes, uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ bool bnc_try_wait(uint32_t mbar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(mbar), "r"(parity) : "memory");
  return ok != 0;
}

// One warp (a block) for G pairs p0 .. p0 + G - 1: lane g chases pair
// p0 + g; R rows a window, `slot` bytes a window's slot
// (banded_nw_chase_geometry).  Shared memory: the slots' mbarriers (with
// a traceback), each pair's ring of BNC_SLOTS slots, then the scratch
// area: mlast rows and the final row's bits while the final row runs, the
// packed path codes after.
__global__ void __launch_bounds__(32) banded_nw_chase_kernel(
    const uint8_t* __restrict__ tb, int amax,
    const float* __restrict__ mlast, int W, const float* __restrict__ dlb,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const float* __restrict__ gp, int n_pairs,
    float* __restrict__ scores, uint8_t* __restrict__ states,
    uint8_t* __restrict__ tblast, uint8_t* __restrict__ ops, int stride,
    int G, int R, int slot) {
  extern __shared__ __align__(16) uint8_t bnc_smem[];
  const int lane = threadIdx.x, g = lane;
  const long long p0 = (long long)blockIdx.x * G;
  const int n_live = (int)min((long long)G, n_pairs - p0);
  const bool chaser = g < n_live;
  const long long p = p0 + (chaser ? g : 0);
  const int la = la_v[p], lb = lb_v[p], dlo = dlo_v[p], bw = bw_v[p];
  const float r_open_a = gp[GP_R_OPEN_A], r_ext_a = gp[GP_R_EXT_A];
  const int RB = W + 1;                       // bytes of a traceback row
  const int head = tb != nullptr ? (G * BNC_SLOTS * 8 + 15) & ~15 : 0;
  const int mine = chaser ? g : 0;            // the lane's ring and mbarriers
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(bnc_smem);
  const uint32_t ring_s = smem_s + (uint32_t)(head + mine * BNC_SLOTS * slot);
  uint8_t* scratch = bnc_smem + head + (size_t)G * BNC_SLOTS * slot;

  // window e of a pair: its rows hi = la - 1 - e R down to lo, one bulk
  // copy (the TMA) into slot e % BNC_SLOTS from the 16-byte boundary at or
  // below the first row, issued by the chasing lane, completing on the
  // slot's mbarrier (phase e / BNC_SLOTS); the few bytes of a window that
  // reach past a 16-byte boundary beyond tb's end come by plain loads
  const uint32_t mbar0 = smem_s + (uint32_t)(mine * BNC_SLOTS * 8);
  const bool copies = chaser && tb != nullptr;
  if (copies)
    for (int q = 0; q < BNC_SLOTS; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(mbar0 + 8 * q));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  const uint8_t* tb_end = tb + (size_t)n_pairs * amax * RB;
  auto issue = [&](int e) {
    const int hi = la - 1 - e * R;
    if (!copies || hi < 0) return;
    const int lo = hi - R + 1 > 0 ? hi - R + 1 : 0;
    const uint8_t* gs = tb + ((size_t)p * amax + lo) * RB;
    const uint8_t* ga = (const uint8_t*)((uintptr_t)gs & ~(uintptr_t)15);
    const long long want = (gs - ga) + (long long)(hi - lo + 1) * RB;
    const long long room = tb_end - ga;
    long long bytes = (want + 15) & ~15LL;
    if (bytes > room) bytes = room & ~15LL;
    const uint32_t dst = ring_s + (uint32_t)((e % BNC_SLOTS) * slot);
    const uint32_t mbar = mbar0 + 8 * (e % BNC_SLOTS);
    for (long long x = bytes; x < want; ++x)
      asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(dst + (uint32_t)x),
                   "r"((uint32_t)ga[x]));
    // the slot was last read through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(mbar), "r"((int)bytes) : "memory");
    if (bytes > 0) bnc_bulk(dst, ga, (int)bytes, mbar);
  };
  auto landed = [&](int e) {         // wait for window e
    if (copies && la - 1 - e * R >= 0)
      while (!bnc_try_wait(mbar0 + 8 * (e % BNC_SLOTS),
                           (uint32_t)((e / BNC_SLOTS) & 1))) {
      }
  };
  for (int e = 0; e < BNC_SLOTS - 1; ++e) issue(e);

  // final DPI row (i = la) over the band of row la-1, cell k at column
  // j = dlo - 1 + k up to lb - 1 (Mrow[startj-1] is NEG), overlapping the
  // first copies: the warp stages its pairs' mlast rows in shared memory,
  // coalesced, and each chasing lane runs its pair's recurrence in order
  float* sML = (float*)scratch;
  uint8_t* sTL = scratch + (size_t)G * W * sizeof(float);
  const long long n_ml = (long long)n_live * W;
  for (long long x = lane; x < n_ml; x += 32) sML[x] = mlast[p0 * W + x];
  __syncwarp();
  int st = OP_M;
  int jstar = -1;           // the final row's last column whose bit is set
  if (chaser) {
    const float* ML = sML + (size_t)g * W;
    uint8_t* TL = sTL + (size_t)g * W;
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
          jstar = dlo - 1 + k;
        }
      }
      TL[k] = bit;
    }
    float score = ML[lb - dlo];                // M(la-1, lb-1)
    const float fin_d = dlb[p];
    if (fin_d > score) {
      score = fin_d;
      st = OP_D;
    }
    if (i1 > score) {
      score = i1;
      st = OP_I;
    }
    scores[p] = score;
    states[p] = (uint8_t)st;
  }
  __syncwarp();
  for (long long x = lane; x < n_ml; x += 32) tblast[p0 * W + x] = sTL[x];
  if (tb == nullptr) return;

  // the path codes of pair g go to scratch row g, every byte OP_PAD until
  // written, and out to ops as one contiguous run at the end
  __syncwarp();
  const int n_ops = n_live * stride;
  for (int x = lane; x < (n_ops + 3) >> 2; x += 32)
    ((uint32_t*)scratch)[x] = 0xffffffffu;
  __syncwarp();
  uint8_t* O = scratch + (size_t)g * stride;
  const int n_max = 4 * stride;
  int i = la, j = lb, n = 0;
  unsigned acc = 0;
  auto alive = [&]() {
    return chaser && (i > 0 || j > 0) && i >= 0 && j >= 0 && n < n_max;
  };
  auto emit = [&]() {
    acc |= (unsigned)st << (2 * (n & 3));
    if ((n & 3) == 3) {
      O[n >> 2] = (uint8_t)acc;
      acc = 0;
    }
    ++n;
  };
  // the next state from the landing cell's bits, as 2-bit tables of the
  // 16 bit patterns: M -> D on TB_DM, else I on TB_IM, else M; D -> M on
  // TB_MD; I -> M on TB_MI
  const uint32_t next_m = 0x64646464u, next_d = 0x00550055u,
                 next_i = 0x0000aaaau;
  int e_end = 0;
  for (int e = 0;; ++e) {
    e_end = e;
    __syncwarp();                    // window e - 1 is read no more
    issue(e + BNC_SLOTS - 1);        // into its slot
    landed(e);
    __syncwarp();
    const int hi = la - 1 - e * R;
    const int lo = hi - R + 1 > 0 ? hi - R + 1 : 0;
    const uintptr_t gs = (uintptr_t)(tb + ((size_t)p * amax + lo) * RB);
    // row ri of window e at shared address sb + ri * RB
    const uint32_t sb = ring_s + (uint32_t)((e % BNC_SLOTS) * slot +
                                            (int)(gs & 15) - lo * RB);
    while (alive()) {
      if (i > lo && j > 0 && i < la && j < lb) {
        // interior: every landing cell has lo <= ri < la and 0 <= rj < lb,
        // so its bits are its byte inside the band, TB_IM at k == -1,
        // else 0; k and the row move by fixed steps a state
        int k = j - i + la - dlo;    // band cell of (i - 1, j - 1)
        uint32_t row = sb + (uint32_t)(i * RB);
        do {
          emit();
          const bool sd = st == OP_D, si = st == OP_I;
          const uint32_t tbl = st == OP_M ? next_m : (sd ? next_d : next_i);
          k += sd ? 1 : (si ? -1 : 0);
          row -= si ? 0 : RB;
          i -= !si;
          j -= !sd;
          int bits;
          if ((unsigned)k < (unsigned)bw)
            bits = bnc_lds(row + k);
          else
            bits = k == -1 ? UT_TB_IM : 0;
          st = (tbl >> (2 * bits)) & 3;
        } while (i > lo && j > 0 && i < la && j < lb && n < n_max);
        continue;
      }
      // the cell whose bits decide the next state is where the move lands
      const int ri = st == OP_I ? i : i - 1;
      const int rj = st == OP_D ? j : j - 1;
      const bool in_tb = ri >= 0 && rj >= 0 && ri < la;
      if (in_tb && ri < lo) break;   // in window e + 1
      emit();
      int bits = 0;
      if (in_tb) {
        const uint32_t row = sb + (uint32_t)(ri * RB);
        const int k = rj - (dlo + ri - la);
        if (rj == lb)
          bits = bnc_lds(row + W);
        else if (k == -1)
          bits = UT_TB_IM;     // the reference's marker TB[i][startj-1]
        else if (k >= 0 && k < bw)
          bits = bnc_lds(row + k);
      } else if (ri == la && rj >= 0) {
        // the final DPI row, read leftwards from lb - 1 in state I only
        bits = rj == jstar ? UT_TB_MI : 0;
      }
      st = ((st == OP_M ? next_m : (st == OP_D ? next_d : next_i)) >>
            (2 * bits)) & 3;
      i = ri;
      j = rj;
    }
    if (!__any_sync(BNW_FULL, alive())) break;
  }
  if (chaser && (n & 3)) {
    for (int r = n & 3; r < 4; ++r) acc |= (unsigned)OP_PAD << (2 * r);
    O[n >> 2] = (uint8_t)acc;
  }
  __syncwarp();
  for (int x = lane; x < n_ops; x += 32) ops[p0 * stride + x] = scratch[x];
  // copies still in flight (windows past a path's end) land before exit
  for (int q = 1; q < BNC_SLOTS; ++q) landed(e_end + q);
}

template <int CV>
static int bnw_fwd_launch(
    const void* a_let, const void* b_let, int amax, int bmax,
    const void* la, const void* lb, const void* dlo, const void* bw,
    const void* gp, float match, float mismatch, int n_pairs, int W,
    void* tb, void* mlast, void* dlb, cudaStream_t stream) {
  const int L = (W + 2 * CV - 1) / (2 * CV);
  if (L > 32) return (int)cudaErrorInvalidValue;
  const int G = 32 / L;
  const int R = (BNW_FLUSH + L - 1 + BNW_FLUSH - 1) / BNW_FLUSH * BNW_FLUSH;
  const size_t smem = (size_t)BNW_WARPS * G * R * (W + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_nw_fwd_kernel<CV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long warps = ((long long)n_pairs + G - 1) / G;
  const long long blocks = (warps + BNW_WARPS - 1) / BNW_WARPS;
  banded_nw_fwd_kernel<CV><<<(unsigned)blocks, 32 * BNW_WARPS, smem,
                             stream>>>(
      (const uint8_t*)a_let, (const uint8_t*)b_let, amax, bmax,
      (const int*)la, (const int*)lb, (const int*)dlo, (const int*)bw,
      (const float*)gp, match, mismatch, n_pairs, W, L, G, R,
      (uint8_t*)tb, (float*)mlast, (float*)dlb);
  return (int)cudaGetLastError();
}

extern "C" int banded_nw_fwd_launch(
    const void* a_let, const void* b_let, int amax, int bmax,
    const void* la, const void* lb, const void* dlo, const void* bw,
    const void* gp, float match, float mismatch, int n_pairs, int W,
    void* tb, void* mlast, void* dlb, void* stream) {
  if (n_pairs <= 0) return 0;
  if (W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (banded_nw_fwd_cells(W) == 6)
    return bnw_fwd_launch<6>(a_let, b_let, amax, bmax, la, lb, dlo, bw, gp,
                             match, mismatch, n_pairs, W, tb, mlast, dlb, s);
  return bnw_fwd_launch<4>(a_let, b_let, amax, bmax, la, lb, dlo, bw, gp,
                           match, mismatch, n_pairs, W, tb, mlast, dlb, s);
}

// banded_nw_chase's launch geometry: the most pairs a warp, G (a power
// of two), that leaves at least BNC_MIN_WARPS warps and fits the shared
// memory; R rows a window and the slot of a window.  Returns the shared
// memory of a block (one warp), or 0 if one pair does not fit.
extern "C" int banded_nw_chase_geometry(int n_pairs, int W, int stride,
                                        int with_tb, int* out) {
  const int RB = W + 1;
  for (int G = 32; G >= 1; G >>= 1) {
    if (G > 1 && (n_pairs + G - 1) / G < BNC_MIN_WARPS) continue;
    int slot = 0, R = 0;
    if (with_tb) {
      int room = BNC_RING_WARP / (BNC_SLOTS * G);
      room = (room < BNC_SLOT_MAX ? room : BNC_SLOT_MAX) & ~15;
      R = (room - 15) / RB;            // up to 15 bytes before the first row
      if (R < 2) R = 2;
      slot = (R * RB + 15 + 15) & ~15;
    }
    long long scratch = (long long)G * W * (sizeof(float) + 1);
    if (with_tb && (long long)G * stride > scratch)
      scratch = (long long)G * stride;
    scratch = (scratch + 15) & ~15LL;
    const long long head = with_tb ? (G * BNC_SLOTS * 8 + 15) & ~15 : 0;
    const long long smem = head + (long long)G * BNC_SLOTS * slot + scratch;
    if (smem <= BNC_SMEM_MAX) {
      out[0] = G;
      out[1] = R;
      out[2] = slot;
      return (int)smem;
    }
  }
  return 0;
}

extern "C" int banded_nw_chase_launch(
    const void* tb, int amax, const void* mlast, int W, const void* dlb,
    const void* la, const void* lb, const void* dlo, const void* bw,
    const void* gp, int n_pairs, void* scores, void* states, void* tblast,
    void* ops, int stride, void* stream) {
  if (n_pairs <= 0) return 0;
  int geo[3];
  const int smem =
      banded_nw_chase_geometry(n_pairs, W, stride, tb != nullptr, geo);
  if (smem <= 0 || ((uintptr_t)tb & 15)) return (int)cudaErrorInvalidValue;
  // as much of the SM's memory as shared memory as the blocks can use
  cudaError_t e = cudaFuncSetAttribute(
      banded_nw_chase_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(banded_nw_chase_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)n_pairs + geo[0] - 1) / geo[0];
  banded_nw_chase_kernel<<<(unsigned)blocks, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, amax, (const float*)mlast, W, (const float*)dlb,
      (const int*)la, (const int*)lb, (const int*)dlo, (const int*)bw,
      (const float*)gp, n_pairs, (float*)scores, (uint8_t*)states,
      (uint8_t*)tblast, (uint8_t*)ops, stride, geo[0], geo[1], geo[2]);
  return (int)cudaGetLastError();
}
