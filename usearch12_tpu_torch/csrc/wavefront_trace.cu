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
// Paths come out as 2-bit codes (1 = M, 2 = D, 3 = I, from the end of the
// alignment back to its start, 4 per byte from the low bits up) and a
// length; each row of `ops` is a multiple of 16 bytes.
//
// What bounds it on the card: one dependent read of the traceback per
// alignment column, la + lb steps per pair, so the latency of a step, not
// bandwidth.  Two variants, chosen by the wrapper (ops/wavefront_trace.py)
// at launch:
//
// - the warp kernel (wavefront_trace_warp_kernel): one warp per pair,
//   TR_WARPS pairs a block, pairs longest first.  Every read of the chase
//   lies on an anti-diagonal below the current one (a step lowers
//   t = i + j by 2 from M, by 1 from D or I, and the Drow[LB] bits of row
//   ri sit on t = ri + lb), and anti-diagonal t is the run of nb bytes at
//   tb_off + t * nb, so the chase reads one contiguous byte range from
//   its top down.  The warp copies it into a ring of TR_SLOTS windows of W
//   anti-diagonals in shared memory with 16-byte cp.async copies, the next
//   TR_SLOTS - 1 windows in flight while it chases the current one.  Its
//   lanes chase in lockstep (each computes the same step from the same
//   shared byte, a broadcast read), so the window changes, the copies and
//   the code stores need no divergence; a step is a shared-memory load and
//   the state logic instead of a device-memory latency.  Past the final
//   row and the Drow[LB] column (the start of a path), t and k move by
//   fixed steps and the next state comes from a 2-bit table.  The final
//   DPI row: the warp reads mlast 32 values at a time, coalesced, and runs
//   the recurrence in order with the values passed by shuffle.  Codes
//   gather 16 to a 32-bit word, lane q keeps the q-th word of each 512
//   steps, and the warp writes them as one 128-byte store.
// - the thread kernel (wavefront_trace_thread_kernel): one thread per
//   pair, each step one dependent byte load from device memory.  With
//   tens of thousands of pairs of similar length in flight those
//   latencies overlap, where the warp kernel's one warp instruction per
//   pair step costs more issue slots; the wrapper takes it where a
//   launch's summed steps pass WARP_MAX_LOAD times its longest pair's.
//
// Build: see usearch12_tpu_torch/_build.py (sm_90a, -fmad=false).

#include "wavefront.cuh"

#define FULL_MASK 0xffffffffu
#define TR_THREADS 128     // thread kernel: pairs a block
#define TR_WARPS 4         // warp kernel: pairs (warps) a block
#define TR_SLOTS 4         // windows in each warp's ring
#define TR_SLOT_MAX 8192   // bytes of one window, at most
#define TR_WIN 32          // anti-diagonals of one window, at most as
                           // the slot size is set from the widest band

enum { ST_M = 0, ST_D = 1, ST_I = 2 };

// The state after a move into a cell whose traceback bits are `bits`.
__device__ __forceinline__ int tr_next(int st, int bits) {
  if (st == ST_M)
    return bits & UT_TB_DM ? ST_D : (bits & UT_TB_IM ? ST_I : ST_M);
  if (st == ST_D) return bits & UT_TB_MD ? ST_M : ST_D;
  return bits & UT_TB_MI ? ST_M : ST_I;
}

// The bits of cell (ri, rj) of a pair; byte(t, q) returns byte q of
// anti-diagonal t of the pair's traceback, called with t falling.
template <typename Byte>
__device__ __forceinline__ int tr_bits(int ri, int rj, int la, int lb,
                                       int dlo, int bw, int nlane, int jstar,
                                       Byte byte) {
  if (ri < 0 || rj < 0) return 0;
  if (ri == la) return rj == jstar ? UT_TB_MI : 0;
  const int k = la - ri + rj - dlo;    // D* - dlo
  const int t = ri + rj;
  if (rj == lb)
    return (k >> 1) < nlane ? (byte(t, k >> 2) >> ((k >> 1 & 1) * 4)) & 15
                            : UT_TB_MD;
  if (k == -1) return UT_TB_IM;
  if (k >= 0 && k < bw) return (byte(t, k >> 2) >> ((k >> 1 & 1) * 4)) & 15;
  return 0;
}

// Score and start state at (la, lb).
__device__ __forceinline__ float tr_start(const float* ML, int lb, float fin_d,
                                          float i1, int* st) {
  float score = ML[lb - 1];
  *st = ST_M;
  if (fin_d > score) {
    score = fin_d;
    *st = ST_D;
  }
  if (i1 > score) {
    score = i1;
    *st = ST_I;
  }
  return score;
}

__device__ __forceinline__ int tr_startj(int dlo, int lb) {
  // first column of the band of row la-1 (DiagBox::GetRange_j)
  int startj = dlo - 1 >= 0 ? dlo - 1 : 0;
  return startj >= lb ? lb - 1 : startj;
}

__global__ void wavefront_trace_thread_kernel(
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

__device__ __forceinline__ int tr_lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return (int)v;
}

__device__ __forceinline__ void tr_cp16(uint32_t dst, const void* src,
                                        int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__global__ void __launch_bounds__(TR_WARPS * 32) wavefront_trace_warp_kernel(
    const uint8_t* __restrict__ tb, long long tb_bytes,
    const long long* __restrict__ tb_off, const int* __restrict__ order,
    const float* __restrict__ mlast, int bmax,
    const float* __restrict__ dlb,
    const int* __restrict__ la_v, const int* __restrict__ lb_v,
    const int* __restrict__ dlo_v, const int* __restrict__ bw_v,
    const float* __restrict__ gp, int n_pairs, int slot,
    float* __restrict__ scores, uint8_t* __restrict__ ops, int ops_stride,
    int* __restrict__ lens) {
  extern __shared__ __align__(16) uint8_t tr_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * TR_WARPS + warp;
  if (g >= n_pairs) return;                      // the whole warp
  const int p = order[g];
  const int la = la_v[p], lb = lb_v[p], dlo = dlo_v[p], bw = bw_v[p];
  const int nlane = ut_nlane(bw);
  const int nb = ut_nbytes(bw);
  const float r_open_a = gp[GP_R_OPEN_A], r_ext_a = gp[GP_R_EXT_A];
  const float* ML = mlast + (size_t)p * bmax;

  // the ring: window k holds anti-diagonals lo_k .. top - k * W in slot
  // k % TR_SLOTS, from the 16-byte boundary at or below its first byte
  const uint8_t* T = tb + tb_off[p];
  const uint8_t* tb_end = tb + tb_bytes;
  const int top = la + lb - 1;
  const int W = (slot - 16) / nb;                // >= 2 (the wrapper's check)
  uint8_t* ring = tr_smem + (size_t)warp * TR_SLOTS * slot;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  auto issue = [&](int k) {                      // copies of window k
    const int hi = top - k * W;
    if (hi >= 0) {
      const int lo = hi - W + 1 > 0 ? hi - W + 1 : 0;
      const uint8_t* gs = T + (size_t)lo * nb;
      const uint8_t* ga = (const uint8_t*)((uintptr_t)gs & ~(uintptr_t)15);
      const int n16 = (int)((gs - ga) + (size_t)(hi - lo + 1) * nb + 15) >> 4;
      const uint32_t dst = ring_s + (uint32_t)((k % TR_SLOTS) * slot);
      for (int c = lane; c < n16; c += 32) {
        const uint8_t* src = ga + 16 * c;
        const long long left = tb_end - src;
        const int n = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
        tr_cp16(dst + 16 * c, n ? src : tb, n);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int k = 0; k < TR_SLOTS - 1; ++k) issue(k);

  // final DPI row, overlapping the first copies; every lane runs the
  // same recurrence on values passed by shuffle, without branches
  const int startj = tr_startj(dlo, lb);
  float i1 = UT_NEG;
  int jstar = -1;
  for (int j0 = startj; j0 < lb; j0 += 32) {
    const int jj = j0 + lane;
    const float v = jj > startj && jj < lb ? ML[jj - 1] : UT_NEG;
    const int n = lb - j0;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const float mi = __shfl_sync(FULL_MASK, v, q) + r_open_a;
      const float ie = i1 + r_ext_a;
      const bool take = q < n && mi > ie;
      i1 = q < n ? (take ? mi : ie) : i1;
      jstar = take ? j0 + q : jstar;
    }
  }
  int st;
  const float score = tr_start(ML, lb, dlb[p], i1, &st);

  // window `cur` holds anti-diagonal t >= cur_lo at shared address
  // sb + t * nb
  int cur = -1, cur_lo = top + 1;
  uint32_t sb = ring_s;
  auto advance = [&]() {
    ++cur;
    __syncwarp();                      // window cur - 1 is read no more
    issue(cur + TR_SLOTS - 1);         // into its slot
    asm volatile("cp.async.wait_group %0;\n" ::"n"(TR_SLOTS - 1));
    __syncwarp();                      // every lane's copies have landed
    const int hi = top - cur * W;
    cur_lo = hi - W + 1 > 0 ? hi - W + 1 : 0;
    const uintptr_t gs = (uintptr_t)(T + (size_t)cur_lo * nb);
    sb = ring_s + (uint32_t)((cur % TR_SLOTS) * slot + (int)(gs & 15) -
                             cur_lo * nb);
  };
  auto byte = [&](int t, int q) {
    while (t < cur_lo) advance();
    return tr_lds(sb + t * nb + q);
  };

  // codes: every lane shifts the same 16-step word into `acc`; lane q of
  // a 512-step run keeps its q-th word and the warp stores the run's 32
  uint32_t* O = (uint32_t*)(ops + (size_t)p * ops_stride);
  uint32_t acc = 0, word = 0;
  int i = la, j = lb, n = 0;
  auto emit = [&]() {
    acc = (acc >> 2) | (uint32_t)(st + 1) << 30;
    if ((++n & 15) == 0) {
      if (lane == (((n >> 4) - 1) & 31)) word = acc;
      if ((n & 511) == 0) O[((n >> 9) - 1) * 32 + lane] = word;
    }
  };
  auto step = [&]() {                  // any cell
    emit();
    const int ri = st == ST_I ? i : i - 1;
    const int rj = st == ST_D ? j : j - 1;
    st = tr_next(st, tr_bits(ri, rj, la, lb, dlo, bw, nlane, jstar, byte));
    i = ri;
    j = rj;
  };
  auto alive = [&]() { return (i > 0 || j > 0) && i >= 0 && j >= 0; };
  // the final row and the Drow[LB] column: only at the start
  while (alive() && (i == la || j == lb)) step();
  // interior: every landing cell has 0 <= ri < la and 0 <= rj < lb, so
  // its bits are its nibble inside the band, TB_IM at k == -1, else 0;
  // t = i + j and k = la - i + j - dlo move by fixed steps, and the next
  // state comes from a 2-bit table of the 16 bit patterns
  const uint32_t next_m = 0x64646464u;   // DM -> D, else IM -> I, else M
  const uint32_t next_d = 0x00550055u;   // MD -> M, else D
  const uint32_t next_i = 0x0000aaaau;   // MI -> M, else I
  int t = i + j, k = la - i + j - dlo;
  while (i > 0 && j > 0) {
    emit();
    const bool sm = st == ST_M, sd = st == ST_D, si = st == ST_I;
    const uint32_t tbl = sm ? next_m : (sd ? next_d : next_i);
    t -= sm ? 2 : 1;
    k += sd ? 1 : (si ? -1 : 0);
    i -= !si;
    j -= !sd;
    int bits;
    if ((unsigned)k < (unsigned)bw && t >= cur_lo)      // the common case
      bits = (tr_lds(sb + t * nb + (k >> 2)) >> ((k << 1) & 4)) & 15;
    else if ((unsigned)k < (unsigned)bw)
      bits = (byte(t, k >> 2) >> ((k << 1) & 4)) & 15;
    else
      bits = k == -1 ? UT_TB_IM : 0;
    st = (tbl >> (2 * bits)) & 3;
  }
  while (alive()) step();
  if ((n & 15) && lane == ((n >> 4) & 31)) word = acc >> (2 * (16 - (n & 15)));
  const int w = (n >> 9) * 32 + lane;
  if ((n & 511) && w < (n + 15) >> 4) O[w] = word;
  if (lane == 0) {
    scores[p] = score;
    lens[p] = n;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Shared memory of one warp kernel block whose widest pair has nb bytes
// an anti-diagonal; 0 if nb is too wide for windows of two anti-diagonals.
extern "C" int wavefront_trace_smem(int nb_max) {
  int slot = TR_WIN * nb_max + 16;
  slot = ((slot < TR_SLOT_MAX ? slot : TR_SLOT_MAX) + 15) & ~15;
  if ((slot - 16) / nb_max < 2) return 0;
  return TR_WARPS * TR_SLOTS * slot;
}

// The version of wavefront_trace_launch's arguments: 2 since the warp
// kernel (tb_bytes, order, nb_max, warp); the one-thread-a-pair entry
// point before it had no version.
extern "C" int wavefront_trace_interface(void) { return 2; }

extern "C" int wavefront_trace_launch(
    const void* tb, long long tb_bytes, const void* tb_off, const void* order,
    const void* mlast, int bmax, const void* dlb, const void* la,
    const void* lb, const void* dlo, const void* bw, const void* gp,
    int n_pairs, int nb_max, int warp, void* scores, void* ops,
    int ops_stride, void* lens, void* stream) {
  if (n_pairs <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!warp) {
    const int blocks = (n_pairs + TR_THREADS - 1) / TR_THREADS;
    wavefront_trace_thread_kernel<<<blocks, TR_THREADS, 0, s>>>(
        (const uint8_t*)tb, (const long long*)tb_off, (const float*)mlast,
        bmax, (const float*)dlb, (const int*)la, (const int*)lb,
        (const int*)dlo, (const int*)bw, (const float*)gp, n_pairs,
        (float*)scores, (uint8_t*)ops, ops_stride, (int*)lens);
    return (int)cudaGetLastError();
  }
  const int smem = wavefront_trace_smem(nb_max);
  if (smem <= 0 || (ops_stride & 15) || ((uintptr_t)tb & 15))
    return (int)cudaErrorInvalidValue;
  const int slot = smem / (TR_WARPS * TR_SLOTS);
  cudaError_t e = cudaFuncSetAttribute(
      wavefront_trace_warp_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_pairs + TR_WARPS - 1) / TR_WARPS;
  wavefront_trace_warp_kernel<<<blocks, TR_WARPS * 32, smem, s>>>(
      (const uint8_t*)tb, tb_bytes, (const long long*)tb_off,
      (const int*)order, (const float*)mlast, bmax, (const float*)dlb,
      (const int*)la, (const int*)lb, (const int*)dlo, (const int*)bw,
      (const float*)gp, n_pairs, slot, (float*)scores, (uint8_t*)ops,
      ops_stride, (int*)lens);
  return (int)cudaGetLastError();
}
