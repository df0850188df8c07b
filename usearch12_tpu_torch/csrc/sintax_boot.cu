// SINTAX bootstraps on the card: the pick histogram, and the boot counts
// with the boot winner.
//
// Both replace the JAX device step
// usearch12_tpu/amplicon/sintax_device.py (BootEngine._build.step), which
// ran as XLA ops on the TPU.
//
// sintax_pick_hist (step :125-141).  Job j of a chunk samples m[j] of its
// nuw[j] unique words in each of `boots` boots.  Boot b's k-th pick is
// stream[b * m[j] + k] % max(nuw[j], 1) in uint32, for k < min(m[j],
// mmax) with mmax = stream_len / boots, the position clipped to the
// stream as the JAX step clips it; P[j][b][w] counts how often
// slot w was picked.  The counts are written in the product's type: int8
// while m <= 127 (the JAX step's int8_ok rule), float16 up to 2048,
// float32 (the plain route, and above 2048, where the wrapper splits the
// counts into float16 parts).  Blocks count tiles of P in shared memory
// (design below, at the kernel).
//
// sintax_boot_count_select (step :143-164): U = P @ mq over each job's
// live word slots (mq the incidence rows of its words, ids clipped to the
// matrix, zero at slots >= nuw), top = max_t U, m_ties = the number of
// targets at top, rsel = rr % max(m_ties, 1) in uint32, and the winner,
// the rsel-th tie in ascending target order.  U never reaches device
// memory.  Two kernels:
//
// - sintax_boot_count_kernel, counting.  Work items are (boot group of
//   BC_MB boots, job, tile of BC_NT targets); each of a few persistent
//   blocks (one a SM) takes a contiguous run of them.  For an item it
//   streams chunks of BC_KC word slots through a ring of BC_STAGES stages
//   in shared memory with cp.async: the boot group's P columns and the
//   incidence rows of the chunk's words, read from w_mat (V, T) by word id
//   (16-byte copies; rows past nuw and targets past T zero-filled).
//   Sixteen warps compute the (BC_MB x BC_NT) U tile on the tensor cores,
//   each 32 targets by 64 or 48 boots: mma.sync m16n8k32 s8 x s8 -> s32,
//   or for P in float16 m16n8k16 f16 x f16 -> f32 with the incidence
//   bytes converted in registers (every partial sum an integer below
//   2^24, so exact).  P is the A operand (row-major, by ldmatrix).  The
//   incidence is word-major while the B operand wants each target's words
//   contiguous; the warp relabels its targets so that a thread's four
//   n-tiles are four adjacent bytes of a row, reads them with one 32-bit
//   load a row (in an order free of bank conflicts) and transposes 4 x 4
//   bytes with byte permutes.  At the item's last chunk the tile's (max,
//   count at max) of every boot row is reduced in registers and across
//   warps and written as one int2: (cq, boots, n_tiles) partials, 8 bytes
//   for each BC_NT targets of U.
// - sintax_boot_pick_kernel, selection, one warp per row (j, b): it merges
//   the row's partials into (top, m_ties) (the pass 1 rule of the select
//   kernel it replaces), takes rsel, finds by a warp scan in ascending tile
//   order the tile that holds the rsel-th tie, recomputes U on that one
//   tile of that one row (only the slots where P is non-zero, at most m),
//   and finds the tie in it.
//
// What bounds it on the card: the live incidence rows, read once per job
// (nuw x T bytes; 1.8 GB for a chunk of 128 jobs of ~240 words at
// T = 60,000), so device memory; the int8 products (2 x boots x nuw x T
// per job) take a third of that time at the tensor cores' dense rate.
// The route it replaces (a gather, a mask and a cast into a float16
// (cq, uwmax, T) tensor, a library bmm into U, and a select over U) moved
// 3.9 GB of mq and 1.5 GB of U a chunk besides.
//
// Build: see usearch12_tpu_torch/_build.py (sm_90a, one nvcc per source).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#define FULL_MASK 0xffffffffu

enum { SB_FLOAT32 = 0, SB_FLOAT16 = 1, SB_INT8 = 2 };

// sintax_pick_hist.  What bounds it: writing P (cq x boots x uwmax
// counts, 3.3 MB a chunk of 128 jobs x 100 boots x 256 slots in int8)
// and reading the stream; the picks themselves are few (m a boot).  One
// block counts a tile of P in shared memory: a group of boots of one job
// over all its slots, or, where one row of counters does not fit
// PH_SMEM_BYTES, one boot over a range of slots (it reads all the boot's
// picks and counts those in its range).  The groups are cut so that a
// chunk gives at least PH_MIN_BLOCKS blocks.  Counters are packed into
// 32-bit words of shared memory and bumped with shared atomics: four
// 8-bit counters a word for int8 P (a count never passes m <= 127, so no
// carry crosses a byte), two 16-bit ones for float16 (counts <= 2048),
// one for float32.  Boot b's picks are stream[b * m + k], so the picks of
// boots b0 .. b1 are one run of the stream, read coalesced.  The tile's
// rows are one contiguous run of P (all slots, or one boot), written from
// the counters with 16-byte stores (scalar stores up to the first 16-byte
// boundary and after the last).
#define PH_THREADS 256
#define PH_SMEM_BYTES (32 * 1024)       // counters of one block
#define PH_MIN_BLOCKS (4 * 132)         // four blocks for each SM

struct PhPlan {
  int nb;       // boots a block
  int groups;   // boot groups a job
  int nw;       // slots a block
  int tiles;    // slot tiles a row
};

static PhPlan ph_plan(int boots, int cq, int uwmax, int cbytes) {
  PhPlan p;
  const long long row = (long long)uwmax * cbytes;
  if (row <= PH_SMEM_BYTES) {
    p.nw = uwmax;
    p.tiles = 1;
    const int rows_fit = (int)(PH_SMEM_BYTES / row);
    int groups = (boots + rows_fit - 1) / rows_fit;
    const int want = (PH_MIN_BLOCKS + cq - 1) / cq;
    if (groups < want) groups = want < boots ? want : boots;
    p.nb = (boots + groups - 1) / groups;
    p.groups = (boots + p.nb - 1) / p.nb;
  } else {
    p.nb = 1;
    p.groups = boots;
    p.nw = PH_SMEM_BYTES / cbytes;
    p.tiles = (uwmax + p.nw - 1) / p.nw;
  }
  return p;
}

__device__ inline uint32_t ph_bits(int8_t*, uint32_t c) { return c & 0xff; }
__device__ inline uint32_t ph_bits(__half*, uint32_t c) {
  return __half_as_ushort(__uint2half_rn(c));
}
__device__ inline uint32_t ph_bits(float*, uint32_t c) {
  return __float_as_uint((float)c);
}

template <typename T, int CB>
__global__ void __launch_bounds__(PH_THREADS) sintax_pick_hist_kernel(
    const int* __restrict__ nuw, const int* __restrict__ m,
    const uint32_t* __restrict__ stream, int stream_len, int boots,
    int uwmax, PhPlan plan, T* __restrict__ P) {
  extern __shared__ uint32_t cnt[];
  constexpr int PER = 32 / CB;                  // counters a word
  constexpr uint32_t MASK = CB == 32 ? 0xffffffffu : (1u << CB) - 1;
  int x = blockIdx.x;
  const int tile = x % plan.tiles;
  x /= plan.tiles;
  const int g = x % plan.groups, j = x / plan.groups;
  const int b0 = g * plan.nb, w0 = tile * plan.nw;
  const int nb = min(plan.nb, boots - b0), nw = min(plan.nw, uwmax - w0);
  const int n_cnt = nb * nw;
  const int n_words = (n_cnt + PER - 1) / PER;
  for (int i = threadIdx.x; i < n_words; i += PH_THREADS) cnt[i] = 0;
  __syncthreads();

  // picks k < min(m, mmax), mmax = stream_len / boots, as the JAX step
  // takes them (its k runs to the stream's mmax)
  const int mj = m[j];
  const int me = min(mj, stream_len / boots);
  const uint32_t n = (uint32_t)max(nuw[j], 1);
  const int total = nb * me;
  for (int idx = threadIdx.x; idx < total; idx += PH_THREADS) {
    const int r = idx / me, k = idx - r * me;
    long long pos = (long long)(b0 + r) * mj + k;
    pos = pos < 0 ? 0 : (pos >= stream_len ? stream_len - 1 : pos);
    const uint32_t w = stream[pos] % n - (uint32_t)w0;
    if (w < (uint32_t)nw) {
      const int e = r * nw + (int)w;
      atomicAdd(&cnt[e / PER], 1u << (CB * (e % PER)));
    }
  }
  __syncthreads();

  // the tile's counts as one contiguous run of P
  T* dst = P + ((size_t)j * boots + b0) * uwmax + w0;
  auto count = [&](int e) -> uint32_t {
    return (cnt[e / PER] >> (CB * (e % PER))) & MASK;
  };
  constexpr int V = 16 / (int)sizeof(T);        // elements a 16-byte store
  int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) / sizeof(T));
  if (head > n_cnt) head = n_cnt;
  const int n_vec = (n_cnt - head) / V;
  for (int e = threadIdx.x; e < head; e += PH_THREADS) {
    const uint32_t bits = ph_bits((T*)nullptr, count(e));
    memcpy(dst + e, &bits, sizeof(T));
  }
  for (int v = threadIdx.x; v < n_vec; v += PH_THREADS) {
    const int e0 = head + v * V;
    uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int byte = q * (int)sizeof(T);
      wd[byte >> 2] |= ph_bits((T*)nullptr, count(e0 + q)) << (8 * (byte & 3));
    }
    *reinterpret_cast<uint4*>(dst + e0) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
  for (int e = head + n_vec * V + threadIdx.x; e < n_cnt; e += PH_THREADS) {
    const uint32_t bits = ph_bits((T*)nullptr, count(e));
    memcpy(dst + e, &bits, sizeof(T));
  }
}

template <typename T, int CB>
static int ph_launch(const void* nuw, const void* m, const void* stream,
                     int stream_len, int boots, int cq, int uwmax, void* P,
                     cudaStream_t s) {
  const PhPlan plan = ph_plan(boots, cq, uwmax, CB / 8);
  const size_t smem =
      ((size_t)plan.nb * plan.nw * (CB / 8) + 3) / 4 * 4;
  const long long blocks = (long long)cq * plan.groups * plan.tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  sintax_pick_hist_kernel<T, CB><<<(int)blocks, PH_THREADS, smem, s>>>(
      (const int*)nuw, (const int*)m, (const uint32_t*)stream, stream_len,
      boots, uwmax, plan, (T*)P);
  return (int)cudaGetLastError();
}

// Slot tiles of a row for P of this type (1 where a row of counters fits
// one block's shared memory).
extern "C" int sintax_pick_hist_tiles(int boots, int cq, int uwmax,
                                      int dtype) {
  const int cbytes = dtype == SB_INT8 ? 1 : (dtype == SB_FLOAT16 ? 2 : 4);
  return ph_plan(boots, cq, uwmax, cbytes).tiles;
}

extern "C" int sintax_pick_hist_launch(
    const void* nuw, const void* m, const void* stream, int stream_len,
    int boots, int cq, int uwmax, int dtype, void* P, void* cuda_stream) {
  if (cq <= 0 || boots <= 0 || uwmax <= 0) return 0;
  if (stream_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  if (dtype == SB_FLOAT16)
    return ph_launch<__half, 16>(nuw, m, stream, stream_len, boots, cq,
                                 uwmax, P, s);
  if (dtype == SB_FLOAT32)
    return ph_launch<float, 32>(nuw, m, stream, stream_len, boots, cq,
                                uwmax, P, s);
  if (dtype == SB_INT8)
    return ph_launch<int8_t, 8>(nuw, m, stream, stream_len, boots, cq,
                                uwmax, P, s);
  return (int)cudaErrorInvalidValue;
}

// ---- sintax_boot_count_select -------------------------------------------

#define BC_WN 8                    // warps along the targets, 32 each
#define BC_WM 2                    // warps along the boots
#define BC_WARPS (BC_WN * BC_WM)
#define BC_THREADS (32 * BC_WARPS)
#define BC_NT (32 * BC_WN)         // targets a tile
#define BC_MT 7                    // m-tiles of 16 boots
#define BC_MTW 4                   // m-tiles of a warp, at most
#define BC_MB (16 * BC_MT)         // boots a group
#define BC_KC 128                  // word slots a chunk
#define BC_STAGES 3
#define BC_INC_LD (BC_NT + 16)     // bytes of a staged incidence row
#define BC_INC_BYTES (BC_KC * BC_INC_LD)

// bytes of a staged P row and of one stage, by the operands' type
__host__ __device__ constexpr int bc_p_ld(bool f16) {
  return BC_KC * (f16 ? 2 : 1) + 16;
}
__host__ __device__ constexpr int bc_stage(bool f16) {
  return BC_MB * bc_p_ld(f16) + BC_INC_BYTES;
}
__host__ __device__ constexpr int bc_smem(bool f16) {
  return BC_STAGES * bc_stage(f16) + BC_WN * BC_MB * (int)sizeof(int2);
}

__device__ __forceinline__ void bc_cp16(uint32_t dst, const void* src,
                                        int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void bc_cp8(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ uint32_t bc_lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Bytes (w[0].b[n], w[1].b[n], w[2].b[n], w[3].b[n]) into o[n]: a 4 x 4
// byte transpose.
__device__ __forceinline__ void bc_transpose(const uint32_t* w, uint32_t* o) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Two int8 values as a half2 (exact).
__device__ __forceinline__ uint32_t bc_h2(uint32_t lo, uint32_t hi, int n) {
  union {
    __half2 h2;
    uint32_t u;
  } x;
  x.h2 = __halves2half2(__int2half_rn((int)(int8_t)(lo >> (8 * n))),
                        __int2half_rn((int)(int8_t)(hi >> (8 * n))));
  return x.u;
}

// (best, cnt) and (ob, oc), each a maximum and its count, merged; no
// branches.
__device__ __forceinline__ void bc_merge(int& best, int& cnt, int ob,
                                         int oc) {
  const int nb = max(best, ob);
  cnt = (best == nb ? cnt : 0) + (ob == nb ? oc : 0);
  best = nb;
}

// A cursor over a block's chunks: item (boot group, job, tile), chunk ks
// of the item's nks.
struct BcCursor {
  int item;
  int ks, nks, j, bg, tile;
};

__device__ __forceinline__ void bc_set(BcCursor& c, int item, int nt, int cq,
                                       const int* nuw) {
  c.item = item;
  c.ks = 0;
  const int jb = item / nt;
  c.tile = item - jb * nt;
  c.bg = jb / cq;
  c.j = jb - c.bg * cq;
  c.nks = max(1, (nuw[c.j] + BC_KC - 1) / BC_KC);
}

__device__ __forceinline__ void bc_next(BcCursor& c, int nt, int cq,
                                        const int* nuw) {
  if (++c.ks == c.nks) bc_set(c, c.item + 1, nt, cq, nuw);
}

// Warp (wm, wn) computes m-tiles wm * BC_MTW .. of the boot group against
// targets wn * 32 .. + 31 of the tile.  Its B fragments come from one
// 32-bit load a row: column g of n-tile n4 stands for target 4 g + n4, so
// a thread's four n-tiles are the four bytes at 4 g of a row, and a 4 x 4
// byte transpose gives each n-tile's four words (int8) or two pairs
// (float16).  The order of the targets in a tile does not matter to its
// (max, count at max).
template <bool F16>
__global__ void __launch_bounds__(BC_THREADS, 1) sintax_boot_count_kernel(
    const uint8_t* __restrict__ P, int boots, int uwmax,
    const int* __restrict__ words, const int* __restrict__ nuw,
    const int8_t* __restrict__ w_mat, long long ld, int V, int T, int cq,
    int nt, int n_items, int2* __restrict__ part) {
  extern __shared__ __align__(16) uint8_t bc_smem_buf[];
  constexpr int ESZ = F16 ? 2 : 1;       // bytes of a P element
  constexpr int PLD = bc_p_ld(F16);
  constexpr int STAGE = bc_stage(F16);
  constexpr int PROW = BC_KC * ESZ;      // bytes of a P row chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / BC_WN, wn = warp % BC_WN;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(bc_smem_buf);
  int2* s_part = (int2*)(bc_smem_buf + BC_STAGES * STAGE);
  // P rows 16-byte aligned: 16-byte copies, else 8-byte ones
  const bool p16 = (uwmax * ESZ) % 16 == 0 && ((uintptr_t)P & 15) == 0;

  const int lo = (int)((long long)n_items * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)n_items * (blockIdx.x + 1) / gridDim.x);
  if (lo >= hi) return;

  BcCursor pc, cc;
  bc_set(pc, lo, nt, cq, nuw);
  cc = pc;
  int pslot = 0;
  auto produce = [&]() {
    if (pc.item < hi) {
      const uint32_t st = smem_s + pslot * STAGE;
      const int nuwj = nuw[pc.j];
      const int k0 = pc.ks * BC_KC;
      const uint8_t* prow = P + ((size_t)pc.j * boots + pc.bg * BC_MB) *
                                    uwmax * ESZ + k0 * ESZ;
      // P: BC_MB rows of PROW bytes, in 16-byte copies where aligned
      const int csz = p16 ? 16 : 8, per_row = PROW / csz;
      for (int c = tid; c < BC_MB * per_row; c += BC_THREADS) {
        const int r = c / per_row, off = (c - r * per_row) * csz;
        int n = 0;
        if (pc.bg * BC_MB + r < boots)
          n = min(max((nuwj - k0) * ESZ - off, 0), csz);
        const uint8_t* src = n ? prow + (size_t)r * uwmax * ESZ + off : P;
        if (p16)
          bc_cp16(st + r * PLD + off, src, n);
        else
          bc_cp8(st + r * PLD + off, src, n);
      }
      // the incidence rows of the chunk's words, BC_NT targets each
      const int q = tid % (BC_NT / 16);
      const int col = pc.tile * BC_NT + q * 16;
      const int ncol = min(max(T - col, 0), 16);
#pragma unroll
      for (int x = 0; x < BC_KC * (BC_NT / 16) / BC_THREADS; ++x) {
        const int r = tid / (BC_NT / 16) + x * (BC_THREADS / (BC_NT / 16));
        const int k = k0 + r;
        int n = 0;
        const int8_t* src = w_mat;
        if (k < nuwj && ncol) {
          const int w = min(max(words[(size_t)pc.j * uwmax + k], 0), V - 1);
          n = ncol;
          src = w_mat + (size_t)w * ld + col;
        }
        bc_cp16(st + BC_MB * PLD + r * BC_INC_LD + q * 16, src, n);
      }
      bc_next(pc, nt, cq, nuw);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    pslot = pslot + 1 == BC_STAGES ? 0 : pslot + 1;
  };
  for (int s = 0; s < BC_STAGES - 1; ++s) produce();

  typedef typename std::conditional<F16, float, int>::type Acc;
  Acc acc[BC_MTW][4][4];
  int cslot = 0;
  while (cc.item < hi) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(BC_STAGES - 2));
    __syncthreads();                     // chunk cc is in; cc - 1 is done
    produce();
    if (cc.ks == 0) {
#pragma unroll
      for (int i = 0; i < BC_MTW; ++i)
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n4][e] = 0;
    }
    const uint32_t sp = smem_s + cslot * STAGE;
    const uint32_t inc = sp + BC_MB * PLD + wn * 32 + 4 * g;
#pragma unroll
    for (int s = 0; s < BC_KC / (F16 ? 16 : 32); ++s) {
      uint32_t bf[4][2];
      if constexpr (F16) {
        // rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of the 16-slot step
        uint32_t w[4];
#pragma unroll
        for (int d = 0; d < 4; ++d)
          w[d] = bc_lds32(inc + (s * 16 + 2 * t4 + (d & 1) + 8 * (d >> 1)) *
                                    BC_INC_LD);
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4) {
          bf[n4][0] = bc_h2(w[0], w[1], n4);
          bf[n4][1] = bc_h2(w[2], w[3], n4);
        }
      } else {
        // rows 4 t4 + r (and 16 +) of the 32-slot step; load q reads row
        // r = q ^ x, x = t4 & 2, which keeps the warp's four t4 groups on
        // distinct banks
        const int x = t4 & 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t l[4], w[4], o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            l[q] = bc_lds32(inc + (32 * s + 16 * h + 4 * t4 + (q ^ x)) *
                                      BC_INC_LD);
#pragma unroll
          for (int r = 0; r < 4; ++r) w[r] = x ? l[r ^ 2] : l[r];
          bc_transpose(w, o);
#pragma unroll
          for (int n4 = 0; n4 < 4; ++n4) bf[n4][h] = o[n4];
        }
      }
#pragma unroll
      for (int i = 0; i < BC_MTW; ++i) {
        const int mt = wm * BC_MTW + i;
        if (mt >= BC_MT) break;
        uint32_t a[4];
        const uint32_t addr = sp + (mt * 16 + (lane & 7) + (lane & 8)) * PLD +
                              s * 32 + (lane >> 4) * 16;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
            : "r"(addr));
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4) {
          Acc* d = acc[i][n4];
          if constexpr (F16) {
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                  "r"(bf[n4][0]), "r"(bf[n4][1]));
          } else {
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                  "r"(bf[n4][0]), "r"(bf[n4][1]));
          }
        }
      }
    }
    if (cc.ks == cc.nks - 1) {
      // (max, count at max) of each boot row over the tile: C column c of
      // n-tile n4 is target 4 c + n4 of the warp's 32; targets past T
      // count as INT_MIN (every tile holds at least one target below T)
      const int col0 = cc.tile * BC_NT + wn * 32 + 8 * t4;
      const bool full = (cc.tile + 1) * BC_NT <= T;
#pragma unroll
      for (int i = 0; i < BC_MTW; ++i) {
        const int mt = wm * BC_MTW + i;
        if (mt >= BC_MT) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v[8];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int n4 = 0; n4 < 4; ++n4)
              v[4 * e + n4] = full || col0 + 4 * e + n4 < T
                                  ? (int)acc[i][n4][2 * h + e]
                                  : INT_MIN;
          int best = v[0], cnt = 0;
#pragma unroll
          for (int q = 1; q < 8; ++q) best = max(best, v[q]);
#pragma unroll
          for (int q = 0; q < 8; ++q) cnt += v[q] == best;
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const int ob = __shfl_xor_sync(FULL_MASK, best, off);
            const int oc = __shfl_xor_sync(FULL_MASK, cnt, off);
            bc_merge(best, cnt, ob, oc);
          }
          if (t4 == 0)
            s_part[wn * BC_MB + mt * 16 + g + 8 * h] = make_int2(best, cnt);
        }
      }
      __syncthreads();
      const int b = cc.bg * BC_MB + tid;
      if (tid < BC_MB && b < boots) {
        int best = INT_MIN, cnt = 0;
        for (int w = 0; w < BC_WN; ++w) {
          const int2 x = s_part[w * BC_MB + tid];
          bc_merge(best, cnt, x.x, x.y);
        }
        part[((size_t)cc.j * boots + b) * nt + cc.tile] = make_int2(best, cnt);
      }
    }
    bc_next(cc, nt, cq, nuw);
    cslot = cslot + 1 == BC_STAGES ? 0 : cslot + 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <bool F16>
__global__ void sintax_boot_pick_kernel(
    const uint8_t* __restrict__ P, int boots, int uwmax,
    const int* __restrict__ words, const int* __restrict__ nuw,
    const int8_t* __restrict__ w_mat, long long ld, int V, int T, int rows,
    int nt, const int2* __restrict__ part, const uint32_t* __restrict__ rr,
    int* __restrict__ winner, int* __restrict__ top) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;                       // the whole warp
  const int j = row / boots;
  const int2* pr = part + (size_t)row * nt;

  // (top, m_ties)
  int best = INT_MIN, cnt = 0;
  for (int i = lane; i < nt; i += 32) bc_merge(best, cnt, pr[i].x, pr[i].y);
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(FULL_MASK, best, off);
    const int oc = __shfl_xor_sync(FULL_MASK, cnt, off);
    bc_merge(best, cnt, ob, oc);
  }
  const uint32_t rsel = rr[row] % (uint32_t)max(cnt, 1);

  // the tile that holds the rsel-th tie, in ascending tile order
  uint32_t base = 0, r2 = 0;
  int tile = 0;
  for (int i0 = 0; i0 < nt; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t c = i < nt && pr[i].x == best ? (uint32_t)pr[i].y : 0u;
    uint32_t incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t x = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += x;
    }
    const uint32_t total = __shfl_sync(FULL_MASK, incl, 31);
    if (base + total > rsel) {
      const unsigned hit = __ballot_sync(FULL_MASK, base + incl > rsel);
      const int L = __ffs(hit) - 1;
      tile = i0 + L;
      r2 = rsel - base - __shfl_sync(FULL_MASK, incl - c, L);
      break;
    }
    base += total;
  }

  // U of that tile of this row, TPL targets a lane, from P's non-zero
  // slots
  constexpr int TPL = BC_NT / 32;
  const int col0 = tile * BC_NT + lane * TPL;
  int acc[TPL];
#pragma unroll
  for (int q = 0; q < TPL; ++q) acc[q] = 0;
  const int nuwj = nuw[j];
  for (int k0 = 0; k0 < nuwj; k0 += 32) {
    const int k = k0 + lane;
    int pv = 0, w = 0;
    if (k < nuwj) {
      const size_t at = (size_t)row * uwmax + k;
      pv = F16 ? (int)__half2float(((const __half*)P)[at])
               : (int)((const int8_t*)P)[at];
      w = min(max(words[(size_t)j * uwmax + k], 0), V - 1);
    }
    unsigned live = __ballot_sync(FULL_MASK, pv != 0);
    while (live) {
      const int s = __ffs(live) - 1;
      live &= live - 1;
      const int v = __shfl_sync(FULL_MASK, pv, s);
      const int8_t* r = w_mat + (size_t)__shfl_sync(FULL_MASK, w, s) * ld;
#pragma unroll
      for (int q = 0; q < TPL; ++q)
        if (col0 + q < T) acc[q] += v * (int)r[col0 + q];
    }
  }

  // the r2-th tie of the tile
  int n = 0;
#pragma unroll
  for (int q = 0; q < TPL; ++q) n += col0 + q < T && acc[q] == best;
  int ex = n;
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL_MASK, ex, off);
    if (lane >= off) ex += x;
  }
  ex -= n;
  if ((uint32_t)ex <= r2 && r2 < (uint32_t)(ex + n)) {
    int seen = ex;
    for (int q = 0; q < TPL; ++q) {
      if (col0 + q < T && acc[q] == best) {
        if ((uint32_t)seen == r2) winner[row] = col0 + q;
        ++seen;
      }
    }
  }
  if (lane == 0) top[row] = best;
}

// Bytes of the (cq, boots, n_tiles) partials for T targets.
extern "C" long long sintax_boot_partial_bytes(int cq, int boots, int T) {
  return (long long)cq * boots * ((T + BC_NT - 1) / BC_NT) * sizeof(int2);
}

template <bool F16>
static int bc_launch(const void* P, int cq, int boots, int uwmax,
                     const void* words, const void* nuw, const void* w_mat,
                     long long ld, int V, int T, const void* rr, void* part,
                     void* winner, void* top, cudaStream_t s) {
  const int nt = (T + BC_NT - 1) / BC_NT;
  const int groups = (boots + BC_MB - 1) / BC_MB;
  const long long n_items = (long long)groups * cq * nt;
  if (n_items >= INT_MAX) return (int)cudaErrorInvalidValue;
  const int smem = bc_smem(F16);
  cudaError_t e = cudaFuncSetAttribute(
      sintax_boot_count_kernel<F16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, n_sm = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sintax_boot_count_kernel<F16>, BC_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long fill = (long long)n_sm * per_sm;
  const long long blocks = fill < n_items ? fill : n_items;
  sintax_boot_count_kernel<F16><<<(int)blocks, BC_THREADS, smem, s>>>(
      (const uint8_t*)P, boots, uwmax, (const int*)words, (const int*)nuw,
      (const int8_t*)w_mat, ld, V, T, cq, nt, (int)n_items, (int2*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = cq * boots;
  const int warps = 8;
  sintax_boot_pick_kernel<F16><<<(rows + warps - 1) / warps, 32 * warps, 0,
                                 s>>>(
      (const uint8_t*)P, boots, uwmax, (const int*)words, (const int*)nuw,
      (const int8_t*)w_mat, ld, V, T, rows, nt, (const int2*)part,
      (const uint32_t*)rr, (int*)winner, (int*)top);
  return (int)cudaGetLastError();
}

extern "C" int sintax_boot_count_select_launch(
    const void* P, int dtype, int cq, int boots, int uwmax, const void* words,
    const void* nuw, const void* w_mat, long long ld, int V, int T,
    const void* rr, void* part, void* winner, void* top, void* cuda_stream) {
  if (cq <= 0 || boots <= 0) return 0;
  if (T <= 0 || V <= 0 || uwmax % 8 || ld % 16 ||
      ((uintptr_t)w_mat & 15) || ((uintptr_t)P & 7))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  if (dtype == SB_INT8)
    return bc_launch<false>(P, cq, boots, uwmax, words, nuw, w_mat, ld, V, T,
                            rr, part, winner, top, s);
  if (dtype == SB_FLOAT16)
    return bc_launch<true>(P, cq, boots, uwmax, words, nuw, w_mat, ld, V, T,
                           rr, part, winner, top, s);
  return (int)cudaErrorInvalidValue;
}
