// The CSR ranker's UDBSearchBig ranking of a chunk of queries on the card.
//
// It replaces no Pallas kernel: it replaces the JAX package's jnp stages
// of usearch12_tpu/ops/csr_rank.py (CSRDeviceRanker._build: the hit
// stream, the per-target counts, the ranking and the top K), which the
// port ran as torch ops (ops/csr_rank.py: hits, counts, rank_big, _top;
// they stay there as this kernel's plain version, for CPU tensors).
//
// What it computes, per query (one row of `meta`: its wmax words, then
// the offset and the size of its table in global memory, 0 slots for
// the table in shared memory):
//
// - the hit stream: the query's word rows of the CSR (starts, sizes,
//   postings) end to end in word order, cut at `cap` positions; a hit's
//   position is the running offset of its word's row plus its index in
//   the row; targets >= T (the padding entry) count for nothing;
// - for each touched target its count and its first touch (least
//   position);
// - nextv: the largest count among the touched targets whose first
//   touch comes before that of the earliest target with the maximal
//   count (0 where none is touched);
// - the top K by (count desc, first touch asc), written as K counts and
//   K targets, count 0 and target T past the touched targets; then
//   nextv and the number of targets touched.
//
// Every output equals the plain version's for the same input, bit for
// bit: the counts, targets and nextv are integers, and the order of the
// threads changes nothing (atomic adds and minima, exact selection).
//
// What bounds it on the card: the bytes of the posting rows it reads
// (4 bytes a hit, each read once, plus each word's start and size) and
// its output rows; about 8-10 k hits a query for 253-nt reads against
// 203,452 targets, some 20 MB for a window of 512 queries, 6 us at
// 3.35 TB/s.  The route it replaces made dense (B, 2^t_bits) int64 count,
// first-touch and key rows a chunk (t_bits = 18 there) and radix passes
// of topk over them: 1-2 GB of traffic a chunk of 64 queries.
//
// The design keeps the work proportional to the hits: one block a query
// walks its posting rows (the hit stream is never written), counting in
// an open-addressing table keyed by target (linear probing, a
// multiplicative hash; count by atomicAdd, first touch by atomicMin).
// The table lives in shared memory (CR_SLOTS slots) for a query of at
// most 14,336 hits (the wrapper's SMEM_HITS), so at most 7/8 full; a
// query with more hits uses a table of its own in global memory that the
// wrapper sizes at twice its hits (rounded up to a power of two) and
// places with `meta`.
// Each later pass scans only the table: block reductions for nextv, then
// a radix select of the K-th largest key over a 37-bit key (count << 18
// | (2^18 - 1 - first), the order of the plain version's 64-bit key, as
// cap <= 2^18), 10 bits a pass with a 1024-bin histogram in shared
// memory, then the keys at or above it (exactly min(K, touched) of them,
// keys being distinct) are compacted and each is placed by the number of
// larger keys among them.  A full table (which the sizes above exclude)
// is not silently cut: the query's nextv comes back -1 and the wrapper
// raises.
//
// Build: see usearch12_tpu_torch/_build.py (sm_90a, one nvcc per source).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define CR_FULL_MASK 0xffffffffu
#define CR_THREADS 1024          // one block a query; also the bins
#define CR_SLOTS_LOG 14
#define CR_SLOTS (1 << CR_SLOTS_LOG)
#define CR_DIGIT 10
#define CR_BINS (1 << CR_DIGIT)
#define CR_FBITS 18              // first touches < cap <= 2^18
#define CR_EMPTY (-1)

static_assert(CR_BINS == CR_THREADS, "one bin a thread");

struct CrTable {
  int* key;
  int* cnt;
  int* first;
  unsigned size;   // a power of two
  int shift;       // 32 - log2(size)
};

struct CrSum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct CrMax {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct CrMin {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// The reduction of v over the block, in every thread.  red: 32 ints of
// shared memory, free on entry.
template <typename Op>
__device__ __forceinline__ int cr_block_reduce(int v, Op op, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(CR_FULL_MASK, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[lane];
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(CR_FULL_MASK, v, o));
  return v;
}

// One hit of target t at position pos.  Returns false where the table is
// full (no free slot on the whole probe sequence).
__device__ __forceinline__ bool cr_insert(const CrTable& tb, int t, int pos) {
  const unsigned mask = tb.size - 1;
  unsigned h = ((unsigned)t * 2654435761u) >> tb.shift;
  volatile int* key = tb.key;
  for (unsigned probe = 0; probe < tb.size; ++probe) {
    int k = key[h];
    if (k == CR_EMPTY) k = atomicCAS(tb.key + h, CR_EMPTY, t);
    if (k == CR_EMPTY || k == t) {
      atomicAdd(tb.cnt + h, 1);
      atomicMin(tb.first + h, pos);
      return true;
    }
    h = (h + 1) & mask;
  }
  return false;
}

__device__ __forceinline__ unsigned long long cr_key(int cnt, int first) {
  return ((unsigned long long)cnt << CR_FBITS) |
         (unsigned long long)(((1 << CR_FBITS) - 1) - first);
}

__global__ void __launch_bounds__(CR_THREADS, 1)
csr_rank_big_kernel(const long long* __restrict__ starts,
                    const long long* __restrict__ sizes,
                    const int* __restrict__ postings,
                    const long long* __restrict__ meta, int wmax, int cap,
                    int T, int K, int* spill, long long spill_total,
                    long long* cand_key, int* cand_tgt, int* out) {
  extern __shared__ int cr_smem[];
  __shared__ long long w_start[CR_THREADS], w_size[CR_THREADS];
  __shared__ int red[32];
  __shared__ int full, ncand, sel_digit, sel_above;
  int* hist = cr_smem + 3 * CR_SLOTS;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const long long* row = meta + b * (wmax + 2);

  CrTable tb;
  const long long slots = row[wmax + 1];
  if (slots > 0) {
    const long long off = row[wmax];
    tb.key = spill + off;
    tb.cnt = spill + spill_total + off;
    tb.first = spill + 2 * spill_total + off;
    tb.size = (unsigned)slots;
    tb.shift = 32 - (31 - __clz((int)slots));
  } else {
    tb.key = cr_smem;
    tb.cnt = cr_smem + CR_SLOTS;
    tb.first = cr_smem + 2 * CR_SLOTS;
    tb.size = CR_SLOTS;
    tb.shift = 32 - CR_SLOTS_LOG;
  }
  for (unsigned i = tid; i < tb.size; i += CR_THREADS) {
    tb.key[i] = CR_EMPTY;
    tb.cnt[i] = 0;
    tb.first[i] = INT_MAX;
  }
  if (tid == 0) {
    full = 0;
    ncand = 0;
  }
  __syncthreads();

  // the hit stream, word by word, the threads striding over a row; the
  // rows' starts and sizes fetched a tile of words at a time
  bool ok = true;
  long long pos0 = 0;
  for (int base = 0; base < wmax && pos0 < cap; base += CR_THREADS) {
    const int nw = min(CR_THREADS, wmax - base);
    if (tid < nw) {
      const long long w = row[base + tid];
      w_start[tid] = starts[w];
      w_size[tid] = sizes[w];
    }
    __syncthreads();
    for (int i = 0; i < nw && pos0 < cap; ++i) {
      const long long n = w_size[i];
      const int* p = postings + w_start[i];
      const long long lim = n < cap - pos0 ? n : cap - pos0;
      for (long long j = tid; j < lim; j += CR_THREADS) {
        const int t = p[j];
        if ((unsigned)t < (unsigned)T)
          ok &= cr_insert(tb, t, (int)(pos0 + j));
      }
      pos0 += n;
    }
    __syncthreads();
  }
  if (!ok) full = 1;
  __syncthreads();

  // touched, the maximal count, the earliest first touch at it, nextv
  int touched = 0, maxv = 0;
  for (unsigned i = tid; i < tb.size; i += CR_THREADS)
    if (tb.key[i] != CR_EMPTY) {
      ++touched;
      maxv = max(maxv, tb.cnt[i]);
    }
  touched = cr_block_reduce(touched, CrSum(), red);
  maxv = cr_block_reduce(maxv, CrMax(), red);
  int first_max = INT_MAX;
  for (unsigned i = tid; i < tb.size; i += CR_THREADS)
    if (tb.key[i] != CR_EMPTY && tb.cnt[i] == maxv)
      first_max = min(first_max, tb.first[i]);
  first_max = cr_block_reduce(first_max, CrMin(), red);
  int nextv = 0;
  for (unsigned i = tid; i < tb.size; i += CR_THREADS)
    if (tb.key[i] != CR_EMPTY && tb.first[i] < first_max)
      nextv = max(nextv, tb.cnt[i]);
  nextv = cr_block_reduce(nextv, CrMax(), red);

  // the K-th largest key, a digit a pass from the top (every key where
  // K or fewer targets are touched)
  unsigned long long kth = 0;
  if (touched > K) {
    const int lane = tid & 31, warp = tid >> 5;
    unsigned long long prefix = 0;
    int above = 0;
    for (int shift = 3 * CR_DIGIT; shift >= 0; shift -= CR_DIGIT) {
      hist[tid] = 0;
      __syncthreads();
      for (unsigned i = tid; i < tb.size; i += CR_THREADS)
        if (tb.key[i] != CR_EMPTY) {
          const unsigned long long k = cr_key(tb.cnt[i], tb.first[i]);
          if ((k >> (shift + CR_DIGIT)) == prefix)
            atomicAdd(hist + ((k >> shift) & (CR_BINS - 1)), 1);
        }
      __syncthreads();
      // s: the keys in bins >= tid (a suffix sum over the block)
      const int v = hist[tid];
      int s = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(CR_FULL_MASK, s, o);
        if (lane + o < 32) s += y;
      }
      if (lane == 0) red[warp] = s;
      __syncthreads();
      for (int u = warp + 1; u < 32; ++u) s += red[u];
      const int need = K - above;
      if (s >= need && s - v < need) {
        sel_digit = tid;
        sel_above = above + s - v;
      }
      __syncthreads();
      prefix = (prefix << CR_DIGIT) | (unsigned long long)sel_digit;
      above = sel_above;
      __syncthreads();
    }
    kth = prefix;
  }

  // the top keys, compacted, then each put in its place
  long long* ck = cand_key + b * K;
  int* ct = cand_tgt + b * K;
  for (unsigned i = tid; i < tb.size; i += CR_THREADS)
    if (tb.key[i] != CR_EMPTY) {
      const unsigned long long k = cr_key(tb.cnt[i], tb.first[i]);
      if (k >= kth) {
        const int c = atomicAdd(&ncand, 1);
        ck[c] = (long long)k;
        ct[c] = tb.key[i];
      }
    }
  __syncthreads();
  const int n = ncand;
  int* o = out + b * (2LL * K + 2);
  for (int i = tid; i < n; i += CR_THREADS) {
    const long long k = ck[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += ck[j] > k;
    o[r] = (int)(k >> CR_FBITS);
    o[K + r] = ct[i];
  }
  for (int r = n + tid; r < K; r += CR_THREADS) {
    o[r] = 0;
    o[K + r] = T;
  }
  if (tid == 0) {
    o[2 * K] = full ? -1 : nextv;
    o[2 * K + 1] = touched;
  }
}

extern "C" int csr_rank_big_launch(
    const void* starts, const void* sizes, const void* postings,
    const void* meta, int B, int wmax, int cap, int T, int K, void* spill,
    long long spill_total, void* cand_key, void* cand_tgt, void* out,
    void* cuda_stream) {
  if (B <= 0) return 0;
  const int smem = (3 * CR_SLOTS + CR_BINS) * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      csr_rank_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  csr_rank_big_kernel<<<B, CR_THREADS, smem, (cudaStream_t)cuda_stream>>>(
      (const long long*)starts, (const long long*)sizes,
      (const int*)postings, (const long long*)meta, wmax, cap, T, K,
      (int*)spill, spill_total, (long long*)cand_key, (int*)cand_tgt,
      (int*)out);
  return (int)cudaGetLastError();
}
