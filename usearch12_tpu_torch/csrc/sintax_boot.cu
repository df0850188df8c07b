// SINTAX bootstraps on the card: the pick histogram and the boot winner.
//
// Both replace parts of the JAX device step
// usearch12_tpu/amplicon/sintax_device.py (BootEngine._build.step), which
// ran as XLA ops on the TPU; between them, U = P @ mq stays a library
// product (ops/sintax_boot.py), as the JAX package left it to XLA.
//
// sintax_pick_hist (step :125-141).  Job j of a chunk samples m[j] of its
// nuw[j] unique words in each of `boots` boots.  Boot b's k-th pick is
// stream[b * m[j] + k] % max(nuw[j], 1) in uint32, the position clipped
// to the stream as the JAX step clips it; P[j][b][w] counts how often
// slot w was picked.  One thread owns row (j, b) of P (cq, boots, uwmax):
// it zeroes the row and adds its m picks, so it needs no atomics.  The
// counts are written in the product's type (float32 or float16; counts of
// at most 2048 are exact in float16, and the wrapper takes float16 only
// below that bound).
//
// sintax_boot_select (step :156-164).  Row r = (j, b) of U (cq, boots, T)
// holds the word counts of every target.  top = max_t U, m_ties = the
// number of targets at top, rsel = rr[r] % max(m_ties, 1) in uint32, and
// the winner is the rsel-th tie in ascending target order.  One block per
// row: pass 1 reduces (top, m_ties) over the block; pass 2 walks the row
// in tiles of the block's width and finds the tie by a block-wide prefix
// count (warp ballots, one running base), stopping at the tile that holds
// it.  Nothing of (cq, boots, T) is written: the JAX step materialises
// is_tie and its cumsum, (cq, boots, T) int32 each (3 GB each at
// T = 60,000 and 128 x 100 rows).
//
// What bounds them on the card: the select reads U once for pass 1 and
// up to once more for pass 2, so it is bound by device memory (1.5 or
// 3 GB a chunk at T = 60,000); the histogram writes 6.5 MB a chunk and is
// bound by its one thread per row.  Both are the simple kernels; fusing
// the gather and the product into the select, so that U never reaches
// device memory, is later work.
//
// Build: see usearch12_tpu_torch/_build.py (sm_90a, one nvcc per source).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SB_THREADS 256
#define SB_WARPS (SB_THREADS / 32)

enum { SB_FLOAT32 = 0, SB_FLOAT16 = 1 };

__device__ inline float sb_load(const float* p) { return *p; }
__device__ inline float sb_load(const __half* p) { return __half2float(*p); }
__device__ inline void sb_store(float* p, float x) { *p = x; }
__device__ inline void sb_store(__half* p, float x) { *p = __float2half(x); }

template <typename T>
__global__ void sintax_pick_hist_kernel(
    const int* __restrict__ nuw, const int* __restrict__ m,
    const uint32_t* __restrict__ stream, int stream_len, int boots,
    int rows, int uwmax, T* __restrict__ P) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int j = r / boots, b = r - j * boots;
  T* row = P + (size_t)r * uwmax;
  for (int w = 0; w < uwmax; ++w) sb_store(row + w, 0.f);
  const int mj = m[j];
  const uint32_t n = (uint32_t)max(nuw[j], 1);
  for (int k = 0; k < mj; ++k) {
    long long pos = (long long)b * mj + k;
    pos = pos < 0 ? 0 : (pos >= stream_len ? stream_len - 1 : pos);
    const uint32_t w = stream[pos] % n;
    sb_store(row + w, sb_load(row + w) + 1.f);
  }
}

template <typename T>
__global__ void sintax_boot_select_kernel(
    const T* __restrict__ U, const uint32_t* __restrict__ rr, int n_t,
    int* __restrict__ winner, int* __restrict__ top) {
  __shared__ float s_best[SB_WARPS];
  __shared__ int s_cnt[SB_WARPS];
  __shared__ int s_found;
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* u = U + (size_t)row * n_t;

  // pass 1: (top, m_ties)
  float best = -INFINITY;
  int cnt = 0;
  for (int t = threadIdx.x; t < n_t; t += SB_THREADS) {
    const float x = sb_load(u + t);
    if (x > best) {
      best = x;
      cnt = 1;
    } else if (x == best) {
      ++cnt;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oc = __shfl_down_sync(0xffffffffu, cnt, off);
    if (ob > best) {
      best = ob;
      cnt = oc;
    } else if (ob == best) {
      cnt += oc;
    }
  }
  if (lane == 0) {
    s_best[warp] = best;
    s_cnt[warp] = cnt;
  }
  if (threadIdx.x == 0) s_found = 0;
  __syncthreads();
  best = s_best[0];
  cnt = s_cnt[0];
  for (int w = 1; w < SB_WARPS; ++w) {
    if (s_best[w] > best) {
      best = s_best[w];
      cnt = s_cnt[w];
    } else if (s_best[w] == best) {
      cnt += s_cnt[w];
    }
  }
  const uint32_t rsel = rr[row] % (uint32_t)max(cnt, 1);
  __syncthreads();                     // s_best / s_cnt are reused below

  // pass 2: the rsel-th tie in ascending t
  uint32_t base = 0;
  for (int t0 = 0; t0 < n_t; t0 += SB_THREADS) {
    const int t = t0 + threadIdx.x;
    const bool tie = t < n_t && sb_load(u + t) == best;
    const unsigned ball = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) s_cnt[warp] = __popc(ball);
    __syncthreads();
    uint32_t before = base, total = base;
    for (int w = 0; w < SB_WARPS; ++w) {
      if (w < warp) before += s_cnt[w];
      total += s_cnt[w];
    }
    before += __popc(ball & ((1u << lane) - 1u));
    if (tie && before == rsel) s_found = t;
    base = total;
    __syncthreads();                   // s_cnt is rewritten next tile
    if (base > rsel) break;            // the same for the whole block
  }
  if (threadIdx.x == 0) {
    winner[row] = s_found;
    top[row] = (int)best;
  }
}

extern "C" int sintax_pick_hist_launch(
    const void* nuw, const void* m, const void* stream, int stream_len,
    int boots, int cq, int uwmax, int dtype, void* P, void* cuda_stream) {
  const int rows = cq * boots;
  if (rows <= 0) return 0;
  if (stream_len <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + SB_THREADS - 1) / SB_THREADS;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  if (dtype == SB_FLOAT16) {
    sintax_pick_hist_kernel<__half><<<blocks, SB_THREADS, 0, s>>>(
        (const int*)nuw, (const int*)m, (const uint32_t*)stream, stream_len,
        boots, rows, uwmax, (__half*)P);
  } else if (dtype == SB_FLOAT32) {
    sintax_pick_hist_kernel<float><<<blocks, SB_THREADS, 0, s>>>(
        (const int*)nuw, (const int*)m, (const uint32_t*)stream, stream_len,
        boots, rows, uwmax, (float*)P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int sintax_boot_select_launch(
    const void* U, int dtype, const void* rr, int rows, int n_t,
    void* winner, void* top, void* cuda_stream) {
  if (rows <= 0) return 0;
  if (n_t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  if (dtype == SB_FLOAT16) {
    sintax_boot_select_kernel<__half><<<rows, SB_THREADS, 0, s>>>(
        (const __half*)U, (const uint32_t*)rr, n_t, (int*)winner,
        (int*)top);
  } else if (dtype == SB_FLOAT32) {
    sintax_boot_select_kernel<float><<<rows, SB_THREADS, 0, s>>>(
        (const float*)U, (const uint32_t*)rr, n_t, (int*)winner, (int*)top);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
