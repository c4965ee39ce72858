// Segmented overlap-save convolution for Hopper (sm_90a), fp32 on the CUDA
// cores.
//
// Replaces the TPU kernel pyaudiodsptools_tpu/kernels/pallas_conv.py ::
// segmented_conv_fused (bodies _kernel_dma_union / _kernel_dma). Per channel
// of a (C, T) float32 signal it computes
//
//     y[c, m] = sum_k h[k] * x[c, m - shift - k],   0 <= m < T
//
// by overlap-save: windows of n = halo + seg samples start seg samples apart,
// and each yields its last seg (wrap-free) output samples. In accumulate mode
// it adds that sum into y instead (y[c, m] += ..., m >= shift; y[c, m <
// shift] is left as it is): a kernel longer than a window is cut into
// consecutive partitions, each with its own output delay, and the launch of
// partition p > 0 adds into the output of the ones before
// (ops/fft_filter.plan_partitions), so the partitions' sum costs no pass of
// its own.
//
// What bounds it: device memory has to deliver the signal n/seg times and
// take it once, but the transform itself moves each window through shared
// memory once per pass, forward and back, and that (not device memory, not
// the fp32 FLOPs) is what the time goes to. The design therefore keeps a
// window in shared memory from its gather to its store, halves the number
// of transforms by packing two real windows into one complex signal, and
// runs the transform of csrc/window_fft.cuh (two radix-4 levels per pass, no
// reorder pass, a fused innermost pass, padded shared memory, per-pass
// twiddle rows), which csrc/convpairs.cu shares. A window over a cluster
// runs the transform's owned schedule: below the top pass each run of
// points belongs to the same warps in every pass, and only the warps that
// share points wait for each other. On an H100 at a window of 32,768 it is
// 4.6-5.4 % faster than the same items with a block barrier after every
// pass, which is no faster than the block-wide passes: the warp and group
// barriers, not the item order, buy the time (they also leave ptxas fewer
// spills, 120 bytes against 164). A window in one block keeps a block
// barrier after every pass, which measured faster there (PERF.md).
//
// One window pair per thread block, or per thread-block CLUSTER of P = 2 or
// 4 blocks (segconv_kernel<P>): a window of up to 16,384 points fits one
// block's shared memory, one of 65,536 a cluster of four. The wider window
// wastes less of its transform on the halo: at a halo of 8,192 a window of
// 16,384 transforms 2.0 points for each one it keeps, one of 65,536 1.14.
// The host (kernels/segconv.py, ops/fft_filter.plan_segments) picks the
// window, and with it the version, by a rule measured on an H100.
//
// The gather issues all of a thread's loads before its first shared-memory
// store: chunks of four samples, 16 bytes wide from the first 16-byte
// boundary of the window's span on, at most three samples alone at each end,
// out-of-range samples (idx < 0, idx >= T) silence, so the wrapper pads
// nothing. The first `shift` output samples are exact zeros (the output
// delay), not the transform's rounding noise. One block fills an SM, and on
// an H100 its gather costs little (blocks run out of phase across the SMs),
// but its store does: 3.7 of a 32,768 block's 34.6 us, 5.8 of a 16,384
// block's 30.6 (PERF.md). So a writing launch hands each window's whole
// 16-byte chunks to the Tensor Memory Accelerator (bulk_store) and the block
// leaves while they drain, and an accumulating launch loads all of a
// thread's chunks of y before it adds and stores any (add_store). The sums
// and their order are the same: the output is bit for bit the one of a
// store a chunk at a time.
//
// Plain C interface: segconv_launch() enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_fft.cuh"

// Chunks of four points a thread gathers: a block of m points has at least
// m/16 threads (window_threads).
#define SEGCONV_CHUNKS 4

namespace {

// Samples [s, s+4) of a row of T, silence outside [0, T). One 16-byte load
// where all four lie inside (the caller has aligned s).
__device__ __forceinline__ float4 load4(const float* __restrict__ xr,
                                        long long s, int T) {
  if (s >= 0 && s + 4 <= T)
    return __ldg(reinterpret_cast<const float4*>(xr + s));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (s + e >= 0 && s + e < T) ? __ldg(xr + s + e) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float load1(const float* __restrict__ xr,
                                       long long s, int T) {
  return (s >= 0 && s < T) ? __ldg(xr + s) : 0.0f;
}

// Output sample o of a row, below T: exact silence below `shift`, or with
// kAcc added to what is there (and left as it is below `shift`).
template <bool kAcc>
__device__ __forceinline__ void store1(float* yr, long long o, int T,
                                       int shift, float v) {
  if (o >= T) return;
  if (o < shift) {
    if (!kAcc) yr[o] = 0.0f;
  } else {
    yr[o] = kAcc ? yr[o] + v : v;
  }
}

// Samples from s on (s may be < 0) before the row's first 16-byte boundary
// at or after s (0..3).
__device__ __forceinline__ int head_points(const float* row, long long s) {
  const uintptr_t a = (uintptr_t)row + (uintptr_t)(s * 4);
  return (int)(((16 - (a & 15)) & 15) >> 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Points [lo, hi) of [i_lo, m) whose outputs o0 + i lie on whole 16-byte
// chunks of the row at or past `shift` and below T (lo == hi: none).
__device__ __forceinline__ void whole_chunks(const float* yr, long long o0,
                                             int i_lo, int m, int T,
                                             int shift, int* lo, int* hi) {
  long long l = i_lo, h = m;
  if (o0 + l < shift) l = shift - o0;
  if (o0 + h > T) h = T - o0;
  if (l < h) {
    l += head_points(yr, o0 + l);
    h -= (4 - head_points(yr, o0 + h)) & 3;
  }
  *lo = (int)l;
  *hi = (int)(h > l ? h : l);
}

// The writing store. The wrap-free points' outputs leave by the Tensor
// Memory Accelerator: the block is done once they lie in shared memory, and
// the writes drain beside the next block's gather and transform. Each
// thread takes its points of [i_lo, m) out of z into registers (at most
// SEGCONV_POINTS a thread: a block of m points has m/16 threads at least)
// and stores alone the few outside each window's whole 16-byte chunks.
// After a barrier the rest go back into z as two runs, window a's and then
// window b's. One thread hands both runs to cp.async.bulk and waits until
// they have been read.
#define SEGCONV_POINTS 16
__device__ __forceinline__ void bulk_store(float2* z, float* yr, long long oa,
                                           int seg, int i_lo, int m, int T,
                                           int shift, bool has_b) {
  int lo_a, hi_a, lo_b = 0, hi_b = 0;
  whole_chunks(yr, oa, i_lo, m, T, shift, &lo_a, &hi_a);
  if (has_b) whole_chunks(yr, oa + seg, i_lo, m, T, shift, &lo_b, &hi_b);
  float2 v[SEGCONV_POINTS];
#pragma unroll
  for (int k = 0; k < SEGCONV_POINTS; ++k) {
    const int i = i_lo + (int)threadIdx.x + k * (int)blockDim.x;
    if (i < m) {
      v[k] = z[pad(i)];
      if (i < lo_a || i >= hi_a) store1<false>(yr, oa + i, T, shift, v[k].x);
      if (has_b && (i < lo_b || i >= hi_b))
        store1<false>(yr, oa + seg + i, T, shift, v[k].y);
    }
  }
  __syncthreads();                    // z is read: the runs may overwrite it
  float* run = reinterpret_cast<float*>(z);
  const int la = hi_a - lo_a;         // a multiple of 4: run b on 16 bytes
#pragma unroll
  for (int k = 0; k < SEGCONV_POINTS; ++k) {
    const int i = i_lo + (int)threadIdx.x + k * (int)blockDim.x;
    if (i < m) {
      if (i >= lo_a && i < hi_a) run[i - lo_a] = v[k].x;
      if (i >= lo_b && i < hi_b) run[la + i - lo_b] = v[k].y;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    if (la > 0)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              reinterpret_cast<uint64_t>(yr + oa + lo_a)),
          "r"(smem_u32(run)), "r"(la * 4)
          : "memory");
    if (hi_b > lo_b)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              reinterpret_cast<uint64_t>(yr + oa + seg + lo_b)),
          "r"(smem_u32(run + la)), "r"((hi_b - lo_b) * 4)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the block's shared memory stays until the copies have read it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The accumulating store. Every chunk of y that a thread adds into is
// loaded first, all in flight at once, then added and stored 16 bytes wide.
// Chunk by chunk, each load would wait for the store before it (the
// compiler cannot move a load of y past a store to y): a round trip a
// chunk.
__device__ __forceinline__ void add_store(const float2* z, float* yr,
                                          long long oa, int seg, int i_lo,
                                          int m, int T, int shift,
                                          bool has_b) {
  const int first = min(m, i_lo + head_points(yr, oa + i_lo));
  const int nb2 = (m - first) >> 2;   // at most SEGCONV_CHUNKS a thread
  const auto whole = [&](long long o) { return o >= shift && o + 4 <= T; };
  float4 ya[SEGCONV_CHUNKS], yb[SEGCONV_CHUNKS];
#pragma unroll
  for (int u = 0; u < SEGCONV_CHUNKS; ++u) {
    const int q = (int)threadIdx.x + u * (int)blockDim.x;
    const long long o = oa + first + 4 * q;
    if (q < nb2) {
      if (whole(o)) ya[u] = *reinterpret_cast<const float4*>(yr + o);
      if (has_b && whole(o + seg))
        yb[u] = *reinterpret_cast<const float4*>(yr + o + seg);
    }
  }
  const auto put = [&](long long o, float4 y, float v0, float v1, float v2,
                       float v3) {
    if (whole(o)) {
      y.x += v0;
      y.y += v1;
      y.z += v2;
      y.w += v3;
      __stcg(reinterpret_cast<float4*>(yr + o), y);   // one 16-byte store
    } else {                          // at the output delay or at T
      store1<true>(yr, o, T, shift, v0);
      store1<true>(yr, o + 1, T, shift, v1);
      store1<true>(yr, o + 2, T, shift, v2);
      store1<true>(yr, o + 3, T, shift, v3);
    }
  };
#pragma unroll
  for (int u = 0; u < SEGCONV_CHUNKS; ++u) {
    const int q = (int)threadIdx.x + u * (int)blockDim.x;
    if (q < nb2) {
      const int i = first + 4 * q;
      const float2 v0 = z[pad(i)], v1 = z[pad(i + 1)], v2 = z[pad(i + 2)],
                   v3 = z[pad(i + 3)];
      put(oa + i, ya[u], v0.x, v1.x, v2.x, v3.x);
      if (has_b) put(oa + seg + i, yb[u], v0.y, v1.y, v2.y, v3.y);
    }
  }
  // the points before the first chunk and after the last, one a thread
  int i = -1;
  if ((int)threadIdx.x < first - i_lo) i = i_lo + threadIdx.x;
  else if ((int)threadIdx.x >= 4 && (int)threadIdx.x - 4 < m - first - 4 * nb2)
    i = first + 4 * nb2 + (int)threadIdx.x - 4;
  if (i >= 0) {
    const float2 v = z[pad(i)];
    store1<true>(yr, oa + i, T, shift, v.x);
    if (has_b) store1<true>(yr, oa + seg + i, T, shift, v.y);
  }
}

// P blocks a window pair (1, or a cluster of 2 or 4). Block `rank` of a
// pair holds points [rank*m, (rank+1)*m) of both windows, m = n/P. kAcc: add
// into y (accumulate mode).
template <int P, bool kAcc>
__global__ void __launch_bounds__(WINDOW_FFT_THREADS)
segconv_kernel(const float* __restrict__ x, float* __restrict__ y,
               const float2* __restrict__ spec, const float2* __restrict__ tw,
               int T, int ln, int halo, int seg, int shift, int n_seg,
               int n_pairs) {
  extern __shared__ float2 z[];
  const int lm = ln - (P == 4 ? 2 : P == 2 ? 1 : 0);
  const int m = 1 << lm;
  const int rank = P > 1 ? (int)(blockIdx.x % P) : 0;
  const int pair = (int)(blockIdx.x / P);
  const int c = pair / n_pairs;
  const int s0 = 2 * (pair % n_pairs);
  const bool has_b = s0 + 1 < n_seg;
  const float* xr = x + (size_t)c * T;
  float* yr = y + (size_t)c * T;
  const int base = rank * m;

  // Gather: window a -> real part, window b (seg samples later, the same
  // 16-byte phase: seg % 4 == 0) -> imaginary part. Point i of this block
  // reads sample sa + i of window a.
  const long long sa = (long long)s0 * seg - halo - shift + base;
  const long long sb = sa + seg;
  const int h = head_points(xr, sa);
  const int nb = (m - h) >> 2;
  float4 va[SEGCONV_CHUNKS], vb[SEGCONV_CHUNKS];
#pragma unroll
  for (int u = 0; u < SEGCONV_CHUNKS; ++u) {
    const int k = threadIdx.x + u * blockDim.x;
    if (k < nb) {
      va[u] = load4(xr, sa + h + 4 * k, T);
      vb[u] = has_b ? load4(xr, sb + h + 4 * k, T)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // the h points before the first chunk and the (m - h) % 4 after the last,
  // one a thread
  int ep = -1;
  if ((int)threadIdx.x < h) ep = threadIdx.x;
  else if ((int)threadIdx.x >= 4 && (int)threadIdx.x - 4 < m - h - 4 * nb)
    ep = h + 4 * nb + (int)threadIdx.x - 4;
  float ea = 0.0f, eb = 0.0f;
  if (ep >= 0) {
    ea = load1(xr, sa + ep, T);
    eb = has_b ? load1(xr, sb + ep, T) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < SEGCONV_CHUNKS; ++u) {
    const int k = threadIdx.x + u * blockDim.x;
    if (k < nb) {
      const int i = h + 4 * k;
      z[pad(i)] = make_float2(va[u].x, vb[u].x);
      z[pad(i + 1)] = make_float2(va[u].y, vb[u].y);
      z[pad(i + 2)] = make_float2(va[u].z, vb[u].z);
      z[pad(i + 3)] = make_float2(va[u].w, vb[u].w);
    }
  }
  if (ep >= 0) z[pad(ep)] = make_float2(ea, eb);

  if constexpr (P == 1) {
    __syncthreads();
    convolve_window(z, spec, tw, ln);
  } else {
    convolve_window_cluster<P, true>(z, spec, tw, ln);
  }

  // Store the wrap-free points (window index >= halo) of each window, masked
  // at T. Local point i is output sample oa + i of window a, oa + seg + i of
  // window b.
  const int i_lo = max(0, halo - base);
  if (i_lo >= m) return;
  const long long oa = (long long)s0 * seg + base - halo;
  if constexpr (kAcc)
    add_store(z, yr, oa, seg, i_lo, m, T, shift, has_b);
  else
    bulk_store(z, yr, oa, seg, i_lo, m, T, shift, has_b);
}

template <int P, bool kAcc>
int launch(const float* x, float* y, const float2* spec, const float2* tw,
           int C, int T, int ln, int halo, int seg, int shift,
           cudaStream_t stream) {
  const int n = 1 << ln, m = n / P;
  const int n_seg = (T + seg - 1) / seg;
  const int n_pairs = (n_seg + 1) / 2;
  const long long blocks = (long long)C * n_pairs * P;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      segconv_kernel<P, kAcc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (P == 1) {
    segconv_kernel<P, kAcc><<<(unsigned)blocks, window_threads(m), smem,
                              stream>>>(
        x, y, spec, tw, T, ln, halo, seg, shift, n_seg, n_pairs);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(window_threads(m));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, segconv_kernel<P, kAcc>, x, y, spec, tw,
                           T, ln, halo, seg, shift, n_seg, n_pairs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (C, T) float32; spec: (n, 2) spectrum / n in the forward
// transform's output order; tw: the per-pass twiddle rows of an n-point
// window; blocks_per_window: 1 (n <= 16,384), or a cluster of 2 or 4 (n >=
// 256, n / blocks <= 16,384); halo and seg multiples of 4; accumulate: 0
// writes y, 1 adds into it.
extern "C" int segconv_launch(const float* x, float* y, const float* spec,
                              const float* tw, int C, int T, int n, int halo,
                              int seg, int shift, int blocks_per_window,
                              int accumulate, void* stream) {
  const int ln = window_log2(n);
  const int P = blocks_per_window;
  if (ln < 0 || (halo & 3) || (seg & 3) || halo + seg != n ||
      !(P == 1 || P == 2 || P == 4) || n / P > 16384 ||
      (P > 1 && n < 256))
    return (int)cudaErrorInvalidValue;
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = (cudaStream_t)stream;
#define SEGCONV_LAUNCH(P_, ACC)                                               \
  return launch<P_, ACC>(x, y, spec2, tw2, C, T, ln, halo, seg, shift, st)
  if (accumulate) {
    if (P == 4) SEGCONV_LAUNCH(4, true);
    if (P == 2) SEGCONV_LAUNCH(2, true);
    SEGCONV_LAUNCH(1, true);
  }
  if (P == 4) SEGCONV_LAUNCH(4, false);
  if (P == 2) SEGCONV_LAUNCH(2, false);
  SEGCONV_LAUNCH(1, false);
#undef SEGCONV_LAUNCH
}
