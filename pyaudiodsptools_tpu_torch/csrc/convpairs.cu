// Circular convolution of real rows for Hopper (sm_90a), fp32 on the CUDA
// cores: the streaming windows' convolution.
//
// Replaces the TPU kernel pyaudiodsptools_tpu/kernels/pallas_conv.py ::
// conv_pairs_fused (body _kernel). For R real rows of n samples and a real
// filter's spectrum it computes, per row,
//
//     out[r] = irfft(rfft(row[r]) * H)         (n a power of two, 16..65,536)
//
// It has two entry points over one kernel body:
//
//   convpairs_launch       rows given as an array (possibly strided); all n
//                          samples of every row are stored.
//   convpairs_step_launch  one window of a FIR's streaming step. Row r's
//                          window is n consecutive samples of
//                          concat(hist[r], block[r]) gathered from the TWO
//                          arrays as they lie (the history row may be a slice
//                          of a longer one); only the last `keep` (wrap-free)
//                          samples of the result are stored, or ADDED into
//                          the output (the accumulate mode: a kernel too long
//                          for one window streams in partitions, one launch
//                          each, summed in partition order); and the next
//                          history, concat(hist[r], block[r])[B:], is written
//                          to a third array by one launch of the step, or by
//                          none. The old history is only read, so the
//                          caller's previous state stays valid, and each
//                          thread block touches its own two rows only.
//
// What bounds it: by bytes one read of the rows (and of the history) and one
// write of what is kept. In the streaming step that is a few hundred KB to a
// few MB, so a launch is over before the card is full and its time is the
// latency of one pair's passes through shared memory. The design is that of csrc/segconv.cu: a PAIR of rows per
// transform (row 2p in the real part, row 2p+1 in the imaginary part of one
// complex window; an odd last row rides alone), the window resident in
// shared memory from load to store, and the transform of
// csrc/window_fft.cuh.
//
// Three ways to spread a pair over the card, chosen by the host per window
// size and batch (kernels/convpairs.py has the rule, PERF.md the
// measurements: up to 16,384 points the cluster of four is ahead by a
// quarter to a fifth at 64 to 112 rows of 16,384, by 1-3 us at the smaller
// windows, and behind from 128 rows on, so it takes the largest one-block
// window of a step's batch only):
//
//   one block a pair    (convpairs_kernel<1>) the whole window in one thread
//                       block's shared memory, up to 16,384 points.
//   a cluster of P      (convpairs_kernel<P>, P = 2 or 4, sm_90 thread-block
//                       cluster) block q of the cluster holds part q of the
//                       window, and csrc/window_fft.cuh's cluster transform
//                       (the top pass through distributed shared memory,
//                       the levels below on each part, bit-equal to the
//                       one-block transform) runs on it. P times the blocks,
//                       each with 1/P of the butterflies, the loads and the
//                       stores. The only way to the windows no block holds:
//                       32,768 points over 2 (or 4) blocks, 65,536 over 4
//                       blocks of 16,384, which a stream at a block size of
//                       16,384 or a filter of tens of thousands of taps
//                       needs.
//
// The next history is written by blocks of their own, which do nothing else
// and run beside the transforming ones: the copy (11 MB of traffic at block
// size 4,096) hides behind the transform instead of adding to it.
//
// Plain C interface: the launchers enqueue on the given stream, allocate
// nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

#include "window_fft.cuh"

// Points of a window one block holds at most.
#define BLOCK_POINTS 16384
// Samples of the next history that one copying block writes.
#define COPY_CHUNK 4096

// Where the rows come from and where the results go.
struct PairsIo {
  // sample i of row r: i < split ? a[r*a_stride + i] : b[r*b_stride + i-split]
  const float* a;
  const float* b;
  long long a_stride, b_stride;
  int split;
  // samples [keep0, n) of row r's result go to out[r*out_stride + i - keep0]
  // (added to what is there where acc is set)
  float* out;
  long long out_stride;
  int keep0;
  int acc;
  // next[r*next_len + k] = sample (shift + k) of row r's source, k < next_len
  // (past the window too: the source is split + block samples long); null:
  // nothing is written
  float* next;
  int next_len, shift;
};

namespace {

__device__ __forceinline__ float source(const PairsIo& io, int r, int i) {
  return i < io.split ? io.a[(size_t)r * io.a_stride + i]
                      : io.b[(size_t)r * io.b_stride + (i - io.split)];
}

// P == 1: one block a pair, the first `pairs` blocks of the grid. P == 2 or
// 4: clusters of P blocks, the first P * pairs blocks, each holding n / P
// points (the launcher sets the cluster's size). The blocks after those
// (whole clusters of them) only copy: block k of them writes chunk k of the
// next history, COPY_CHUNK samples of one row, straight from the source to
// its place (nothing of it passes through the transform), while the others
// transform.
template <int P>
__global__ void __launch_bounds__(WINDOW_FFT_THREADS)
convpairs_kernel(const PairsIo io, const float2* __restrict__ spec,
                 const float2* __restrict__ tw, int R, int ln) {
  extern __shared__ float2 z[];
  const int n = 1 << ln;
  const int pairs = (R + 1) / 2;
  if ((int)blockIdx.x >= pairs * P) {
    const int chunk = (int)blockIdx.x - pairs * P;
    const int per_row = (io.next_len + COPY_CHUNK - 1) / COPY_CHUNK;
    const int r = chunk / per_row;
    if (r >= R) return;            // the grid is rounded up to whole clusters
    const int k0 = (chunk - r * per_row) * COPY_CHUNK;
    const int k1 = min(io.next_len, k0 + COPY_CHUNK);
    float* dst = io.next + (size_t)r * io.next_len;
    for (int k = k0 + threadIdx.x; k < k1; k += blockDim.x)
      dst[k] = source(io, r, io.shift + k);
    return;
  }
  const int rank = P > 1 ? (int)(blockIdx.x % P) : 0;
  const int r0 = 2 * (int)(blockIdx.x / P);
  const bool has_b = r0 + 1 < R;
  const int m = n / P;              // points this block holds
  const int base = rank * m;        // the window index of its first point

  for (int i = threadIdx.x; i < m; i += blockDim.x)
    z[pad(i)] = make_float2(source(io, r0, base + i),
                            has_b ? source(io, r0 + 1, base + i) : 0.0f);

  if constexpr (P > 1) {
    convolve_window_cluster<P>(z, spec, tw, ln);
  } else {
    __syncthreads();
    convolve_window(z, spec, tw, ln);
  }

  float* a_out = io.out + (size_t)r0 * io.out_stride;
  float* b_out = a_out + io.out_stride;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int o = base + i - io.keep0;
    if (o < 0) continue;
    const float2 v = z[pad(i)];
    if (io.acc) {
      a_out[o] += v.x;
      if (has_b) b_out[o] += v.y;
    } else {
      a_out[o] = v.x;
      if (has_b) b_out[o] = v.y;
    }
  }
}

// Threads of a block that holds m points of a window spread over a cluster:
// a pass needs m/16, the loads, the stores and the history copy like more.
// Four points a thread up to 512 threads measured fastest on an H100 at every
// window from 2,048 to 16,384; 1,024 threads lose at 16,384.
int cluster_threads(int m) {
  int threads = m / 4;
  if (threads > 512) threads = 512;
  if (threads < 32) threads = 32;
  return threads;
}

// Blocks that copy the next history (0 where there is none), in whole
// clusters of P.
unsigned copy_blocks(const PairsIo& io, int R, int P) {
  if (io.next == nullptr || io.next_len == 0) return 0;
  const unsigned chunks =
      (unsigned)R * (unsigned)((io.next_len + COPY_CHUNK - 1) / COPY_CHUNK);
  return (chunks + P - 1) / P * P;
}

template <int P>
int launch_cluster(const PairsIo& io, const float2* spec, const float2* tw,
                   int R, int ln, cudaStream_t st) {
  const int m = (1 << ln) / P;
  const unsigned pairs = (unsigned)((R + 1) / 2);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(pairs * P + copy_blocks(io, R, P));
  config.blockDim = dim3(cluster_threads(m));
  config.dynamicSmemBytes = window_smem_bytes(m);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaFuncSetAttribute(
      convpairs_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)config.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, convpairs_kernel<P>, io, spec, tw, R, ln);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch(const PairsIo& io, const float* spec, const float* tw, int R, int n,
           int blocks, void* stream) {
  const int ln = window_log2(n);
  if (ln < 0 || R <= 0 || !(blocks == 1 || blocks == 2 || blocks == 4) ||
      n / blocks > BLOCK_POINTS)
    return (int)cudaErrorInvalidValue;
  // a part must keep a whole two-level pass above it and a whole innermost
  // pass below: n >= 1,024 for a cluster
  if (blocks > 1 && ln < 10) return (int)cudaErrorInvalidValue;
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks == 2) return launch_cluster<2>(io, spec2, tw2, R, ln, st);
  if (blocks == 4) return launch_cluster<4>(io, spec2, tw2, R, ln, st);
  const unsigned pairs = (unsigned)((R + 1) / 2);
  const size_t smem = window_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      convpairs_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  convpairs_kernel<1><<<pairs + copy_blocks(io, R, 1), window_threads(n), smem,
                        st>>>(io, spec2, tw2, R, ln);
  return (int)cudaGetLastError();
}

}  // namespace

// in: R rows of n floats, row r at in + r*in_stride; out: (R, n) contiguous;
// spec: (n, 2) spectrum / n in the forward transform's output order; tw: the
// per-pass twiddle rows of an n-point window; blocks: thread blocks a pair,
// 1 (n <= 16,384) or a cluster of 2 or 4 (n >= 1,024, n / blocks <= 16,384).
extern "C" int convpairs_launch(const float* in, float* out, const float* spec,
                                const float* tw, int R, int n,
                                long long in_stride, int blocks,
                                void* stream) {
  if (in_stride < n) return (int)cudaErrorInvalidValue;
  PairsIo io = {};
  io.a = in;
  io.a_stride = in_stride;
  io.split = n;
  io.out = out;
  io.out_stride = n;
  return launch(io, spec, tw, R, n, blocks, stream);
}

// One window of the streaming step. Sample i of row r's window is
// hist[r*hist_stride + i] below `split` and block[r*block_stride + i - split]
// from there on (hist points at the window's first sample; split may be 0,
// or >= n where the window lies in the history). The window's last `keep`
// output samples go to out[r*out_stride + k], k < keep, or are added there
// (accumulate != 0). next: null, or (R, next_len) contiguous, written with
// sample shift + k of row r's source (the caller passes the whole history
// with split = its length and shift = B: next = concat(hist, block)[B:]).
extern "C" int convpairs_step_launch(const float* hist, long long hist_stride,
                                     int split, const float* block,
                                     long long block_stride, float* out,
                                     long long out_stride, int keep,
                                     int accumulate, float* next, int next_len,
                                     int shift, const float* spec,
                                     const float* tw, int R, int n, int blocks,
                                     void* stream) {
  if (split < 0 || keep < 1 || keep > n || out_stride < keep ||
      (R > 1 && (hist_stride < split || block_stride < 1)) ||
      (next != nullptr && next_len > 0 && (shift < 0 || next_len > split)))
    return (int)cudaErrorInvalidValue;
  PairsIo io = {};
  io.a = hist;
  io.b = block;
  io.a_stride = hist_stride;
  io.b_stride = block_stride;
  io.split = split;
  io.out = out;
  io.out_stride = out_stride;
  io.keep0 = n - keep;
  io.acc = accumulate != 0;
  io.next = next;
  io.next_len = next != nullptr ? next_len : 0;
  io.shift = shift;
  return launch(io, spec, tw, R, n, blocks, stream);
}
