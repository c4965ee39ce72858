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
// A third, convpairs_spectral_launch, is a whole step of a FIR longer than
// one window through a frequency-domain delay line, on a kernel body of its
// own (below, after the two entry points' launchers).
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
  // the kernel of a PairsIo (the name is overloaded: the delay line's below)
  void (*kernel)(const PairsIo, const float2*, const float2*, int, int) =
      convpairs_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)config.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, kernel, io, spec, tw, R, ln);
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

// ---------------------------------------------------------------------------
// The frequency-domain delay line: a FIR longer than one window streamed in
// uniform partitions (uniformly partitioned overlap-save). The kernel, its
// zero lead included, is cut into partitions of B taps (B the block size);
// partition p delays its output by p blocks. The window of a step is the
// last n samples of input (n the smallest power of two >= 2B: the last
// n - B samples before the block, then the block), and its spectrum X_k is
// stored in a ring of S slots, one a partition. A step's output is the last
// B samples of the inverse transform of
//
//     Y_k = sum over the partitions p of X_(k-p) * H_p,
//
// each H_p the n-point spectrum of partition p's taps: one window transform
// a step, however long the kernel, and a multiply-accumulate over the ring
// that reads each stored spectrum once. The partitions that are exactly
// zero (a fused cascade's lead is made of them) are left out of the sum.
//
// One launch is the whole step: the window gathered from the input ring and
// the block, its forward transform, its spectrum stored into slot pos % S
// (the slot that the oldest partition no longer needs), the sum, the
// inverse transform, the block's output stored, the block stored into the
// input ring and pos + 1 written out. Both rings are written IN PLACE; no
// window of this step reads the slots it writes (the sum reads slots pos,
// pos - 1, ... pos - (S - 1), of which only pos is this step's).
//
// What bounds it: the sum reads the ring, S spectra of n points a row pair
// (reverb_live: 129 used partitions x 32 pairs x 1,024 points x 8 bytes,
// 33.8 MB a step), and its filters' slices (1.06 MB in all, shared by every
// pair, from L2). So the sum is spread over blocks that do nothing else,
// the transforms kept off its way. Two shapes of the launch, by the window,
// H standing for SPECTRAL_BLOCKS (4):
//
//   n <= 16,384  (convpairs_kernel<true>) a cluster of 1 + H blocks a row
//                pair. Block 0 holds the window: it gathers
//                and transforms it, stores its spectrum and, once the
//                others' sums are in, adds them, transforms back and stores
//                the output. Blocks 1..H each sum a slice of n / H spectrum
//                points over the partitions of delay >= 1, which read only
//                slots that earlier steps wrote: they start at once, beside
//                block 0's gather and transform. A partition of delay 0 (a
//                kernel with no lead) needs this step's spectrum: block 0
//                multiplies it itself, and adds the slices to it. Block 0
//                reads the slices from the others' shared memory: two
//                phases of the cluster's barrier, the slices written, then
//                block 0 done reading them (a block's shared memory must
//                outlive every read of it).
//   n > 16,384   (convpairs_kernel<false>) no block holds the window: it
//                goes over a cluster of H blocks
//                (csrc/window_fft.cuh's cluster transform), each of which,
//                after the forward transform, sums over every partition the
//                slice of the spectrum it holds (the current slot after the
//                block barrier that follows its store).
//
// Inside a block the sum's lanes (two spectrum points a lane, 16-byte loads)
// are split into groups that take every G-th partition, their partial sums
// added in group order through shared memory, so that each thread has
// several loads in flight.

// Blocks that sum beside the window's block of a row pair (n <= 16,384),
// and the cluster a window past 16,384 points goes over (n / 4 <= 16,384
// up to MAX_WINDOW). At reverb_live's shapes (64 rows, 129 partitions of a
// 1,024-point window) four summing blocks a pair measured fastest on an
// H100 (18.7 us a step in a graph; two 25.4, one 44.1, eight 24.1).
#define SPECTRAL_BLOCKS 4
// Threads of each block of a cluster of 1 + SPECTRAL_BLOCKS, and of a
// window's cluster past 16,384 points. At reverb_live's shapes 256 measured
// fastest (128 threads 26.1 us, 512 24.8); 512 threads hold a 16,384-point
// part of a window.
#define SPECTRAL_SPLIT_THREADS 256
#define SPECTRAL_THREADS 512
// Partitions whose loads a thread of the sum issues before it adds any (16
// spills at the 128 registers a thread that two blocks an SM leave).
#define SPECTRAL_BATCH 8

// Where a spectral step's data lie. Row r of the block at
// block[r * block_stride + i]; the output (R, B) contiguous; the input ring
// (R, T, B), row r's slot t at input[(r * T + t) * B]; the spectrum ring
// (S, pairs, n) complex, slot s of pair q at ring[(s * pairs + q) * n].
struct SpectralIo {
  const float* block;
  long long block_stride;
  float* out;
  float* input;
  float2* ring;
  const int* pos;         // this step's place in both rings, 0 <= pos < period
  int* next_pos;          // written (pos + 1) % period
  const int* delays;      // (parts,) each used partition's delay in blocks,
                          // ascending
  int parts, slots, tslots, period, B;
};

namespace {

// Threads of the sum that share one lane of two spectrum points: the block's
// threads over the lanes of its m points, 1 where a thread walks several
// lanes.
__host__ __device__ __forceinline__ int spectral_groups(int m, int threads) {
  const int lanes = m / 2;
  return threads > lanes ? threads / lanes : 1;
}

// The cluster's barrier in halves (PTX barrier.cluster): every thread of the
// cluster arrives, then waits for all to have arrived. The arrive releases
// the thread's earlier writes and reads, the wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Gathers row pair `pair`'s window points [base, base + m) into z (padded):
// window sample i is sample g = i - (n - B) of the block, or (g < 0) of the
// block d steps back, which lies in the input ring's slot (pos - d) % T.
__device__ __forceinline__ void gather_window(const SpectralIo& io, float2* z,
                                              int pair, int R, int n,
                                              int base, int m, int pos) {
  const int B = io.B, T = io.tslots, r0 = 2 * pair;
  const bool has_b = r0 + 1 < R;
  const float* blk_a = io.block + (size_t)r0 * io.block_stride;
  const float* blk_b = blk_a + io.block_stride;
  const float* in_a = io.input + (size_t)r0 * T * B;
  const float* in_b = in_a + (size_t)T * B;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int g = base + i - (n - B);
    float a, b = 0.0f;
    if (g >= 0) {
      a = blk_a[g];
      if (has_b) b = blk_b[g];
    } else {
      const int d = (B - 1 - g) / B;
      const int at = ((pos % T - d + T) % T) * B + g + d * B;
      a = in_a[at];
      if (has_b) b = in_b[at];
    }
    z[pad(i)] = make_float2(a, b);
  }
}

// Samples [k0, B) of row pair `pair`'s block, every `step`-th from k0, into
// the input ring's slot pos % T (no window of this step reads it).
__device__ __forceinline__ void store_block(const SpectralIo& io, int pair,
                                            int R, int pos, int k0,
                                            int step) {
  const int B = io.B, T = io.tslots, r0 = 2 * pair;
  const bool has_b = r0 + 1 < R;
  const float* blk_a = io.block + (size_t)r0 * io.block_stride;
  const float* blk_b = blk_a + io.block_stride;
  float* in_a = io.input + (size_t)r0 * T * B + (pos % T) * B;
  float* in_b = in_a + (size_t)T * B;
  for (int k = k0; k < B; k += step) {
    in_a[k] = blk_a[k];
    if (has_b) in_b[k] = blk_b[k];
  }
}

// The window's points [base, base + m) (padded in z) from sample n - B on
// into the output: the block's output samples.
__device__ __forceinline__ void store_output(const SpectralIo& io,
                                             const float2* z, int pair,
                                             int R, int n, int base, int m) {
  const int B = io.B, r0 = 2 * pair;
  const bool has_b = r0 + 1 < R;
  float* a_out = io.out + (size_t)r0 * B;
  float* b_out = a_out + B;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int o = base + i - (n - B);
    if (o < 0) continue;
    const float2 v = z[pad(i)];
    a_out[o] = v.x;
    if (has_b) b_out[o] = v.y;
  }
}

// The sum over the partitions u >= u_first of the spectrum points
// [base, base + m) of one row pair, whose ring row (slot 0) is `ring`:
// Y = sum of X_(k - delay u) * H_u. Lane l holds points base + 2l and
// base + 2l + 1; group g of the G groups sums the partitions u_first + g,
// + G, ... in that order, SPECTRAL_BATCH of them loaded before they are
// added; the groups' sums are added in group order through `scratch`
// (G x m / 2 float4s, unused where G == 1). Each lane's total (point 2l in
// .x, .y, point 2l + 1 in .z, .w) goes to put(l, y), from the thread that
// holds it. It ends in a block barrier.
template <class Put>
__device__ __forceinline__ void sum_slice(const SpectralIo& io,
                                          const float2* ring,
                                          const float2* __restrict__ spec,
                                          int n, size_t slot_stride,
                                          int base, int m, int u_first,
                                          int here, float4* scratch,
                                          Put put) {
  const int S = io.slots;
  const int lanes = m / 2;
  const int G = spectral_groups(m, (int)blockDim.x);
  const int g = G > 1 ? (int)threadIdx.x / lanes : 0;
  const int l0 = G > 1 ? (int)threadIdx.x % lanes : (int)threadIdx.x;
  const int lstep = G > 1 ? lanes : (int)blockDim.x;
  for (int l = l0; l < lanes; l += lstep) {
    const float4* xs = reinterpret_cast<const float4*>(ring + base + 2 * l);
    const float4* hs = reinterpret_cast<const float4*>(spec + base + 2 * l);
    float2 y0 = make_float2(0.0f, 0.0f), y1 = y0;
    for (int u0 = u_first + g; u0 < io.parts; u0 += G * SPECTRAL_BATCH) {
      float4 x[SPECTRAL_BATCH], h[SPECTRAL_BATCH];
#pragma unroll
      for (int k = 0; k < SPECTRAL_BATCH; ++k) {
        const int u = u0 + k * G;
        if (u < io.parts) {
          int s = here - __ldg(io.delays + u);
          if (s < 0) s += S;
          x[k] = xs[(size_t)s * (slot_stride / 2)];
          h[k] = __ldg(hs + (size_t)u * (n / 2));
        }
      }
#pragma unroll
      for (int k = 0; k < SPECTRAL_BATCH; ++k) {
        if (u0 + k * G < io.parts) {
          y0 = cadd(y0, cmul(make_float2(x[k].x, x[k].y),
                             make_float2(h[k].x, h[k].y)));
          y1 = cadd(y1, cmul(make_float2(x[k].z, x[k].w),
                             make_float2(h[k].z, h[k].w)));
        }
      }
    }
    const float4 y = make_float4(y0.x, y0.y, y1.x, y1.y);
    if (G > 1) scratch[g * lanes + l] = y;
    else put(l, y);
  }
  if (G > 1) {
    __syncthreads();
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
      float4 y = scratch[l];
      for (int k = 1; k < G; ++k) {
        const float4 v = scratch[k * lanes + l];
        y.x += v.x;
        y.y += v.y;
        y.z += v.z;
        y.w += v.w;
      }
      put(l, y);
    }
  }
  __syncthreads();
}

// The 16-byte aligned scratch of a block that holds `held` window points in
// z (the groups' partial sums lie past them).
__device__ __forceinline__ float4* sum_scratch(float2* z, int held) {
  return reinterpret_cast<float4*>(z + ((pad(held) + 1) & ~1));
}

// Split: a cluster of 1 + H blocks a row pair (H = SPECTRAL_BLOCKS), block
// 0 the window's, blocks 1..H the sum's. Otherwise a cluster of P = H
// blocks, block `rank` holding window points [rank * n/P, (rank + 1) * n/P)
// and summing them.
template <bool Split>
__global__ void __launch_bounds__(SPECTRAL_THREADS)
convpairs_kernel(const SpectralIo io, const float2* __restrict__ spec,
                 const float2* __restrict__ tw, int R, int ln) {
  extern __shared__ float2 z[];
  constexpr int H = SPECTRAL_BLOCKS, P = SPECTRAL_BLOCKS;
  const int n = 1 << ln;
  const int pairs = (R + 1) / 2;
  constexpr int C = Split ? H + 1 : P;    // blocks of a cluster
  const int rank = (int)blockIdx.x % C;
  const int pair = (int)blockIdx.x / C;
  const int pos = __ldg(io.pos);
  const int here = pos % io.slots;
  const size_t slot_stride = (size_t)pairs * n;
  float2* ring = io.ring + (size_t)pair * n;

  if constexpr (Split) {
    if (rank > 0) {
      // a summing block: its slice's totals into its own z, for block 0
      const int m = n / H;
      const int u_first = __ldg(io.delays) == 0 ? 1 : 0;
      float4* slice = reinterpret_cast<float4*>(z);
      sum_slice(io, ring, spec, n, slot_stride, (rank - 1) * m, m, u_first,
                here, sum_scratch(z, n),
                [&](int l, float4 y) { slice[l] = y; });
      cluster_arrive();                 // the slice is written
      cluster_wait();
      cluster_arrive();
      cluster_wait();                   // block 0 has read it
      return;
    }
    gather_window(io, z, pair, R, n, 0, n, pos);
    store_block(io, pair, R, pos, threadIdx.x, blockDim.x);
    __syncthreads();
    forward_levels(z, tw, ln, ln);
    // X_k into the ring; z becomes X_k * H_0 where a partition has delay 0
    const bool now = __ldg(io.delays) == 0;
    float2* dst = ring + (size_t)here * slot_stride;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float2 x = z[pad(i)];
      dst[i] = x;
      if (now) z[pad(i)] = cmul(x, __ldg(spec + i));
    }
    cluster_arrive();
    cluster_wait();                     // the slices are written
    {
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      const int m = n / H;
      for (int l = threadIdx.x; l < n / 2; l += blockDim.x) {
        const int i = 2 * l;
        const float4* slice = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(z, 1 + i / m));
        const float4 y = slice[(i % m) / 2];
        float2 y0 = make_float2(y.x, y.y), y1 = make_float2(y.z, y.w);
        if (now) {
          y0 = cadd(z[pad(i)], y0);
          y1 = cadd(z[pad(i + 1)], y1);
        }
        z[pad(i)] = y0;
        z[pad(i + 1)] = y1;
      }
    }
    cluster_arrive();                   // done reading the slices
    __syncthreads();
    inverse_levels(z, tw, ln, ln);
    store_output(io, z, pair, R, n, 0, n);
    if (pair == 0 && threadIdx.x == 0) *io.next_pos = (pos + 1) % io.period;
    cluster_wait();
  } else {
    const int m = n / P;                // points this block holds
    const int base = rank * m;          // the window index of its first point
    gather_window(io, z, pair, R, n, base, m, pos);
    store_block(io, pair, R, pos, rank * blockDim.x + threadIdx.x,
                P * blockDim.x);
    forward_window_cluster<P>(z, tw, ln);
    // X_k into the ring; the sum below reads it back where a partition's
    // delay is 0
    float2* dst = ring + (size_t)here * slot_stride + base;
    for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = z[pad(i)];
    __syncthreads();
    sum_slice(io, ring, spec, n, slot_stride, base, m, 0, here,
              sum_scratch(z, m), [&](int l, float4 y) {
                z[pad(2 * l)] = make_float2(y.x, y.y);
                z[pad(2 * l + 1)] = make_float2(y.z, y.w);
              });
    inverse_window_cluster<P>(z, tw, ln);
    store_output(io, z, pair, R, n, base, m);
    if (blockIdx.x == 0 && threadIdx.x == 0)
      *io.next_pos = (pos + 1) % io.period;
  }
}

// Dynamic shared memory of a spectral block: `held` padded window points,
// then the groups' partial sums of a slice of m points (G > 1).
size_t spectral_smem_bytes(int held, int m, int threads) {
  const size_t points = (window_smem_bytes(held) + 15) / 16 * 16;
  const int G = spectral_groups(m, threads);
  return points + (G > 1 ? (size_t)G * m * sizeof(float2) : 0);
}

template <bool Split>
int launch_spectral(const SpectralIo& io, const float2* spec,
                    const float2* tw, int R, int ln, cudaStream_t st) {
  const int n = 1 << ln;
  constexpr int H = SPECTRAL_BLOCKS;
  constexpr int C = Split ? H + 1 : H;
  const int threads = Split ? SPECTRAL_SPLIT_THREADS : SPECTRAL_THREADS;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((R + 1) / 2 * C));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = spectral_smem_bytes(Split ? n : n / H, n / H,
                                                threads);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  void (*kernel)(const SpectralIo, const float2*, const float2*, int, int) =
      convpairs_kernel<Split>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)config.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, kernel, io, spec, tw, R, ln);
  if (err != cudaSuccess) return (int)err;
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

// One step of a FIR streamed through a frequency-domain delay line (see
// SpectralIo): block (R, B) rows block_stride apart; out (R, B); input
// (R, tslots, B) and ring (slots, (R + 1) / 2, n, 2), both written in
// place; pos and next_pos one int each on the device; delays (parts,) int,
// ascending, each in [0, slots); spec (parts, n, 2) each partition's
// spectrum / n in the forward transform's output order; tw the per-pass
// twiddle rows of an n-point window.
extern "C" int convpairs_spectral_launch(
    const float* block, long long block_stride, float* out, float* input,
    float* ring, const int* pos, int* next_pos, const int* delays, int parts,
    int slots, int tslots, int period, int B, const float* spec,
    const float* tw, int R, int n, void* stream) {
  const int ln = window_log2(n);
  if (ln < 0 || R <= 0 || B < 1 || 2 * B - 1 > n || parts < 1 ||
      slots < 1 || tslots < 1 || (long long)(tslots - 1) * B < n - B ||
      period < 1 || period % slots || period % tslots ||
      (R > 1 && block_stride < B) || n / SPECTRAL_BLOCKS > BLOCK_POINTS)
    return (int)cudaErrorInvalidValue;
  SpectralIo io = {};
  io.block = block;
  io.block_stride = block_stride;
  io.out = out;
  io.input = input;
  io.ring = reinterpret_cast<float2*>(ring);
  io.pos = pos;
  io.next_pos = next_pos;
  io.delays = delays;
  io.parts = parts;
  io.slots = slots;
  io.tslots = tslots;
  io.period = period;
  io.B = B;
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= BLOCK_POINTS)
    return launch_spectral<true>(io, spec2, tw2, R, ln, st);
  return launch_spectral<false>(io, spec2, tw2, R, ln, st);
}
