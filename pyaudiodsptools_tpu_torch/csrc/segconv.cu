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
// and each yields its last seg (wrap-free) output samples.
//
// What bounds it: device memory has to deliver the signal n/seg times and
// take it once, but the transform itself moves each window through shared
// memory once per pass, forward and back, with a barrier after each, and that
// (not device memory, not the fp32 FLOPs) is what the time goes to. The
// design therefore keeps a window in shared memory from its gather to its
// store, halves the number of transforms by packing two real windows into
// one complex signal, and runs the transform of csrc/window_fft.cuh (two
// radix-4 levels per pass, no reorder pass, a fused innermost pass, padded
// shared memory, per-pass twiddle rows), which csrc/convpairs.cu shares.
//
// One thread block per (channel, pair of consecutive windows). The block
// gathers from any sample offset and masks idx < 0 and idx >= T to zero, so
// the wrapper pads nothing.
//
// Plain C interface: segconv_launch() enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "window_fft.cuh"

namespace {

__global__ void __launch_bounds__(WINDOW_FFT_THREADS)
segconv_kernel(const float* __restrict__ x, float* __restrict__ y,
               const float2* __restrict__ spec, const float2* __restrict__ tw,
               int T, int ln, int halo, int seg, int shift, int n_seg,
               int n_pairs) {
  extern __shared__ float2 z[];
  const int n = 1 << ln;
  const int c = blockIdx.x / n_pairs;
  const int s0 = 2 * (blockIdx.x % n_pairs);
  const bool has_b = s0 + 1 < n_seg;
  const float* xc = x + (size_t)c * T;
  float* yc = y + (size_t)c * T;

  // Gather: window a -> real part, window b -> imaginary part. Window s
  // reads input [s*seg - halo - shift, +n); out-of-range reads are silence.
  const long long base_a = (long long)s0 * seg - halo - shift;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long ia = base_a + i, ib = ia + seg;
    const float a = (ia >= 0 && ia < T) ? xc[ia] : 0.0f;
    const float b = (has_b && ib >= 0 && ib < T) ? xc[ib] : 0.0f;
    z[pad(i)] = make_float2(a, b);
  }
  __syncthreads();

  convolve_window(z, spec, tw, ln);

  // Store the wrap-free last seg samples of each window, masked at T. The
  // first `shift` output samples are exact silence (the output delay), not
  // the transform's rounding noise.
  const long long out_a = (long long)s0 * seg;
  for (int j = threadIdx.x; j < seg; j += blockDim.x) {
    const float2 v = z[pad(halo + j)];
    const long long oa = out_a + j, ob = oa + seg;
    if (oa < T) yc[oa] = (oa < shift) ? 0.0f : v.x;
    if (has_b && ob < T) yc[ob] = (ob < shift) ? 0.0f : v.y;
  }
}

}  // namespace

extern "C" int segconv_launch(const float* x, float* y, const float* spec,
                              const float* tw, int C, int T, int n, int halo,
                              int seg, int shift, void* stream) {
  const int ln = window_log2(n);
  if (ln < 0) return (int)cudaErrorInvalidValue;
  const int n_seg = (T + seg - 1) / seg;
  const int n_pairs = (n_seg + 1) / 2;
  const size_t smem = window_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      segconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)C * n_pairs;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  segconv_kernel<<<(unsigned)blocks, window_threads(n), smem,
                   (cudaStream_t)stream>>>(
      x, y, reinterpret_cast<const float2*>(spec),
      reinterpret_cast<const float2*>(tw), T, ln, halo, seg, shift, n_seg,
      n_pairs);
  return (int)cudaGetLastError();
}
