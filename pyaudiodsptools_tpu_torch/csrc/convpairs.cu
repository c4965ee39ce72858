// Circular convolution of real rows for Hopper (sm_90a), fp32 on the CUDA
// cores: the streaming windows' convolution.
//
// Replaces the TPU kernel pyaudiodsptools_tpu/kernels/pallas_conv.py ::
// conv_pairs_fused (body _kernel). For a (R, n) float32 array and a real
// filter's spectrum it computes, per row,
//
//     out[r] = irfft(rfft(in[r]) * H)          (n a power of two, 16..16,384)
//
// the whole circular convolution: all n samples are stored, and the caller
// keeps the wrap-free ones.
//
// What bounds it: by bytes one read and one write of the rows; in the
// streaming step that is a few hundred KB, so a launch is over before the
// card is full (32 blocks for 64 rows) and its time is the latency of one
// block's passes through shared memory. The design is that of
// csrc/segconv.cu without the gather: one thread block per PAIR of rows
// (row 2p in the real part, row 2p+1 in the imaginary part of one complex
// window; an odd last row rides alone), the window resident in shared memory
// from load to store, and the transform of csrc/window_fft.cuh. Rows may be
// strided (in_stride floats apart), so the caller can pass a view of a longer
// history without copying it first.
//
// Plain C interface: convpairs_launch() enqueues on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "window_fft.cuh"

namespace {

__global__ void __launch_bounds__(WINDOW_FFT_THREADS)
convpairs_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float2* __restrict__ spec,
                 const float2* __restrict__ tw, int R, int ln,
                 long long in_stride) {
  extern __shared__ float2 z[];
  const int n = 1 << ln;
  const int r0 = 2 * blockIdx.x;
  const bool has_b = r0 + 1 < R;
  const float* a_row = in + (size_t)r0 * in_stride;
  const float* b_row = a_row + in_stride;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    z[pad(i)] = make_float2(a_row[i], has_b ? b_row[i] : 0.0f);
  __syncthreads();

  convolve_window(z, spec, tw, ln);

  float* a_out = out + (size_t)r0 * n;
  float* b_out = a_out + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 v = z[pad(i)];
    a_out[i] = v.x;
    if (has_b) b_out[i] = v.y;
  }
}

}  // namespace

// in: R rows of n floats, row r at in + r*in_stride; out: (R, n) contiguous;
// spec: (n, 2) spectrum / n in the forward transform's output order; tw: the
// per-pass twiddle rows of an n-point window.
extern "C" int convpairs_launch(const float* in, float* out, const float* spec,
                                const float* tw, int R, int n,
                                long long in_stride, void* stream) {
  const int ln = window_log2(n);
  if (ln < 0 || R <= 0 || in_stride < n) return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      convpairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + 1) / 2);
  convpairs_kernel<<<blocks, window_threads(n), smem, (cudaStream_t)stream>>>(
      in, out, reinterpret_cast<const float2*>(spec),
      reinterpret_cast<const float2*>(tw), R, ln, in_stride);
  return (int)cudaGetLastError();
}
