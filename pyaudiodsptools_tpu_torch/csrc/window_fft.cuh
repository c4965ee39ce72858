// The window transform shared by csrc/segconv.cu and csrc/convpairs.cu:
// circular convolution of ONE complex window of n = 2^ln points, resident in
// a thread block's shared memory, with a spectrum that the host stores
// pre-scaled and in the forward transform's output order. Packing two real
// signals into the real and imaginary parts of the window convolves both
// with a real filter at once (h is real, so the parts never mix).
//
// What the passes cost is shared-memory traffic and barriers, not device
// memory and not fp32 FLOPs, so the transform
//   * does TWO radix-4 levels per pass in registers (16 points per thread): a
//     16,384-point transform takes 3 passes each way instead of 7;
//   * skips every reorder pass: forward is decimation in frequency (natural
//     order in, digit-reversed out), the host stores the filter's spectrum in
//     that digit-reversed order (already divided by n), and the inverse is
//     the exact adjoint, decimation in time (digit-reversed in, natural out);
//   * runs the innermost levels of both directions and the spectrum multiply
//     as ONE pass: those levels work on 16 (or 8) neighbouring points, which
//     one thread holds from the last forward level to the first inverse one;
//   * pads shared memory by one slot per 16 so that this pass, where each
//     thread walks its own 16 neighbours, is free of bank conflicts.
//
// Twiddles never come from fast-math intrinsics. Fetching them as strided
// gathers from one n-entry table took a large share of the time on an H100
// (PERF.md: the per-pass layout halved it), so the host
// (kernels/segconv.py::pass_twiddles, float64) lays them out per pass,
// indexed by the thread's own j: consecutive threads read consecutive
// entries. A two-level pass reads six entries per 16 points, w_m^(j*p) and
// w_(m/4)^(j*p) for p = 1..3; the remaining factor of the outer level's
// twiddle, w_m^(c*(m/16)*p) = w_16^(c*p), is a compile-time constant, as are
// all twiddles of the innermost pass.
//
// The levels, for n = 2^ln (kernels/segconv.py::stage_radices is the same
// list): radix 4 at sizes n, n/4, ... down to 4 (ln even) or 8 (ln odd), then
// one radix-2 level if ln is odd.
//
// A kernel that includes this header fills z[pad(i)], i < n, synchronises,
// calls convolve_window() with all its threads, and reads z[pad(i)] back (the
// call ends in a barrier).
//
// A window too large for one block (or one that should be spread wider) goes
// over a thread-block cluster of P = 2 or 4 blocks: block q holds points
// [q*n/P, (q+1)*n/P). The top two radix-4 levels (sizes n and n/4) combine
// points n/4 and n/16 apart, so one pass gathers each thread's 16 points
// from the P blocks' shared memory (distributed shared memory), does the
// same register work as the one-block pass and scatters them back; every
// level below is local to a block's points (16/P runs of n/16) and runs
// the one-block passes on them. Same operations on the same operands in the
// same order: the cluster and the one-block transform agree bit for bit.
// The kernel fills its block's z, then calls convolve_window_cluster<P>()
// with all its threads (it synchronises the cluster first and last).
//
// csrc/segconv.cu runs a cluster's window in the owned schedule
// (convolve_window_cluster<P, true>): below the top pass each run of n/16
// points belongs to the same threads in every pass down and back up, and
// only the threads that share points wait for each other between two passes,
// a warp or a group of warps; the cluster barriers stay after the gather,
// after the top pass, before its adjoint and before the store. A window in
// one block, and every window of csrc/convpairs.cu, keep a block barrier
// after every pass (the passes' default instantiations).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// 1,024 threads: a 16,384-point window leaves room for one block per SM, and
// the passes are latency-bound, so the block brings as many warps as it can
// (fewer threads per block measured slower on an H100: PERF.md).
#define WINDOW_FFT_THREADS 1024
// The fewest threads that wait at one group barrier (owner_threads).
#define WINDOW_FFT_OWNER_THREADS 128

namespace {

// Shared-memory slot of point i: one pad slot per 16 points.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * b
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
// -i * a  and  +i * a
__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 mul_pos_i(float2 a) {
  return make_float2(-a.y, a.x);
}

// v * exp(-2*pi*i*k/16). k is a compile-time constant wherever this is
// called (fully unrolled loops), so the switch folds away.
__device__ __forceinline__ float2 mul_w16(float2 v, int k) {
  const float c1 = 0.92387953251128674f, s1 = 0.38268343236508977f,
              r = 0.70710678118654752f;
  switch (k & 15) {
    case 0: return v;
    case 1: return cmul(v, make_float2(c1, -s1));
    case 2: return cmul(v, make_float2(r, -r));
    case 3: return cmul(v, make_float2(s1, -c1));
    case 4: return mul_neg_i(v);
    case 5: return cmul(v, make_float2(-s1, -c1));
    case 6: return cmul(v, make_float2(-r, -r));
    case 7: return cmul(v, make_float2(-c1, -s1));
    case 8: return make_float2(-v.x, -v.y);
    case 9: return cmul(v, make_float2(-c1, s1));
    case 10: return cmul(v, make_float2(-r, r));
    case 11: return cmul(v, make_float2(-s1, c1));
    case 12: return mul_pos_i(v);
    case 13: return cmul(v, make_float2(s1, c1));
    case 14: return cmul(v, make_float2(r, r));
    default: return cmul(v, make_float2(c1, s1));
  }
}

// 4-point DFT on registers (decimation in frequency, w = -i), and its
// adjoint (w = +i). Twiddles are applied by the callers.
__device__ __forceinline__ void dft4_forward(float2& a0, float2& a1, float2& a2,
                                             float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3),
               t3 = mul_neg_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}
__device__ __forceinline__ void dft4_inverse(float2& a0, float2& a1, float2& a2,
                                             float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3),
               t3 = mul_pos_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// f(t) for the items t of a pass of n items that this thread does in the
// owned schedule, shared out warp by warp: warp w does the w-th of the
// block's equal runs of items, its lanes taking them in turn. A pass numbers
// its items in the order of the points they touch (a pass at size m = 2^lm:
// item t lies in the run of m points t >> (lm - 4) or t >> (lm - 2); the
// innermost pass: item t is points 16t.. or 8t..), so where a pass's runs of
// points fit a warp's share, the warp touches the same points in every pass;
// neighbouring lanes take neighbouring items as in the block-wide passes
// (the same shared-memory banks).
template <class F>
__device__ __forceinline__ void for_warp_items(int n, F f) {
  const int per = n / (int)(blockDim.x >> 5);
  const int t0 = (int)(threadIdx.x >> 5) * per + (int)(threadIdx.x & 31);
  for (int k = 0; k < per; k += 32)
    if (t0 + k < n) f(t0 + k);        // a block of one warp: n may be < 32
}

// One pass over ONE radix-4 level of size m = 2^lm, in place. `tw` points at
// this pass's three rows of m/4 twiddles: row p-1 holds w_m^(j*p). Its
// 2^(ln-2) items (radix-4 butterflies) are shared out over the block, or
// (kOwned) warp by warp.
template <bool kForward, bool kOwned = false>
__device__ __forceinline__ void pass_one_level(float2* z,
                                               const float2* __restrict__ tw,
                                               int ln, int lm) {
  // the owned passes compute the pass's geometry in each item (fewer live
  // registers there, measured on an H100); the block-wide ones once
  const auto item = [&](int t, int lq, int q) {
    const int j = t & (q - 1);
    const int i0 = ((t >> lq) << lm) + j;
    const float2 w1 = __ldg(tw + j), w2 = __ldg(tw + q + j),
                 w3 = __ldg(tw + 2 * q + j);
    float2 a0 = z[pad(i0)], a1 = z[pad(i0 + q)], a2 = z[pad(i0 + 2 * q)],
           a3 = z[pad(i0 + 3 * q)];
    if (kForward) {
      dft4_forward(a0, a1, a2, a3);
      a1 = cmul(a1, w1);
      a2 = cmul(a2, w2);
      a3 = cmul(a3, w3);
    } else {
      a1 = cmulc(a1, w1);
      a2 = cmulc(a2, w2);
      a3 = cmulc(a3, w3);
      dft4_inverse(a0, a1, a2, a3);
    }
    z[pad(i0)] = a0;
    z[pad(i0 + q)] = a1;
    z[pad(i0 + 2 * q)] = a2;
    z[pad(i0 + 3 * q)] = a3;
  };
  if constexpr (kOwned) {
    for_warp_items(1 << (ln - 2),
                   [&](int t) { item(t, lm - 2, 1 << (lm - 2)); });
  } else {
    const int lq = lm - 2, q = 1 << lq;
    for (int t = threadIdx.x; t < (1 << (ln - 2)); t += blockDim.x)
      item(t, lq, q);
  }
}

// The register work of a pass over TWO radix-4 levels, sizes m and m/4, on
// the 16 points b + j + c*(m/16) + a*(m/4), a, c in 0..3, held as x[a][c]:
// the outer level combines over a for each c, the inner one over c for each
// a (after the outer level, index a names the quarter the point now lives
// in). w[0..2] hold w_m^(j*p), w[3..5] hold w_(m/4)^(j*p), p = 1..3. The
// outer level's twiddle for column c is
// w_m^((j + c*m/16)*p) = w_m^(j*p) * w_16^(c*p).
template <bool kForward>
__device__ __forceinline__ void two_levels_on_registers(float2 (&x)[4][4],
                                                        const float2 (&w)[6]) {
  if (kForward) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dft4_forward(x[0][c], x[1][c], x[2][c], x[3][c]);
#pragma unroll
      for (int p = 1; p < 4; ++p)
        x[p][c] = mul_w16(cmul(x[p][c], w[p - 1]), c * p);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dft4_forward(x[a][0], x[a][1], x[a][2], x[a][3]);
#pragma unroll
      for (int p = 1; p < 4; ++p) x[a][p] = cmul(x[a][p], w[2 + p]);
    }
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int p = 1; p < 4; ++p) x[a][p] = cmulc(x[a][p], w[2 + p]);
      dft4_inverse(x[a][0], x[a][1], x[a][2], x[a][3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int p = 1; p < 4; ++p)
        x[p][c] = cmulc(mul_w16(x[p][c], 16 - c * p), w[p - 1]);
      dft4_inverse(x[0][c], x[1][c], x[2][c], x[3][c]);
    }
  }
}

// One pass over TWO radix-4 levels, sizes m = 2^lm and m/4, in place on the
// 2^ln points of z. `tw` points at this pass's six rows of m/16 twiddles:
// rows 0..2 hold w_m^(j*p), rows 3..5 hold w_(m/4)^(j*p), p = 1..3. Its
// 2^(ln-4) items (16 points each) are shared out over the block, or
// (kOwned) warp by warp.
template <bool kForward, bool kOwned = false>
__device__ __forceinline__ void pass_two_levels(float2* z,
                                                const float2* __restrict__ tw,
                                                int ln, int lm) {
  // the geometry as in pass_one_level
  const auto item = [&](int t, int lq2, int q2, int q1) {
    const int j = t & (q2 - 1);
    const int i0 = ((t >> lq2) << lm) + j;
    float2 w[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) w[p] = __ldg(tw + p * q2 + j);
    float2 x[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[a][c] = z[pad(i0 + c * q2 + a * q1)];
    two_levels_on_registers<kForward>(x, w);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) z[pad(i0 + c * q2 + a * q1)] = x[a][c];
  };
  if constexpr (kOwned) {
    for_warp_items(1 << (ln - 4), [&](int t) {
      item(t, lm - 4, 1 << (lm - 4), 4 << (lm - 4));
    });
  } else {
    const int lq2 = lm - 4, q2 = 1 << lq2, q1 = q2 << 2;
    for (int t = threadIdx.x; t < (1 << (ln - 4)); t += blockDim.x)
      item(t, lq2, q2, q1);
  }
}

// The innermost pass for even ln: forward levels 16 and 4, the spectrum
// multiply, inverse levels 4 and 16, on 16 neighbouring points per thread.
// Its twiddles, w_16^(c*p), are compile-time constants.
// Its 2^(ln-4) items are shared out over the block, or (kOwned) warp by
// warp.
template <bool kOwned = false>
__device__ __forceinline__ void center_pass_16(float2* z,
                                               const float2* __restrict__ spec,
                                               int ln) {
  const auto item = [&](int t) {
    const int i0 = t << 4;
    float2 x[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[a][c] = z[pad(i0 + c + 4 * a)];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dft4_forward(x[0][c], x[1][c], x[2][c], x[3][c]);
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], c * p);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dft4_forward(x[a][0], x[a][1], x[a][2], x[a][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[a][c] = cmul(x[a][c], __ldg(spec + i0 + c + 4 * a));
      dft4_inverse(x[a][0], x[a][1], x[a][2], x[a][3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], 16 - c * p);
      dft4_inverse(x[0][c], x[1][c], x[2][c], x[3][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) z[pad(i0 + c + 4 * a)] = x[a][c];
  };
  if constexpr (kOwned)
    for_warp_items(1 << (ln - 4), item);
  else
    for (int t = threadIdx.x; t < (1 << (ln - 4)); t += blockDim.x) item(t);
}

// The innermost pass for odd ln: forward level 8 and the radix-2 level, the
// spectrum multiply, and their inverses, on 8 neighbouring points per thread.
// Its twiddles are w_8^(c*p) = w_16^(2*c*p).
// Its 2^(ln-3) items are shared out over the block, or (kOwned) warp by
// warp.
template <bool kOwned = false>
__device__ __forceinline__ void center_pass_8(float2* z,
                                              const float2* __restrict__ spec,
                                              int ln) {
  const auto item = [&](int t) {
    const int i0 = t << 3;
    float2 x[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) x[a][c] = z[pad(i0 + c + 2 * a)];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      dft4_forward(x[0][c], x[1][c], x[2][c], x[3][c]);
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], 2 * c * p);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float2 s = cadd(x[a][0], x[a][1]), d = csub(x[a][0], x[a][1]);
      s = cmul(s, __ldg(spec + i0 + 2 * a));
      d = cmul(d, __ldg(spec + i0 + 2 * a + 1));
      x[a][0] = cadd(s, d);
      x[a][1] = csub(s, d);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], 16 - 2 * c * p);
      dft4_inverse(x[0][c], x[1][c], x[2][c], x[3][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) z[pad(i0 + c + 2 * a)] = x[a][c];
  };
  if constexpr (kOwned)
    for_warp_items(1 << (ln - 3), item);
  else
    for (int t = threadIdx.x; t < (1 << (ln - 3)); t += blockDim.x) item(t);
}

// The levels of size <= 2^lm_top of the circular convolution, down and back
// up, on the 2^ln points of z (already synchronised): forward passes, the
// innermost pass with the spectrum multiply, the adjoint passes back. With
// lm_top == ln that is the whole convolution of an n-point window. With
// lm_top < ln, z holds 2^(ln - lm_top) independent runs of 2^lm_top points
// whose higher levels the caller has done (and will undo) itself; lm_top
// then differs from the window's log2 by a multiple of 4 (whole two-level
// passes), so the levels below pair up as they do in the whole window.
// `spec` points at the spectrum entry of z's first point and `tw` at the
// twiddle rows of the first pass at or below lm_top; the passes walk them
// down and back up again. Every thread of the block must call it; it ends in
// a barrier.
__device__ __forceinline__ void convolve_levels(float2* z,
                                                const float2* __restrict__ spec,
                                                const float2* __restrict__ tw,
                                                int ln, int lm_top) {
  // The innermost pass takes the levels of size <= 16 (lm_top even) or <= 8
  // (odd); the outer levels go two per pass from the top, and one alone if
  // their number is odd.
  const int inner = (lm_top & 1) ? 3 : 4;
  int lm = lm_top;
  for (; lm - 4 >= inner; lm -= 4) {
    pass_two_levels<true>(z, tw, ln, lm);
    tw += 6 << (lm - 4);
    __syncthreads();
  }
  const bool single = lm > inner;      // one outer level of size 2^lm left
  if (single) {
    pass_one_level<true>(z, tw, ln, lm);
    __syncthreads();
  }

  if (lm_top & 1) center_pass_8(z, spec, ln);
  else center_pass_16(z, spec, ln);
  __syncthreads();

  // Back out: lm is the lowest outer level (the single one, or the innermost
  // pass's top), so the two-level passes resume four levels of two above it.
  if (single) {
    pass_one_level<false>(z, tw, ln, lm);
    __syncthreads();
  }
  for (lm += 4; lm <= lm_top; lm += 4) {
    tw -= 6 << (lm - 4);
    pass_two_levels<false>(z, tw, ln, lm);
    __syncthreads();
  }
}

// The whole circular convolution of the n = 2^ln points in z.
__device__ __forceinline__ void convolve_window(float2* z,
                                                const float2* __restrict__ spec,
                                                const float2* __restrict__ tw,
                                                int ln) {
  convolve_levels(z, spec, tw, ln, ln);
}

// The owned schedule (csrc/segconv.cu, a window over a cluster). Below a
// window's top pass its points are 16 independent runs of n/16, 16/P of
// them in each block of a cluster of P. convolve_levels_owned runs
// convolve_levels' passes with each pass's items shared out warp by warp,
// so that each run belongs to the same threads in every pass, from its
// first forward level through the spectrum multiply back up, and between
// two passes only the threads that share points wait for each other.

// Threads of a group that owns runs of points below the top pass of a
// window spread over `blocks` blocks of `threads` (16 / blocks runs a
// block): the threads of a run, but WINDOW_FFT_OWNER_THREADS at least (a
// block has 16 hardware barriers and __syncthreads takes one, so 1,024
// threads make at most 8 groups), and the whole block at most. A block of
// 1,024 threads: 8 groups of 128 in a cluster of two (a run of 2,048 points
// each), 4 of 256 in a cluster of four (4,096). kernels/segconv.py::
// owner_threads is the same rule.
__device__ __forceinline__ int owner_threads(int threads, int blocks) {
  const int run = threads * blocks / 16;
  const int width = run > WINDOW_FFT_OWNER_THREADS ? run
                                                    : WINDOW_FFT_OWNER_THREADS;
  return width < threads ? width : threads;
}

// The barrier between two passes of the owned schedule whose runs of points
// (the larger of the two passes') are 2^ls of the block's 2^ln: only the
// threads holding one run wait for each other. A warp where it lies in one
// warp's points; the group of `width` where in a group's, at hardware
// barrier 1 + the group's index (0 is __syncthreads'); else the block.
template <int P>
__device__ __forceinline__ void owned_sync(int ln, int ls) {
  const int width = owner_threads(blockDim.x, P);
  const int span = (int)(blockDim.x >> (ln - ls));
  if (span <= 32) {
    __syncwarp();
  } else if (span <= width && width < (int)blockDim.x) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)threadIdx.x / width),
                 "r"(width)
                 : "memory");
  } else {
    __syncthreads();
  }
}

// convolve_levels in the owned schedule of a window over P blocks. It ends
// with no barrier: the caller's block or cluster barrier follows before any
// thread reads another group's points.
template <int P>
__device__ __forceinline__ void convolve_levels_owned(
    float2* z, const float2* __restrict__ spec, const float2* __restrict__ tw,
    int ln, int lm_top) {
  const int inner = (lm_top & 1) ? 3 : 4;
  int lm = lm_top;
  for (; lm - 4 >= inner; lm -= 4) {
    pass_two_levels<true, true>(z, tw, ln, lm);
    tw += 6 << (lm - 4);
    owned_sync<P>(ln, lm);
  }
  const bool single = lm > inner;
  if (single) {
    pass_one_level<true, true>(z, tw, ln, lm);
    owned_sync<P>(ln, lm);
  }

  if (lm_top & 1) center_pass_8<true>(z, spec, ln);
  else center_pass_16<true>(z, spec, ln);

  if (single) {
    owned_sync<P>(ln, lm);
    pass_one_level<false, true>(z, tw, ln, lm);
  }
  for (lm += 4; lm <= lm_top; lm += 4) {
    owned_sync<P>(ln, lm);
    tw -= 6 << (lm - 4);
    pass_two_levels<false, true>(z, tw, ln, lm);
  }
}

// The top pass of a window spread over a cluster of P blocks: two radix-4
// levels of size n = 2^ln and n/4. Point j + c*(n/16) + a*(n/4) lives in
// block a*P/4 at local index (a % (4/P))*(n/4) + j + c*(n/16); this block
// does the n/(16P) values of j that start at rank * n/(16P).
template <int P, bool kForward>
__device__ __forceinline__ void pass_two_levels_cluster(
    float2* (&zq)[P], const float2* __restrict__ tw, int ln, int rank) {
  const int q2 = 1 << (ln - 4), q1 = q2 << 2;
  const int share = q2 / P;
  for (int t = threadIdx.x; t < share; t += blockDim.x) {
    const int j = rank * share + t;
    float2 w[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) w[p] = __ldg(tw + p * q2 + j);
    float2 x[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[a][c] = zq[a * P / 4][pad((a % (4 / P)) * q1 + j + c * q2)];
    two_levels_on_registers<kForward>(x, w);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        zq[a * P / 4][pad((a % (4 / P)) * q1 + j + c * q2)] = x[a][c];
  }
}

// The whole circular convolution of an n = 2^ln point window spread over a
// cluster of P (2 or 4) blocks, n/P points in each block's z (filled, not
// yet synchronised). Every thread of every block of the cluster calls it;
// it ends in a cluster barrier, after which a block may read its own z.
// kOwned: the levels below the top pass in the owned schedule, whose only
// block-wide barriers are the cluster's.
template <int P, bool kOwned = false>
__device__ __forceinline__ void convolve_window_cluster(
    float2* z, const float2* __restrict__ spec, const float2* __restrict__ tw,
    int ln) {
  namespace cg = cooperative_groups;
  static_assert(P == 2 || P == 4, "a cluster of 2 or 4 blocks");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lm = ln - (P == 4 ? 2 : 1);          // log2 of a block's points
  float2* zq[P];
#pragma unroll
  for (int a = 0; a < P; ++a) zq[a] = cluster.map_shared_rank(z, a);
  cluster.sync();
  pass_two_levels_cluster<P, true>(zq, tw, ln, rank);
  cluster.sync();
  if constexpr (kOwned)
    convolve_levels_owned<P>(z, spec + (rank << lm), tw + (6 << (ln - 4)),
                             lm, ln - 4);
  else
    convolve_levels(z, spec + (rank << lm), tw + (6 << (ln - 4)), lm, ln - 4);
  cluster.sync();
  pass_two_levels_cluster<P, false>(zq, tw, ln, rank);
  cluster.sync();
}

// The transform in halves, for a kernel that does more between the forward
// transform and its adjoint than one spectrum multiply (csrc/convpairs.cu's
// frequency-domain delay line stores the window's spectrum and sums the
// products of many stored spectra with many filters'). The halves run the
// operations of convolve_levels' passes on the same operands in the same
// order: the forward passes down and the forward half of the innermost pass
// leave the window's spectrum in z, in the forward transform's output order
// (the order of the host's spectrum tables); the inverse half of the
// innermost pass and the adjoint passes take it back up.

// The forward half of center_pass_16: levels 16 and 4 on 16 neighbouring
// points a thread.
__device__ __forceinline__ void center_forward_16(float2* z, int ln) {
  for (int t = threadIdx.x; t < (1 << (ln - 4)); t += blockDim.x) {
    const int i0 = t << 4;
    float2 x[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[a][c] = z[pad(i0 + c + 4 * a)];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dft4_forward(x[0][c], x[1][c], x[2][c], x[3][c]);
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], c * p);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dft4_forward(x[a][0], x[a][1], x[a][2], x[a][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) z[pad(i0 + c + 4 * a)] = x[a][c];
    }
  }
}

// The inverse half of center_pass_16.
__device__ __forceinline__ void center_inverse_16(float2* z, int ln) {
  for (int t = threadIdx.x; t < (1 << (ln - 4)); t += blockDim.x) {
    const int i0 = t << 4;
    float2 x[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) x[a][c] = z[pad(i0 + c + 4 * a)];
      dft4_inverse(x[a][0], x[a][1], x[a][2], x[a][3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], 16 - c * p);
      dft4_inverse(x[0][c], x[1][c], x[2][c], x[3][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) z[pad(i0 + c + 4 * a)] = x[a][c];
  }
}

// The forward half of center_pass_8: level 8 and the radix-2 level on 8
// neighbouring points a thread.
__device__ __forceinline__ void center_forward_8(float2* z, int ln) {
  for (int t = threadIdx.x; t < (1 << (ln - 3)); t += blockDim.x) {
    const int i0 = t << 3;
    float2 x[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) x[a][c] = z[pad(i0 + c + 2 * a)];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      dft4_forward(x[0][c], x[1][c], x[2][c], x[3][c]);
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], 2 * c * p);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      z[pad(i0 + 2 * a)] = cadd(x[a][0], x[a][1]);
      z[pad(i0 + 2 * a + 1)] = csub(x[a][0], x[a][1]);
    }
  }
}

// The inverse half of center_pass_8.
__device__ __forceinline__ void center_inverse_8(float2* z, int ln) {
  for (int t = threadIdx.x; t < (1 << (ln - 3)); t += blockDim.x) {
    const int i0 = t << 3;
    float2 x[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float2 s = z[pad(i0 + 2 * a)], d = z[pad(i0 + 2 * a + 1)];
      x[a][0] = cadd(s, d);
      x[a][1] = csub(s, d);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int p = 1; p < 4; ++p) x[p][c] = mul_w16(x[p][c], 16 - 2 * c * p);
      dft4_inverse(x[0][c], x[1][c], x[2][c], x[3][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) z[pad(i0 + c + 2 * a)] = x[a][c];
  }
}

// The forward half of convolve_levels (same arguments, no spectrum): the
// passes down and the innermost pass's forward half. z (already
// synchronised) ends as its spectrum; it ends in a barrier.
__device__ __forceinline__ void forward_levels(float2* z,
                                               const float2* __restrict__ tw,
                                               int ln, int lm_top) {
  const int inner = (lm_top & 1) ? 3 : 4;
  int lm = lm_top;
  for (; lm - 4 >= inner; lm -= 4) {
    pass_two_levels<true>(z, tw, ln, lm);
    tw += 6 << (lm - 4);
    __syncthreads();
  }
  if (lm > inner) {
    pass_one_level<true>(z, tw, ln, lm);
    __syncthreads();
  }
  if (lm_top & 1) center_forward_8(z, ln);
  else center_forward_16(z, ln);
  __syncthreads();
}

// The inverse half of convolve_levels: from a spectrum in z (synchronised)
// back up. `tw` as for forward_levels; it ends in a barrier.
__device__ __forceinline__ void inverse_levels(float2* z,
                                               const float2* __restrict__ tw,
                                               int ln, int lm_top) {
  const int inner = (lm_top & 1) ? 3 : 4;
  int lm = lm_top;
  for (; lm - 4 >= inner; lm -= 4) tw += 6 << (lm - 4);
  const bool single = lm > inner;
  if (lm_top & 1) center_inverse_8(z, ln);
  else center_inverse_16(z, ln);
  __syncthreads();
  if (single) {
    pass_one_level<false>(z, tw, ln, lm);
    __syncthreads();
  }
  for (lm += 4; lm <= lm_top; lm += 4) {
    tw -= 6 << (lm - 4);
    pass_two_levels<false>(z, tw, ln, lm);
    __syncthreads();
  }
}

// The forward half of convolve_window_cluster<P>: z (filled, not yet
// synchronised) ends as this block's slice of the window's spectrum,
// entries [rank * n/P, (rank + 1) * n/P) of the forward transform's output
// order; it ends in a block barrier.
template <int P>
__device__ __forceinline__ void forward_window_cluster(
    float2* z, const float2* __restrict__ tw, int ln) {
  namespace cg = cooperative_groups;
  static_assert(P == 2 || P == 4, "a cluster of 2 or 4 blocks");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float2* zq[P];
#pragma unroll
  for (int a = 0; a < P; ++a) zq[a] = cluster.map_shared_rank(z, a);
  cluster.sync();
  pass_two_levels_cluster<P, true>(zq, tw, ln, rank);
  cluster.sync();
  forward_levels(z, tw + (6 << (ln - 4)), ln - (P == 4 ? 2 : 1), ln - 4);
}

// The inverse half of convolve_window_cluster<P>: from each block's slice
// of a spectrum in z (synchronised in the block) to the window; it ends in
// a cluster barrier, after which a block may read its own z.
template <int P>
__device__ __forceinline__ void inverse_window_cluster(
    float2* z, const float2* __restrict__ tw, int ln) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float2* zq[P];
#pragma unroll
  for (int a = 0; a < P; ++a) zq[a] = cluster.map_shared_rank(z, a);
  inverse_levels(z, tw + (6 << (ln - 4)), ln - (P == 4 ? 2 : 1), ln - 4);
  cluster.sync();
  pass_two_levels_cluster<P, false>(zq, tw, ln, rank);
  cluster.sync();
}

// log2(n) for a power of two n >= 16, else -1.
inline int window_log2(int n) {
  int ln = 0;
  while ((1 << ln) < n) ++ln;
  return ((1 << ln) == n && ln >= 4) ? ln : -1;
}

// Dynamic shared memory of one window, pad slots included.
inline size_t window_smem_bytes(int n) {
  return (size_t)(n + (n >> 4)) * sizeof(float2);
}

// Threads of a block for an n-point window: one per 16 points, a whole warp
// at least, WINDOW_FFT_THREADS at most.
inline int window_threads(int n) {
  int threads = n / 16;
  if (threads > WINDOW_FFT_THREADS) threads = WINDOW_FFT_THREADS;
  if (threads < 32) threads = 32;
  return threads;
}

}  // namespace
