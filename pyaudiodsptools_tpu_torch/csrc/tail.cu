// Fused tail for Hopper (sm_90a): a run of delay / tremolo / waveshaper
// stages in one pass over the signal.
//
// Replaces the TPU kernel pyaudiodsptools_tpu/kernels/tail_pallas.py ::
// tail_kernel (body _kernel, stage loop _apply_stages). For a (C, T) float32
// signal and a stage plan it applies, in order:
//
//   taps  y[t] = (wet ? 0 : x[t]) + sum_k w_k * x[t - d_k],  x[t < 0] = 0
//   gain  y[t] = x[t] * g[row, t]          (the tremolo's precomputed row)
//   map   y[t] = f(x[t]),  f in saturator / softclipper / harddistortion /
//         bitcrusher
//
// and after any stage that precedes a later taps stage, positions before the
// signal start are silence again (harddistortion maps 0 to about 0.95, and a
// delay's history must start at zeros).
//
// What bounds it: bytes. The function reads the signal once and writes it
// once, and does a few operations per sample. Run op by op it would cost one
// round trip through device memory per member. Here one thread block takes
// one (channel, time tile): it loads the tile plus a left halo of `halo`
// samples (the sum of the stages' largest tap offsets) into shared memory,
// applies every stage on the resident window, and stores the tile. The halo
// re-reads of neighbouring blocks hit L2. A stage works only on the part of
// the window that later stages still depend on, so the stages after the last
// taps stage (where the pow and the sine usually are) touch the tile alone.
// Consecutive pointwise stages (gain, map) keep their value in a register: the
// run before the first taps stage is applied while loading, the run after
// the last one while storing, and only a run between two taps stages makes a
// pass of its own over the window.
//
// The stage plan is data: a small table passed by value, so one build serves
// every chain.
//
// The LAST taps stage is evaluated while storing: each output reads its taps
// straight from the window and nothing is written back. An earlier taps stage
// (a plan with two delays) runs IN PLACE: it walks the window from its top
// down in chunks of one position per thread; a chunk reads all its taps
// (which lie at or below each position), synchronises, then writes. Lower
// chunks have not been written yet, so every read sees the stage's input.
//
// The taps and gain stages use __fmul_rn/__fadd_rn so that nvcc does not
// contract them into FMAs: they then round exactly as the member ops run in
// sequence do, which keeps a following bitcrusher (whose floor division
// turns one ulp into a whole 1/64 step) on the same steps.
//
// Plain C interface: tail_launch() enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#define TAIL_MAX_STAGES 16
#define TAIL_MAX_TAPS 64

enum { KIND_TAPS = 0, KIND_GAIN = 1, KIND_MAP = 2 };
enum { MAP_SATURATOR = 0, MAP_SOFTCLIPPER = 1, MAP_HARDDISTORTION = 2,
       MAP_BITCRUSHER = 3 };

// taps: a = first tap slot, b = tap count, p0 = dry weight (1 or 0)
// gain: a = gain row
// map:  a = map code; saturator p0 = coeff, p1 = makeup, b = mode (1 or 2);
//       softclipper p0 = drive
// lo:   first window position whose value later stages (and in the end the
//       tile's outputs) still depend on; the stage computes [lo, W) only.
//       It starts at 0 and rises by each taps stage's largest offset, up to
//       `halo` for the stages after the last taps stage.
struct TailStage {
  int kind, a, b, zero_after, lo;
  float p0, p1;
};

struct TailPlan {
  int n_stages, halo;
  TailStage stages[TAIL_MAX_STAGES];
  int offsets[TAIL_MAX_TAPS];
  float weights[TAIL_MAX_TAPS];
};

namespace {

__device__ __forceinline__ float saturate(float x, float coeff, float makeup,
                                          int mode) {
  float a = fabsf(x);
  const float over = a - coeff;
  float ratio = over / (1.0f - coeff);
  if (mode == 2) ratio = __fmul_rn(ratio, ratio);
  const float shaped = coeff + over / __fadd_rn(1.0f, ratio);
  a = (a > coeff) ? shaped : a;
  a = (a > 1.0f) ? (coeff + 1.0f) / 2.0f : a;
  return makeup * ((x < 0.0f) ? -a : a);
}

__device__ __forceinline__ float softclip(float x, float drive) {
  float a = fminf(fabsf(x), 1.0f);
  a = __fadd_rn(__fmul_rn(-1.0f, powf(fabsf(a - 1.0f), drive)), 1.0f);
  return (x < 0.0f) ? -a : a;
}

__device__ __forceinline__ float harddist(float x) {
  const float hard_limit = 1.0f, linear_limit = 0.8f;
  // 0 counts as positive, and the SIGNED hard limit goes into the sine.
  const float sign = (x >= 0.0f) ? 1.0f : -1.0f;
  float amplitude = fabsf(x);
  amplitude = (amplitude <= linear_limit) ? amplitude : hard_limit * sign;
  const float scale = (float)(1.0 - 0.8);
  const float compression = __fmul_rn(scale, sinf((amplitude - linear_limit) / scale));
  return __fadd_rn(linear_limit, compression) * sign;
}

__device__ __forceinline__ float bitcrush(float x) {
  // float -> int32, wrap (not saturate) to int16, FLOOR division by 512
  // (an arithmetic shift; C's `/` would truncate toward zero), then / 64.
  const int q32 = (int)(x * 32767.0f);
  const int q16 = (int)(short)(unsigned short)(q32 & 0xFFFF);
  return (float)(q16 >> 9) / 64.0f;
}

__device__ __forceinline__ float apply_map(const TailStage& st, float v) {
  switch (st.a) {
    case MAP_SATURATOR: return saturate(v, st.p0, st.p1, st.b);
    case MAP_SOFTCLIPPER: return softclip(v, st.p0);
    case MAP_HARDDISTORTION: return harddist(v);
    default: return bitcrush(v);
  }
}

// One elementwise stage (gain or map) on one value at global time t.
__device__ __forceinline__ float apply_pointwise(const TailStage& st, float v,
                                                 int t,
                                                 const float* __restrict__ gains,
                                                 int T) {
  if (st.kind == KIND_GAIN) {
    v = (t >= 0) ? __fmul_rn(v, gains[(size_t)st.a * T + t]) : v;
  } else {
    v = apply_map(st, v);
  }
  return (st.zero_after && t < 0) ? 0.0f : v;
}

// One taps stage at window position j: dry + sum_k w_k * w[j - d_k], each
// product and sum rounded on its own, in tap order.
__device__ __forceinline__ float taps_at(const TailPlan& plan,
                                         const TailStage& st, const float* w,
                                         int j) {
  float acc = __fmul_rn(st.p0, w[j]);
  for (int i = 0; i < st.b; ++i) {
    const int jj = j - plan.offsets[st.a + i];
    // below the window: either before the signal start (silence) or outside
    // what this tile's outputs depend on
    const float v = (jj >= 0) ? w[jj] : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(plan.weights[st.a + i], v));
  }
  return acc;
}

// Index of the first taps stage at or after k (n_stages if there is none).
__device__ __forceinline__ int next_taps(const TailPlan& plan, int k) {
  while (k < plan.n_stages && plan.stages[k].kind != KIND_TAPS) ++k;
  return k;
}

__global__ void __launch_bounds__(1024)
tail_kernel(const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ gains, const TailPlan plan, int T, int S,
            int n_tiles) {
  extern __shared__ float w[];
  const int c = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int D = plan.halo;
  const int t0 = tile * S;                 // first output sample of the tile
  const int width = min(S, T - t0);        // ragged last tile
  const int W = D + width;                 // resident window [t0 - D, t0 + width)
  const int first = t0 - D;                // global time of w[0], may be < 0
  const float* xc = x + (size_t)c * T;

  // Runs of pointwise stages stay in a register from one stage to the next.
  // The run before the first taps stage rides the load ...
  int k = next_taps(plan, 0);
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int t = first + j;
    float v = (t >= 0) ? xc[t] : 0.0f;
    for (int i = 0; i < k; ++i) v = apply_pointwise(plan.stages[i], v, t, gains, T);
    w[j] = v;
  }
  __syncthreads();

  // ... the last taps stage rides the store (below) ...
  int last_taps = -1;
  while (k < plan.n_stages) {
    const int k_next = next_taps(plan, k + 1);
    if (k_next == plan.n_stages) {
      last_taps = k;
      break;
    }
    // ... an earlier taps stage runs in place, top down ...
    const TailStage st = plan.stages[k];
    for (int hi = W; hi > st.lo; hi -= blockDim.x) {
      const int j = hi - 1 - (int)threadIdx.x;
      float acc = 0.0f;
      if (j >= st.lo) {
        acc = taps_at(plan, st, w, j);
        if (st.zero_after && first + j < 0) acc = 0.0f;
      }
      __syncthreads();
      if (j >= st.lo) w[j] = acc;
    }
    __syncthreads();
    // ... and the pointwise run between two taps stages goes through the
    // window.
    if (k_next > k + 1) {
      for (int j = st.lo + threadIdx.x; j < W; j += blockDim.x) {
        float v = w[j];
        for (int i = k + 1; i < k_next; ++i)
          v = apply_pointwise(plan.stages[i], v, first + j, gains, T);
        w[j] = v;
      }
      __syncthreads();
    }
    k = k_next;
  }

  // The store: the last taps stage (read straight from the window, nothing
  // written back, so no in-place walk and no barriers), then the pointwise
  // run that follows it, then out.
  float* oc = out + (size_t)c * T + t0;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    float v;
    if (last_taps >= 0) v = taps_at(plan, plan.stages[last_taps], w, D + j);
    else v = w[D + j];
    for (int i = (last_taps >= 0 ? last_taps + 1 : k); i < plan.n_stages; ++i)
      v = apply_pointwise(plan.stages[i], v, t0 + j, gains, T);
    oc[j] = v;
  }
}

}  // namespace

extern "C" int tail_launch(const float* x, float* out, const float* gains,
                           const TailPlan* plan, int C, int T, int S,
                           void* stream) {
  if (plan->n_stages > TAIL_MAX_STAGES) return (int)cudaErrorInvalidValue;
  const int n_tiles = (T + S - 1) / S;
  const long long blocks = (long long)C * n_tiles;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int width = S < T ? S : T;
  const size_t smem = (size_t)(plan->halo + width) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_kernel<<<(unsigned)blocks, 1024, smem, (cudaStream_t)stream>>>(
      x, out, gains, *plan, T, S, n_tiles);
  return (int)cudaGetLastError();
}
