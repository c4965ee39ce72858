// Speculative dynamics walks for Hopper (sm_90a): the compressor / gate
// envelope automaton, or a cascade of them, walked along time by every
// (segment, channel) lane at once.
//
// Replaces the TPU kernels of pyaudiodsptools_tpu/kernels/dynamics_pallas.py
// that dynamics_pallas_offline launches: _spec_kernel (the audio sweep; here
// dynamics_audio_walk) and _spec_state_kernel (the states-only sweep; here
// dynamics_state_walk). Both read a time-major (L, Rp) float32 signal (lane
// r = g*C + c, see csrc/relayout.cu) and the entry state of every lane and
// op, (n_ops, Rp) int32, walk the L rows, and write the exit states. The
// audio walk also writes the (L, Rp) output; the state walk writes no audio
// and leaves out the last op's gain, which nothing reads.
//
// One state int per lane and op (dynamics_pallas.py: the encoding comment):
//   s = -1           skip (one sample after a completed release)
//   s = 0            REST
//   s in [1, x_max)  ATTACK, x == s
//   s = x_max        HOLD
//   s = x_max + y    RELEASE, y in [1, y_max)
// One sample of one op (dynamics_pallas.py: _int_automaton), to the letter:
//   over  = |row| > thr
//   att_g = 1 + s * att_step
//   rel_g = rel0 + (s - x_max) * rel_step
//   gain  = s > 0 ? (s < x_max ? att_g : (over ? ratio : rel_g)) : 1
//   out   = (row * pre) * gain              -- the next op's input
//   next  = s < 0 ? 0 : s == 0 ? over : s in attack ? s + 1
//           : over ? x_max : (s + 1 == end ? -1 : s + 1)
// `ratio` (the hold gain, attack_env[x_max-1]) and `rel0` (release_env[0])
// are separate scalars: they differ when x_max == 1.
//
// What bounds them: by bytes the audio walk reads and writes the signal once
// (8 bytes a sample) and the state walk reads it once (4 bytes a sample).
// But a lane's walk is SERIAL: each sample's state depends on the one
// before, about a dozen dependent instructions per op, so a thread's time is
// L times that latency and the card is full only when there are a few
// hundred thousand lanes. The design: one thread per lane, its n_ops states
// in registers for the whole walk (n_ops is a template parameter, so the op
// loop unrolls and no state is ever spilled or indexed); neighbouring
// threads are neighbouring lanes, so every row's loads and stores are
// coalesced without shared memory; and since the input never depends on the
// state, each thread loads a chunk of WALK_CHUNK rows into registers before
// it walks them, which keeps that many loads in flight per thread and takes
// the memory latency out of the dependent chain. How many lanes there are
// (the number of segments) is the planner's choice in kernels/dynamics.py.
//
// The two ramps and the output product use __fmul_rn / __fadd_rn / __fsub_rn
// so that nvcc contracts nothing into an FMA: each product and sum rounds on
// its own, as the plain PyTorch version's separate mul and add calls do. That
// matters more here than elsewhere: a gate's mask is |compressor output| >
// threshold, so one ulp can flip a mask bit and send the gate's state down
// another path. Everything else is compares, selects and exact int-to-float
// conversions, so kernel and plain version agree bit for bit.
//
// The serial walk (dynamics_serial_walk) is the streaming step: it replaces
// dynamics_pallas.py :: dynamics_pallas (body _kernel), which walks ONE op
// over a (C, T) block from a carried state and returns the state. Here one
// launch walks a whole cascade (op j+1 reads op j's output sample, which is
// what the TPU package's op-after-op loop computes), reads and writes the
// block as it lies, channel-major (C, T), and walks exactly T samples: there
// is no tile padding whose samples a guard would have to keep off the state.
// One thread per channel, the same automaton<> and cascade<> as the walks
// above with the same rounding, so it is bit-equal to the audio walk at one
// segment. What bounds it: nothing the card has much of. A block of 64
// channels is two warps; the time is T times the latency of one sample's
// dependent chain. Thread c reads x[c*T + t], so neighbouring threads are T
// floats apart and a warp's load touches 32 cache lines; the block (a few
// hundred KB) sits in L1/L2, each thread's WALK_CHUNK loads are issued
// before the chunk is walked, and the next seven samples of a line are hits.
//
// Plain C interface: each launcher enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#define DYN_MAX_OPS 4
#define WALK_CHUNK 8
#define WALK_THREADS 128
// One warp a block: 64 channels spread over two SMs.
#define SERIAL_THREADS 32

struct DynOp {
  float thr, pre, ratio, att_step, rel0, rel_step;
  int x_max, end;   // end = x_max + y_max: where a release completes
};

struct DynOps {
  int n_ops;
  DynOp op[DYN_MAX_OPS];
};

namespace {

// One sample of one op: returns the op's output, advances s.
template <bool WITH_GAIN>
__device__ __forceinline__ float automaton(const DynOp& p, int& s, float row) {
  const bool over = fabsf(row) > p.thr;
  const bool pos = s > 0;
  const bool in_att = pos && (s < p.x_max);
  float out = row;
  if (WITH_GAIN) {
    const float s_f = (float)s;
    const float att_g = __fadd_rn(1.0f, __fmul_rn(s_f, p.att_step));
    const float rel_g = __fadd_rn(
        p.rel0, __fmul_rn(__fsub_rn(s_f, (float)p.x_max), p.rel_step));
    const float hi_g = over ? p.ratio : rel_g;
    const float gain = pos ? (in_att ? att_g : hi_g) : 1.0f;
    out = __fmul_rn(__fmul_rn(row, p.pre), gain);
  }
  const int sp1 = s + 1;
  const int rel_next = (sp1 == p.end) ? -1 : sp1;   // release done -> skip
  const int hi_next = over ? p.x_max : rel_next;    // hold stay / re-trigger
  int n = in_att ? sp1 : hi_next;                   // attack ignores the mask
  n = (s == 0) ? (int)over : n;                     // REST trigger
  n = (s < 0) ? 0 : n;                              // skip consumes itself
  s = n;
  return out;
}

template <int N_OPS, bool AUDIO>
__device__ __forceinline__ float cascade(const DynOps& ops, int (&s)[N_OPS],
                                         float row) {
#pragma unroll
  for (int j = 0; j < N_OPS; ++j) {
    if (AUDIO || j + 1 < N_OPS)
      row = automaton<true>(ops.op[j], s[j], row);
    else
      automaton<false>(ops.op[j], s[j], row);
  }
  return row;
}

template <int N_OPS, bool AUDIO>
__global__ void __launch_bounds__(WALK_THREADS)
walk_kernel(const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ entry, int* __restrict__ exit_state,
            const DynOps ops, int L, int Rp) {
  const int r = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (r >= Rp) return;
  int s[N_OPS];
#pragma unroll
  for (int j = 0; j < N_OPS; ++j) s[j] = entry[(size_t)j * Rp + r];

  const float* xr = x + r;
  float* outr = AUDIO ? out + r : nullptr;
  int l = 0;
  for (; l + WALK_CHUNK <= L; l += WALK_CHUNK) {
    float v[WALK_CHUNK];
#pragma unroll
    for (int k = 0; k < WALK_CHUNK; ++k) v[k] = xr[(size_t)(l + k) * Rp];
#pragma unroll
    for (int k = 0; k < WALK_CHUNK; ++k) {
      const float y = cascade<N_OPS, AUDIO>(ops, s, v[k]);
      if (AUDIO) outr[(size_t)(l + k) * Rp] = y;
    }
  }
  for (; l < L; ++l) {
    const float y = cascade<N_OPS, AUDIO>(ops, s, xr[(size_t)l * Rp]);
    if (AUDIO) outr[(size_t)l * Rp] = y;
  }

#pragma unroll
  for (int j = 0; j < N_OPS; ++j) exit_state[(size_t)j * Rp + r] = s[j];
}

template <bool AUDIO>
int launch(const float* x, float* out, const int* entry, int* exit_state,
           const DynOps* ops, int L, int Rp, void* stream) {
  if (ops->n_ops < 1 || ops->n_ops > DYN_MAX_OPS || L < 0 || Rp <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((Rp + WALK_THREADS - 1) / WALK_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (ops->n_ops) {
    case 1:
      walk_kernel<1, AUDIO><<<blocks, WALK_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, L, Rp);
      break;
    case 2:
      walk_kernel<2, AUDIO><<<blocks, WALK_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, L, Rp);
      break;
    case 3:
      walk_kernel<3, AUDIO><<<blocks, WALK_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, L, Rp);
      break;
    default:
      walk_kernel<4, AUDIO><<<blocks, WALK_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, L, Rp);
      break;
  }
  return (int)cudaGetLastError();
}

template <int N_OPS>
__global__ void __launch_bounds__(SERIAL_THREADS)
serial_walk_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const int* __restrict__ entry, int* __restrict__ exit_state,
                   const DynOps ops, int C, int T) {
  const int c = blockIdx.x * SERIAL_THREADS + threadIdx.x;
  if (c >= C) return;
  int s[N_OPS];
#pragma unroll
  for (int j = 0; j < N_OPS; ++j) s[j] = entry[(size_t)j * C + c];

  const float* xc = x + (size_t)c * T;
  float* outc = out + (size_t)c * T;
  int t = 0;
  for (; t + WALK_CHUNK <= T; t += WALK_CHUNK) {
    float v[WALK_CHUNK];
#pragma unroll
    for (int k = 0; k < WALK_CHUNK; ++k) v[k] = xc[t + k];
#pragma unroll
    for (int k = 0; k < WALK_CHUNK; ++k)
      outc[t + k] = cascade<N_OPS, true>(ops, s, v[k]);
  }
  for (; t < T; ++t) outc[t] = cascade<N_OPS, true>(ops, s, xc[t]);

#pragma unroll
  for (int j = 0; j < N_OPS; ++j) exit_state[(size_t)j * C + c] = s[j];
}

}  // namespace

// Serial walk: out (C, T) and exit states (n_ops, C) from x (C, T),
// channel-major, and entry states (n_ops, C).
extern "C" int dynamics_serial_walk_launch(const float* x, float* out,
                                           const int* entry, int* exit_state,
                                           const DynOps* ops, int C, int T,
                                           void* stream) {
  if (ops->n_ops < 1 || ops->n_ops > DYN_MAX_OPS || T < 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((C + SERIAL_THREADS - 1) / SERIAL_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (ops->n_ops) {
    case 1:
      serial_walk_kernel<1><<<blocks, SERIAL_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, C, T);
      break;
    case 2:
      serial_walk_kernel<2><<<blocks, SERIAL_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, C, T);
      break;
    case 3:
      serial_walk_kernel<3><<<blocks, SERIAL_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, C, T);
      break;
    default:
      serial_walk_kernel<4><<<blocks, SERIAL_THREADS, 0, st>>>(
          x, out, entry, exit_state, *ops, C, T);
      break;
  }
  return (int)cudaGetLastError();
}

// Audio walk: out (L, Rp) and exit states (n_ops, Rp) from x (L, Rp) and
// entry states (n_ops, Rp).
extern "C" int dynamics_audio_walk_launch(const float* x, float* out,
                                          const int* entry, int* exit_state,
                                          const DynOps* ops, int L, int Rp,
                                          void* stream) {
  return launch<true>(x, out, entry, exit_state, ops, L, Rp, stream);
}

// State walk: exit states only.
extern "C" int dynamics_state_walk_launch(const float* x, const int* entry,
                                          int* exit_state, const DynOps* ops,
                                          int L, int Rp, void* stream) {
  return launch<false>(x, nullptr, entry, exit_state, ops, L, Rp, stream);
}
