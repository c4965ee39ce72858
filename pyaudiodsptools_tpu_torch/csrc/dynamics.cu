// Speculative dynamics walks for Hopper (sm_90a): the compressor / gate
// envelope automaton, or a cascade of them, walked along time by every
// (segment, channel) lane at once.
//
// Replaces the TPU kernels of pyaudiodsptools_tpu/kernels/dynamics_pallas.py
// that dynamics_pallas_offline launches: _spec_kernel (the audio sweep; here
// dynamics_audio_walk) and _spec_state_kernel (the states-only sweep; here
// dynamics_state_walk). Both read the signal (C, T) float32 AS IT LIES,
// cut into G segments of L samples a channel (segment g of channel c is
// x[c, g*L : min((g+1)*L, T)], the last one ragged and walked on zeros past
// T), and the entry state of every lane and op, (n_ops, C*G) int32 with lane
// r = g*C + c; each lane walks its segment and the exit states are written.
// The audio walk also writes the output, (C, T) as the input lies; the state
// walk writes no audio and leaves out the last op's gain, which nothing
// reads. (The TPU kernels read a time-major copy of the signal, made and
// undone by the relayout kernels, csrc/relayout.cu: here no such copy is
// made.)
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
// L times that latency, and with a few tens of thousands of lanes the card
// has only a few warps an SM to hide it with; the loads have to be in flight
// long before the walk needs them. The design: one thread a segment, its
// n_ops states in registers for the whole walk (n_ops is a template
// parameter, so the op loop unrolls and no state is ever spilled or
// indexed). A block takes TILE_ROWS consecutive rows of the (C*G, L) view of
// the signal (row c*G + g is segment g of channel c). It stages tiles of
// TILE_ROWS rows x TILE_K samples through shared memory: each row's TILE_K
// samples are contiguous in device memory, so the copies (cp.async, 16 bytes
// a thread where the signal's shape allows) are coalesced along time, and a
// ring of TILE_STAGES tiles keeps two of them in flight while the threads
// walk the third. Rows lie TILE_PITCH floats apart (TILE_PITCH / 4 odd), so
// the copies into a tile and each thread's 16-byte reads of its own row are
// free of bank conflicts. The audio walk writes its outputs into one of two
// output tiles and the block stores that tile, coalesced along time, after
// the next barrier, while it walks the next tile into the other one. Rows
// past T (the ragged last segment) are filled with zeros by the copy and
// walked; none of their outputs is stored. How many lanes there are (the
// number of segments) is the planner's choice in kernels/dynamics.py.
//
// The two ramps and the output product use __fmul_rn / __fadd_rn / __fsub_rn
// so that nvcc contracts nothing into an FMA: each product and sum rounds on
// its own, as the plain PyTorch version's separate mul and add calls do. That
// matters more here than elsewhere: a gate's mask is |compressor output| >
// threshold, so one ulp can flip a mask bit and send the gate's state down
// another path. Everything else is compares, selects and exact int-to-float
// conversions, so kernel and plain version agree bit for bit.
//
// The serial walk (dynamics_serial_walk / dynamics_serial_step) is the
// streaming step: it replaces dynamics_pallas.py :: dynamics_pallas (body
// _kernel), which walks ONE op over a (C, T) block from a carried state and
// returns the state. Here one launch walks a whole cascade (op j+1 reads op
// j's output sample, which is what the TPU package's op-after-op loop
// computes), reads and writes the block as it lies, channel-major (C, T),
// walks exactly T samples, and (the step entry point) reads and writes the
// four fields {mode, x, y, skip} of every op's carried state itself, as the
// TPU kernel does, packing them into the walk's single int in registers.
//
// What bounds it: nothing the card has much of. The block is a few hundred KB
// and a channel's samples depend on each other through the state, so one
// thread a channel is T times the latency of one sample's dependent chain on
// two warps of the card. The design brings the offline stage's speculation
// inside a thread block:
//   * one thread block a channel: 64 channels sit on 64 SMs;
//   * the channel's samples go through shared memory, loaded and stored with
//     coalesced accesses along time by all the block's threads, a tile of G
//     segments of L = 2^lseg samples at a time (a longer block is walked tile after tile,
//     each from the exit of the one before);
//   * one thread a segment. Every thread walks its segment from a
//     guessed entry, writes its exit to shared memory, takes a new entry
//     from the exits to its left, and repeats until every entry equals its
//     left neighbour's exit. Segment 0's entry is the carried state, never a
//     guess, and each round fixes at least one more segment, so the loop ends
//     within
//     `segments` rounds with every entry the true serial state. Every round
//     walks with audio into a second tile (the state's dependent chain sets
//     the pace; the gain rides beside it), so the round that finds nothing
//     changed has already written the block: a right guess costs ONE walk;
//   * the first guess is the carried state advanced in closed form by the
//     segment's offset as if no sample were over the threshold (a release
//     counts on and ends in skip then REST, HOLD starts a release, an attack
//     runs out and releases, REST stays): exact in silence, where a gate's
//     release (8,824 samples in the flagship chain) outlasts whole blocks,
//     and on loud audio any over-threshold sample sends HOLD and RELEASE to
//     x_max whatever the guess was. A guess only costs rounds: the fixpoint
//     is the serial trajectory;
//   * a sound that dies away inside the block would still hand its state on
//     one silent segment a round. So each walk notes, per op, whether it saw
//     a sample over the threshold; an op that saw none moved exactly as the
//     closed form moves it, and the next entry is taken from the nearest
//     segment to the left that did see one, advanced in closed form over the
//     quiet segments between: a quiet stretch settles in one round.
// Sample i of a tile lies at shared-memory slot i + i/L: segments are L + 1
// slots apart, so the threads of a warp, each reading its own segment, hit
// different banks. Same automaton<> and cascade<> as the walks above with the
// same rounding, so the result is bit-equal to the audio walk at one segment.
//
// Plain C interface: each launcher enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define DYN_MAX_OPS 4
// The serial walk: samples a thread loads into registers before it walks
// them.
#define WALK_CHUNK 8
// The offline walks: rows (segments, one thread each) a block, samples a row
// of a tile, floats between rows in shared memory, tiles in the input ring.
#define TILE_ROWS 128
#define TILE_K 32
#define TILE_PITCH (TILE_K + 4)
#define TILE_STAGES 3
#define TILE_FLOATS (TILE_ROWS * TILE_PITCH)
// The serial walk: at most this many segments (threads) a tile.
#define SERIAL_MAX_THREADS 1024

struct DynOp {
  float thr, pre, ratio, att_step, rel0, rel_step;
  int x_max, end;   // end = x_max + y_max: where a release completes
};

struct DynOps {
  int n_ops;
  DynOp op[DYN_MAX_OPS];
};

// Where the serial walk reads and writes the carried states of a channel.
// Either as single ints, entry and exit (n_ops, C); or (entry == nullptr) as
// the four fields of each op: mode, x, y (int32) and skip (one byte, 0 or 1)
// read from one (C,) array each, and written to ints_out, (n_ops, 3, C) in
// the order mode, x, y, and skip_out, (n_ops, C).
struct DynCarry {
  const int* entry;
  int* exit_state;
  const int* mode[DYN_MAX_OPS];
  const int* x[DYN_MAX_OPS];
  const int* y[DYN_MAX_OPS];
  const unsigned char* skip[DYN_MAX_OPS];
  int* ints_out;
  unsigned char* skip_out;
};

// The modes of the four-field state (ops/dynamics.py).
#define MODE_REST 0
#define MODE_ATTACK 1
#define MODE_HOLD 2
#define MODE_RELEASE 3

namespace {

// One sample of one op whose over-threshold bit is `over`: returns the op's
// output, advances s.
template <bool WITH_GAIN>
__device__ __forceinline__ float automaton(const DynOp& p, int& s, float row,
                                           bool over) {
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

// One sample of one op: returns the op's output, advances s.
template <bool WITH_GAIN>
__device__ __forceinline__ float automaton(const DynOp& p, int& s, float row) {
  return automaton<WITH_GAIN>(p, s, row, fabsf(row) > p.thr);
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

// cp.async of 16 bytes (src_bytes of them read, the rest zeros) and of 4.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One thread's row of a tile, `len` samples: the cascade over each sample in
// order, four at a time out of shared memory; with AUDIO the outputs go to
// the same place in the output tile.
template <int N_OPS, bool AUDIO>
__device__ __forceinline__ void walk_row(const DynOps& ops, int (&s)[N_OPS],
                                         const float* in, float* out,
                                         int len) {
  int k = 0;
  for (; k + 4 <= len; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(in + k);
    float4 y;
    y.x = cascade<N_OPS, AUDIO>(ops, s, q.x);
    y.y = cascade<N_OPS, AUDIO>(ops, s, q.y);
    y.z = cascade<N_OPS, AUDIO>(ops, s, q.z);
    y.w = cascade<N_OPS, AUDIO>(ops, s, q.w);
    if (AUDIO) *reinterpret_cast<float4*>(out + k) = y;
  }
  for (; k < len; ++k) {
    const float y = cascade<N_OPS, AUDIO>(ops, s, in[k]);
    if (AUDIO) out[k] = y;
  }
}

// The offline walks. Block b takes rows b*TILE_ROWS ... of the (C*G, L)
// view, thread i walks row b*TILE_ROWS + i (threads past the last row only
// copy and store). kVec: the signal's rows start on 16-byte boundaries (T,
// L multiples of 4, aligned pointers) and move 16 bytes a copy; else 4.
// Dynamic shared memory: the ring of TILE_STAGES input tiles, with AUDIO two
// output tiles, then each row's offset in x and its length (L, or what is
// left of T in the ragged last segment).
template <int N_OPS, bool AUDIO, bool kVec>
__global__ void __launch_bounds__(TILE_ROWS, 2)
walk_kernel(const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ entry, int* __restrict__ exit_state,
            const DynOps ops, int C, int T, int G, int L) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* otile = ring + TILE_STAGES * TILE_FLOATS;
  long long* row_off = reinterpret_cast<long long*>(
      otile + (AUDIO ? 2 * TILE_FLOATS : 0));
  int* row_len = reinterpret_cast<int*>(row_off + TILE_ROWS);
  constexpr int W = kVec ? 4 : 1;           // floats a copy
  constexpr int CH = TILE_K / W;            // copies a row of a tile
  const int R = C * G;
  const int v0 = (int)blockIdx.x * TILE_ROWS;
  const int rows = min(TILE_ROWS, R - v0);
  const int tid = threadIdx.x;

  int s[N_OPS];
  int lane = 0;
  if (tid < rows) {
    const int c = (v0 + tid) / G, g = v0 + tid - c * G;
    lane = g * C + c;
    row_off[tid] = (long long)c * T + (long long)g * L;
    row_len[tid] = g == G - 1 ? T - g * L : L;
#pragma unroll
    for (int j = 0; j < N_OPS; ++j) s[j] = entry[(size_t)j * R + lane];
  }
  __syncthreads();

  // tile t: samples [t*TILE_K, t*TILE_K + TILE_K) of every row, zeros where
  // a row has none (past its length)
  auto load_tile = [&](int t, float* dst) {
    const int k0 = t * TILE_K;
    for (int i = tid; i < rows * CH; i += TILE_ROWS) {
      const int r = i / CH, k = k0 + (i - r * CH) * W;
      const int valid = max(0, min(W, row_len[r] - k));
      const float* src = x + row_off[r] + (valid > 0 ? k : 0);
      float* d = dst + r * TILE_PITCH + (k - k0);
      if (kVec) copy16(d, src, 4 * valid);
      else copy4(d, src, 4 * valid);
    }
  };
  auto store_tile = [&](int t, const float* src) {
    const int k0 = t * TILE_K;
    for (int i = tid; i < rows * CH; i += TILE_ROWS) {
      const int r = i / CH, k = k0 + (i - r * CH) * W;
      const int valid = max(0, min(W, row_len[r] - k));
      if (valid == 0) continue;
      const float* p = src + r * TILE_PITCH + (k - k0);
      float* d = out + row_off[r] + k;
      if (kVec) {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(p);
      } else {
        *d = *p;
      }
    }
  };

  const int ntiles = (L + TILE_K - 1) / TILE_K;
#pragma unroll
  for (int p = 0; p < TILE_STAGES - 1; ++p) {
    if (p < ntiles) load_tile(p, ring + p * TILE_FLOATS);
    copy_commit();
  }
  for (int t = 0; t <= ntiles; ++t) {
    copy_wait<TILE_STAGES - 2>();          // this thread's copies of tile t
    __syncthreads();                       // everyone's; tile t-1 walked
    if (AUDIO && t > 0) store_tile(t - 1, otile + ((t - 1) & 1) * TILE_FLOATS);
    if (t == ntiles) break;
    const int tn = t + TILE_STAGES - 1;    // into the slot tile t-1 left
    if (tn < ntiles) load_tile(tn, ring + (tn % TILE_STAGES) * TILE_FLOATS);
    copy_commit();
    if (tid < rows)
      walk_row<N_OPS, AUDIO>(
          ops, s, ring + (t % TILE_STAGES) * TILE_FLOATS + tid * TILE_PITCH,
          otile + (t & 1) * TILE_FLOATS + tid * TILE_PITCH,
          min(TILE_K, L - t * TILE_K));
  }

  if (tid < rows) {
#pragma unroll
    for (int j = 0; j < N_OPS; ++j) exit_state[(size_t)j * R + lane] = s[j];
  }
}

size_t walk_smem_bytes(bool audio) {
  return sizeof(float) * (size_t)TILE_FLOATS * (TILE_STAGES + (audio ? 2 : 0)) +
         (sizeof(long long) + sizeof(int)) * TILE_ROWS;
}

template <int N_OPS, bool AUDIO, bool kVec>
int launch_walk(const float* x, float* out, const int* entry, int* exit_state,
                const DynOps* ops, int C, int T, int G, int L,
                cudaStream_t st) {
  const size_t smem = walk_smem_bytes(AUDIO);
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<N_OPS, AUDIO, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((C * G + TILE_ROWS - 1) / TILE_ROWS);
  walk_kernel<N_OPS, AUDIO, kVec><<<blocks, TILE_ROWS, smem, st>>>(
      x, out, entry, exit_state, *ops, C, T, G, L);
  return (int)cudaGetLastError();
}

template <bool AUDIO>
int launch(const float* x, float* out, const int* entry, int* exit_state,
           const DynOps* ops, int C, int T, int G, int L, void* stream) {
  if (ops->n_ops < 1 || ops->n_ops > DYN_MAX_OPS || C < 1 || T < 1 ||
      G < 1 || L < 1 || (long long)(G - 1) * L >= T ||
      (long long)G * L < T || (long long)C * G > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const bool vec = T % 4 == 0 && L % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (!AUDIO || reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
#define WALK_CASE(N)                                                          \
  return vec ? launch_walk<N, AUDIO, true>(x, out, entry, exit_state, ops, C, \
                                           T, G, L, st)                       \
             : launch_walk<N, AUDIO, false>(x, out, entry, exit_state, ops,   \
                                            C, T, G, L, st)
  switch (ops->n_ops) {
    case 1: WALK_CASE(1);
    case 2: WALK_CASE(2);
    case 3: WALK_CASE(3);
    default: WALK_CASE(4);
  }
#undef WALK_CASE
}

// State s after d >= 0 samples none of which is over the threshold: from
// ATTACK, HOLD or RELEASE the single int counts up one a sample (the attack
// runs out into HOLD, HOLD into the release) until the release completes at
// `end` with the skip state, then REST.
__device__ __forceinline__ int advance_quiet(const DynOp& p, int s, int d) {
  if (d == 0) return s;
  if (s <= 0) return 0;
  const int t = s + d;
  return t < p.end ? t : (t == p.end ? -1 : 0);
}

// kernels/dynamics.py :: encode_state and decode_state on one channel.
__device__ __forceinline__ int encode_fields(const DynOp& p, int mode, int x,
                                             int y, bool skip) {
  const int s = mode == MODE_ATTACK ? x
              : mode == MODE_HOLD ? p.x_max
              : mode == MODE_RELEASE ? p.x_max + y : 0;
  return skip ? -1 : s;
}

// One sample through the cascade with audio; loud[j] becomes true if op j
// finds its input over its threshold.
template <int N_OPS>
__device__ __forceinline__ float cascade_noting_loud(const DynOps& ops,
                                                     int (&s)[N_OPS],
                                                     bool (&loud)[N_OPS],
                                                     float row) {
#pragma unroll
  for (int j = 0; j < N_OPS; ++j) {
    const bool over = fabsf(row) > ops.op[j].thr;
    loud[j] |= over;
    row = automaton<true>(ops.op[j], s[j], row, over);
  }
  return row;
}

// `len` samples of one segment walked from states s, with audio. An op whose
// loud[j] stays false has moved exactly as advance_quiet() moves it.
template <int N_OPS>
__device__ __forceinline__ void walk_segment(const DynOps& ops, int (&s)[N_OPS],
                                             bool (&loud)[N_OPS],
                                             const float* seg_in,
                                             float* seg_out, int len) {
  int i = 0;
  for (; i + WALK_CHUNK <= len; i += WALK_CHUNK) {
    float v[WALK_CHUNK];
#pragma unroll
    for (int k = 0; k < WALK_CHUNK; ++k) v[k] = seg_in[i + k];
#pragma unroll
    for (int k = 0; k < WALK_CHUNK; ++k)
      seg_out[i + k] = cascade_noting_loud<N_OPS>(ops, s, loud, v[k]);
  }
  for (; i < len; ++i)
    seg_out[i] = cascade_noting_loud<N_OPS>(ops, s, loud, seg_in[i]);
}

// The nearest segment left of g whose bit in `quiet` (one bit a segment, 32
// a word) is clear. Bit 0 of word 0 is always clear.
__device__ __forceinline__ int nearest_loud_left(const unsigned* quiet, int g) {
  int w = (g - 1) >> 5;
  unsigned bits = ~quiet[w] & (0xffffffffu >> (31 - ((g - 1) & 31)));
  while (bits == 0) bits = ~quiet[--w];
  return (w << 5) + 31 - __clz(bits);
}

// One thread block a channel, G segments of 2^lseg samples a tile, thread g
// walking segment g. The block may have more threads than segments (whole
// warps, G <= blockDim.x): the others help to load and store the tile, which
// with one thread a segment would take as long as a round. Dynamic shared
// memory: G * (2^lseg + 1) floats for the tile's input, as many for its
// output, then N_OPS * G ints for the segments' exit states. `rounds`, where
// not null, receives per channel the rounds of the fixpoint loop (walks of a
// segment) summed over the tiles.
template <int N_OPS>
__global__ void __launch_bounds__(SERIAL_MAX_THREADS)
serial_walk_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const DynCarry carry, const DynOps ops, int C, int T,
                   int lseg, int G, int* __restrict__ rounds) {
  extern __shared__ float tile[];
  __shared__ unsigned quiet[DYN_MAX_OPS * (SERIAL_MAX_THREADS / 32)];
  const int g = threadIdx.x, L = 1 << lseg, threads = blockDim.x;
  const int c = blockIdx.x;
  float* tile_out = tile + G * (L + 1);
  int* seg_exit = reinterpret_cast<int*>(tile_out + G * (L + 1));
  const float* seg_in = tile + min(g, G - 1) * (L + 1);
  float* seg_out = tile_out + min(g, G - 1) * (L + 1);

  int carried[N_OPS];
#pragma unroll
  for (int j = 0; j < N_OPS; ++j)
    carried[j] = carry.entry != nullptr
        ? carry.entry[(size_t)j * C + c]
        : encode_fields(ops.op[j], carry.mode[j][c], carry.x[j][c],
                        carry.y[j][c], carry.skip[j][c] != 0);

  const float* xc = x + (size_t)c * T;
  float* outc = out + (size_t)c * T;
  int n_rounds = 0;
  for (int t0 = 0; t0 < T; t0 += G * L) {
    const int len = min(G * L, T - t0);
    for (int k = g; k < len; k += threads)
      tile[k + (k >> lseg)] = xc[t0 + k];
    __syncthreads();

    // threads past the last segment walk nothing (and are never looked at:
    // a search to the left starts at a segment with samples)
    const int my_len = g < G ? max(0, min(L, len - g * L)) : 0;
    const int last = (len - 1) >> lseg;       // the last segment with samples
    // Every round walks WITH audio into the output tile: the state's
    // dependent chain sets the pace and the gain rides beside it, and the
    // round that finds no entry changed has already written the right
    // samples, so no walk follows the loop.
    int e[N_OPS];
#pragma unroll
    for (int j = 0; j < N_OPS; ++j)
      e[j] = advance_quiet(ops.op[j], carried[j], g * L);
    for (;;) {
      int s[N_OPS];
      bool loud[N_OPS];
#pragma unroll
      for (int j = 0; j < N_OPS; ++j) {
        s[j] = e[j];
        loud[j] = false;
      }
      walk_segment<N_OPS>(ops, s, loud, seg_in, seg_out, my_len);
#pragma unroll
      for (int j = 0; j < N_OPS; ++j) {
        if (g < G) seg_exit[j * G + g] = s[j];
        // segment 0 starts from the true state: it counts as loud, so that
        // every search to the left ends
        const unsigned m = __ballot_sync(0xffffffffu, !loud[j] && g != 0);
        if ((g & 31) == 0)
          quiet[j * (SERIAL_MAX_THREADS / 32) + (g >> 5)] = m;
      }
      __syncthreads();
      int changed = 0;
      if (g > 0 && g <= last) {
#pragma unroll
        for (int j = 0; j < N_OPS; ++j) {
          changed |= (seg_exit[j * G + g - 1] != e[j]);
          // The next entry: the exit of the nearest segment to the left
          // where op j saw a loud sample, advanced over the quiet segments
          // between (none: the left neighbour's exit as it is). The
          // segments that walked from true entries have true exits and true
          // quiet bits, so this fixes at least one more segment a round,
          // like taking the neighbour's exit, and a whole quiet stretch at
          // once.
          const int h = nearest_loud_left(
              quiet + j * (SERIAL_MAX_THREADS / 32), g);
          e[j] = advance_quiet(ops.op[j], seg_exit[j * G + h],
                               (g - 1 - h) * L);
        }
      }
#pragma unroll
      for (int j = 0; j < N_OPS; ++j) carried[j] = seg_exit[j * G + last];
      ++n_rounds;
      // a barrier as well: the exits are read before the next round's are
      // written, and the output tile is whole before it is stored
      if (!__syncthreads_or(changed)) break;
    }
    for (int k = g; k < len; k += threads)
      outc[t0 + k] = tile_out[k + (k >> lseg)];
    // the next tile's loads touch the input tile only, and its first barrier
    // stands between this store and the next write of the output tile
  }

  if (g != 0) return;
  if (rounds != nullptr) rounds[c] = n_rounds;
#pragma unroll
  for (int j = 0; j < N_OPS; ++j) {
    const int v = carried[j];
    if (carry.entry != nullptr) {
      carry.exit_state[(size_t)j * C + c] = v;
      continue;
    }
    const int x_max = ops.op[j].x_max;
    const bool attack = v > 0 && v < x_max, hold = v == x_max,
               release = v > x_max;
    int* f = carry.ints_out + (size_t)j * 3 * C + c;
    f[0] = attack ? MODE_ATTACK
         : hold ? MODE_HOLD : release ? MODE_RELEASE : MODE_REST;
    f[C] = (attack || hold) ? v : 0;
    f[2 * (size_t)C] = release ? v - x_max : 0;
    carry.skip_out[(size_t)j * C + c] = v < 0 ? 1 : 0;
  }
}

int launch_serial(const float* x, float* out, const DynCarry& carry,
                  const DynOps* ops, int C, int T, int lseg, int segments,
                  int threads, int* rounds, void* stream) {
  if (ops->n_ops < 1 || ops->n_ops > DYN_MAX_OPS || T < 1 || C <= 0 ||
      lseg < 0 || lseg > 20 || segments < 1 || segments > threads ||
      threads % 32 != 0 || threads > SERIAL_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)segments *
                      (2 * ((1u << lseg) + 1) + ops->n_ops);
  cudaStream_t st = (cudaStream_t)stream;
#define SERIAL_CASE(N)                                                       \
  {                                                                          \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        serial_walk_kernel<N>,                                               \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);             \
    if (err != cudaSuccess) return (int)err;                                 \
    serial_walk_kernel<N><<<C, threads, smem, st>>>(                         \
        x, out, carry, *ops, C, T, lseg, segments, rounds);                  \
  }
  switch (ops->n_ops) {
    case 1: SERIAL_CASE(1) break;
    case 2: SERIAL_CASE(2) break;
    case 3: SERIAL_CASE(3) break;
    default: SERIAL_CASE(4) break;
  }
#undef SERIAL_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Serial walk: out (C, T) and exit states (n_ops, C) from x (C, T),
// channel-major, and entry states (n_ops, C), in tiles of `segments` segments
// of 2^lseg samples, `threads` (>= segments, whole warps) a block. rounds:
// (C,) ints or null.
extern "C" int dynamics_serial_walk_launch(const float* x, float* out,
                                           const int* entry, int* exit_state,
                                           const DynOps* ops, int C, int T,
                                           int lseg, int segments, int threads,
                                           int* rounds, void* stream) {
  if (entry == nullptr || exit_state == nullptr)
    return (int)cudaErrorInvalidValue;
  DynCarry carry = {};
  carry.entry = entry;
  carry.exit_state = exit_state;
  return launch_serial(x, out, carry, ops, C, T, lseg, segments, threads,
                       rounds, stream);
}

// The streaming step: the same walk with the carried states as the four
// fields of each op. `carry` holds the 4 * n_ops input arrays and the two
// output arrays (its entry and exit_state are null).
extern "C" int dynamics_serial_step_launch(const float* x, float* out,
                                           const DynCarry* carry,
                                           const DynOps* ops, int C, int T,
                                           int lseg, int segments, int threads,
                                           void* stream) {
  if (carry->entry != nullptr || carry->ints_out == nullptr ||
      carry->skip_out == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_serial(x, out, *carry, ops, C, T, lseg, segments, threads,
                       nullptr, stream);
}

// Audio walk: out (C, T) and exit states (n_ops, C*G) from x (C, T), cut
// into G segments of L samples a channel ((G-1)*L < T <= G*L), and entry
// states (n_ops, C*G), lane g*C + c.
extern "C" int dynamics_audio_walk_launch(const float* x, float* out,
                                          const int* entry, int* exit_state,
                                          const DynOps* ops, int C, int T,
                                          int G, int L, void* stream) {
  return launch<true>(x, out, entry, exit_state, ops, C, T, G, L, stream);
}

// State walk: exit states only.
extern "C" int dynamics_state_walk_launch(const float* x, const int* entry,
                                          int* exit_state, const DynOps* ops,
                                          int C, int T, int G, int L,
                                          void* stream) {
  return launch<false>(x, nullptr, entry, exit_state, ops, C, T, G, L,
                       stream);
}

// ---------------------------------------------------------------------------
// The settle step of the offline fixpoint (no TPU kernel: the counterpart of
// dynamics_pallas.py's next_entries and jnp.all inside dynamics_pallas_offline's
// lax.while_loop). After a walk has written its exit states z (n_ops, R), one
// launch
//   * writes the next entries into e (n_ops, R) in place: lane r = g*C + c of
//     segment g+1 takes segment g's exit z[r - C], segment 0 keeps REST (0);
//   * compares them with the entries the walk started from (e before the
//     write): flags[0] = 1 where none changed;
//   * counts the walk: flags[1] = 1 after the state walk (mode 0), else + 1;
//     flags[2] counts the audio walks of every settle since the flags were
//     zeroed (modes 1 and 2), so that a reader can sum the walks of many
//     replays of a graph;
//   * in a CUDA graph's while node (mode 2) sets the node's condition to
//     !done && walks < limit, the loop's bound G + 2 of dynamics_pallas.py;
//     a loop that ends at the bound unsettled adds 1 to flags[3].
// Each element is read and written by one thread only (e and z are distinct
// buffers), so nothing waits for anything but the block's one reduction.
// What bounds it: a few hundred KB read and written once by ONE block (the
// flag needs the whole comparison), a few microseconds at chain8's 32,768
// ints; the walks around it take hundreds.

#define SETTLE_THREADS 1024

namespace {

__global__ void __launch_bounds__(SETTLE_THREADS)
settle_kernel(const int* __restrict__ z, int* __restrict__ e,
              int* __restrict__ flags, long long total, int C, int R,
              int mode, int limit, cudaGraphConditionalHandle handle) {
  int changed = 0;
  for (long long i = threadIdx.x; i < total; i += SETTLE_THREADS) {
    const int r = (int)(i % R);
    const int next = r >= C ? z[i - C] : 0;
    changed |= next != e[i];
    e[i] = next;
  }
  changed = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    const int done = !changed;
    const int walks = mode == 0 ? 1 : flags[1] + 1;
    flags[0] = done;
    flags[1] = walks;
    if (mode != 0) flags[2] += 1;
    if (mode == 2) {
      const int more = !done && walks < limit;
      if (!done && !more) flags[3] += 1;
      cudaGraphSetConditional(handle, (unsigned int)more);
    }
  }
}

}  // namespace

// The settle step: z, e (n_ops, C*G) int32, flags int32[4]; mode 0 after the
// state walk, 1 after an audio walk run eagerly, 2 inside a while node whose
// conditional handle is `handle`.
extern "C" int dynamics_settle_launch(const int* z, int* e, int* flags,
                                      int n_ops, int C, int R, int mode,
                                      int limit,
                                      unsigned long long handle,
                                      void* stream) {
  if (n_ops < 1 || n_ops > DYN_MAX_OPS || C < 1 || R < C || mode < 0 ||
      mode > 2 || z == nullptr || e == nullptr || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  settle_kernel<<<1, SETTLE_THREADS, 0, (cudaStream_t)stream>>>(
      z, e, flags, (long long)n_ops * R, C, R, mode, limit,
      (cudaGraphConditionalHandle)handle);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The round step of the time-sharded dynamics (parallel/dynspec.py; no TPU
// kernel: the counterpart of the body of the lax.while_loop in
// pyaudiodsptools_tpu/parallel/dynspec.py, after its ppermute). Each time rank
// walks its shard with the serial walk; its exits go to the next time rank
// (NCCL, point to point) into `came`. Then one launch, mode 0:
//   * writes the next entries into e (n_ops, C) in place: `came` as it is,
//     REST (0) on time rank 0 (`first`), which receives nothing;
//   * counts the round where the JAX package's loop runs it (it is "live"):
//     the first round of the render, or one after a round in which an entry
//     moved on some time rank (flags[0], as the last round's all-reduce left
//     it); flags[1] counts this render's live rounds, flags[2] every live
//     round since the flags were zeroed (a reader sums many replays);
//   * compares the next entries with the ones the round walked from:
//     flags[0] = 1 where one moved (the flag is then all-reduced, max, over
//     the time ranks, in place).
// Mode 1, the round gate, before a round inside a CUDA graph: sets the
// conditional `handle` of the if node that holds the round's walk to "the
// round is live". A captured render runs n_time rounds, unrolled (NCCL's work
// inside a conditional while node was refused on the H100: PERF.md), each
// walk in an if node; a round after the fixpoint walks from the same entries,
// so skipping its walk leaves the loop's output and exits as they are.
// What bounds it: a few hundred ints by one block; the walk beside it takes
// milliseconds.

#define ROUND_THREADS 256

namespace {

__global__ void __launch_bounds__(ROUND_THREADS)
round_kernel(const int* __restrict__ came, int* __restrict__ e,
             int* __restrict__ flags, int total, int first, int mode,
             cudaGraphConditionalHandle handle) {
  const bool live = flags[1] == 0 || flags[0] != 0;
  if (mode == 1) {
    if (threadIdx.x == 0) cudaGraphSetConditional(handle, live ? 1u : 0u);
    return;
  }
  int changed = 0;
  for (int i = threadIdx.x; i < total; i += ROUND_THREADS) {
    const int next = first ? 0 : came[i];
    changed |= next != e[i];
    e[i] = next;
  }
  changed = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    if (live) {
      flags[1] += 1;
      flags[2] += 1;
    }
    flags[0] = changed;
  }
}

}  // namespace

// The round step: came, e (n_ops, C) int32 (`total` = n_ops * C; came unread
// where `first`), flags int32[3]; mode 0 the step, mode 1 the gate of the
// if node whose conditional handle is `handle`.
extern "C" int dynamics_round_launch(const int* came, int* e, int* flags,
                                     int total, int first, int mode,
                                     unsigned long long handle,
                                     void* stream) {
  if (flags == nullptr || mode < 0 || mode > 1 ||
      (mode == 0 && (total < 1 || e == nullptr ||
                     (!first && came == nullptr))))
    return (int)cudaErrorInvalidValue;
  round_kernel<<<1, mode == 0 ? ROUND_THREADS : 32, 0,
                 (cudaStream_t)stream>>>(came, e, flags, total, first, mode,
                                         (cudaGraphConditionalHandle)handle);
  return (int)cudaGetLastError();
}
