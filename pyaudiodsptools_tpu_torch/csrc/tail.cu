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
// and the input of every taps stage is silence before the signal start
// (harddistortion maps 0 to about 0.95, and a delay's history starts at
// zeros).
//
// What bounds it: bytes. The function reads the signal once and writes it
// once, and does a few operations per sample. The design: a thread block
// WALKS ALONG TIME. It takes a run of consecutive tiles of S samples of one
// channel, and keeps the input of each taps stage in a ring buffer: the
// stage's reach (its largest tap offset) of history plus the tile, so the
// history is read from device memory once per run and not once per tile.
// A run that does not start at the signal start first walks the tiles that
// cover the halo D (the sum of the stages' reaches) without storing them:
// from there on every ring holds what it would hold had the run started at
// time 0. The first ring has room for one more tile, into which the next
// tile comes by 16-byte cp.async while the block works on the current one
// (a double buffer; more tiles in flight measured no faster on an H100: the
// kernel is bound by its instructions, PERF.md). Stores are 16 bytes wide.
// The host (kernels/tail.py) picks the tile, the rings' layout and the runs
// per channel so that the grid fills the card with two blocks an SM; where
// the rings do not fit shared memory the same kernel keeps them in a
// device-memory scratch slice of its own (and copies each tile in with
// plain loads).
//
// Stage by stage on a tile:
//   * the pointwise run before the first taps stage (if any) is applied in
//     place on the tile in the first ring;
//   * every taps stage but the last reads its ring and writes, after the
//     pointwise run that follows it, into the next taps stage's ring (one
//     position a thread: rings never alias, so there is no in-place walk);
//   * the last taps stage and the pointwise run after it are evaluated while
//     storing, four positions a thread (a 16-byte store); a plan without a
//     taps stage applies all its stages there.
//
// The taps and gain stages use __fmul_rn/__fadd_rn so that nvcc does not
// contract them into FMAs: they then round exactly as the member ops run in
// sequence do, which keeps a following bitcrusher (whose floor division
// turns one ulp into a whole 1/64 step) on the same steps.
//
// The stage plan is DATA: a small int32 table (floats as their bits) that
// the host builds once per plan and keeps on the device. A block copies it
// into shared memory at its start (or reads it from device memory where it
// is too large), so one build serves every chain, of any number of stages
// and taps.
//
// Plain C interface: tail_launch() enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define TAIL_THREADS 512

enum { KIND_TAPS = 0, KIND_GAIN = 1, KIND_MAP = 2 };
enum { MAP_SATURATOR = 0, MAP_SOFTCLIPPER = 1, MAP_HARDDISTORTION = 2,
       MAP_BITCRUSHER = 3 };

// The table (kernels/tail.py::stage_table writes it):
//   header, TAB_HEADER words: n_stages, n_taps, first_taps, last_taps
//     (-1 where the plan has no taps stage), then zeros;
//   stage k at TAB_HEADER + TAB_STAGE*k:
//     kind, a, b, buf_off, buf_len, p0 (float bits), p1 (float bits), next
//     taps: a = first tap slot, b = tap count, p0 = dry weight (1 or 0),
//           buf_off / buf_len = its input ring (floats from the ring base,
//           a multiple of the tile), next = the next taps stage (n_stages
//           if none)
//     gain: a = gain row
//     map:  a = map code; saturator p0 = coeff, p1 = makeup, b = mode (1
//           or 2); softclipper p0 = drive
//   then the n_taps tap offsets, then the n_taps tap weights (float bits).
#define TAB_HEADER 8
#define TAB_STAGE 8

namespace {

struct Stage {
  int kind, a, b, buf_off, buf_len, next;
  float p0, p1;
};

__device__ __forceinline__ Stage load_stage(const int* tab, int k) {
  const int* s = tab + TAB_HEADER + TAB_STAGE * k;
  Stage st;
  st.kind = s[0];
  st.a = s[1];
  st.b = s[2];
  st.buf_off = s[3];
  st.buf_len = s[4];
  st.p0 = __int_as_float(s[5]);
  st.p1 = __int_as_float(s[6]);
  st.next = s[7];
  return st;
}

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

__device__ __forceinline__ float apply_map(const Stage& st, float v) {
  switch (st.a) {
    case MAP_SATURATOR: return saturate(v, st.p0, st.p1, st.b);
    case MAP_SOFTCLIPPER: return softclip(v, st.p0);
    case MAP_HARDDISTORTION: return harddist(v);
    default: return bitcrush(v);
  }
}

// One pointwise stage (gain or map) on one value at time t (0 <= t < T).
__device__ __forceinline__ float pointwise(const Stage& st, float v, int t,
                                           const float* __restrict__ gains,
                                           int T) {
  if (st.kind == KIND_GAIN) return __fmul_rn(v, gains[(size_t)st.a * T + t]);
  return apply_map(st, v);
}

// The same on U chunks of four consecutive times t[u]..t[u]+3 (chunks not
// ok are skipped; times >= T are don't-cares and read no gain). The stage is
// decoded once for all of a thread's chunks, so their independent chains
// (a pow each, in the soft clipper) overlap.
template <int U>
__device__ __forceinline__ void pointwise_chunks(
    const Stage& st, float (&v)[U][4], const int (&t)[U], const bool (&ok)[U],
    const float* __restrict__ gains, int T) {
  if (st.kind == KIND_GAIN) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const float* g = gains + (size_t)st.a * T + t[u];
      float gv[4];
      if (t[u] + 4 <= T && (((uintptr_t)g) & 15) == 0) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(g));
        gv[0] = g4.x; gv[1] = g4.y; gv[2] = g4.z; gv[3] = g4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gv[e] = (t[u] + e < T) ? __ldg(g + e) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[u][e] = __fmul_rn(v[u][e], gv[e]);
    }
    return;
  }
  switch (st.a) {
    case MAP_SATURATOR:
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok[u]) v[u][e] = saturate(v[u][e], st.p0, st.p1, st.b);
      break;
    case MAP_SOFTCLIPPER:
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok[u]) v[u][e] = softclip(v[u][e], st.p0);
      break;
    case MAP_HARDDISTORTION:
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok[u]) v[u][e] = harddist(v[u][e]);
      break;
    default:
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok[u]) v[u][e] = bitcrush(v[u][e]);
  }
}

// Ring slot of the value `back` samples before slot s (0 <= back <= len).
__device__ __forceinline__ int ring_back(int s, int back, int len) {
  const int r = s - back;
  return r < 0 ? r + len : r;
}

// Four consecutive ring values from slot s (len and s's tile base are
// multiples of 4, so the misalignment s & 3 is the same for every thread:
// two aligned 16-byte reads and a select, no divergence).
__device__ __forceinline__ void ring4(const float* buf, int len, int s,
                                      float (&v)[4]) {
  const int a = s & ~3, r = s & 3;
  const float4 lo = *reinterpret_cast<const float4*>(buf + a);
  if (r == 0) {
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    return;
  }
  const float4 hi =
      *reinterpret_cast<const float4*>(buf + (a + 4 == len ? 0 : a + 4));
  if (r == 1) {
    v[0] = lo.y; v[1] = lo.z; v[2] = lo.w; v[3] = hi.x;
  } else if (r == 2) {
    v[0] = lo.z; v[1] = lo.w; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = lo.w; v[1] = hi.x; v[2] = hi.y; v[3] = hi.z;
  }
}

// One taps stage at ring slot s: dry + sum_k w_k * ring[s - d_k], each
// product and sum rounded on its own, in tap order.
__device__ __forceinline__ float taps_at(const int* tab, int n_stages,
                                         int n_taps, const Stage& st,
                                         const float* buf, int s) {
  const int* offs = tab + TAB_HEADER + TAB_STAGE * n_stages;
  float acc = __fmul_rn(st.p0, buf[s]);
  for (int i = 0; i < st.b; ++i) {
    const float w = __int_as_float(offs[n_taps + st.a + i]);
    acc = __fadd_rn(acc, __fmul_rn(w, buf[ring_back(s, offs[st.a + i],
                                                    st.buf_len)]));
  }
  return acc;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Tile i of one channel (samples [i*S, i*S + width)) into its slots of a
// ring of len floats: asynchronous copies into shared memory (16 bytes
// where the row allows), or plain copies into a device-memory ring.
template <bool kSmemRing>
__device__ __forceinline__ void load_tile(float* buf, int len,
                                          const float* __restrict__ xc, int i,
                                          int S, int T) {
  const int t0 = i * S, width = min(S, T - t0);
  const float* src = xc + t0;
  const int slot = t0 % len;
  float* dst = buf + slot;
  const int n4 = ((((uintptr_t)src) & 15) == 0) ? (width >> 2) : 0;
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    if constexpr (kSmemRing) {
      cp_async16(dst + 4 * q, src + 4 * q);
    } else {
      *reinterpret_cast<float4*>(dst + 4 * q) =
          __ldg(reinterpret_cast<const float4*>(src + 4 * q));
    }
  }
  for (int p = 4 * n4 + threadIdx.x; p < width; p += blockDim.x) {
    if constexpr (kSmemRing) cp_async4(dst + p, src + p);
    else dst[p] = __ldg(src + p);
  }
  if constexpr (kSmemRing) cp_async_commit();
}

// One block per (channel, run of tiles). The dynamic shared memory holds the
// table (where table_smem) and then the rings (where kSmemRing); otherwise
// the rings are this block's slice of `scratch`. U: chunks of four
// positions a thread carries through the store's stages at once (the tile
// over 4 * TAIL_THREADS, 1 or 2).
template <bool kSmemRing, int U>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_kernel(const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ gains, const int* __restrict__ table,
            int table_words, int table_smem, float* __restrict__ scratch,
            int ring_floats, int T, int S, int n_tiles, int tiles_per_run,
            int runs, int warm_tiles) {
  extern __shared__ float4 smem4[];
  int* stab = reinterpret_cast<int*>(smem4);
  const int table_slots = table_smem ? ((table_words + 3) & ~3) : 0;
  if (table_smem)
    for (int i = threadIdx.x; i < table_words; i += blockDim.x)
      stab[i] = __ldg(table + i);
  const int* tab = table_smem ? stab : table;
  const int n_stages = __ldg(table), n_taps = __ldg(table + 1);
  const int first_taps = __ldg(table + 2), last_taps = __ldg(table + 3);

  const int c = blockIdx.x / runs, r = blockIdx.x % runs;
  const int i_out = r * tiles_per_run;
  const int i_end = min(n_tiles, i_out + tiles_per_run);
  const int i_first = max(0, i_out - warm_tiles);
  const float* xc = x + (size_t)c * T;
  float* oc = out + (size_t)c * T;
  float* ring = kSmemRing
                    ? reinterpret_cast<float*>(smem4) + table_slots
                    : scratch + (size_t)blockIdx.x * ring_floats;

  // A run from the signal start reads silence before it: zero rings. Any
  // other run walks the halo's tiles first, after which what garbage the
  // rings held has left every value a stored output depends on.
  if (i_first == 0)
    for (int q = threadIdx.x; q < (ring_floats >> 2); q += blockDim.x)
      reinterpret_cast<float4*>(ring)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // The first ring: the first taps stage's input, or with no taps stage the
  // whole ring (two tiles).
  int off1 = 0, len1 = ring_floats;
  if (first_taps >= 0) {
    off1 = tab[TAB_HEADER + TAB_STAGE * first_taps + 3];
    len1 = tab[TAB_HEADER + TAB_STAGE * first_taps + 4];
  }
  float* buf1 = ring + off1;

  // The first ring holds the halo, the tile being worked on and the next
  // one, so a tile lands in slots whose samples no one reads any more.
  load_tile<kSmemRing>(buf1, len1, xc, i_first, S, T);
  for (int i = i_first; i < i_end; ++i) {
    if constexpr (kSmemRing) cp_async_wait_all();
    __syncthreads();  // tile i is in; every read of tile i - 1 is done
    if (i + 1 < i_end) load_tile<kSmemRing>(buf1, len1, xc, i + 1, S, T);
    const int t0 = i * S, width = min(S, T - t0);
    const int ts1 = t0 % len1;

    // the pointwise run before the first taps stage, in place
    if (first_taps > 0) {
      for (int p = threadIdx.x; p < width; p += blockDim.x) {
        float v = buf1[ts1 + p];
        for (int k = 0; k < first_taps; ++k)
          v = pointwise(load_stage(tab, k), v, t0 + p, gains, T);
        buf1[ts1 + p] = v;
      }
      __syncthreads();
    }

    // every taps stage but the last, with the pointwise run after it, from
    // its ring into the next one's
    for (int k = first_taps; k >= 0 && k != last_taps;) {
      const Stage st = load_stage(tab, k);
      const Stage nx = load_stage(tab, st.next);
      const float* src = ring + st.buf_off;
      float* dst = ring + nx.buf_off;
      const int ts = t0 % st.buf_len, tn = t0 % nx.buf_len;
      for (int p = threadIdx.x; p < width; p += blockDim.x) {
        float v = taps_at(tab, n_stages, n_taps, st, src, ts + p);
        for (int j = k + 1; j < st.next; ++j)
          v = pointwise(load_stage(tab, j), v, t0 + p, gains, T);
        dst[tn + p] = v;
      }
      __syncthreads();
      k = st.next;
    }

    if (i < i_out) continue;  // a halo tile of the walk: nothing to store

    // the store: the last taps stage and the pointwise run after it (or,
    // without a taps stage, every stage), U chunks of four positions a
    // thread at once
    const bool vec_out = (((uintptr_t)(oc + t0)) & 15) == 0;
    const int* offs = tab + TAB_HEADER + TAB_STAGE * n_stages;
    Stage lt = {};
    const float* src = buf1;
    int ts = ts1;
    if (last_taps >= 0) {
      lt = load_stage(tab, last_taps);
      src = ring + lt.buf_off;
      ts = t0 % lt.buf_len;
    }
    for (int p0 = 4 * threadIdx.x; p0 < width; p0 += 4 * U * blockDim.x) {
      int p[U], t[U];
      bool ok[U];
      float v[U][4], w4[4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = p0 + 4 * u * (int)blockDim.x;
        t[u] = t0 + p[u];
        ok[u] = p[u] < width;
        if (!ok[u]) continue;
        ring4(src, last_taps >= 0 ? lt.buf_len : len1, ts + p[u], w4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[u][e] = last_taps >= 0 ? __fmul_rn(lt.p0, w4[e]) : w4[e];
      }
      for (int i = 0; last_taps >= 0 && i < lt.b; ++i) {
        const int d = offs[lt.a + i];
        const float w = __int_as_float(offs[n_taps + lt.a + i]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!ok[u]) continue;
          ring4(src, lt.buf_len, ring_back(ts + p[u], d, lt.buf_len), w4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[u][e] = __fadd_rn(v[u][e], __fmul_rn(w, w4[e]));
        }
      }
      for (int k = last_taps >= 0 ? last_taps + 1 : 0; k < n_stages; ++k)
        pointwise_chunks<U>(load_stage(tab, k), v, t, ok, gains, T);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        if (vec_out && p[u] + 4 <= width) {
          *reinterpret_cast<float4*>(oc + t[u]) =
              make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p[u] + e < width) oc[t[u] + e] = v[u][e];
        }
      }
    }
  }
}

template <bool kSmemRing>
int launch(const float* x, float* out, const float* gains, const int* table,
           int table_words, int table_smem, float* scratch, int ring_floats,
           int C, int T, int S, int runs, int warm_tiles,
           cudaStream_t stream) {
  const int n_tiles = (T + S - 1) / S;
  const int tiles_per_run = (n_tiles + runs - 1) / runs;
  const size_t smem =
      (table_smem ? (size_t)((table_words + 3) & ~3) * 4 : 0) +
      (kSmemRing ? (size_t)ring_floats * 4 : 0);
  // two chunks a thread where the tile has them for every thread
  auto kernel = S >= 8 * TAIL_THREADS ? tail_kernel<kSmemRing, 2>
                                      : tail_kernel<kSmemRing, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)C * runs), TAIL_THREADS, smem, stream>>>(
      x, out, gains, table, table_words, table_smem, scratch, ring_floats, T,
      S, n_tiles, tiles_per_run, runs, warm_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (C, T) float32; gains: the gain rows (n_gain, T) or null; table:
// the stage table (table_words int32 on the device), copied into shared
// memory where table_smem; the rings (ring_floats floats a block, a
// multiple of S) in shared memory where ring_smem, else in `scratch`
// (C * runs * ring_floats floats); S: the tile, a multiple of 4; runs: runs
// of tiles per channel, none of them empty (ceil(n_tiles / runs) tiles
// each); warm_tiles: the tiles a run walks before its first to cover the
// halo.
extern "C" int tail_launch(const float* x, float* out, const float* gains,
                           const int* table, int table_words, int table_smem,
                           int ring_smem, float* scratch, int ring_floats,
                           int C, int T, int S, int runs, int warm_tiles,
                           void* stream) {
  if (C <= 0 || T <= 0 || S <= 0 || (S & 3) || runs <= 0 ||
      ring_floats < 2 * S || ring_floats % S || warm_tiles < 0 ||
      (long long)C * runs > 2147483647LL ||
      (!ring_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ring_smem)
    return launch<true>(x, out, gains, table, table_words, table_smem, scratch,
                        ring_floats, C, T, S, runs, warm_tiles, st);
  return launch<false>(x, out, gains, table, table_words, table_smem, scratch,
                       ring_floats, C, T, S, runs, warm_tiles, st);
}
