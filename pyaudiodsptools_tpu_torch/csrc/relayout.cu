// Relayout for Hopper (sm_90a): natural (C, T) <-> segment-major time-major
// (L, Rp), the layout the speculative dynamics walks' plain version runs on.
//
// Replaces the TPU kernels pyaudiodsptools_tpu/kernels/relayout.py ::
// time_major_pack (body _pack_kernel) and time_major_unpack (body
// _unpack_kernel). Time is cut into G segments of L samples (only the last
// may be shorter); lane r = g*C + c holds channel c of segment g, and row l
// of the time-major array holds sample l of every lane:
//
//   pack    tm[l, r] = x[c, g*L + l]   where g*L + l < T and r < C*G,
//                      0               everywhere else (ragged rows, pad lanes)
//   unpack  y[c, g*L + l] = tm[l, r]   for exactly the T valid samples
//
// What bounds them: bytes. Each reads the signal once and writes it once and
// computes nothing, so the design is about keeping enough bytes in flight
// with few instructions. The two sides are contiguous along different axes:
// the natural side along time, the time-major side along lanes. A thread
// block moves one tile of TL = 128 rows x TR = 64 lanes (32 KB) through
// shared memory.
//
// * Pack, and unpack's masked path: the tile goes through shared memory
//   padded to TL + 1 columns with 4-byte accesses. Threads run along time on
//   the natural side and along lanes on the time-major side, so both sides
//   coalesce for any C, and (g, c) is computed once per lane, not per
//   element. Pack writes zeros into pad lanes and ragged rows.
// * Unpack's box path, where every lane of the tile lies in one segment (g,
//   and channels c0 .. c0+63 of it) and the launch is aligned (T, L and Rp
//   multiples of 4 floats, both pointers on 16 bytes: the tensor map's row
//   strides and the 16-byte stores need it). One thread loads the tile with
//   the Tensor Memory Accelerator as two 2-D boxes of tm seen as (L, Rp), 32
//   lanes (128 bytes) x 128 rows at (l0, r0 + 32s), in the 128-byte swizzle,
//   rows past L filled with zeros; an mbarrier counts the bytes in. Every
//   thread then reads two 4 x 4 blocks as four 16-byte loads each (the
//   swizzle makes each quarter warp's loads one conflict-free wavefront),
//   transposes them in registers and stores four 16-byte vectors along
//   time; a warp writes 8 runs of 64 bytes. The only index arithmetic is
//   per tile (one division for g) and per 4 samples (l < L, t < T).
//   Unpack's masked path takes the tiles whose lanes straddle two segments
//   (C not a multiple of 64, C < 64) and every tile of a launch that is not
//   aligned.
//
// Pack has one path: the same box path for pack (TMA loads of x seen as
// (C, T), 16-byte stores along lanes; and with a TMA store of the tile
// transposed in place) measured no faster than the padded tile on the card,
// where unpack's box path is faster than its masked path.
//
// One tile per block, six blocks an SM (by shared memory). At the main
// path's geometry (C = 64, T = 1,323,008, G = 256, L = 5,168, Rp = 16,384)
// every tile of an unpack takes the box path. The TPU kernels' (8, 128)
// tiling, 128-multiple segment lengths, zero-extended side buffer, closing
// chunk and 128-wide patch are not carried over.
//
// cuTensorMapEncodeTiled lives in libcuda: it is reached through
// cudaGetDriverEntryPoint(ByVersion), so the library links the runtime only.
//
// Plain C interface: each launcher enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// request it refuses, or when libcuda refuses the tensor map);
// relayout_unpack_box_tiles says how many tiles of an unpack take the box
// path.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define TL 128        // rows (samples of a segment) a tile
#define TR 64         // lanes a tile
#define SUB 32        // floats along a TMA box's contiguous axis: 128 bytes
#define THREADS 256
#define TILE_BYTES (TL * TR * 4)
// the padded TR x (TL + 1) tile of pack and of unpack's masked path
#define MASKED_STRIDE (TL + 1)
#define MASKED_BYTES (TR * MASKED_STRIDE * 4)
// unpack's: the box path's tile, aligned to 1024 bytes (the swizzle's
// period), or the padded tile at the unaligned base
#define SMEM_BYTES (TILE_BYTES + 1024)

static_assert(MASKED_BYTES <= SMEM_BYTES, "masked tile fits");
static_assert(TR % SUB == 0 && TL <= 256, "a tile is whole boxes");
static_assert(TL * TR / 16 == 2 * THREADS, "two 4x4 blocks a thread");

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset in floats of element (row, col) of a box of 32-float rows stored
// with the 128-byte swizzle: 16-byte chunk col/4 of row `row` is chunk
// (col/4) ^ (row % 8), as the Tensor Memory Accelerator writes it.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * SUB + ((chunk ^ (row & 7)) << 2);
}

__device__ __forceinline__ float* aligned_tile(unsigned char* raw) {
  return reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// One thread arms the barrier for the tile's bytes and loads it as TR/SUB
// boxes of TL rows x SUB lanes of tm, box s at (l0, r0 + SUB*s) into
// sub-tile s; everyone waits for the bytes. A wait that outlasts 2^32
// clocks (about 2 s) traps: a fault, not a hang.
__device__ __forceinline__ void tma_tile(float* tile, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int l0) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(smem_u32(bar)),
                 "r"(TILE_BYTES)
                 : "memory");
    for (int s = 0; s < TR / SUB; ++s)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
              smem_u32(tile + s * SUB * TL)),
          "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
          "r"(r0 + s * SUB), "r"(l0)
          : "memory");
  }
  __syncthreads();   // the barrier is initialised before anyone waits on it
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(0u)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 32)) __trap();
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// (g, c0) of the tile's first lane, and whether an unpack's tile takes the
// box path: the launch is aligned and lanes r0 .. r0+TR-1 are channels
// c0 .. c0+TR-1 of one segment g < G. The host's count
// (relayout_unpack_box_tiles) is the same test.
__host__ __device__ __forceinline__ bool box_tile(int r0, int C, int G,
                                                  int box_ok, int* g,
                                                  int* c0) {
  *g = r0 / C;
  *c0 = r0 - *g * C;
  return box_ok && *g < G && *c0 + TR <= C;
}

// tm (L, Rp) <- x (C, T): tile[lane][row], rows padded to TL + 1
__global__ void __launch_bounds__(THREADS)
pack_kernel(const float* __restrict__ x, float* __restrict__ tm, int C, int T,
            int G, int L, int Rp) {
  extern __shared__ float tile[];
  const int l0 = blockIdx.x * TL;
  const int r0 = blockIdx.y * TR;
  const int R = C * G;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < TR; i += THREADS / 32) {
    const int r = r0 + i;
    const int gr = r / C;
    const int c = r - gr * C;
    // samples of lane r: 0 for a pad lane, what is left of T in the last
    // segment, else L
    const int valid = r < R ? min(L, T - gr * L) : 0;
    const float* src = x + (long long)c * T + (long long)gr * L;
    for (int k = tx; k < TL; k += 32) {
      const int l = l0 + k;
      tile[i * MASKED_STRIDE + k] = l < valid ? src[l] : 0.0f;
    }
  }
  __syncthreads();
  for (int k = ty; k < TL; k += THREADS / 32) {
    const int l = l0 + k;
    if (l >= L) break;
    for (int i = tx; i < TR; i += 32) {
      const int r = r0 + i;
      if (r < Rp) tm[(long long)l * Rp + r] = tile[i * MASKED_STRIDE + k];
    }
  }
}

// y (C, T) <- tm (L, Rp)
__global__ void __launch_bounds__(THREADS)
unpack_kernel(const float* __restrict__ tm, float* __restrict__ y, int C,
              int T, int G, int L, int Rp, int box_ok,
              const __grid_constant__ CUtensorMap map) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int l0 = blockIdx.x * TL;
  const int r0 = blockIdx.y * TR;
  const int R = C * G;
  int g, c0;
  if (box_tile(r0, C, G, box_ok, &g, &c0)) {
    // two boxes of 128 rows x 32 lanes: sub-tile s holds lanes r0 + 32s ..
    // as rows l of 32 swizzled floats; rows past L come in as zeros
    float* tile = aligned_tile(smem_raw);
    tma_tile(tile, &map, &bar, r0, l0);
    const long long seg = (long long)g * L;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int blk = threadIdx.x + n * THREADS;
      const int qb8 = blk & 7;            // 4-lane chunk in the sub-tile
      const int rest = blk >> 3;
      const int kb = rest % (TL / 4);     // 4-row group
      const int s = rest / (TL / 4);      // sub-tile
      const float* sub = tile + s * SUB * TL;
      float4 v[4];                        // v[i]: row 4kb + i, 4 lanes
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = *reinterpret_cast<const float4*>(sub + swz(4 * kb + i, qb8));
      const int l = l0 + 4 * kb;
      // L and T are multiples of 4: the 4 samples are all valid or none
      if (l < L && seg + l < T) {
        float* dst = y + (long long)(c0 + s * SUB + 4 * qb8) * T + seg + l;
        store4(dst, v[0].x, v[1].x, v[2].x, v[3].x);
        store4(dst + T, v[0].y, v[1].y, v[2].y, v[3].y);
        store4(dst + 2LL * T, v[0].z, v[1].z, v[2].z, v[3].z);
        store4(dst + 3LL * T, v[0].w, v[1].w, v[2].w, v[3].w);
      }
    }
    return;
  }
  float* tile = reinterpret_cast<float*>(smem_raw);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int k = ty; k < TL; k += THREADS / 32) {
    const int l = l0 + k;
    for (int i = tx; i < TR; i += 32) {
      const int r = r0 + i;
      tile[i * MASKED_STRIDE + k] =
          (l < L && r < R) ? tm[(long long)l * Rp + r] : 0.0f;
    }
  }
  __syncthreads();
  for (int i = ty; i < TR; i += THREADS / 32) {
    const int r = r0 + i;
    if (r >= R) break;
    const int gr = r / C;
    const int c = r - gr * C;
    const int valid = min(L, T - gr * L);
    float* dst = y + (long long)c * T + (long long)gr * L;
    for (int k = tx; k < TL; k += 32) {
      const int l = l0 + k;
      if (l < valid) dst[l] = tile[i * MASKED_STRIDE + k];
    }
  }
}

bool grid_for(int L, int Rp, dim3* grid) {
  const long long tiles_l = ((long long)L + TL - 1) / TL;
  const long long tiles_r = ((long long)Rp + TR - 1) / TR;
  if (tiles_l <= 0 || tiles_r <= 0 || tiles_l > 2147483647LL ||
      tiles_r > 65535LL)
    return false;
  *grid = dim3((unsigned)tiles_l, (unsigned)tiles_r);
  return true;
}

bool request_ok(int C, int G, int L, int Rp, dim3* grid) {
  return C > 0 && G > 0 && (long long)C * G <= Rp && grid_for(L, Rp, grid);
}

// The launch-wide half of the box path's test: the tensor map over tm needs
// a 16-byte base and row stride (Rp a multiple of 4), the 16-byte stores
// into y need T and L in whole vectors and a 16-byte base, and a tile of
// channels needs C >= TR.
int box_launch(const void* tm, const void* y, int C, int T, int L, int Rp) {
  return T % 4 == 0 && L % 4 == 0 && Rp % 4 == 0 &&
         reinterpret_cast<uintptr_t>(tm) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0 && C >= TR;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D float32 tensor map over a row-major (rows, cols) array, boxes of
// box_rows x SUB floats in the 128-byte swizzle, zeros outside the array.
bool encode_map(CUtensorMap* map, const float* base, int rows, int cols,
                int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {SUB, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int relayout_unpack_box_tiles(int C, int T, int G, int L, int Rp,
                                         const void* tm, const void* y) {
  dim3 grid;
  if (!request_ok(C, G, L, Rp, &grid)) return -1;
  const int ok = box_launch(tm, y, C, T, L, Rp);
  long long lane_tiles = 0;
  for (unsigned t = 0; t < grid.y; ++t) {
    int g, c0;
    lane_tiles += box_tile((int)t * TR, C, G, ok, &g, &c0);
  }
  return (int)(lane_tiles * grid.x);
}

extern "C" int relayout_pack_launch(const float* x, float* tm, int C, int T,
                                    int G, int L, int Rp, void* stream) {
  dim3 grid;
  if (!request_ok(C, G, L, Rp, &grid)) return (int)cudaErrorInvalidValue;
  pack_kernel<<<grid, THREADS, MASKED_BYTES, (cudaStream_t)stream>>>(
      x, tm, C, T, G, L, Rp);
  return (int)cudaGetLastError();
}

extern "C" int relayout_unpack_launch(const float* tm, float* y, int C, int T,
                                      int G, int L, int Rp, void* stream) {
  dim3 grid;
  if (!request_ok(C, G, L, Rp, &grid)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const int ok = box_launch(tm, y, C, T, L, Rp);
  if (ok && !encode_map(&map, tm, L, Rp, TL)) return (int)cudaErrorInvalidValue;
  unpack_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tm, y, C, T, G, L, Rp, ok, map);
  return (int)cudaGetLastError();
}
