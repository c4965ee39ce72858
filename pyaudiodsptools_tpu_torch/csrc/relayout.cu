// Relayout for Hopper (sm_90a): natural (C, T) <-> segment-major time-major
// (L, Rp), the layout the speculative dynamics walks (csrc/dynamics.cu) run
// on.
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
// computes nothing. The only difficulty is that the two sides are contiguous
// along different axes: the natural side along time, the time-major side
// along lanes. A thread block therefore moves one 32 x 32 tile (32 lanes x
// 32 rows) through shared memory: on the natural side threadIdx.x runs along
// time (for a fixed lane, consecutive rows are consecutive addresses of one
// channel), on the time-major side it runs along lanes, so both the loads
// and the stores of a warp are one contiguous 128-byte run. The tile is
// padded to 33 columns, so that neither the row-wise nor the column-wise
// access has a shared-memory bank conflict. A block computes its own offsets
// and masks the ragged edges; none of the TPU kernels' (8, 128) tiling,
// 128-multiple segment lengths, zero-extended side buffer, closing chunk or
// 128-wide patch is carried over. Because a tile is cut along LANES and not
// along channels, the access pattern is the same for every channel count
// (C = 1 and C = 3 coalesce as C = 64 does).
//
// Plain C interface: each launcher enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#define TILE 32
#define ROWS_PER_PASS 8

namespace {

// tm (L, Rp) <- x (C, T)
__global__ void __launch_bounds__(TILE * ROWS_PER_PASS)
pack_kernel(const float* __restrict__ x, float* __restrict__ tm, int C, int T,
            int G, int L, int Rp) {
  __shared__ float tile[TILE][TILE + 1];   // [lane][row]
  const int l0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const int R = C * G;
  // natural side: threadIdx.x along time, threadIdx.y (+ passes) along lanes
  for (int i = threadIdx.y; i < TILE; i += ROWS_PER_PASS) {
    const int r = r0 + i;
    const int l = l0 + threadIdx.x;
    float v = 0.0f;
    if (r < R && l < L) {
      const int g = r / C;
      const int c = r - g * C;
      const long long t = (long long)g * L + l;
      if (t < T) v = x[(long long)c * T + t];
    }
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
  // time-major side: threadIdx.x along lanes
  for (int i = threadIdx.y; i < TILE; i += ROWS_PER_PASS) {
    const int l = l0 + i;
    const int r = r0 + threadIdx.x;
    if (l < L && r < Rp) tm[(long long)l * Rp + r] = tile[threadIdx.x][i];
  }
}

// y (C, T) <- tm (L, Rp)
__global__ void __launch_bounds__(TILE * ROWS_PER_PASS)
unpack_kernel(const float* __restrict__ tm, float* __restrict__ y, int C,
              int T, int G, int L, int Rp) {
  __shared__ float tile[TILE][TILE + 1];   // [row][lane]
  const int l0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const int R = C * G;
  for (int i = threadIdx.y; i < TILE; i += ROWS_PER_PASS) {
    const int l = l0 + i;
    const int r = r0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (l < L && r < R) ? tm[(long long)l * Rp + r] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TILE; i += ROWS_PER_PASS) {
    const int r = r0 + i;
    const int l = l0 + threadIdx.x;
    if (r < R && l < L) {
      const int g = r / C;
      const int c = r - g * C;
      const long long t = (long long)g * L + l;
      if (t < T) y[(long long)c * T + t] = tile[threadIdx.x][i];
    }
  }
}

bool grid_for(int L, int Rp, dim3* grid) {
  const long long tiles_l = ((long long)L + TILE - 1) / TILE;
  const long long tiles_r = ((long long)Rp + TILE - 1) / TILE;
  if (tiles_l <= 0 || tiles_r <= 0 || tiles_l > 2147483647LL ||
      tiles_r > 65535LL)
    return false;
  *grid = dim3((unsigned)tiles_l, (unsigned)tiles_r);
  return true;
}

}  // namespace

extern "C" int relayout_pack_launch(const float* x, float* tm, int C, int T,
                                    int G, int L, int Rp, void* stream) {
  dim3 grid;
  if (C <= 0 || G <= 0 || (long long)C * G > Rp || !grid_for(L, Rp, &grid))
    return (int)cudaErrorInvalidValue;
  pack_kernel<<<grid, dim3(TILE, ROWS_PER_PASS), 0, (cudaStream_t)stream>>>(
      x, tm, C, T, G, L, Rp);
  return (int)cudaGetLastError();
}

extern "C" int relayout_unpack_launch(const float* tm, float* y, int C, int T,
                                      int G, int L, int Rp, void* stream) {
  dim3 grid;
  if (C <= 0 || G <= 0 || (long long)C * G > Rp || !grid_for(L, Rp, &grid))
    return (int)cudaErrorInvalidValue;
  unpack_kernel<<<grid, dim3(TILE, ROWS_PER_PASS), 0, (cudaStream_t)stream>>>(
      tm, y, C, T, G, L, Rp);
  return (int)cudaGetLastError();
}
