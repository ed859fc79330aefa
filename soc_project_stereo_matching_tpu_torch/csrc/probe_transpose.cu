// P3: volume transpose (B, A, D, C) -> (B, C, D, A), 1- or 2-byte elements.
//
// Replaces: scripts/aggr_transpose_probe.py, the pallas_call in `make_ktrans`
//   with both of its bodies: `swap_body` (a transpose of the block in vector
//   registers) and `mxu_body` (the same function as a product with an
//   identity matrix, exact for the values it sees).  They compute one
//   function, so one kernel is the counterpart of both: this card has no
//   reason to route a copy through its tensor cores.
//
// It is the swap of the outer and the inner axis of a cost or aggregated
// volume, D kept: (B, H, D, W) uint8 into the (B, W, D, H) view in which a
// horizontal path is a column, and the uint16 partial sums back.
//
// What bounds it on the H100: bytes.  Every element is read once and written
// once and nothing is computed, so the least time is 2 * bytes / 3.35 TB/s.
//
// Design: for every (b, d) the (A, C) plane is cut into 32 x 32 tiles.  A
// block of 32 x 8 threads reads a tile with C, the input's inner axis,
// across the lanes (32 or 64 consecutive bytes per warp: whole sectors),
// parks it in shared memory, one 32-bit word per element, and writes it with
// A, the output's inner axis, across the lanes.  The tile has 33 columns so
// that reading it by column hits 32 different banks.  Edge tiles are masked:
// neither 375 nor 450 is a multiple of 32.  A plane of another d lies D planes
// further on, on both sides, so d only enters the two offsets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

template <typename T>
__global__ void transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 int A, int D, int C, int tiles_a,
                                 int tiles_c) {
  __shared__ unsigned tile[kTile][kTile + 1];
  int t = blockIdx.x;
  const int tc = t % tiles_c;
  t /= tiles_c;
  const int ta = t % tiles_a;
  t /= tiles_a;
  const int d = t % D;
  const int b = t / D;
  const int a0 = ta * kTile, c0 = tc * kTile;
  const T* src = in + ((size_t)b * A * D + d) * C;   // + a * D * C + c
  T* dst = out + ((size_t)b * C * D + d) * A;        // + c * D * A + a

  const int c = c0 + threadIdx.x;
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int a = a0 + r;
    if (a < A && c < C) tile[r][threadIdx.x] = src[(size_t)a * D * C + c];
  }
  __syncthreads();
  const int a = a0 + threadIdx.x;
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int cc = c0 + r;
    if (cc < C && a < A) dst[(size_t)cc * D * A + a] = (T)tile[threadIdx.x][r];
  }
}

template <typename T>
int launch_transpose(const void* in, void* out, int B, int A, int D, int C,
                     cudaStream_t stream) {
  const int tiles_a = (A + kTile - 1) / kTile;
  const int tiles_c = (C + kTile - 1) / kTile;
  const long long blocks = (long long)B * D * tiles_a * tiles_c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transpose_kernel<T><<<(unsigned)blocks, dim3(kTile, kRows), 0, stream>>>(
      (const T*)in, (T*)out, A, D, C, tiles_a, tiles_c);
  return (int)cudaGetLastError();
}

}  // namespace

// in: (B, A, D, C), out: (B, C, D, A), elements of `elem_bytes` (1 or 2).
extern "C" int sgm_probe_transpose(const void* in, void* out, int B, int A,
                                   int D, int C, int elem_bytes,
                                   void* stream) {
  if ((long long)B * A * D * C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) return launch_transpose<uint8_t>(in, out, B, A, D, C, s);
  if (elem_bytes == 2) return launch_transpose<uint16_t>(in, out, B, A, D, C, s);
  return (int)cudaErrorInvalidValue;
}
