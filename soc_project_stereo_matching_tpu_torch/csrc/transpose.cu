// P3: volume transpose (B, A, D, C) -> (B, C, D, A), 1- or 2-byte elements.
// A main-path kernel: K2's horizontal pair runs on the transposed volume
// (ops/kernels.py horizontal_partial), and the probes time it alone.
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
// The first version moved one element a thread (32 or 64 bytes a warp and
// request) and reached 30% of that.
//
// Design: 16 bytes a thread on both sides.
//   - Pitches.  The rows of the volumes the engine hands over are 450 or 375
//     elements long: no row starts on a 16-byte boundary.  So both sides take
//     a pitch: the input's rows are `pin` elements apart of which the first C
//     are read, the output's rows `pout` elements apart of which the first A
//     hold data and the rest zeros.  The caller pads the transposed volumes,
//     which only it sees, to a pitch of 16 elements; the layout of every
//     public volume stays contiguous.
//   - Loads.  For every (b, d) the (A, C) plane is cut into tiles of 128
//     bytes of A by 64 elements of C.  A thread loads one aligned 16-byte
//     chunk of an input row, from the row segment's aligned-down address on,
//     whatever the row's own alignment (one chunk more per row than the
//     segment is long); consecutive lanes take consecutive rows, and a
//     thread has all its chunks in flight before it uses one.  A chunk that
//     would reach outside the tensor is loaded element by element instead.
//   - The tile is parked transposed in shared memory, A along a row of 128
//     bytes (+16 of padding), the row's shift taken out on the way in:
//     consecutive lanes write consecutive elements.
//   - Stores.  A thread stores 16 bytes of an output row where the output's
//     pitch and base allow it (else 4 bytes, else one element): eight lanes
//     a 128-byte line, a quarter-warp a shared-memory wavefront.
// Edge tiles are masked.  A plane of another d lies D rows further on, on
// both sides, so d only enters the two offsets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLine = 128;     // bytes of the output's inner axis per tile
constexpr int kTileC = 64;     // elements of the input's inner axis per tile
constexpr int kThreads = 256;
constexpr int kPitch = kLine + 16;
enum { kSkip, kChunk, kZeros, kSingly };

template <int SV> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<4> { using type = unsigned; };
template <> struct Vec<2> { using type = uint16_t; };
template <> struct Vec<1> { using type = uint8_t; };

// T: the element; SV: bytes per store.
template <typename T, int SV>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, int A, int D,
                 int C, int pin, int pout, int tiles_a, int tiles_c,
                 size_t in_elems) {
  constexpr int ES = (int)sizeof(T);
  constexpr int TA = kLine / ES;          // rows of the input per tile
  constexpr int EPC = 16 / ES;            // elements per chunk
  constexpr int NK = kTileC / EPC + 1;    // chunks per row segment
  constexpr int NL = (NK * TA + kThreads - 1) / kThreads;
  __shared__ __align__(16) unsigned char tile[kTileC][kPitch];

  int t = blockIdx.x;
  const int tc = t % tiles_c;
  t /= tiles_c;
  const int ta = t % tiles_a;
  t /= tiles_a;
  const int d = t % D;
  const int b = t / D;
  const int a0 = ta * TA, c0 = tc * kTileC;
  const int nvalid = min(kTileC, C - c0);
  const uintptr_t lo = (uintptr_t)in, hi = (uintptr_t)(in + in_elems);

  // loads: chunk k of row r, all of a thread's chunks before any is used
  uint4 v[NL];
  int shift[NL];     // elements from the first chunk's start to column c0
  int mode[NL];      // kSkip, kChunk, kZeros (a row of the padding) or
                     // kSingly (element by element)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx % TA, k = idx / TA;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    shift[i] = 0;
    mode[i] = kSkip;
    if (k >= NK) continue;
    if (a0 + r >= A) {
      mode[i] = kZeros;
      continue;
    }
    const T* row = in + (((size_t)b * A + a0 + r) * D + d) * pin + c0;
    const uintptr_t addr = (uintptr_t)row;
    const int sh = (int)(addr & 15);
    if (16 * k >= sh + nvalid * ES) continue;     // past the segment
    const uintptr_t q = addr - sh + 16 * k;
    shift[i] = sh / ES;
    mode[i] = kSingly;
    if (q >= lo && q + 16 <= hi) {
      v[i] = *(const uint4*)q;
      mode[i] = kChunk;
    }
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx % TA, k = idx / TA;
    if (mode[i] == kSkip) continue;
    const unsigned w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    const int first = k * EPC - shift[i];
    const T* row = in + (((size_t)b * A + a0 + r) * D + d) * pin + c0;
#pragma unroll
    for (int j = 0; j < EPC; ++j) {
      const int c = first + j;
      if (c < 0 || c >= nvalid) continue;
      T e = (T)(w[j * ES / 4] >> (8 * (j * ES % 4)));
      if (mode[i] == kSingly) e = row[c];
      *(T*)&tile[c][r * ES] = e;
    }
  }
  __syncthreads();

  // stores: piece p of output row cc
  constexpr int PPR = kLine / SV;
  using V = typename Vec<SV>::type;
  for (int idx = threadIdx.x; idx < kTileC * PPR; idx += kThreads) {
    const int cc = idx / PPR, p = idx % PPR;
    const int a = a0 + p * (SV / ES);
    if (cc >= nvalid || a >= pout) continue;
    T* dst = out + (((size_t)b * C + c0 + cc) * D + d) * pout + a;
    *(V*)dst = *(const V*)&tile[cc][p * SV];
  }
}

template <typename T, int SV>
int launch_sv(const void* in, void* out, int B, int A, int D, int C, int pin,
              int pout, cudaStream_t stream) {
  constexpr int TA = kLine / (int)sizeof(T);
  const int tiles_a = (pout + TA - 1) / TA;
  const int tiles_c = (C + kTileC - 1) / kTileC;
  const long long blocks = (long long)B * D * tiles_a * tiles_c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transpose_kernel<T, SV><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)in, (T*)out, A, D, C, pin, pout, tiles_a, tiles_c,
      (size_t)B * A * D * pin);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_transpose(const void* in, void* out, int B, int A, int D, int C,
                     int pin, int pout, cudaStream_t stream) {
  // the widest store that every output row's start allows
  const uintptr_t align = (uintptr_t)out | ((uintptr_t)pout * sizeof(T));
  if (align % 16 == 0)
    return launch_sv<T, 16>(in, out, B, A, D, C, pin, pout, stream);
  if (align % 4 == 0)
    return launch_sv<T, 4>(in, out, B, A, D, C, pin, pout, stream);
  return launch_sv<T, (int)sizeof(T)>(in, out, B, A, D, C, pin, pout, stream);
}

}  // namespace

// in: (B, A, D, pin) of which the first C of the inner axis are read;
// out: (B, C, D, pout), its first A of the inner axis the data, the rest
// zeros; elements of `elem_bytes` (1 or 2).
extern "C" int sgm_volume_transpose(const void* in, void* out, int B, int A,
                                   int D, int C, int pin, int pout,
                                   int elem_bytes, void* stream) {
  if (C > pin || A > pout) return (int)cudaErrorInvalidValue;
  if ((long long)B * A * D * C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return launch_transpose<uint8_t>(in, out, B, A, D, C, pin, pout, s);
  if (elem_bytes == 2)
    return launch_transpose<uint16_t>(in, out, B, A, D, C, pin, pout, s);
  return (int)cudaErrorInvalidValue;
}
