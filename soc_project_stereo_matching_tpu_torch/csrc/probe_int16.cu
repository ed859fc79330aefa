// P4: the SGM recurrence in 16-bit lanes: the rung ladder and `scan16`.
//
// Replaces: scripts/mosaic_int16_probe.py, the pallas_call in `compile_probe`
//   with its rung bodies `k_p0` .. `k_p10` and `k_p5b`, and rung p7, the group
//   scan with 16-bit state: the `compute16=True` branch of
//   `_scan_group_kernel` in
//   soc_project_stereo_matching_tpu/ops/pallas_kernels.py.
//
// On the TPU a rung is a compile that must not crash.  Here every rung is a
// kernel that must give the right numbers: each is one 16-bit operation of
// the recurrence on values packed two to a 32-bit register, the even
// disparity in the low half, as the TPU packs a sublane pair.
//
//   p0   widen uint8 and store
//   p1   x + (x shifted by 1 along the path axis W)
//   p2   x + (x shifted by 2 along D): an even shift moves whole registers
//   p3   x + (x shifted by 1 along D): an odd shift weaves the halves of two
//        registers, __byte_perm(a, b, 0x5432)
//   p4   the shift by 1 along D with the 255 sentinel selected in at d = 0
//   p5   a 16-bit state carried through a loop over rows: s = min(s, x + 1)
//   p5b  the same loop with s = s + x
//   p6   the circular doubling-tree min over D (shifts 1, 2, 4, ...)
//   p8   min(x, y), y = x shifted along W: __vminu2
//   p9   compare and select: __vcmpltu2 and a mask
//   p10  the arithmetic min y + ((x - y) & ((x - y) >> 15))
//
// `scan16` is p7: a group of vertical directions over a (B, S, D, W) cost
// volume, as sgm_scan_direction walks it (aggregate.cu): one warp per
// path, reverse, the wrapping diagonals or restart, P1, and P2 from the two
// gray values along the path.  Its state is packed: a lane holds 2 NP
// consecutive disparities in NP registers.  L(d-1) and L(d+1) are each one
// __byte_perm of two neighbouring registers (the neighbour lane's through a
// shuffle), the three mins, the two adds and the subtract are one sub-word
// SIMD instruction for two disparities (__vminu2, __vadd2, __vsub2), and the
// min over D is a butterfly of packed mins with one min of the two halves at
// the end.  Every intermediate is at most 255 + 255 + max(P1, P2), and
// `& 0xFF` is a mask of both halves, so 16 bits are exact; the wrapper
// refuses penalties that could overflow.
//
// What bounds it on the H100: what bounds the K2 scan, memory access (a byte
// per cost element, a uint16 read-modify-write per volume element and
// direction, D planes at stride W).  Packing halves the integer instructions
// of a step, which the K2 scan does not wait for; so `scan16` is a probe, its
// time stands beside the K2 scan's in PERF.md, and the main path keeps the
// K2 scan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSentinel2 = 0x00FF00FFu;  // 255 in both halves
constexpr unsigned kLow = 0x0000FFFFu;
constexpr unsigned kHigh = 0xFFFF0000u;

__device__ __forceinline__ unsigned both(int v) {
  return (unsigned)v * 0x00010001u;
}

// (a's high half, b's low half): the packed pair one disparity further on.
__device__ __forceinline__ unsigned weave(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5432);
}

// ---- the rungs ----------------------------------------------------------------

// Pair dp (rows 2 dp, 2 dp + 1) of column w of a uint8 (D, W) plane.
__device__ __forceinline__ unsigned load_pair(const uint8_t* x, int W, int dp,
                                              int w) {
  return (unsigned)x[(size_t)(2 * dp) * W + w] |
         ((unsigned)x[(size_t)(2 * dp + 1) * W + w] << 16);
}

__device__ __forceinline__ int mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Pair dp of the packed column `col` (D/2 words at stride `stride`) shifted
// by `shift` along D, circularly: result[d] = col[d - shift].
__device__ __forceinline__ unsigned shift_d(const unsigned* col, int stride,
                                            int half, int dp, int shift) {
  shift = mod(shift, 2 * half);
  if (shift % 2 == 0) return col[mod(dp - shift / 2, half) * stride];
  const unsigned odd = col[mod(dp - (shift + 1) / 2, half) * stride];
  const unsigned even = col[mod(dp - (shift - 1) / 2, half) * stride];
  return weave(odd, even);
}

// One (D, W) plane per blockIdx.y; a block takes 32 columns and all D/2
// pairs, which it first packs into shared memory: buf[2][D/2][32].
template <int RUNG>
__global__ void rung_plane_kernel(const uint8_t* __restrict__ x,
                                  uint16_t* __restrict__ out, int D, int W) {
  extern __shared__ unsigned buf[];
  const int half = D / 2;
  const uint8_t* xp = x + (size_t)blockIdx.y * D * W;
  uint16_t* op = out + (size_t)blockIdx.y * D * W;
  const int tx = threadIdx.x;
  const int w = blockIdx.x * 32 + tx;
  const bool live = w < W;
  unsigned* cur = buf;
  unsigned* nxt = buf + half * 32;
  for (int dp = threadIdx.y; dp < half; dp += blockDim.y)
    cur[dp * 32 + tx] = live ? load_pair(xp, W, dp, w) : 0u;
  __syncthreads();

  if (RUNG == 6) {  // min over D by doubling shifts, in place of a reduction
    for (int shift = 1; shift < D; shift *= 2) {
      for (int dp = threadIdx.y; dp < half; dp += blockDim.y)
        nxt[dp * 32 + tx] = __vminu2(cur[dp * 32 + tx],
                                     shift_d(cur + tx, 32, half, dp, shift));
      __syncthreads();
      unsigned* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  if (!live) return;
  const int wl = mod(w - 1, W);  // the column a shift by 1 along W brings
  for (int dp = threadIdx.y; dp < half; dp += blockDim.y) {
    const unsigned xs = RUNG == 6 ? load_pair(xp, W, dp, w) : cur[dp * 32 + tx];
    unsigned r = xs;
    if (RUNG == 1) r = __vadd2(xs, load_pair(xp, W, dp, wl));
    if (RUNG == 2) r = __vadd2(xs, shift_d(cur + tx, 32, half, dp, 2));
    if (RUNG == 3) r = __vadd2(xs, shift_d(cur + tx, 32, half, dp, 1));
    if (RUNG == 4) {
      r = shift_d(cur + tx, 32, half, dp, 1);
      if (dp == 0) r = (r & kHigh) | (kSentinel2 & kLow);
    }
    if (RUNG == 6) r = __vadd2(xs, cur[dp * 32 + tx]);
    if (RUNG == 8) r = __vminu2(xs, load_pair(xp, W, dp, wl));
    if (RUNG == 9) {
      const unsigned y = load_pair(xp, W, dp, wl);
      const unsigned less = __vcmpltu2(xs, y);  // 0xFFFF where x < y
      r = (xs & less) | (y & ~less);
    }
    if (RUNG == 10) {
      const unsigned y = load_pair(xp, W, dp, wl);
      const unsigned diff = __vsub2(xs, y);
      // (diff >> 15) per signed half: all ones where the half is negative
      const unsigned sign = ((diff >> 15) & 0x00010001u) * 0xFFFFu;
      r = __vadd2(y, diff & sign);
    }
    op[(size_t)(2 * dp) * W + w] = (uint16_t)(r & kLow);
    op[(size_t)(2 * dp + 1) * W + w] = (uint16_t)(r >> 16);
  }
}

// p5 / p5b: a (1, W) 16-bit state carried over `rows` rows; a thread holds
// two neighbouring columns in one register.
template <bool ADD>
__global__ void rung_loop_kernel(const uint8_t* __restrict__ x,
                                 uint16_t* __restrict__ out, int rows, int W) {
  const int w = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (w >= W) return;
  const bool pair = w + 1 < W;
  const uint8_t* xp = x + (size_t)blockIdx.y * rows * W;
  uint16_t* op = out + (size_t)blockIdx.y * rows * W;
  unsigned state = 0;
  for (int s = 0; s < rows; ++s) {
    const size_t at = (size_t)s * W + w;
    const unsigned xs =
        (unsigned)xp[at] | (pair ? (unsigned)xp[at + 1] << 16 : 0u);
    state = ADD ? __vadd2(state, xs) : __vminu2(state, __vadd2(xs, both(1)));
    const unsigned r = __vadd2(xs, state);
    op[at] = (uint16_t)(r & kLow);
    if (pair) op[at + 1] = (uint16_t)(r >> 16);
  }
}

template <int RUNG>
int launch_plane(const uint8_t* x, uint16_t* out, int B, int D, int W,
                 cudaStream_t stream) {
  const int half = D / 2;
  const dim3 block(32, half < 32 ? half : 32);
  const dim3 grid((W + 31) / 32, B);
  rung_plane_kernel<RUNG><<<grid, block, 2 * half * 32 * sizeof(unsigned),
                            stream>>>(x, out, D, W);
  return (int)cudaGetLastError();
}

// ---- scan16 ---------------------------------------------------------------------

template <int NP>
__global__ void scan16_kernel(const uint8_t* __restrict__ cost,
                              const uint8_t* __restrict__ img,
                              uint16_t* __restrict__ aggr, int B, int S, int D,
                              int W, int reverse, int roll, int restart,
                              int p1, int p2_init, int accumulate) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  if (warp >= B * W) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int b = warp / W;
  const int path = warp - b * W;
  const size_t plane = (size_t)W;
  const uint8_t* cost_b = cost + (size_t)b * S * D * W;
  const uint8_t* img_b = img + (size_t)b * S * W;
  uint16_t* aggr_b = aggr + (size_t)b * S * D * W;

  const int d0 = lane * 2 * NP;
  unsigned valid[NP], last[NP];  // per half: d < D, d >= D - 1
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int lo = d0 + 2 * j, hi = lo + 1;
    valid[j] = (lo < D ? kLow : 0u) | (hi < D ? kHigh : 0u);
    last[j] = (lo >= D - 1 ? kLow : 0u) | (hi >= D - 1 ? kHigh : 0u);
  }
  const unsigned first = lane == 0 ? kLow : 0u;  // d == 0: register 0, low

  unsigned prev[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) prev[j] = 0u;
  int prev_min = 0, prev_gray = 0;
  const unsigned p1p1 = both(p1);

  for (int s = 0; s < S; ++s) {
    const int row = reverse ? S - 1 - s : s;
    int col = path;
    if (roll) {
      col = (path + roll * (s % W)) % W;
      if (col < 0) col += W;
    }
    const int gray = img_b[row * W + col];
    const size_t base = (size_t)row * D * W + col;
    unsigned c[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int lo = d0 + 2 * j;
      c[j] = (lo < D ? (unsigned)cost_b[base + lo * plane] : 0u) |
             (lo + 1 < D ? (unsigned)cost_b[base + (lo + 1) * plane] << 16 : 0u);
    }

    unsigned cur[NP];
    const bool fresh =
        s == 0 || (restart && roll &&
                   ((roll > 0 && col == 0) || (roll < 0 && col == W - 1)));
    if (fresh) {
#pragma unroll
      for (int j = 0; j < NP; ++j) cur[j] = c[j];
    } else {
      const int p2 = max(p1, p2_init / (abs(gray - prev_gray) + 1));
      const unsigned min_p2 = both(prev_min + p2);
      const unsigned min2 = both(prev_min);
      const unsigned below = __shfl_up_sync(kFull, prev[NP - 1], 1);
      const unsigned above = __shfl_down_sync(kFull, prev[0], 1);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const unsigned a = j > 0 ? prev[j - 1] : below;
        const unsigned z = j < NP - 1 ? prev[j + 1] : above;
        unsigned up = weave(a, prev[j]);   // L(d-1) of both halves
        unsigned dn = weave(prev[j], z);   // L(d+1) of both halves
        if (j == 0) up = (up & ~first) | (kSentinel2 & first);
        dn = (dn & ~last[j]) | (kSentinel2 & last[j]);
        const unsigned m = __vminu2(
            __vminu2(prev[j], __vadd2(__vminu2(up, dn), p1p1)), min_p2);
        cur[j] = __vsub2(__vadd2(c[j], m), min2) & kSentinel2;
      }
    }

    unsigned packed_min = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int lo = d0 + 2 * j;
      if (lo < D) {
        uint16_t* a = aggr_b + base + lo * plane;
        const unsigned v = cur[j] & kLow;
        *a = (uint16_t)(accumulate ? *a + v : v);
      }
      if (lo + 1 < D) {
        uint16_t* a = aggr_b + base + (lo + 1) * plane;
        const unsigned v = cur[j] >> 16;
        *a = (uint16_t)(accumulate ? *a + v : v);
      }
      packed_min = __vminu2(packed_min, cur[j] | ~valid[j]);
      prev[j] = cur[j];
    }
    for (int off = 16; off > 0; off >>= 1)
      packed_min = __vminu2(packed_min, __shfl_xor_sync(kFull, packed_min, off));
    prev_min = (int)min(packed_min & kLow, packed_min >> 16);
    prev_gray = gray;
  }
}

template <int NP>
int launch_scan16(const uint8_t* cost, const uint8_t* img, uint16_t* aggr,
                  int B, int S, int D, int W, int reverse, int roll,
                  int restart, int p1, int p2_init, int accumulate,
                  cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long blocks = ((long long)B * W * 32 + kThreads - 1) / kThreads;
  scan16_kernel<NP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      cost, img, aggr, B, S, D, W, reverse, roll, restart, p1, p2_init,
      accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// One rung on uint8 (B, R, W) planes into uint16 (B, R, W): R = D (even) for
// the plane rungs, the number of rows for the loop rungs 5 and 11 (p5b).
extern "C" int sgm_probe_rung(const void* x, void* out, int rung, int B,
                              int R, int W, void* stream) {
  if ((long long)B * R * W == 0) return 0;
  const uint8_t* xs = (const uint8_t*)x;
  uint16_t* o = (uint16_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (rung == 5 || rung == 11) {
    const dim3 grid(((W + 1) / 2 + 127) / 128, B);
    if (rung == 5)
      rung_loop_kernel<false><<<grid, 128, 0, s>>>(xs, o, R, W);
    else
      rung_loop_kernel<true><<<grid, 128, 0, s>>>(xs, o, R, W);
    return (int)cudaGetLastError();
  }
  if (R % 2 || R > 256) return (int)cudaErrorInvalidValue;
  switch (rung) {
    case 0: return launch_plane<0>(xs, o, B, R, W, s);
    case 1: return launch_plane<1>(xs, o, B, R, W, s);
    case 2: return launch_plane<2>(xs, o, B, R, W, s);
    case 3: return launch_plane<3>(xs, o, B, R, W, s);
    case 4: return launch_plane<4>(xs, o, B, R, W, s);
    case 6: return launch_plane<6>(xs, o, B, R, W, s);
    case 8: return launch_plane<8>(xs, o, B, R, W, s);
    case 9: return launch_plane<9>(xs, o, B, R, W, s);
    case 10: return launch_plane<10>(xs, o, B, R, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

// One vertical direction of a group scan with packed 16-bit state; the
// arguments of sgm_scan_direction, without `vertical`.
extern "C" int sgm_probe_scan16(const void* cost, const void* img, void* aggr,
                                int B, int S, int D, int W, int reverse,
                                int roll, int restart, int p1, int p2_init,
                                int accumulate, void* stream) {
  if (B * S * W == 0) return 0;
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  const uint8_t* c = (const uint8_t*)cost;
  const uint8_t* g = (const uint8_t*)img;
  uint16_t* a = (uint16_t*)aggr;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 63) / 64) {
#define SGM_SCAN16_CASE(N)                                                   \
  case N:                                                                    \
    return launch_scan16<N>(c, g, a, B, S, D, W, reverse, roll, restart, p1, \
                            p2_init, accumulate, s);
    SGM_SCAN16_CASE(1)
    SGM_SCAN16_CASE(2)
    SGM_SCAN16_CASE(3)
    SGM_SCAN16_CASE(4)
#undef SGM_SCAN16_CASE
  }
  return (int)cudaErrorInvalidValue;
}
