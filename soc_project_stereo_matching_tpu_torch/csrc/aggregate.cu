// K2: SGM path aggregation (one launch per direction) and the WTA reduction.
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   _directional_scan_group / _scan_group_kernel (with and without its
//   cross-tile carry-in/out refs) and
//   _directional_scan_group_bidir / _bidir_kernel, as driven by
//   aggregate_paths_wta and parallel/tiles.py, and
//   wta_reduce_pallas / _wta_kernel / _wta_reduce_block.
//
// What bounds it on the H100 (measured; PERF.md, Open questions): memory
// access efficiency, not the chain of dependent steps.  Each direction
// must move one cost byte read and one uint16 read-modify-write per volume
// element, but the passes run far below that byte roofline.  At the cone
// shape a horizontal pass takes about 5x as long as a vertical one, though
// its paths are only 1.2x longer (W=450 vs H=375 steps): its warp walks
// one row, so its 32 lanes touch D
// planes at stride W and no neighbouring warp shares those sectors, and
// most of each 32-byte sector fetched is wasted.  A vertical or diagonal
// pass has neighbouring warps on neighbouring columns, so their loads
// share sectors, yet it still reaches only a few per cent of the roofline.
// The WTA pass reads the uint16 volume once (twice with the inverse view)
// and writes 5 or 10 int32 planes.
//
// Scan design (the GPU SGM pattern of arXiv 1610.04121): every path is an
// independent 1-D scan, and one warp walks one path.  Lane l holds the DPL
// consecutive disparities d = l*DPL .. l*DPL+DPL-1 (D <= 32*DPL <= 256) in
// registers; __shfl_up/down deliver L(d-1) and L(d+1) across lane
// boundaries and a butterfly min gives min_d L.  Adaptive P2 is computed in
// the kernel from the two gray values along the path.  B*W or B*H warps
// run at once.  This plain design leaves the access pattern as it is;
// staging tiles in shared memory is left for later.  Each direction launch
// adds its contribution into the uint16 volume (the first one stores it);
// launches are ordered on the stream and within a launch every pixel
// belongs to exactly one path, so no atomics are needed.
//
// Wrap diagonals: the path that starts at column k of its first row is at
// column (k + roll*s) mod W at step s, so the previous pixel of a path is
// the wrapped one.  In restart mode the path restarts (raw cost) whenever it
// is at column 0 (roll > 0) or W-1 (roll < 0) after its first step.
//
// Carry mode (sgm_scan_carry, vertical scans of an H-tile): the DP state
// crosses tile boundaries as int32 planes indexed by column, the layout of
// the Pallas entry (cost (B, n, D, W), min (B, n, 1, W)).  A path's first
// step reads the state at column (col - roll) mod W of the carry-in and the
// upstream tile's boundary gray row there, for P2; its last step writes
// the state at its own column of the carry-out.  Each column is the last
// column of exactly one path, so the writes never collide.  A reverse scan
// takes the carry at the tile's last row and emits it at the first.  Only a
// first step without a carry-in starts fresh; a zero carry-in is neutral
// (m = 0, so the first row contributes its raw cost).
//
// WTA design: one thread per pixel, looping over d with w fastest across
// threads (coalesced).  A single pass keeps the first argmin, the min and
// the min over d != best; c1/c2 are re-read at clip(best -+ 1).  The inverse
// view samples plane k at column j + dmin + k (65535 outside the image).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 255;
constexpr int kBig = 1 << 30;
constexpr int kUint16Max = 65535;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One direction's cross-tile DP state; all pointers null outside carry
// mode.  Plane pointers are already offset to the direction; n is the
// number of directions in the carry tensors (their batch stride).
struct Carry {
  const int* in_cost;         // (B, n, D, W) int32, or null: fresh start
  const int* in_min;          // (B, n, 1, W) int32
  const uint8_t* prev_gray;   // (B, W) upstream boundary row
  int* out_cost;              // (B, n, D, W) int32, or null: not wanted
  int* out_min;               // (B, n, 1, W) int32
  int n;
};

template <int DPL>
__global__ void scan_kernel(const uint8_t* __restrict__ cost,
                            const uint8_t* __restrict__ img,
                            uint16_t* __restrict__ aggr, int B, int H, int D,
                            int W, int vertical, int reverse, int roll,
                            int restart, int p1, int p2_init, int accumulate,
                            Carry carry) {
  const int paths = vertical ? W : H;  // paths per image
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  if (warp >= B * paths) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int b = warp / paths;
  const int path = warp - b * paths;
  const int steps = vertical ? H : W;
  const size_t plane = (size_t)W;  // stride between d planes of one row
  const uint8_t* cost_b = cost + (size_t)b * H * D * W;
  const uint8_t* img_b = img + (size_t)b * H * W;
  uint16_t* aggr_b = aggr + (size_t)b * H * D * W;

  int prev[DPL];
  int prev_min = 0;
  int prev_gray = 0;
  const bool carried = carry.in_cost != nullptr;
  const size_t cost_stride = (size_t)carry.n * D * W;
  const size_t min_stride = (size_t)carry.n * W;
  if (carried) {  // carry mode is vertical: the path starts at column `path`
    int pc = (path - roll) % W;
    if (pc < 0) pc += W;
    const int* cin = carry.in_cost + b * cost_stride + pc;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      prev[i] = d < D ? cin[(size_t)d * W] : 0;
    }
    prev_min = carry.in_min[b * min_stride + pc];
    prev_gray = carry.prev_gray[(size_t)b * W + pc];
  }
  int last_col = 0;
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    int row, col;
    if (vertical) {
      row = t;
      col = path;
      if (roll) {
        col = (path + roll * (s % W)) % W;
        if (col < 0) col += W;
      }
    } else {
      row = path;
      col = t;
    }
    const int gray = img_b[row * W + col];
    const size_t base = (size_t)row * D * W + col;
    int c[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      c[i] = d < D ? cost_b[base + d * plane] : 0;
    }

    int cur[DPL];
    const bool fresh =
        (s == 0 && !carried) ||
        (restart && roll &&
         ((roll > 0 && col == 0) || (roll < 0 && col == W - 1)));
    if (fresh) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) cur[i] = c[i];
    } else {
      const int p2 = max(p1, p2_init / (abs(gray - prev_gray) + 1));
      const int up = __shfl_up_sync(kFull, prev[DPL - 1], 1);   // L(d-1), i=0
      const int dn = __shfl_down_sync(kFull, prev[0], 1);       // L(d+1), i=DPL-1
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        const int lm = d == 0 ? kSentinel : (i > 0 ? prev[i - 1] : up);
        const int lp = d >= D - 1 ? kSentinel : (i < DPL - 1 ? prev[i + 1] : dn);
        const int m = min(min(prev[i], lm + p1), min(lp + p1, prev_min + p2));
        cur[i] = (c[i] + m - prev_min) & 0xFF;
      }
    }

    int local_min = INT_MAX;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      if (d < D) {
        uint16_t* a = aggr_b + base + d * plane;
        *a = (uint16_t)(accumulate ? *a + cur[i] : cur[i]);
        local_min = min(local_min, cur[i]);
      }
      prev[i] = cur[i];
    }
    prev_min = warp_min(local_min);
    prev_gray = gray;
    last_col = col;
  }
  if (carry.out_cost != nullptr) {  // the state after the last step
    int* cout = carry.out_cost + b * cost_stride + last_col;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      if (d < D) cout[(size_t)d * W] = prev[i];
    }
    if (lane == 0) carry.out_min[b * min_stride + last_col] = prev_min;
  }
}

template <int DPL>
int launch_scan(const uint8_t* cost, const uint8_t* img, uint16_t* aggr,
                int B, int H, int D, int W, int vertical, int reverse,
                int roll, int restart, int p1, int p2_init, int accumulate,
                Carry carry, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps = 8 paths per block
  const long long warps = (long long)B * (vertical ? W : H);
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  scan_kernel<DPL><<<(unsigned)blocks, kThreads, 0, stream>>>(
      cost, img, aggr, B, H, D, W, vertical, reverse, roll, restart, p1,
      p2_init, accumulate, carry);
  return (int)cudaGetLastError();
}

int scan_direction(const void* cost, const void* img, void* aggr, int B,
                   int H, int D, int W, int vertical, int reverse, int roll,
                   int restart, int p1, int p2_init, int accumulate,
                   Carry carry, void* stream) {
  if (B * H * W == 0) return 0;
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  const uint8_t* c = (const uint8_t*)cost;
  const uint8_t* g = (const uint8_t*)img;
  uint16_t* a = (uint16_t*)aggr;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
#define SGM_SCAN_CASE(N)                                                  \
  case N:                                                                 \
    return launch_scan<N>(c, g, a, B, H, D, W, vertical, reverse, roll,  \
                          restart, p1, p2_init, accumulate, carry, s);
    SGM_SCAN_CASE(1)
    SGM_SCAN_CASE(2)
    SGM_SCAN_CASE(3)
    SGM_SCAN_CASE(4)
    SGM_SCAN_CASE(5)
    SGM_SCAN_CASE(6)
    SGM_SCAN_CASE(7)
    SGM_SCAN_CASE(8)
#undef SGM_SCAN_CASE
  }
  return (int)cudaErrorInvalidValue;
}

struct Best {
  int idx, min1, min2;
};

// First argmin, min and min over k != argmin of f(0..D-1).
template <typename F>
__device__ __forceinline__ Best reduce_planes(int D, F f) {
  Best r{0, f(0), kBig};
  for (int k = 1; k < D; ++k) {
    const int v = f(k);
    if (v < r.min1) {
      r.min2 = r.min1;
      r.min1 = v;
      r.idx = k;
    } else if (v < r.min2) {
      r.min2 = v;
    }
  }
  return r;
}

__global__ void wta_kernel(const uint16_t* __restrict__ aggr,
                           int* __restrict__ out, int B, int H, int D, int W,
                           int dmin, int include_inverse) {
  const size_t n = (size_t)B * H * W;
  const size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = (int)(idx % W);
  const uint16_t* a = aggr + (idx / W) * D * W;

  auto fwd = [&](int k) { return (int)a[(size_t)k * W + j]; };
  Best r = reduce_planes(D, fwd);
  out[idx] = r.idx;
  out[n + idx] = r.min1;
  out[2 * n + idx] = r.min2;
  out[3 * n + idx] = fwd(max(r.idx - 1, 0));
  out[4 * n + idx] = fwd(min(r.idx + 1, D - 1));
  if (!include_inverse) return;

  auto inv = [&](int k) {
    const int col = j + dmin + k;
    return (col >= 0 && col < W) ? (int)a[(size_t)k * W + col] : kUint16Max;
  };
  r = reduce_planes(D, inv);
  out[5 * n + idx] = r.idx;
  out[6 * n + idx] = r.min1;
  out[7 * n + idx] = r.min2;
  out[8 * n + idx] = inv(max(r.idx - 1, 0));
  out[9 * n + idx] = inv(min(r.idx + 1, D - 1));
}

}  // namespace

// One direction of the aggregation: vertical (scan over H; roll -1/0/+1
// selects the wrap diagonals) or horizontal (scan over W).  accumulate=0
// stores the contribution, 1 adds it to the volume.
extern "C" int sgm_scan_direction(const void* cost, const void* img,
                                  void* aggr, int B, int H, int D, int W,
                                  int vertical, int reverse, int roll,
                                  int restart, int p1, int p2_init,
                                  int accumulate, void* stream) {
  return scan_direction(cost, img, aggr, B, H, D, W, vertical, reverse, roll,
                        restart, p1, p2_init, accumulate, Carry{}, stream);
}

// One vertical direction of an H-tile in carry mode (see the header):
// cin_cost may be null (fresh paths; then cin_min and prev_gray are unused)
// and cout_cost null (no carry-out wanted).  The carry pointers point at
// this direction's plane of (B, n, ...) int32 tensors.
extern "C" int sgm_scan_carry(const void* cost, const void* img, void* aggr,
                              const void* cin_cost, const void* cin_min,
                              const void* prev_gray, void* cout_cost,
                              void* cout_min, int B, int H, int D, int W,
                              int n, int reverse, int roll, int restart,
                              int p1, int p2_init, int accumulate,
                              void* stream) {
  const Carry carry{(const int*)cin_cost, (const int*)cin_min,
                    (const uint8_t*)prev_gray, (int*)cout_cost,
                    (int*)cout_min, n};
  return scan_direction(cost, img, aggr, B, H, D, W, 1, reverse, roll,
                        restart, p1, p2_init, accumulate, carry, stream);
}

// WTA planes of a uint16 (B, H, D, W) volume into out = int32 (5 or 10, B,
// H, W): best, min, sec_min, c1, c2 of the forward view, then of the inverse.
extern "C" int sgm_wta_reduce(const void* aggr, void* out, int B, int H,
                              int D, int W, int dmin, int include_inverse,
                              void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  if (D < 1) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  wta_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
               (cudaStream_t)stream>>>((const uint16_t*)aggr, (int*)out, B, H,
                                       D, W, dmin, include_inverse);
  return (int)cudaGetLastError();
}
