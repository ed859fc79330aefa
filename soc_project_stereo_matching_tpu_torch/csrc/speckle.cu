// K4: speckle removal by connected-component labelling.
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   remove_speckles_pallas and its three kernels, _speckle_labels_kernel
//   (+ _cc_propagate), _speckle_hist_kernel and _speckle_verdict_kernel.
//
// The function: two 8-neighbours are connected when both are finite and
// |d_p - d_q| <= diff in f32; every finite pixel of a component with fewer
// than min_area finite pixels becomes +inf; NaN, -inf and +inf pass through
// (each is a component of its own and is never counted).
//
// What bounds it on the H100: not bytes (a f32 map in, one out: 0.1 ms for
// 32 cone frames) but dependent trips to memory.  The first design (a
// lock-free union-find over the whole batch in device memory, then a plain
// atomicAdd per finite pixel on its root) spent 7.7 of its 8.3 ms at cone
// B=32 chasing parent chains through the L2 with atomics, and the count
// added into one word per component: one component there holds 67,665 of a
// frame's 168,750 pixels.
//
// Design: block-based union-find (the pattern of Allegretti, Bolelli and
// Grana, "Optimized Block-Based Algorithms to Label Connected Components on
// GPUs", IEEE TPDS 2020), four launches:
//   1. tile_kernel: one block of 32 x kTileH threads per tile of a frame.
//      It loads the tile into shared memory; a warp is a tile row, and each
//      pixel's run head (the first pixel of its horizontal run of connected
//      pixels) comes from one ballot, so the shared parent array starts as
//      trees of depth one.  The links to the row above are united with
//      shared-memory atomicMin; a link is skipped where the links of the
//      pixel's run neighbours already carry it, so two runs that touch
//      along a stretch are united about once.  Every pixel then gets its
//      tile root as a flat index over the batch; the count scratch is
//      zeroed here.
//   2. border_kernel: one thread per pixel on a tile's top row, left column
//      and right column unites it, in device memory, with the neighbours it
//      has in other tiles.  Only those unions touch device memory, and a
//      tile never crosses a frame, so frames never connect.
//   3. flatten_count_kernel: every pixel takes its root; a warp adds its
//      finite pixels once per distinct root (__match_any_sync).
//   4. verdict_kernel: four pixels a thread, 16-byte loads and stores where
//      the planes are aligned.
// Unions are by minimum (Playne and Hawick's lock-free union: the larger
// root is hung under the smaller by atomicMin and the union retried if
// another thread moved it first), and a tile's local order is the flat
// order, so every root is its component's smallest flat index over the
// batch: the labels even equal the JAX op's.  Only the verdict must.
//
// Two further entries run the stages apart: sgm_speckle_union_labels (the
// label stage, 1-3 without the count: the flattened roots) and
// sgm_speckle_count_verdict (the tail on given roots: a memset, the
// aggregated count, 4).  The wrappers count both as remove_speckles.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;                    // a warp per tile row
constexpr int kTileH = 16;
constexpr int kTileThreads = kTileW * kTileH;
// the top row, and the left and right columns below it
constexpr int kBorderPixels = kTileW + 2 * (kTileH - 1);
constexpr int kBorderThreads = (kBorderPixels + 31) / 32 * 32;
constexpr int kThreads = 256;
constexpr int kVerdictPixels = 4;             // per thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool linked(float a, float b, float diff) {
  return isfinite(a) && isfinite(b) && fabsf(a - b) <= diff;
}

// --- union-find: the same code on shared and on device memory -------------

__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Unite the trees of a and b; the larger root goes under the smaller.
__device__ void unite(int* parent, int a, int b) {
  const volatile int* vp = parent;
  while (true) {
    a = find_root(vp, a);
    b = find_root(vp, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + a, b);
    if (old == a) return;
    a = old;  // a stopped being a root meanwhile: unite from its new parent
  }
}

struct Tile {
  int frame, y0, x0;  // the tile's frame and its first row and column
};

__device__ __forceinline__ Tile tile_of(int block, int tiles_x, int tiles_y) {
  const int per_frame = tiles_x * tiles_y;
  const int frame = block / per_frame;
  const int t = block - frame * per_frame;
  const int ty = t / tiles_x;
  return {frame, ty * kTileH, (t - ty * tiles_x) * kTileW};
}

// 1. Label each tile in shared memory.  label: every pixel's tile root as a
// flat index; count (may be null): zeroed.
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const float* __restrict__ disp, int* __restrict__ label,
            int* __restrict__ count, int H, int W, int tiles_x, int tiles_y,
            float diff) {
  __shared__ float sd[kTileThreads];
  __shared__ int parent[kTileThreads];
  __shared__ unsigned run_links[kTileH];  // per row: bit x = x linked to x-1
  const Tile t = tile_of(blockIdx.x, tiles_x, tiles_y);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r = t.y0 + ty, c = t.x0 + tx;
  const bool in = r < H && c < W;
  const int frame_base = t.frame * H * W;
  const int p = in ? frame_base + r * W + c : 0;
  const float d = in ? disp[p] : NAN;  // NaN: outside the frame, never linked
  sd[threadIdx.x] = d;

  // this row: a pixel linked to its left neighbour joins that pixel's run
  const float left_d = __shfl_up_sync(kFull, d, 1);
  const bool left = tx > 0 && linked(d, left_d, diff);
  const unsigned lefts = __ballot_sync(kFull, left);
  const int head = 31 - __clz(~lefts & (kFull >> (31 - tx)));  // bit 0 clear
  parent[threadIdx.x] = (ty << 5) | head;
  if (tx == 0) run_links[ty] = lefts;
  __syncthreads();

  // the row above.  A link that a run neighbour's links already carry is
  // skipped: up-left is up of the left neighbour L, up-right up of the
  // right one; and up is carried when L links up and up(L) and up(p) are
  // one run
  const float* above = sd + threadIdx.x - kTileW;
  const bool up = ty > 0 && linked(d, above[0], diff);
  const unsigned ups = __ballot_sync(kFull, up);
  if (ty > 0 && isfinite(d)) {
    const int me = threadIdx.x;
    const bool left_up = left && (ups >> (tx - 1) & 1);
    if (up && !(left_up && (run_links[ty - 1] >> tx & 1)))
      unite(parent, me, me - kTileW);
    if (tx > 0 && !left_up && linked(d, above[-1], diff))
      unite(parent, me, me - kTileW - 1);
    const bool right_up = tx < 31 && (lefts >> (tx + 1) & 1) &&
                          (ups >> (tx + 1) & 1);
    if (tx < 31 && !right_up && linked(d, above[1], diff))
      unite(parent, me, me - kTileW + 1);
  }
  __syncthreads();

  if (!in) return;
  const int root = find_root(parent, threadIdx.x);
  label[p] = frame_base + (t.y0 + (root >> 5)) * W + t.x0 + (root & 31);
  if (count) count[p] = 0;
}

// 2. Unite across tile borders, in device memory: each pixel of a tile's
// top row and left and right columns with its earlier 8-neighbours (left,
// up-left, up, up-right) that lie in another tile; every link between two
// tiles is such a pair.
__global__ void __launch_bounds__(kBorderThreads)
border_kernel(const float* __restrict__ disp, int* label, int H, int W,
              int tiles_x, int tiles_y, float diff) {
  const Tile t = tile_of(blockIdx.x, tiles_x, tiles_y);
  const int i = threadIdx.x;
  int ty, tx;
  if (i < kTileW) {
    ty = 0, tx = i;
  } else if (i < kTileW + kTileH - 1) {
    ty = i - kTileW + 1, tx = 0;
  } else {
    ty = i - (kTileW + kTileH - 1) + 1, tx = kTileW - 1;
  }
  const int r = t.y0 + ty, c = t.x0 + tx;
  const bool in = i < kBorderPixels && r < H && c < W;
  const int p = in ? t.frame * H * W + r * W + c : 0;
  const float d = in ? disp[p] : NAN;

  // on the top row (warp 0 holds it whole), skip a diagonal link that the
  // run neighbour's up link carries, as tile_kernel does
  const bool top = i < kTileW;
  const float left_d = __shfl_up_sync(kFull, d, 1);
  const bool left = top && tx > 0 && linked(d, left_d, diff);
  const float up_d = in && r > 0 ? disp[p - W] : NAN;
  const bool up = linked(d, up_d, diff);
  const float up_left_d = __shfl_up_sync(kFull, up_d, 1);  // every lane
  const bool up_left = top && tx > 0 &&  // up(p) linked to its left
                       linked(up_d, up_left_d, diff);
  const unsigned ups = __ballot_sync(kFull, up);
  const unsigned lefts = __ballot_sync(kFull, left);
  if (!in || !isfinite(d)) return;

  if (ty == 0 && up && !(left && (ups >> (tx - 1) & 1) && up_left))
    unite(label, p, p - W);
  if (c > 0 && (tx == 0 || ty == 0)) {        // up-left in another tile
    const bool carried = left && (ups >> (tx - 1) & 1);
    if (r > 0 && !carried && linked(d, disp[p - W - 1], diff))
      unite(label, p, p - W - 1);
  }
  if (c > 0 && tx == 0 && linked(d, disp[p - 1], diff))  // left
    unite(label, p, p - 1);
  if (c + 1 < W && (tx == kTileW - 1 || ty == 0)) {  // up-right
    const bool carried = top && tx < kTileW - 1 && (lefts >> (tx + 1) & 1) &&
                         (ups >> (tx + 1) & 1);
    if (r > 0 && !carried && linked(d, disp[p - W + 1], diff))
      unite(label, p, p - W + 1);
  }
}

// One add per distinct root of the warp; every lane must call it.
__device__ __forceinline__ void add_once_per_root(int* count, bool counted,
                                                  int root) {
  const unsigned peers = __match_any_sync(kFull, counted ? root : -1);
  if (counted && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(count + root, __popc(peers));
}

// 3. Every pixel's root; with count, the finite pixels of each component.
__global__ void __launch_bounds__(kThreads)
flatten_count_kernel(const float* __restrict__ disp, int* label, int* count,
                     int n) {
  const unsigned p = blockIdx.x * kThreads + threadIdx.x;  // n < 2^31
  const bool in = p < (unsigned)n;
  int root = -1;
  if (in) {
    const int l = label[p];
    root = find_root(label, l);
    if (root != l) label[p] = root;
  }
  if (count) add_once_per_root(count, in && isfinite(disp[p]), root);
}

// The tail's count, on given roots.
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ disp, const int* __restrict__ label,
             int* count, int n) {
  const unsigned p = blockIdx.x * kThreads + threadIdx.x;
  const bool in = p < (unsigned)n;
  add_once_per_root(count, in && isfinite(disp[p]), in ? label[p] : -1);
}

// 4. p becomes +inf iff it is finite and its component is smaller than
// min_area.  `wide`: the three planes are 16-byte aligned, so every whole
// group of four pixels is one load or store per plane.
__device__ __forceinline__ float verdict(float d, int l, const int* count,
                                         int min_area) {
  return isfinite(d) && count[l] < min_area ? INFINITY : d;
}

__global__ void __launch_bounds__(kThreads)
verdict_kernel(const float* __restrict__ disp, const int* __restrict__ label,
               const int* __restrict__ count, float* __restrict__ out, int n,
               int min_area, int wide) {
  const long long i =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kVerdictPixels;
  if (i >= n) return;
  if (wide && i + kVerdictPixels <= n) {
    const float4 d = *reinterpret_cast<const float4*>(disp + i);
    const int4 l = *reinterpret_cast<const int4*>(label + i);
    *reinterpret_cast<float4*>(out + i) = make_float4(
        verdict(d.x, l.x, count, min_area), verdict(d.y, l.y, count, min_area),
        verdict(d.z, l.z, count, min_area), verdict(d.w, l.w, count, min_area));
    return;
  }
  for (long long j = i; j < i + kVerdictPixels && j < n; ++j)
    out[j] = verdict(disp[j], label[j], count, min_area);
}

struct Grid {
  int n, tiles_x, tiles_y, tiles, blocks, verdict_blocks;
};

// false if the batch does not fit int32 labels
bool grid_of(int B, int H, int W, Grid* g) {
  const long long n = (long long)B * H * W;
  if (n > 0x7fffffff) return false;
  g->n = (int)n;
  g->tiles_x = (W + kTileW - 1) / kTileW;
  g->tiles_y = (H + kTileH - 1) / kTileH;
  g->tiles = B * g->tiles_x * g->tiles_y;
  g->blocks = (int)((n + kThreads - 1) / kThreads);
  g->verdict_blocks = (int)((n + kThreads * kVerdictPixels - 1) /
                            (kThreads * kVerdictPixels));
  return true;
}

// Steps 1-3: label gets every pixel's root; count (may be null) the finite
// pixels of each component at its root.
void label_stage(const float* d, int* lab, int* cnt, int H, int W,
                 const Grid& g, float diff, cudaStream_t s) {
  tile_kernel<<<g.tiles, kTileThreads, 0, s>>>(d, lab, cnt, H, W, g.tiles_x,
                                               g.tiles_y, diff);
  border_kernel<<<g.tiles, kBorderThreads, 0, s>>>(d, lab, H, W, g.tiles_x,
                                                   g.tiles_y, diff);
  flatten_count_kernel<<<g.blocks, kThreads, 0, s>>>(d, lab, cnt, g.n);
}

void launch_verdict(const float* d, const int* lab, const int* cnt, float* out,
                    const Grid& g, int min_area, cudaStream_t s) {
  const int wide =
      (((uintptr_t)d | (uintptr_t)lab | (uintptr_t)out) & 15) == 0;
  verdict_kernel<<<g.verdict_blocks, kThreads, 0, s>>>(d, lab, cnt, out, g.n,
                                                       min_area, wide);
}

}  // namespace

// disp, out: f32 (B, H, W); label, count: int32 scratch of B*H*W each.
extern "C" int sgm_remove_speckles(const void* disp, void* out, void* label,
                                   void* count, int B, int H, int W,
                                   float diff, int min_area, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  Grid g;
  if (!grid_of(B, H, W, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)disp;
  label_stage(d, (int*)label, (int*)count, H, W, g, diff, s);
  launch_verdict(d, (const int*)label, (const int*)count, (float*)out, g,
                 min_area, s);
  return (int)cudaGetLastError();
}

// The label stage alone.  disp: f32 (B, H, W); label: int32 (B, H, W) out,
// every pixel's root: the smallest flat index (over the batch) of its
// component.
extern "C" int sgm_speckle_union_labels(const void* disp, void* label, int B,
                                        int H, int W, float diff,
                                        void* stream) {
  if ((long long)B * H * W == 0) return 0;
  Grid g;
  if (!grid_of(B, H, W, &g)) return (int)cudaErrorInvalidValue;
  label_stage((const float*)disp, (int*)label, nullptr, H, W, g, diff,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The tail alone.  disp, out: f32 (B, H, W); label: int32 flat roots in
// [0, B*H*W) as sgm_speckle_union_labels gives them; count: int32 scratch
// of B*H*W.
extern "C" int sgm_speckle_count_verdict(const void* disp, const void* label,
                                         void* count, void* out, int B, int H,
                                         int W, int min_area, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  Grid g;
  if (!grid_of(B, H, W, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(count, 0, sizeof(int) * (size_t)g.n, s);
  if (err != cudaSuccess) return (int)err;
  const float* d = (const float*)disp;
  count_kernel<<<g.blocks, kThreads, 0, s>>>(d, (const int*)label, (int*)count,
                                             g.n);
  launch_verdict(d, (const int*)label, (const int*)count, (float*)out, g,
                 min_area, s);
  return (int)cudaGetLastError();
}
