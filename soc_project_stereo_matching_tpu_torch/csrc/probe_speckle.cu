// S1-S4: the kernels of the speckle probes.
//
// Replaces: scripts/speckle_probe.py (the label kernel
//   pallas_kernels.py:_speckle_labels_kernel / _cc_propagate and its variants
//   _labels_kernel_variant: pair, fori16, block4, pyr) and
//   scripts/speckle_tail_probe.py (_hist_kernel, _verdict_kernel,
//   _fused_kernel).
//
// S1 speckle_labels: connected-component labels by min-propagation to a
// fixed point, the JAX kernel's function round for round: a seg round
// (run-min over horizontal runs, run-min over vertical runs of that, four
// diagonal link-mins) and a cheap round (three link-mins from the old
// plane, the downward one from the new, four diagonal link-mins) in turn.
// Every step is a whole-plane update, and a variant that stops early
// (fori16) must equal the plain version, so every step reads one plane and
// writes another, with a barrier between steps.
//   What bounds it: neither bytes nor operations but the number of steps
//   between barriers times a step's chain of dependent trips to the L2 and
//   to shared memory (PERF.md: a barrier costs 1-3 us, a step 5-40 us).
//   Design: a frame's planes (3 label planes that rotate, the link mask in
//   bytes) do not fit one SM's shared memory (675 KB each at the cone
//   shape, 6 MB at 1000x1500), so they live in global memory, read through
//   the L2, and one thread-block cluster owns a frame (block4: four
//   frames).  Its size is chosen before the launch from the card's own
//   answer, asked once for every size from 1 to 16 blocks: the fewest waves
//   of programs, a wave being as many clusters as the card holds at once
//   but no more than keep their planes in the L2, then the largest size.
//   On an NVIDIA H100 80GB HBM3, which holds seven clusters of 16 such
//   blocks at once, that is 9 blocks a frame at B = 8, at B = 32 six in two
//   waves of 16 frames, for a 37x45 frame one block, whose barrier is a
//   __syncthreads.  Between steps a cluster's blocks
//   meet at cluster.sync(); the convergence flag is reduced through
//   distributed shared memory.  No host read per round.
//   A round takes fewer steps than the whole-plane steps it is made of:
//   the steps that look at neighbours only (all six of a cheap round, the
//   four diagonal ones of a seg round) are fused into one, a block taking
//   32x64 tiles with a halo of 4 into shared memory (cp.async, the next
//   tile's copies in flight while the current one's steps run) and running
//   the steps there one after the other, each exactly as the whole-plane
//   step would leave the tile's own pixels.  So a seg round is three steps
//   (horizontal run-min, vertical run-min, the fused diagonals) and a cheap
//   round one, where the first design took six each.
//   A horizontal run-min is a warp per row, a lane eight neighbouring
//   columns: each lane's run-min within its columns, then a segmented
//   min-scan over the lanes with shuffles for what enters each lane, from
//   the left and then from the right.  A vertical run-min is a block per
//   strip of 32 columns: each warp takes a chunk of ceil(H / 32) rows (a
//   lane a column), scans it down, leaves the chunk's summary in shared
//   memory (the min of its first and of its last run, whether its first
//   row links up, whether it is one run), a segmented min-scan over the
//   chunks gives each what enters it from above and below, and a walk up
//   the chunk writes the run-min; no walk is longer than a chunk (the first
//   design gave each column to one thread: 15 warps of 256 at the cone
//   shape walking 375 rows down and up).  pyr finds every pixel's run heads
//   once before the loop, the vertical ones by the same chunks; its
//   run-min is an atomicMin into the head's slot of a scratch plane and a
//   load back.
//   Each pass is a function of its own (__noinline__): inlined into one
//   kernel they shared one allocation of 64 registers and spilled about a
//   kilobyte, whose reloads after every cluster barrier (which invalidates
//   the L1) stalled each step.
//
// S2 speckle_hist, S3 speckle_verdict, S4 speckle_tail_fused: the TPU builds
// one-hot matrices and contracts them on the MXU because a scatter-add is
// near-serial there, and bands the root plane to cut the products.  Here a
// count is an atomicAdd at the label's own address and a verdict a load
// from it, so neither the products nor the band are carried over.
//   What bounds them: bytes (4 per pixel in, 4 out) and, for S2, atomics on
//   one word per large component.  S2 (redesigned) takes four labels a
//   thread in one 16-byte load, merges equal neighbours into runs in
//   registers, the runs that start at one position of the quad across the
//   warp (__match_any_sync, __reduce_add_sync), the warp's leaders into an
//   open-addressing table in shared memory (atomicCAS on the key, atomicAdd
//   on the count; 2048 slots for the 1024 labels a block takes, so it
//   cannot fill), and adds once per distinct label of the block; its
//   zeroing of the counts is a memset before it.  `aggregate` false keeps
//   one device-memory add per pixel, the probe's control for what
//   contention on a large component's word costs.  S3 at the probe's shape
//   moves 11 MB and a launch's latency bounds it; its design keeps the
//   instruction count down: the frame is a grid axis, a thread loads four
//   labels in 16 bytes, has its four gathers in flight together and stores
//   16 bytes.
//   S4 (redesigned) is S2, root_small and S3 in one launch, with no memset.
//   What bounds it: bytes (the labels in, the verdicts out, 8 a pixel) and
//   a launch's fixed cost: every count of a frame must be in before any
//   verdict reads it, so the launch is cooperative
//   (cudaLaunchAttributeCooperative) and its blocks meet at two grid
//   barriers, cg::this_grid().sync() (header-only since CUDA 11: no -rdc),
//   every zero before any add, every add before any verdict.  The grid is
//   every block the card holds at once (one block of 1024 threads an SM,
//   asked once per device), and the batch's labels, taken as one flat
//   array, are spread over the blocks in contiguous shares, thread t of a
//   block holding up to four neighbouring quads (16 labels), read 16 bytes
//   at a time (a quad that crosses a frame's end gives each label its own
//   frame).  The labels stay in registers across both barriers, so they
//   are read once.  Before the first barrier a thread merges its equal
//   neighbours into runs and adds each run into the block's open-addressing
//   table in shared memory (a slot is read before it is claimed, so a key
//   the table holds costs one atomic), and the block stores 0 in device
//   memory at each key its table claimed; after it, one add per key; after
//   the second, a thread reads one count through the L2 (__ldcg) per run,
//   all its loads in flight together, packs its verdicts into bits, and the
//   warp stores them coalesced: in step k lane l stores the warp's quad
//   32 k + l, its four verdicts shuffled from the thread that holds it, in
//   one 16-byte store.  So only the roots that the labels name are zeroed,
//   one store per distinct label of a block, where the first design zeroed
//   the whole h_hist x lo plane of every frame (786 KB a frame at the cone
//   shape, 8.26 MB at 1000x1500), and one add goes to device memory per
//   distinct label of a block.  A table has a slot for each label of its
//   block (at most 16384), twice as many where that fits, so it cannot
//   fill.  A batch with more labels than the blocks hold at once (cone B=32:
//   5.96 M labels, 2.16 M a round on an NVIDIA H100's 132 blocks) runs in
//   rounds of whole frames, the tile a block takes chosen so that its table
//   holds every key of it; two barriers a round.  Frames of different
//   rounds never share a count, so a round's verdicts and the next round's
//   zeros need no barrier between them.  A frame larger than one round is
//   refused, as is a card that cannot hold a block
//   (cudaErrorCooperativeLaunchTooLarge).  `aggregate` false keeps one
//   zero store and one device-memory add per pixel, the control.
//   Tried and dropped (kernel_ab.py's ablations and PERF.md, PR 10): S2's
//   merge across the warp (__match_any_sync, __reduce_add_sync, a round per
//   run) before the table, slower than the inserts it saves; a thread
//   taking quads 1024 apart (each warp load and store contiguous), whose
//   runs were cut at every quad; fewer blocks for small batches (a quad a
//   thread at least), no faster.
//   The first design, a cluster of 8 blocks of 1024 threads per frame,
//   zeroed the whole root plane, read the labels twice, a label a thread at
//   a time, crossed two cluster.sync() and by default added once per pixel;
//   at cone B=8 its 64 blocks left half the SMs without one.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLabelThreads = 1024;       // of an S1 block
constexpr int kLabelWarps = kLabelThreads / 32;
constexpr int kMaxLabelCluster = 16;      // blocks of an S1 cluster, at most
constexpr int kMinPixels = 1;             // an S1 thread's pixels, at least
constexpr int kHistThreads = 256;         // of an S2 block
constexpr int kHistLabels = 4;            // labels a thread of S2 takes
constexpr int kHistTile = kHistThreads * kHistLabels;  // an S2 block's
constexpr int kHistSlotBits = 11;         // its table: twice the keys
constexpr int kHistSlots = 1 << kHistSlotBits;         // it can meet
constexpr int kVerdictThreads = 256;      // of S3
constexpr int kVerdictLabels = 4;         // labels a thread of S3 takes
constexpr int kTailThreads = 1024;        // of an S4 block
constexpr int kTailQuads = 4;             // quads a thread of S4 holds
constexpr int kTailBlockLabels = 4 * kTailQuads * kTailThreads;  // a block's
constexpr int kTailSlotBits = 14;         // its table: a slot a label
constexpr int kTailSlots = 1 << kTailSlotBits;
static_assert(kTailSlots >= kTailBlockLabels, "an S4 table cannot fill");
// keys, counts and the claim order of an S4 block's largest table
constexpr int kTailSmem = 3 * kTailSlots * (int)sizeof(int);
constexpr int kFixedRounds = 16;          // of fori16
constexpr int kBlockFrames = 4;           // of block4
constexpr int kBatch = 4;                 // pixels a thread has in flight
constexpr int kRows = 8;                  // rows a column walk loads at once
constexpr int kLaneCols = 8;              // columns a lane of a row walk takes
constexpr int kSegCols = 32 * kLaneCols;  // and its warp at once
constexpr int kTileH = 32, kTileW = 64;   // a fused step's tile
constexpr int kHalo = 4;                  // its halo: 3 the steps reach, + 1
constexpr int kTileRows = kTileH + 2 * kHalo, kTileCols = kTileW + 2 * kHalo;
constexpr int kTileCells = kTileRows * kTileCols;
constexpr int kCellsPerThread = (kTileCells + kLabelThreads - 1) / kLabelThreads;
constexpr int kTilePixels = kTileH * kTileW;
constexpr int kPixelsPerThread = kTilePixels / kLabelThreads;
static_assert(kTilePixels % kLabelThreads == 0, "a tile's pixels split evenly");
constexpr unsigned kFull = 0xffffffffu;
enum Mode { kBase = 0, kPair = 1, kFori16 = 2, kBlock4 = 3, kPyr = 4 };

// neighbour (dr, dc) of link-mask bit k; bits 2-5 are the diagonal order
__constant__ int kDr[6] = {0, -1, -1, -1, 1, 1};
__constant__ int kDc[6] = {-1, 0, -1, 1, -1, 1};

// Where a thread stands in its cluster.  Warps and pixels go round the
// blocks so that a step with few rows or columns still uses every SM.
struct Who {
  int tid;    // thread of the cluster: neighbouring threads, neighbouring pixels
  int lane;
  int warp;   // warp of the cluster, round-robin over its blocks
  int rank;   // block of the cluster
};

// One program's planes: F frames side by side, npx = F * H * W pixels; the
// cluster's blocks, threads and warps.
struct Planes {
  int npx, rows, H, W;
  int blocks, threads, warps;
};

// A vertical run-min's chunk summaries, a row per chunk of rows (a warp)
// and a column per lane, padded against bank conflicts when read by column.
struct ColumnScratch {
  int top[kLabelWarps][33];     // min of the chunk's first run
  int bot[kLabelWarps][33];     // min of its last run
  int flags[kLabelWarps][33];   // 1: its first row links up; 2: one run
  int from_above[kLabelWarps][33];
  int from_below[kLabelWarps][33];
};

// A fused step's tiles: two sets of copies in flight (the tile with its
// halo, the round's input at the tile's own pixels, the link-mask rows from
// their 4-byte aligned-down addresses), and two planes the steps write in
// turn.
constexpr int kMaskPitch = (kTileCols + 3 + 3) / 4 * 4;   // bytes of a row
struct TileCopy {
  int val[kTileCells];
  int before[kTilePixels];
  uint8_t mask[kTileRows * kMaskPitch];
};
struct TileScratch {
  TileCopy copy[2];
  int work[2][kTileCells];
};

union BlockScratch {
  ColumnScratch col;
  TileScratch tile;
};

// A block's scratch (dynamic shared memory: more than 48 KB), at namespace
// scope so that the passes, which are functions of their own, address it
// as shared memory.
extern __shared__ __align__(16) unsigned char block_smem[];

__device__ __forceinline__ BlockScratch& block_scratch() {
  return *reinterpret_cast<BlockScratch*>(block_smem);
}

__device__ __forceinline__ int ld(const int* p) { return __ldcg(p); }

// pyr's scatter and gather steps take kBatch pixels a thread at a time:
// first every pixel's own loads, then every neighbour's, so that a thread
// waits for the L2 twice per batch and not twice per pixel.
#define FOR_PIXEL_BATCH(i0) \
  for (int i0 = w.tid; i0 < g.npx; i0 += kBatch * g.threads)
#define FOR_BATCH_PIXEL(k, i, i0)                                           \
  _Pragma("unroll") for (int k = 0, i = i0; k < kBatch;                     \
                         ++k, i += g.threads) if (i < g.npx)

// The barrier between two steps: every write of the step is seen by every
// block of the cluster after it (planes are read through the L2).
__device__ __forceinline__ void step_sync(cg::cluster_group& cluster,
                                          const Planes& g) {
  if (g.blocks == 1)
    __syncthreads();
  else
    cluster.sync();
}

// mask and initial labels of every pixel
__device__ __noinline__ void
init_pass(const Who w, const Planes g, const float* __restrict__ disp,
          uint8_t* mask, int* lab, int lo_bits, float diff) {
  for (int i = w.tid; i < g.npx; i += g.threads) {
    const int row = i / g.W;
    const int c = i - row * g.W;
    const int r = row % g.H;
    const float d = disp[i];
    int m = 0;
    if (isfinite(d)) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int rr = r + kDr[k], cc = c + kDc[k];
        if (rr < 0 || rr >= g.H || cc < 0 || cc >= g.W) continue;
        const float nd = disp[i + kDr[k] * g.W + kDc[k]];
        if (isfinite(nd) && fabsf(d - nd) <= diff) m |= 1 << k;
      }
    }
    mask[i] = m;
    lab[i] = (r << lo_bits) | c;
  }
}

// One 32-element chunk's segmented min-scan over the lanes, towards higher
// lanes (`up`) or lower; f marks the lanes where a run starts in that
// direction.  `carry` is the running min of the run that enters the chunk.
template <bool up>
__device__ __forceinline__ int chunk_scan(int v, int f, int lane, int& carry) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v2 = up ? __shfl_up_sync(kFull, v, d) : __shfl_down_sync(kFull, v, d);
    const int f2 = up ? __shfl_up_sync(kFull, f, d) : __shfl_down_sync(kFull, f, d);
    if (up ? lane >= d : lane + d < 32) {
      if (!f) v = min(v, v2);
      f |= f2;
    }
  }
  if (!f) v = min(v, carry);
  carry = __shfl_sync(kFull, v, up ? 31 : 0);
  return v;
}

// dst = run-min of src over horizontal runs.  A warp per row, in segments
// of kSegCols columns, a lane kLaneCols neighbouring columns of a segment.
// Left to right: each lane's run-min from the left within its columns, a
// segmented min-scan over the lanes' last runs (what enters each lane from
// the left, the previous segments included), into dst.  Then right to left
// the same from the right, folded into dst.  The rows were written by other
// blocks before the barrier, whose acquire leaves no stale line in the L1,
// so the loads go through it and a lane's columns are whole sectors.
__device__ __noinline__ void
hrun_pass(const Who w, const Planes g, const uint8_t* __restrict__ mask,
          const int* src, int* dst, int big) {
  const int lane = w.lane;
  const int segs = (g.W + kSegCols - 1) / kSegCols;
  for (int row = w.warp; row < g.rows; row += g.warps) {
    const int* s = src + row * g.W;
    const uint8_t* m = mask + row * g.W;
    int* d = dst + row * g.W;
    int carry = big;
    for (int seg = 0; seg < segs; ++seg) {
      const int c0 = seg * kSegCols + lane * kLaneCols;
      int v[kLaneCols];
      unsigned link = 0;   // bit j: column c0 + j links to its left
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const bool in = c0 + j < g.W;
        v[j] = in ? s[c0 + j] : big;
        link |= (in ? (unsigned)(m[c0 + j] & 1) : 0u) << j;
      }
      int brk = kLaneCols;   // the lane's first column that starts a run
#pragma unroll
      for (int j = 1; j < kLaneCols; ++j) {
        if (!(link >> j & 1) && brk == kLaneCols) brk = j;
        v[j] = link >> j & 1 ? min(v[j], v[j - 1]) : v[j];
      }
      const int whole = brk == kLaneCols, head = link & 1;
      const int entering = carry;
      const int left = __shfl_up_sync(
          kFull, chunk_scan<true>(v[kLaneCols - 1], !(whole && head), lane,
                                  carry), 1);
      const int from_left = head ? (lane > 0 ? left : entering) : big;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        if (c0 + j < g.W) d[c0 + j] = j < brk ? min(v[j], from_left) : v[j];
    }
    carry = big;
    for (int seg = segs - 1; seg >= 0; --seg) {
      const int c0 = seg * kSegCols + lane * kLaneCols;
      int v[kLaneCols], fw[kLaneCols];
      unsigned link = 0;   // bit j: column c0 + j + 1 links to its left
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const int c = c0 + j;
        const bool in = c < g.W;
        v[j] = in ? s[c] : big;
        fw[j] = in ? d[c] : big;   // what this lane wrote going right
        link |= (c + 1 < g.W ? (unsigned)(m[c + 1] & 1) : 0u) << j;
      }
      int brk = -1;   // the lane's last column that ends a run
#pragma unroll
      for (int j = kLaneCols - 2; j >= 0; --j) {
        if (!(link >> j & 1) && brk < 0) brk = j;
        v[j] = link >> j & 1 ? min(v[j], v[j + 1]) : v[j];
      }
      const int whole = brk < 0, tail = link >> (kLaneCols - 1) & 1;
      const int entering = carry;
      const int right = __shfl_down_sync(
          kFull, chunk_scan<false>(v[0], !(whole && tail), lane, carry), 1);
      const int from_right = tail ? (lane < 31 ? right : entering) : big;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        if (c0 + j < g.W)
          d[c0 + j] = min(fw[j], j > brk ? min(v[j], from_right) : v[j]);
    }
  }
}

// A block's share of the column strips of a program: (frame, strip) items,
// block-uniform.  Warp k of the block takes rows [r0, r1) of the strip,
// lane l its column c.
struct ColumnWalk {
  int r0, r1, c, top;   // top: the pixel index of the frame's row 0 at c
  bool in;              // c < W
};

__device__ __forceinline__ ColumnWalk column_walk(const Who& w, const Planes& g,
                                                  int item) {
  const int strips = (g.W + 31) / 32;
  const int f = item / strips;
  const int R = (g.H + kLabelWarps - 1) / kLabelWarps;
  const int k = threadIdx.x >> 5;
  ColumnWalk cw;
  cw.r0 = min(g.H, k * R);
  cw.r1 = min(g.H, cw.r0 + R);
  cw.c = (item - f * strips) * 32 + w.lane;
  cw.in = cw.c < g.W;
  cw.top = f * g.H * g.W + cw.c;
  return cw;
}

// dst = run-min of src over vertical runs, a block per strip of 32 columns
// (see the header): down each chunk, the chunks' carries by a segmented
// scan over them, up each chunk.
__device__ __noinline__ void
vrun_pass(const Who w, const Planes g, const uint8_t* __restrict__ mask,
          const int* src, int* dst, int big) {
  ColumnScratch& sc = block_scratch().col;
  const int items = g.rows / g.H * ((g.W + 31) / 32);
  const int k = threadIdx.x >> 5, lane = w.lane;
  for (int item = w.rank; item < items; item += g.blocks) {
    const ColumnWalk cw = column_walk(w, g, item);
    const int* s = src + cw.top;
    const uint8_t* m = mask + cw.top;
    int* d = dst + cw.top;
    // down: the run-min from above within the chunk, into dst
    int run = big, first = big, head = 0, one_run = 1, brk = cw.r1;
    for (int rb = cw.r0; rb < cw.r1; rb += kRows) {
      int v[kRows];
      unsigned ups = 0;   // bit j: row rb + j links up
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (cw.in && rb + j < cw.r1) {
          v[j] = ld(s + (rb + j) * g.W);
          ups |= (unsigned)(m[(rb + j) * g.W] >> 1 & 1) << j;
        }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (cw.in && rb + j < cw.r1) {
          const int r = rb + j;
          const bool up = ups >> j & 1;
          if (r == cw.r0) {
            head = up;
          } else if (!up && one_run) {   // the chunk's first run ends
            one_run = 0;
            brk = r;
            first = run;
          }
          run = up && r > cw.r0 ? min(run, v[j]) : v[j];
          d[r * g.W] = run;
        }
    }
    if (one_run) first = run;
    sc.top[k][lane] = first;
    sc.bot[k][lane] = run;
    sc.flags[k][lane] = head | (one_run << 1);
    __syncthreads();
    // warp k scans columns k, k + kLabelWarps, ... of the strip over the
    // chunks, lane = chunk (lanes past the last chunk: empty chunks)
    for (int col = k; col < 32; col += kLabelWarps) {
      const bool chunk = lane < kLabelWarps;
      const int top = chunk ? sc.top[lane][col] : big;
      const int bot = chunk ? sc.bot[lane][col] : big;
      const int fl = chunk ? sc.flags[lane][col] : 2;
      const int hd = fl & 1, whole = fl >> 1;
      const int hn = __shfl_down_sync(kFull, hd, 1);
      const int next_head = lane < 31 ? hn : 0;
      int carry = big;
      // what leaves the chunk at its last row, going down
      const int down = chunk_scan<true>(bot, !(whole && hd), lane, carry);
      carry = big;
      // what leaves it at its first row, going up
      const int up = chunk_scan<false>(top, !(whole && next_head), lane, carry);
      const int above = __shfl_up_sync(kFull, down, 1);
      const int below = __shfl_down_sync(kFull, up, 1);
      if (chunk) {
        sc.from_above[lane][col] = lane > 0 && hd ? above : big;
        sc.from_below[lane][col] = lane < 31 && next_head ? below : big;
      }
    }
    __syncthreads();
    // up: the run-min from below, with what enters the chunk at both ends
    const int above = sc.from_above[k][lane];
    int run_up = sc.from_below[k][lane];
    for (int rb = cw.r1 - 1; rb >= cw.r0; rb -= kRows) {
      int v[kRows], fw[kRows];
      unsigned links = 0;   // bit j: row rb - j is linked to the row below
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (cw.in && rb - j >= cw.r0) {
          const int r = rb - j;
          v[j] = ld(s + r * g.W);
          fw[j] = d[r * g.W];     // what this thread wrote on its way down
          // linked to the pixel below iff that pixel links up; the chunk's
          // last row takes what enters from below (big if nothing links)
          links |= (r + 1 < cw.r1 ? (unsigned)(m[(r + 1) * g.W] >> 1 & 1)
                                  : 1u) << j;
        }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (cw.in && rb - j >= cw.r0) {
          const int r = rb - j;
          run_up = links >> j & 1 ? min(run_up, v[j]) : v[j];
          int out = min(run_up, fw[j]);
          if (r < brk) out = min(out, above);
          d[r * g.W] = out;
        }
    }
  }
}

// pyr, once: head[i] = (row of the vertical run's head in its frame) << 16
// | (column of the horizontal run's head).
__device__ __noinline__ void
hhead_pass(const Who w, const Planes g, const uint8_t* __restrict__ mask,
           int* head) {
  for (int row = w.warp; row < g.rows; row += g.warps) {
    const int base = row * g.W;
    int carry = 0;
    for (int c0 = 0; c0 < g.W; c0 += 32) {
      const int c = c0 + w.lane;
      const bool in = c < g.W;
      int x = (in && !(mask[base + c] & 1)) ? c : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (w.lane >= d) x = max(x, y);
      }
      x = max(x, carry);
      carry = __shfl_sync(kFull, x, 31);
      if (in) head[base + c] = x;
    }
  }
}

// The vertical heads, by the chunks of vrun_pass: a running max of the rows
// that start a run, the chunks above entering as their max.
__device__ __noinline__ void
vhead_pass(const Who w, const Planes g, const uint8_t* __restrict__ mask,
           int* head) {
  ColumnScratch& sc = block_scratch().col;
  const int items = g.rows / g.H * ((g.W + 31) / 32);
  const int k = threadIdx.x >> 5, lane = w.lane;
  for (int item = w.rank; item < items; item += g.blocks) {
    const ColumnWalk cw = column_walk(w, g, item);
    int last = 0;   // the chunk's last row that starts a run
    for (int r = cw.r0; cw.in && r < cw.r1; ++r)
      if (!(mask[cw.top + r * g.W] & 2)) last = r;
    sc.top[k][lane] = last;
    __syncthreads();
    int cur = 0;
    for (int j = 0; j < k; ++j) cur = max(cur, sc.top[j][lane]);
    for (int r = cw.r0; cw.in && r < cw.r1; ++r) {
      const int i = cw.top + r * g.W;
      if (!(mask[i] & 2)) cur = r;
      head[i] |= cur << 16;
    }
    __syncthreads();   // sc.top is the next item's
  }
}

// the slot of pixel i's run head: of its horizontal run, or its vertical
__device__ __forceinline__ int head_slot(const Planes& g, int i, int packed,
                                         bool vertical) {
  const int row = i / g.W;
  if (!vertical) return row * g.W + (packed & 0xffff);
  const int c = i - row * g.W;
  return (row - row % g.H + (packed >> 16)) * g.W + c;
}

// pyr: slot[head] = min over the run; the slots hold `big` on entry
__device__ __noinline__ void
scatter_pass(const Who w, const Planes g, const int* __restrict__ head,
             const int* src, int* slot, bool vertical) {
  FOR_PIXEL_BATCH(i0) {
    int v[kBatch], at[kBatch];
    FOR_BATCH_PIXEL(k, i, i0) {
      v[k] = ld(src + i);
      at[k] = head_slot(g, i, head[i], vertical);
    }
    FOR_BATCH_PIXEL(k, i, i0) atomicMin(slot + at[k], v[k]);
  }
}

// pyr: dst = the run's min; and the other slot plane back to `big`
__device__ __noinline__ void
gather_pass(const Who w, const Planes g, const int* __restrict__ head,
            const int* slot, int* dst, int* other, bool vertical, int big) {
  FOR_PIXEL_BATCH(i0) {
    int at[kBatch], v[kBatch];
    FOR_BATCH_PIXEL(k, i, i0) at[k] = head_slot(g, i, head[i], vertical);
    FOR_BATCH_PIXEL(k, i, i0) v[k] = ld(slot + at[k]);
    FOR_BATCH_PIXEL(k, i, i0) {
      dst[i] = v[k];
      other[i] = big;
    }
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` (0 or 1) of this thread's groups fly.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Start the copies of a tile into `c`: its cells (`big` beyond the frame),
// for the seg round the round's input at its own pixels, and its rows of
// the link mask, whole 4-byte words from the aligned-down address of the
// halo's first column (the byte of cell (hr, hc) is at hr * kMaskPitch +
// hc + the row's offset; `mask_off` below).  Bytes beyond the frame's
// columns belong to other rows and are masked when read.
template <bool CHEAP>
__device__ __forceinline__ void copy_tile(TileCopy& c, const Planes& g,
                                          const uint8_t* mask, const int* src,
                                          const int* before, int big,
                                          int tile, int tiles_c) {
  const int r0 = tile / tiles_c * kTileH - kHalo;
  const int c0 = tile % tiles_c * kTileW - kHalo;
  for (int x = threadIdx.x; x < kTileCells; x += kLabelThreads) {
    const int row = r0 + x / kTileCols, col = c0 + x % kTileCols;
    if (row >= 0 && row < g.rows && col >= 0 && col < g.W)
      cp_async4(&c.val[x], src + row * g.W + col);
    else
      c.val[x] = big;
  }
  if (!CHEAP && before != nullptr) {
    for (int x = threadIdx.x; x < kTilePixels; x += kLabelThreads) {
      const int row = r0 + kHalo + x / kTileW, col = c0 + kHalo + x % kTileW;
      if (row < g.rows && col < g.W)
        cp_async4(&c.before[x], before + row * g.W + col);
    }
  }
  constexpr int kWords = kMaskPitch / 4;
  for (int x = threadIdx.x; x < kTileRows * kWords; x += kLabelThreads) {
    const int hr = x / kWords, row = r0 + hr;
    if (row < 0 || row >= g.rows) continue;
    const uintptr_t first = (uintptr_t)(mask + row * g.W + c0) & ~(uintptr_t)3;
    cp_async4(&c.mask[hr * kMaskPitch + 4 * (x % kWords)],
              (const void*)(first + 4 * (x % kWords)));
  }
}

// The offset of a tile row's first mask byte in its copy.
__device__ __forceinline__ int mask_off(const uint8_t* mask, const Planes& g,
                                        int row, int c0) {
  return (int)((uintptr_t)(mask + row * g.W + c0) & 3);
}

// The steps of a round that look at neighbours only, fused into one: the
// cheap round's six (with CHEAP: the link-mins with the left, right and
// upper neighbour of the old plane, then with the lower neighbour of the
// new one, then the four diagonal link-mins, each on the plane the last one
// wrote), or the seg round's last four (the diagonals).  Each is still a
// whole-plane step: a block takes kTileH x kTileW tiles with a halo of
// kHalo pixels, and runs the steps one after the other in shared memory on
// all but the halo's outer ring; the steps reach at most 3 pixels, so the
// tile's own pixels come out as the whole-plane steps would leave them.
// With `before` (the round's input), returns whether any of this thread's
// pixels differs from it.
template <bool CHEAP>
__device__ __noinline__ int
tile_pass(const Who w, const Planes g, const uint8_t* __restrict__ mask,
          const int* src, int* dst, const int* before, int big) {
  TileScratch& t = block_scratch().tile;
  const int tiles_c = (g.W + kTileW - 1) / kTileW;
  const int tiles = (g.rows + kTileH - 1) / kTileH * tiles_c;
  int changed = 0;
  // which of this thread's cells a step computes: all but the outer ring
  bool inner[kCellsPerThread];
#pragma unroll
  for (int j = 0; j < kCellsPerThread; ++j) {
    const int x = threadIdx.x + j * kLabelThreads;
    const int hr = x / kTileCols, hc = x % kTileCols;
    inner[j] = x < kTileCells && hr > 0 && hr < kTileRows - 1 && hc > 0 &&
               hc < kTileCols - 1;
  }
  if (w.rank < tiles)
    copy_tile<CHEAP>(t.copy[0], g, mask, src, before, big, w.rank, tiles_c);
  cp_async_commit();
  int set = 0;
  for (int tile = w.rank; tile < tiles; tile += g.blocks) {   // block-uniform
    const int r0 = tile / tiles_c * kTileH, c0 = tile % tiles_c * kTileW;
    // the next tile's copies fly while this one's steps run
    const bool next = tile + g.blocks < tiles;
    if (next)
      copy_tile<CHEAP>(t.copy[set ^ 1], g, mask, src, before, big,
                       tile + g.blocks, tiles_c);
    cp_async_commit();
    cp_async_wait(1);
    __syncthreads();
    const TileCopy& c = t.copy[set];
    // this thread's cells: the value and the links in registers, bits 0-5
    // the mask's, 6 the right neighbour's link to it, 7 the lower one's (a
    // cell of the outer ring has none)
    int own[kCellsPerThread], links[kCellsPerThread];
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      const int x = threadIdx.x + j * kLabelThreads;
      own[j] = x < kTileCells ? c.val[x] : big;
      links[j] = 0;
      if (inner[j]) {
        const int hr = x / kTileCols, hc = x % kTileCols;
        const int row = r0 - kHalo + hr, col = c0 - kHalo + hc;
        const uint8_t* mrow =
            c.mask + hr * kMaskPitch + mask_off(mask, g, row, c0 - kHalo);
        const uint8_t* mdown = c.mask + (hr + 1) * kMaskPitch +
                               mask_off(mask, g, row + 1, c0 - kHalo);
        const bool in = row >= 0 && row < g.rows && col >= 0 && col < g.W;
        const bool right = row >= 0 && row < g.rows && col + 1 < g.W;
        const bool down = row + 1 < g.rows && col >= 0 && col < g.W;
        links[j] = (in ? mrow[hc] : 0) | (right ? mrow[hc + 1] & 1 : 0) << 6 |
                   (down ? mdown[hc] & 2 : 0) << 6;
      }
    }
    // the steps: `kind` 0 the left, right and upper links, 1 the lower,
    // 2-5 the diagonal of that mask bit; the first reads the copy, the
    // others the plane the last one wrote.  A ring cell has no links and
    // keeps its value.  Every cell's loads go before any of its mins.
    const int* sv = c.val;
    int cur = 0;
#pragma unroll
    for (int kind = CHEAP ? 0 : 2; kind < 6; ++kind) {
      int* dv = t.work[cur];
      int n[kCellsPerThread][3];
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        const int x = threadIdx.x + j * kLabelThreads;
        const int lk = links[j];
        if (kind == 0) {
          n[j][0] = lk & 1 ? sv[x - 1] : big;
          n[j][1] = lk & 64 ? sv[x + 1] : big;
          n[j][2] = lk & 2 ? sv[x - kTileCols] : big;
        } else if (kind == 1) {
          n[j][0] = lk & 128 ? sv[x + kTileCols] : big;
        } else {
          n[j][0] = lk & (1 << kind)
                        ? sv[x + kDr[kind] * kTileCols + kDc[kind]] : big;
        }
      }
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        const int x = threadIdx.x + j * kLabelThreads;
        own[j] = min(own[j], n[j][0]);
        if (kind == 0) own[j] = min(own[j], min(n[j][1], n[j][2]));
        if (x < kTileCells) dv[x] = own[j];
      }
      __syncthreads();
      sv = dv;
      cur ^= 1;
    }
#pragma unroll
    for (int j = 0; j < kPixelsPerThread; ++j) {
      const int x = threadIdx.x + j * kLabelThreads;
      const int row = r0 + x / kTileW, col = c0 + x % kTileW;
      if (row < g.rows && col < g.W) {
        const int cell = (x / kTileW + kHalo) * kTileCols + x % kTileW + kHalo;
        const int val = sv[cell];
        dst[row * g.W + col] = val;
        if (before != nullptr)
          changed |= val != (CHEAP ? c.val[cell] : c.before[x]);
      }
    }
    __syncthreads();   // this set and the planes are read: both may refill
    set ^= 1;
  }
  cp_async_wait(0);
  return changed;
}

// scratch: int32 (4, B, H, W): label planes 0-2, the link mask (bytes);
// pyr (7, B, H, W): + the run heads and two slot planes.  A cluster of any size the
// launch gives (labels_launch).
__global__ void __launch_bounds__(kLabelThreads)
labels_kernel(const float* __restrict__ disp, int* __restrict__ out,
              int* __restrict__ rounds, int* scratch, int B, int H, int W,
              int lo_bits, float diff, int mode) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int block_changed[2];
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int program = blockIdx.x / CS;
  const int frames = mode == kBlock4 ? kBlockFrames : 1;
  Planes g;
  g.H = H;
  g.W = W;
  g.rows = frames * H;
  g.npx = g.rows * W;
  g.blocks = CS;
  g.threads = CS * kLabelThreads;
  g.warps = CS * kLabelWarps;
  Who w;
  w.tid = rank * kLabelThreads + threadIdx.x;
  w.lane = threadIdx.x & 31;
  w.warp = (threadIdx.x >> 5) * CS + rank;
  w.rank = rank;
  const size_t plane = (size_t)B * H * W;
  const size_t first = (size_t)program * g.npx;
  disp += first;
  out += first;
  int* lab[3] = {scratch + first, scratch + plane + first,
                 scratch + 2 * plane + first};
  // the link mask, a byte a pixel, in the fourth plane
  uint8_t* mask = (uint8_t*)(scratch + 3 * plane) + first;
  int* head = scratch + 4 * plane + first;                 // pyr only
  int* slot[2] = {scratch + 5 * plane + first, scratch + 6 * plane + first};
  const int big = H << lo_bits;
  const bool paired = mode == kPair || mode == kFori16 || mode == kBlock4;
  const bool checked = mode != kFori16;

  init_pass(w, g, disp, mask, lab[0], lo_bits, diff);
  step_sync(cluster, g);
  if (mode == kPyr) {
    hhead_pass(w, g, mask, head);
    for (int i = w.tid; i < g.npx; i += g.threads)
      slot[0][i] = slot[1][i] = big;
    step_sync(cluster, g);
    vhead_pass(w, g, mask, head);
    step_sync(cluster, g);
  }

  int a = 0, b = 1, c = 2;      // lab[a]: the round's input; b, c: free
  int it = 0, changed = 0, flag = 0;
  for (;;) {
    for (int k = 0; k < (paired ? 2 : 1); ++k) {
      if (k > 0) step_sync(cluster, g);
      const bool seg = paired ? k == 0 : !(it & 1);
      const int* input = checked ? lab[a] : nullptr;
      if (!seg) {
        changed |= tile_pass<true>(w, g, mask, lab[a], lab[b], input, big);
      } else {
        if (mode == kPyr) {
          scatter_pass(w, g, head, lab[a], slot[0], false);
          step_sync(cluster, g);
          gather_pass(w, g, head, slot[0], lab[b], slot[1], false, big);
          step_sync(cluster, g);
          scatter_pass(w, g, head, lab[b], slot[1], true);
          step_sync(cluster, g);
          gather_pass(w, g, head, slot[1], lab[c], slot[0], true, big);
        } else {
          hrun_pass(w, g, mask, lab[a], lab[b], big);
          step_sync(cluster, g);
          vrun_pass(w, g, mask, lab[b], lab[c], big);
        }
        step_sync(cluster, g);
        changed |= tile_pass<false>(w, g, mask, lab[c], lab[b], input, big);
      }
      ++it;
      const int t = a;      // the result (in b) is the next round's input
      a = b;
      b = t;
    }
    if (!checked) {
      step_sync(cluster, g);
      if (it >= kFixedRounds) break;
      continue;
    }
    // the fixed-point test: this block's flag, then every block's through
    // distributed shared memory; the barrier is also the last step's
    const int any = __syncthreads_or(changed);
    changed = 0;
    if (threadIdx.x == 0) block_changed[flag] = any;
    step_sync(cluster, g);
    int total = 0;
    for (int peer = 0; peer < CS; ++peer)
      total |= *cluster.map_shared_rank(&block_changed[flag], peer);
    flag ^= 1;
    if (!total) break;
  }

  for (int i = w.tid; i < g.npx; i += g.threads) out[i] = ld(lab[a] + i);
  if (w.tid == 0) rounds[program] = it;
  step_sync(cluster, g);   // no block leaves while a peer may still read its flag
}

// What a launch asks the card once per device: its L2 size and, per
// cluster size, how many such clusters it holds at once (the answer depends
// on the card's layout, not the data); the kernel's attributes are set on
// the first ask.  Asking on every call cost a 37x45 frame more host time
// than its kernel takes.
constexpr int kDevices = 16;
struct CardFacts {
  int l2;
  int resident[kMaxLabelCluster + 1];
};

// The launch of `programs` clusters of `cs` blocks.
void labels_config(int programs, int cs, cudaLaunchAttribute* attr,
                   cudaLaunchConfig_t* config) {
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3((unsigned)(programs * cs));
  config->blockDim = dim3(kLabelThreads);
  config->dynamicSmemBytes = sizeof(BlockScratch);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
}

cudaError_t card_facts(const CardFacts** facts) {
  static CardFacts known[kDevices];
  static bool asked[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices) return cudaErrorInvalidDevice;
  CardFacts& f = known[device];
  *facts = &f;
  if (asked[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(labels_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(BlockScratch));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      labels_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&f.l2, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return err;
  for (int c = 1; c <= kMaxLabelCluster; ++c) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config;
    labels_config(1, c, attr, &config);
    err = cudaOccupancyMaxActiveClusters(&f.resident[c], labels_kernel,
                                         &config);
    if (err != cudaSuccess) return err;
  }
  asked[device] = true;
  return cudaSuccess;
}

// The cluster size of a launch, decided before it, among 1..16 blocks with
// at least kMinPixels pixels a thread: the fewest waves of programs, where a
// wave is as many programs as the card holds at once, but no more than
// keep their planes (`bytes` each) in three quarters of the L2 (a step
// reads and writes every pixel of a program, and planes that stay in the L2
// make it several times faster than planes in device memory); among those,
// the largest.  Sizes that are not powers of two count: an NVIDIA H100 80GB
// HBM3 holds seven clusters of 16 such blocks at once but eight of 9.
int labels_cluster(const CardFacts& card, int programs, long long pixels,
                   long long bytes) {
  const long long cap = std::max<long long>(1, 3LL * card.l2 / 4 / bytes);
  const long long widest = pixels / ((long long)kMinPixels * kLabelThreads);
  long long best = -1;
  int chosen = 1;
  for (int c = 1; c <= kMaxLabelCluster && (c == 1 || c <= widest); ++c) {
    const long long wave = std::min<long long>(card.resident[c], cap);
    if (wave < 1) continue;
    const long long waves = (programs + wave - 1) / wave;
    if (best < 0 || waves <= best) {
      best = waves;
      chosen = c;
    }
  }
  return chosen;
}

// --- S2-S4 ---------------------------------------------------------------------

// A block's table (S2, S4): open addressing with linear probing over 2^bits
// slots, a key -1 while its slot is empty.  The slot's count is zero
// before the key is set (the table is cleared before a barrier), so an add
// may follow either.  A block meets no more keys than it has slots (S2:
// kHistTile, half its slots): an insert always finds its key or an empty
// slot.  PEEK (S4): a slot is read before it is claimed, so that a key the
// table holds costs one atomic, not two.
template <bool PEEK>
__device__ __forceinline__ void table_add(int* keys, int* vals, int* order,
                                          int* used, int key, int n,
                                          int bits) {
  unsigned h = ((unsigned)key * 2654435761u) >> (32 - bits);
  for (;;) {
    int seen = PEEK ? *(volatile int*)(keys + h) : -1;
    if (seen == -1) seen = atomicCAS(keys + h, -1, key);
    if (seen == -1) order[atomicAdd(used, 1)] = (int)h;
    if (seen == -1 || seen == key) {
      atomicAdd(vals + h, n);
      return;
    }
    h = (h + 1) & ((1u << bits) - 1);
  }
}

// S2.  The frame is blockIdx.y; a block takes kHistTile labels, a thread
// four neighbouring ones (one 16-byte load where `wide`, the tail masked as
// S3 does).  AGG false: one device-memory add per pixel (the probe's
// control).  AGG true: equal neighbours of a thread merge into runs; the
// runs that start at the same position of a quad merge across the warp
// (__match_any_sync on the run's label, __reduce_add_sync on its
// length; a position no lane starts a run at is skipped); the warp's
// leaders add into the block's table in shared memory; then one
// device-memory add per distinct label of the block.  A label outside the
// root plane counts nowhere.  counts: int32 (B, size), zero on entry.
template <bool AGG>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const int* __restrict__ lab, int* counts, int per_frame, int size,
            int wide) {
  __shared__ int keys[AGG ? kHistSlots : 1];
  __shared__ int vals[AGG ? kHistSlots : 1];
  __shared__ int order[AGG ? kHistTile : 1];
  __shared__ int used;
  const int frame = blockIdx.y;
  lab += (size_t)frame * per_frame;
  counts += (size_t)frame * size;
  const int t = threadIdx.x;
  const int i = (blockIdx.x * kHistThreads + t) * kHistLabels;
  int key[kHistLabels];
  if (wide && i + kHistLabels <= per_frame) {
    const int4 v = *reinterpret_cast<const int4*>(lab + i);
    key[0] = v.x, key[1] = v.y, key[2] = v.z, key[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kHistLabels; ++j)
      key[j] = i + j < per_frame ? lab[i + j] : -1;
  }
#pragma unroll
  for (int j = 0; j < kHistLabels; ++j)
    if ((unsigned)key[j] >= (unsigned)size) key[j] = -1;
  if (!AGG) {
#pragma unroll
    for (int j = 0; j < kHistLabels; ++j)
      if (key[j] >= 0) atomicAdd(counts + key[j], 1);
    return;
  }

  for (int s = t; s < kHistSlots; s += kHistThreads) {
    keys[s] = -1;
    vals[s] = 0;
  }
  if (t == 0) used = 0;
  // runs: the length of the run that starts at j, for the j that start one
  int len[kHistLabels];
  len[kHistLabels - 1] = 1;
#pragma unroll
  for (int j = kHistLabels - 2; j >= 0; --j)
    len[j] = key[j] == key[j + 1] ? len[j + 1] + 1 : 1;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kHistLabels; ++j) {
    const bool head = key[j] >= 0 && (j == 0 || key[j] != key[j - 1]);
    if (!__any_sync(kFull, head)) continue;  // the same for the whole warp
    const int k = head ? key[j] : -1;
    const unsigned peers = __match_any_sync(kFull, k);
    const int total = __reduce_add_sync(peers, head ? len[j] : 0);
    if (head && (t & 31) == __ffs(peers) - 1)
      table_add<false>(keys, vals, order, &used, k, total, kHistSlotBits);
  }
  __syncthreads();
  for (int s = t; s < used; s += kHistThreads) {
    const int h = order[s];
    atomicAdd(counts + keys[h], vals[h]);
  }
}

// S3.  The frame is blockIdx.y (no division); a thread takes four
// neighbouring labels (one 16-byte load where `wide`: per_frame a multiple of
// 4 and both planes 16-byte aligned), issues its four byte gathers into the
// frame's root plane before it waits for any, and stores four verdicts (one
// 16-byte store).  The tail of a frame is masked.
__global__ void __launch_bounds__(kVerdictThreads)
verdict_kernel(const int* __restrict__ lab,
               const signed char* __restrict__ small, float* __restrict__ out,
               int per_frame, int size, int wide) {
  const int frame = blockIdx.y;
  lab += (size_t)frame * per_frame;
  out += (size_t)frame * per_frame;
  small += (size_t)frame * size;
  const int i = (blockIdx.x * kVerdictThreads + threadIdx.x) * kVerdictLabels;
  if (i >= per_frame) return;
  const bool whole = wide && i + kVerdictLabels <= per_frame;
  int l[kVerdictLabels];
  if (whole) {
    const int4 v = *reinterpret_cast<const int4*>(lab + i);
    l[0] = v.x, l[1] = v.y, l[2] = v.z, l[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVerdictLabels; ++j)
      l[j] = i + j < per_frame ? lab[i + j] : -1;
  }
  signed char hit[kVerdictLabels];
#pragma unroll
  for (int j = 0; j < kVerdictLabels; ++j)
    hit[j] = (unsigned)l[j] < (unsigned)size ? small[l[j]] : (signed char)0;
  float r[kVerdictLabels];
#pragma unroll
  for (int j = 0; j < kVerdictLabels; ++j) r[j] = hit[j] != 0 ? 1.0f : 0.0f;
  if (whole) {
    *reinterpret_cast<float4*>(out + i) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kVerdictLabels; ++j)
      if (i + j < per_frame) out[i + j] = r[j];
  }
}

// S4's share of a round: the frames [f0, f1) of the batch are the labels
// [start, end) of the flat array, in the quads [start / 4, ceil(end / 4));
// a block takes `share` of them, [q0, q1), its thread t the `held`
// neighbouring quads from q0 + held * t, at most 16 neighbouring labels.
// Every field but q0 and q1 is the same for every block.
struct TailRound {
  int start, end;   // labels of the round
  int q0, q1;       // this block's quads
  int held;         // quads a thread holds: <= kTailQuads (tail_plan)
};

constexpr int kTailLabels = 4 * kTailQuads;   // labels a thread holds

__device__ __forceinline__ TailRound tail_round(int f0, int f1,
                                                int per_frame) {
  TailRound r;
  r.start = f0 * per_frame;
  r.end = f1 * per_frame;
  const int q_lo = r.start >> 2, q_hi = (r.end + 3) >> 2;
  const int share = (q_hi - q_lo + (int)gridDim.x - 1) / (int)gridDim.x;
  r.q0 = min(q_hi, q_lo + (int)blockIdx.x * share);
  r.q1 = min(q_hi, r.q0 + share);
  r.held = (share + kTailThreads - 1) / kTailThreads;
  return r;
}

// The first label of a thread's quads.
__device__ __forceinline__ int tail_first(const TailRound& r) {
  return 4 * (r.q0 + r.held * (int)threadIdx.x);
}

// A thread's labels, label p of it at key[p / 4][p % 4]: its quads' loads
// go out, 16 bytes each where the quad lies in the round and `wide`; -1 for
// a label that is not the thread's.
__device__ __forceinline__ void tail_load(const int* __restrict__ lab,
                                          const TailRound& r, int wide,
                                          int (&key)[kTailQuads][4]) {
  const int i0 = tail_first(r);
#pragma unroll
  for (int k = 0; k < kTailQuads; ++k) {
    const int i = i0 + 4 * k;
    const bool mine = k < r.held && i < 4 * r.q1;
    if (mine && wide && i >= r.start && i + 4 <= r.end) {
      const int4 v = *reinterpret_cast<const int4*>(lab + i);
      key[k][0] = v.x, key[k][1] = v.y, key[k][2] = v.z, key[k][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        key[k][j] = mine && i + j >= r.start && i + j < r.end ? lab[i + j] : -1;
    }
  }
}

// The labels as count indices: f * size + label for a label inside its
// frame's root plane, -1 for any other (the sentinel, a label outside the
// plane, a label that is not the thread's).
__device__ __forceinline__ void tail_keys(const TailRound& r, int per_frame,
                                          int size,
                                          int (&key)[kTailQuads][4]) {
  const int i0 = tail_first(r);
  const int f = i0 / per_frame, rem = i0 - f * per_frame;
#pragma unroll
  for (int p = 0; p < kTailLabels; ++p) {
    int fp = f, rp = rem + p;   // the label's frame
    while (rp >= per_frame) {
      rp -= per_frame;
      ++fp;
    }
    int& k = key[p / 4][p % 4];
    k = (unsigned)k < (unsigned)size ? fp * size + k : -1;
  }
}

// Bit p: label p of a thread starts a run of equal keys (its first label
// and every label whose key differs from the one before).
__device__ __forceinline__ unsigned tail_runs(const int (&key)[kTailQuads][4]) {
  unsigned seg = 1;
#pragma unroll
  for (int p = 1; p < kTailLabels; ++p)
    seg |= (unsigned)(key[p / 4][p % 4] != key[(p - 1) / 4][(p - 1) % 4]) << p;
  return seg;
}

// A thread's runs of a key (not -1) added into the block's table, one
// insert a run.  No lane waits for another: merging the lanes' runs across
// the warp first (__match_any_sync and __reduce_add_sync, a round per run,
// as S2 merges) cost more than the inserts it saved (PERF.md, PR 10).
__device__ __forceinline__ void insert_runs(const int (&key)[kTailQuads][4],
                                            int* keys, int* vals, int* order,
                                            int* used, int bits) {
  const unsigned seg = tail_runs(key);
  unsigned heads = 0;
#pragma unroll
  for (int p = 0; p < kTailLabels; ++p)
    heads |= (unsigned)(seg >> p & 1 && key[p / 4][p % 4] >= 0) << p;
  while (heads) {
    const int p = __ffs(heads) - 1;
    heads &= heads - 1;
    int k = -1;
#pragma unroll
    for (int q = 0; q < kTailLabels; ++q)
      if (q == p) k = key[q / 4][q % 4];
    const unsigned after = seg >> p >> 1;   // the next run's start
    table_add<true>(keys, vals, order, used, k,
                    after ? __ffs(after) : kTailLabels - p, bits);
  }
}

// Before the first barrier: AGG, the block's table is cleared while the
// labels are in flight, its threads' runs are added into it, and 0 is
// stored at each key it claimed; else 0 at every label's key.
template <bool AGG>
__device__ __forceinline__ void tail_zero(int* counts, const TailRound& r,
                                          int per_frame, int size, int bits,
                                          int (&key)[kTailQuads][4],
                                          int* keys, int* vals, int* order,
                                          int* used) {
  if (!AGG) {
    tail_keys(r, per_frame, size, key);
#pragma unroll
    for (int k = 0; k < kTailQuads; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (key[k][j] >= 0) counts[key[k][j]] = 0;
    return;
  }
  for (int s = threadIdx.x; s < 1 << (bits - 2); s += kTailThreads) {
    reinterpret_cast<int4*>(keys)[s] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<int4*>(vals)[s] = make_int4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) *used = 0;
  tail_keys(r, per_frame, size, key);
  __syncthreads();
  insert_runs(key, keys, vals, order, used, bits);
  __syncthreads();
  for (int s = threadIdx.x; s < *used; s += kTailThreads)
    counts[keys[order[s]]] = 0;
}

// Between the barriers: AGG, one add per key of the block's table; else
// one per label.
template <bool AGG>
__device__ __forceinline__ void tail_add(int* counts,
                                         const int (&key)[kTailQuads][4],
                                         const int* keys, const int* vals,
                                         const int* order, const int* used) {
  if (!AGG) {
#pragma unroll
    for (int k = 0; k < kTailQuads; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (key[k][j] >= 0) atomicAdd(counts + key[k][j], 1);
    return;
  }
  for (int s = threadIdx.x; s < *used; s += kTailThreads) {
    const int h = order[s];
    atomicAdd(counts + keys[h], vals[h]);
  }
}

// After the second barrier: a count through the L2 for each run of a key
// (a run's labels share it), all of a thread's loads in flight together,
// its verdicts as bits of a mask.  The stores go out coalesced: the warp's
// threads hold its quads `held` by `held`, and in step k lane l stores the
// warp's quad 32 k + l, its four verdicts shuffled from the mask of the
// thread that holds it (one 16-byte store where the quad lies in the round
// and `wide`).
__device__ __forceinline__ void tail_verdict(const int* counts,
                                             float* __restrict__ out,
                                             const TailRound& r,
                                             const int (&key)[kTailQuads][4],
                                             int min_area, int wide) {
  const unsigned seg = tail_runs(key);
  int n[kTailLabels];
#pragma unroll
  for (int p = 0; p < kTailLabels; ++p) {
    const int k = key[p / 4][p % 4];
    n[p] = seg >> p & 1 && k >= 0 ? __ldcg(counts + k) : 0;
  }
  unsigned small = 0;
#pragma unroll
  for (int p = 0; p < kTailLabels; ++p) {
    if (p > 0 && !(seg >> p & 1)) n[p] = n[p - 1];
    small |= (unsigned)(n[p] > 0 && n[p] < min_area) << p;
  }
  const int lane = threadIdx.x & 31;
  const int warp_q = r.q0 + r.held * ((int)threadIdx.x - lane);
#pragma unroll
  for (int k = 0; k < kTailQuads; ++k) {
    if (k >= r.held) break;   // the same for the whole block
    const int c = 32 * k + lane;   // the warp's quad this lane stores
    const unsigned m = __shfl_sync(kFull, small, c / r.held);
    const int i = 4 * (warp_q + c);
    if (i >= 4 * r.q1) continue;
    const unsigned bits = m >> 4 * (c % r.held) & 15;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = bits >> j & 1 ? 1.0f : 0.0f;
    if (wide && i >= r.start && i + 4 <= r.end) {
      *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j >= r.start && i + j < r.end) out[i + j] = v[j];
    }
  }
}

// S4 (see the header).  A cooperative launch of tail_plan's blocks; rounds
// of `frames` whole frames; a block's table of 2^bits slots (tail_smem).
// Every block reaches every barrier: no thread leaves early, and the loop
// around the verdict's shuffles is the same for the whole block.  counts:
// int32 (B, size), anything on entry.
template <bool AGG>
__global__ void __launch_bounds__(kTailThreads, 1)
tail_kernel(const int* __restrict__ lab, int* counts, float* __restrict__ out,
            int B, int per_frame, int size, int min_area, int frames,
            int bits, int wide) {
  cg::grid_group grid = cg::this_grid();
  int* keys = reinterpret_cast<int*>(block_smem);   // AGG: tail_smem(bits)
  int* vals = keys + (1 << bits);
  int* order = vals + (1 << bits);
  __shared__ int used;
  for (int f0 = 0; f0 < B; f0 += frames) {
    const TailRound r = tail_round(f0, min(B, f0 + frames), per_frame);
    int key[kTailQuads][4];
    tail_load(lab, r, wide, key);
    tail_zero<AGG>(counts, r, per_frame, size, bits, key, keys, vals, order,
                   &used);
    grid.sync();   // every zero before any add
    tail_add<AGG>(counts, key, keys, vals, order, &used);
    grid.sync();   // every add before any verdict
    tail_verdict(counts, out, r, key, min_area, wide);
  }
}

// What an S4 launch asks the card once per device: how many blocks of each
// mode it holds at once (0 without cooperative launches); the kernel's
// shared memory is set on the first ask.
struct TailFacts {
  int resident[2];   // [aggregate]
};

cudaError_t tail_facts(const TailFacts** facts) {
  static TailFacts known[kDevices];
  static bool asked[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices) return cudaErrorInvalidDevice;
  TailFacts& f = known[device];
  *facts = &f;
  if (asked[device]) return cudaSuccess;
  int coop = 0, sms = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tail_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTailSmem);
  if (err != cudaSuccess) return err;
  int n[2];
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n[0], tail_kernel<false>,
                                                      kTailThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n[1], tail_kernel<true>,
                                                      kTailThreads, kTailSmem);
  if (err != cudaSuccess) return err;
  for (int m = 0; m < 2; ++m) f.resident[m] = coop ? n[m] * sms : 0;
  asked[device] = true;
  return cudaSuccess;
}

// A launch's grid and rounds: every block the card holds at once; as many
// whole frames a round as leave a block no more than kTailBlockLabels
// labels (with the two quads that may cross a round's ends); a table of
// twice as many slots as a block's labels where that fits, else one a
// label.  A card that holds no block, or a frame that one round cannot
// take, is refused.
struct TailPlan {
  int blocks, frames, rounds, bits;
};

// The shared memory of a table of 2^bits slots: keys, counts and the claim
// order (no more keys than slots).
int tail_smem(int bits) { return 3 * (1 << bits) * (int)sizeof(int); }

cudaError_t tail_plan(int resident, int B, int per_frame, TailPlan* p) {
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  p->blocks = resident;
  const long long cap = (long long)p->blocks * kTailBlockLabels - 8;
  p->frames = (int)std::min<long long>(B, cap / per_frame);
  if (p->frames < 1) return cudaErrorCooperativeLaunchTooLarge;
  p->rounds = (B + p->frames - 1) / p->frames;
  // the most quads a round can have, and a block's share of them
  const long long quads = ((long long)p->frames * per_frame + 6) / 4 + 1;
  const long long share = (quads + p->blocks - 1) / p->blocks;
  p->bits = 5;
  while ((1LL << p->bits) < 8 * share && p->bits < kTailSlotBits) ++p->bits;
  return cudaSuccess;
}

bool fits_int(long long n) { return n >= 0 && n <= 0x7fffffffLL; }

// S4's indices stay in int: a label's count index, and a quad's label index
// up to a block's labels past the batch's end.
bool tail_fits(int B, int per_frame, int size) {
  return fits_int((long long)B * per_frame + 2 * kTailBlockLabels) &&
         fits_int((long long)B * size);
}

}  // namespace

// disp: f32 (B, H, W); out: int32 (B, H, W) labels; rounds: int32 per
// program (B, or B / 4 in mode block4); scratch: int32 (4, B, H, W), in
// mode pyr (7, B, H, W).
extern "C" int sgm_probe_speckle_labels(const void* disp, void* out,
                                        void* rounds, void* scratch, int B,
                                        int H, int W, int lo_bits, float diff,
                                        int mode, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (mode < kBase || mode > kPyr || H >= (1 << 15) || W >= (1 << 15) ||
      W > (1 << lo_bits) || !fits_int(((long long)H + 1) << lo_bits) ||
      !fits_int((long long)B * H * W) ||
      (mode == kBlock4 && B % kBlockFrames != 0))
    return (int)cudaErrorInvalidValue;
  const int programs = mode == kBlock4 ? B / kBlockFrames : B;
  // a program's planes: three int32 label planes and the byte mask; pyr
  // also the heads and two slot planes
  const long long pixels = (long long)B * H * W / programs;
  const CardFacts* card = nullptr;
  const cudaError_t err = card_facts(&card);
  if (err != cudaSuccess) return (int)err;
  const int cs = labels_cluster(*card, programs, pixels,
                                pixels * (mode == kPyr ? 25 : 13));
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
  labels_config(programs, cs, attr, &config);
  config.stream = (cudaStream_t)stream;
  return (int)cudaLaunchKernelEx(&config, labels_kernel, (const float*)disp,
                                 (int*)out, (int*)rounds, (int*)scratch, B, H,
                                 W, lo_bits, diff, mode);
}

// lab: int32 (B, per_frame); counts: int32 (B, size) out.  Two launches:
// the zeroing of the counts and the count.
extern "C" int sgm_probe_speckle_hist(const void* lab, void* counts, int B,
                                      int per_frame, int size, int aggregate,
                                      void* stream) {
  if (B > 65535 || !fits_int((long long)per_frame + kHistTile) ||
      !fits_int((long long)B * size))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)B * size, s);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || per_frame == 0) return 0;
  const int wide = per_frame % kHistLabels == 0 && ((uintptr_t)lab & 15) == 0;
  const dim3 grid((per_frame + kHistTile - 1) / kHistTile, B);
  if (aggregate)
    hist_kernel<true><<<grid, kHistThreads, 0, s>>>(
        (const int*)lab, (int*)counts, per_frame, size, wide);
  else
    hist_kernel<false><<<grid, kHistThreads, 0, s>>>(
        (const int*)lab, (int*)counts, per_frame, size, wide);
  return (int)cudaGetLastError();
}

// lab: int32 (B, per_frame); small: int8 (B, size); out: f32 (B, per_frame).
extern "C" int sgm_probe_speckle_verdict(const void* lab, const void* small,
                                         void* out, int B, int per_frame,
                                         int size, void* stream) {
  if (B == 0 || per_frame == 0) return 0;
  constexpr int kPerBlock = kVerdictThreads * kVerdictLabels;
  if (B > 65535 || !fits_int((long long)per_frame + kPerBlock))
    return (int)cudaErrorInvalidValue;
  const int wide = per_frame % kVerdictLabels == 0 &&
                   (((uintptr_t)lab | (uintptr_t)out) & 15) == 0;
  verdict_kernel<<<dim3((per_frame + kPerBlock - 1) / kPerBlock, B),
                   kVerdictThreads, 0, (cudaStream_t)stream>>>(
      (const int*)lab, (const signed char*)small, (float*)out, per_frame, size,
      wide);
  return (int)cudaGetLastError();
}

// lab: int32 (B, per_frame); counts: int32 (B, size) scratch, anything on
// entry; out: f32 (B, per_frame).  One cooperative launch, no memset.
extern "C" int sgm_probe_speckle_fused(const void* lab, void* counts,
                                       void* out, int B, int per_frame,
                                       int size, int min_area, int aggregate,
                                       void* stream) {
  if (B == 0 || per_frame == 0) return 0;
  if (B < 0 || per_frame < 0 || size < 0 || !tail_fits(B, per_frame, size))
    return (int)cudaErrorInvalidValue;
  const TailFacts* card = nullptr;
  cudaError_t err = tail_facts(&card);
  if (err != cudaSuccess) return (int)err;
  TailPlan plan;
  err = tail_plan(card->resident[aggregate ? 1 : 0], B, per_frame, &plan);
  if (err != cudaSuccess) return (int)err;
  const int wide = (((uintptr_t)lab | (uintptr_t)out) & 15) == 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)plan.blocks);
  config.blockDim = dim3(kTailThreads);
  config.dynamicSmemBytes = aggregate ? tail_smem(plan.bits) : 0;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const int* l = (const int*)lab;
  if (aggregate)
    return (int)cudaLaunchKernelEx(&config, tail_kernel<true>, l, (int*)counts,
                                   (float*)out, B, per_frame, size, min_area,
                                   plan.frames, plan.bits, wide);
  return (int)cudaLaunchKernelEx(&config, tail_kernel<false>, l, (int*)counts,
                                 (float*)out, B, per_frame, size, min_area,
                                 plan.frames, plan.bits, wide);
}

// S4's plan for a batch: int32[5] out = {blocks, frames a round, rounds,
// table slot bits, blocks the card holds at once}; the first four 0 for an
// empty batch.
extern "C" int sgm_probe_speckle_fused_plan(int B, int per_frame,
                                            int aggregate, void* plan) {
  int* p = (int*)plan;
  const TailFacts* card = nullptr;
  cudaError_t err = tail_facts(&card);
  if (err != cudaSuccess) return (int)err;
  p[0] = p[1] = p[2] = p[3] = 0;
  p[4] = card->resident[aggregate ? 1 : 0];
  if (B < 0 || per_frame < 0 || !tail_fits(B, per_frame, 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || per_frame == 0) return 0;
  TailPlan tp;
  err = tail_plan(p[4], B, per_frame, &tp);
  if (err != cudaSuccess) return (int)err;
  p[0] = tp.blocks;
  p[1] = tp.frames;
  p[2] = tp.rounds;
  p[3] = tp.bits;
  return 0;
}
