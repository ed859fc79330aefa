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
//   (6 to 8 a round) times a barrier's latency plus one trip to the L2.
//   Design: a frame's planes (3 label planes that rotate, the link mask)
//   do not fit one SM's shared memory, so they live in global memory (the
//   L2 holds them) and one thread-block cluster of 8 blocks owns a frame
//   (block4: four frames); cluster.sync() is the barrier between steps, and
//   the convergence flag is reduced through distributed shared memory.  No
//   host read per round.  A horizontal run-min is a warp per row: a
//   segmented min-scan with shuffles from the left, one from the right.  A
//   vertical run-min is a thread per column walking down, then up.  pyr
//   finds every pixel's run heads once before the loop; its run-min is then
//   an atomicMin into the head's slot of a scratch plane and a load back.
//
// S2 speckle_hist, S3 speckle_verdict, S4 speckle_tail_fused: the TPU builds
// one-hot matrices and contracts them on the MXU because a scatter-add is
// near-serial there, and bands the root plane to cut the products.  Here a
// count is an atomicAdd at the label's own address and a verdict a load
// from it, so neither the products nor the band are carried over.
//   What bounds them: bytes (4 per pixel in, 4 out) and, for S2, atomics on
//   one word per large component; `aggregate` lets a warp add once per
//   distinct label (__match_any_sync).  S4 needs every count of a frame
//   before any verdict: a cluster per frame, cluster.sync() between.  S3 at
//   the probe's shape moves 11 MB and a launch's latency bounds it; its
//   design keeps the instruction count down: the frame is a grid axis, a
//   thread loads four labels in 16 bytes, has its four gathers in flight
//   together and stores 16 bytes.

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;
constexpr int kThreads = 1024;            // of a cluster's block
constexpr int kWarps = kThreads / 32;
constexpr int kClusterThreads = kClusterBlocks * kThreads;
constexpr int kClusterWarps = kClusterBlocks * kWarps;
constexpr int kFlatThreads = 256;         // of S2
constexpr int kVerdictThreads = 256;      // of S3
constexpr int kVerdictLabels = 4;         // labels a thread of S3 takes
constexpr int kFixedRounds = 16;          // of fori16
constexpr int kBlockFrames = 4;           // of block4
constexpr int kBatch = 4;                 // pixels a thread has in flight
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
};

// One program's planes: F frames side by side, npx = F * H * W pixels.
struct Planes {
  int npx, rows, H, W;
};

__device__ __forceinline__ int ld(const int* p) { return __ldcg(p); }

// The elementwise steps take kBatch pixels a thread at a time: first every
// pixel's own loads, then every neighbour's, so that a thread waits for the
// L2 twice per batch and not twice per pixel.
#define FOR_PIXEL_BATCH(i0) \
  for (int i0 = w.tid; i0 < g.npx; i0 += kBatch * kClusterThreads)
#define FOR_BATCH_PIXEL(k, i, i0)                                           \
  _Pragma("unroll") for (int k = 0, i = i0; k < kBatch;                     \
                         ++k, i += kClusterThreads) if (i < g.npx)

// mask and initial labels of every pixel
__device__ void init_pass(const Who& w, const Planes& g,
                          const float* __restrict__ disp, int* mask, int* lab,
                          int lo_bits, float diff) {
  for (int i = w.tid; i < g.npx; i += kClusterThreads) {
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

// One 32-pixel chunk's segmented min-scan over the lanes, towards higher
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

// dst = run-min of src over horizontal runs.  A warp per row: a segmented
// min-scan from the left writes dst, one from the right folds into it (each
// lane reads back what it wrote itself).  kChunks chunks' loads go first.
__device__ void hrun_pass(const Who& w, const Planes& g,
                          const int* __restrict__ mask, const int* src,
                          int* dst, int big) {
  constexpr int kChunks = 4;
  const int lane = w.lane;
  for (int row = w.warp; row < g.rows; row += kClusterWarps) {
    const int base = row * g.W;
    int carry = big;
    for (int c0 = 0; c0 < g.W; c0 += 32 * kChunks) {
      int v[kChunks], f[kChunks];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = c0 + 32 * k + lane;
        v[k] = c < g.W ? ld(src + base + c) : big;
        // a pixel without a link to its left starts a run (column 0 has none)
        f[k] = c < g.W ? !(mask[base + c] & 1) : 1;
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = c0 + 32 * k + lane;
        const int m = chunk_scan<true>(v[k], f[k], lane, carry);
        if (c < g.W) dst[base + c] = m;
      }
    }
    carry = big;
    for (int c0 = ((g.W - 1) / 32) * 32; c0 >= 0; c0 -= 32 * kChunks) {
      int v[kChunks], f[kChunks], left[kChunks];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = c0 - 32 * k + lane;
        const bool in = c >= 0 && c < g.W;
        v[k] = in ? ld(src + base + c) : big;
        left[k] = in ? dst[base + c] : big;
        // a pixel whose right neighbour has no link to it ends a run
        f[k] = (!in || c == g.W - 1) ? 1 : !(mask[base + c + 1] & 1);
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = c0 - 32 * k + lane;
        const int m = chunk_scan<false>(v[k], f[k], lane, carry);
        if (c >= 0 && c < g.W) dst[base + c] = min(m, left[k]);
      }
    }
  }
}

// dst = run-min of src over vertical runs.  A thread per column (a warp per
// strip of 32 columns of one frame): down, then up.
__device__ void vrun_pass(const Who& w, const Planes& g,
                          const int* __restrict__ mask, const int* src,
                          int* dst, int big) {
  const int strips = (g.W + 31) / 32;
  const int frames = g.rows / g.H;
  for (int s = w.warp; s < frames * strips; s += kClusterWarps) {
    const int f = s / strips;
    const int c = (s - f * strips) * 32 + w.lane;
    if (c >= g.W) continue;
    const int top = f * g.H * g.W + c;
    // kRows rows at a time: their loads first, then the chain, then stores
    constexpr int kRows = 8;
    int run = big;
    for (int r0 = 0; r0 < g.H; r0 += kRows) {
      int v[kRows], m[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < g.H) {
          v[k] = ld(src + top + (r0 + k) * g.W);
          m[k] = mask[top + (r0 + k) * g.W];
        }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < g.H) {
          run = (m[k] & 2) ? min(run, v[k]) : v[k];
          dst[top + (r0 + k) * g.W] = run;
        }
    }
    run = big;
    for (int r0 = g.H - 1; r0 >= 0; r0 -= kRows) {
      int v[kRows], m[kRows], down[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 - k >= 0) {
          const int i = top + (r0 - k) * g.W;
          v[k] = ld(src + i);
          down[k] = dst[i];       // what this thread wrote on its way down
          // linked to the pixel below iff that pixel links up (row H-1: none)
          m[k] = r0 - k < g.H - 1 ? mask[i + g.W] : 0;
        }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 - k >= 0) {
          run = (m[k] & 2) ? min(run, v[k]) : v[k];
          dst[top + (r0 - k) * g.W] = min(run, down[k]);
        }
    }
  }
}

// pyr, once: head[i] = (row of the vertical run's head in its frame) << 16
// | (column of the horizontal run's head).
__device__ void hhead_pass(const Who& w, const Planes& g,
                           const int* __restrict__ mask, int* head) {
  for (int row = w.warp; row < g.rows; row += kClusterWarps) {
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

__device__ void vhead_pass(const Who& w, const Planes& g,
                           const int* __restrict__ mask, int* head) {
  const int strips = (g.W + 31) / 32;
  const int frames = g.rows / g.H;
  for (int s = w.warp; s < frames * strips; s += kClusterWarps) {
    const int f = s / strips;
    const int c = (s - f * strips) * 32 + w.lane;
    if (c >= g.W) continue;
    const int top = f * g.H * g.W + c;
    int cur = 0;
    for (int r = 0; r < g.H; ++r) {
      const int i = top + r * g.W;
      if (!(mask[i] & 2)) cur = r;
      head[i] |= cur << 16;
    }
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
__device__ void scatter_pass(const Who& w, const Planes& g,
                             const int* __restrict__ head, const int* src,
                             int* slot, bool vertical) {
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
__device__ void gather_pass(const Who& w, const Planes& g,
                            const int* __restrict__ head, const int* slot,
                            int* dst, int* other, bool vertical, int big) {
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

// the link-mins with the left, right and upper neighbour
__device__ void cheap_a_pass(const Who& w, const Planes& g,
                             const int* __restrict__ mask, const int* src,
                             int* dst) {
  FOR_PIXEL_BATCH(i0) {
    int v[kBatch], m[kBatch];
    FOR_BATCH_PIXEL(k, i, i0) {
      v[k] = ld(src + i);
      // bit 2 here: the right neighbour links back (a row's first pixel
      // never links left)
      m[k] = (mask[i] & 3) | ((i + 1 < g.npx && (mask[i + 1] & 1)) ? 4 : 0);
    }
    FOR_BATCH_PIXEL(k, i, i0) {
      const int left = (m[k] & 1) ? ld(src + i - 1) : v[k];
      const int right = (m[k] & 4) ? ld(src + i + 1) : v[k];
      const int up = (m[k] & 2) ? ld(src + i - g.W) : v[k];
      v[k] = min(min(v[k], left), min(right, up));
    }
    FOR_BATCH_PIXEL(k, i, i0) dst[i] = v[k];
  }
}

// the link-min with the lower neighbour (a frame's first row never links up)
__device__ void cheap_b_pass(const Who& w, const Planes& g,
                             const int* __restrict__ mask, const int* src,
                             int* dst) {
  FOR_PIXEL_BATCH(i0) {
    int v[kBatch], down[kBatch];
    FOR_BATCH_PIXEL(k, i, i0) {
      v[k] = ld(src + i);
      down[k] = i + g.W < g.npx && (mask[i + g.W] & 2);
    }
    FOR_BATCH_PIXEL(k, i, i0)
      if (down[k]) v[k] = min(v[k], ld(src + i + g.W));
    FOR_BATCH_PIXEL(k, i, i0) dst[i] = v[k];
  }
}

// one diagonal link-min; with `before`, returns whether any of this
// thread's pixels differs from it (the round's input plane)
__device__ int diag_pass(const Who& w, const Planes& g,
                         const int* __restrict__ mask, const int* src,
                         int* dst, int bit, const int* before) {
  const int off = kDr[bit] * g.W + kDc[bit];
  int changed = 0;
  FOR_PIXEL_BATCH(i0) {
    int v[kBatch], was[kBatch], link[kBatch];
    FOR_BATCH_PIXEL(k, i, i0) {
      v[k] = ld(src + i);
      link[k] = mask[i] & (1 << bit);
      if (before != nullptr) was[k] = ld(before + i);
    }
    FOR_BATCH_PIXEL(k, i, i0)
      if (link[k]) v[k] = min(v[k], ld(src + i + off));
    FOR_BATCH_PIXEL(k, i, i0) {
      dst[i] = v[k];
      if (before != nullptr) changed |= v[k] != was[k];
    }
  }
  return changed;
}

// scratch: int32 (4 or 7, B, H, W): label planes 0-2, the mask; pyr: the
// run heads and two slot planes.
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
__launch_bounds__(kThreads)
labels_kernel(const float* __restrict__ disp, int* __restrict__ out,
              int* __restrict__ rounds, int* scratch, int B, int H, int W,
              int lo_bits, float diff, int mode) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int block_changed[2];
  const int rank = (int)cluster.block_rank();
  const int program = blockIdx.x / kClusterBlocks;
  const int frames = mode == kBlock4 ? kBlockFrames : 1;
  Who w;
  w.tid = rank * kThreads + threadIdx.x;
  w.lane = threadIdx.x & 31;
  w.warp = (threadIdx.x >> 5) * kClusterBlocks + rank;
  Planes g;
  g.H = H;
  g.W = W;
  g.rows = frames * H;
  g.npx = g.rows * W;
  const size_t plane = (size_t)B * H * W;
  const size_t first = (size_t)program * g.npx;
  disp += first;
  out += first;
  int* lab[3] = {scratch + first, scratch + plane + first,
                 scratch + 2 * plane + first};
  int* mask = scratch + 3 * plane + first;
  int* head = scratch + 4 * plane + first;                 // pyr only
  int* slot[2] = {scratch + 5 * plane + first, scratch + 6 * plane + first};
  const int big = H << lo_bits;
  const bool paired = mode == kPair || mode == kFori16 || mode == kBlock4;
  const bool checked = mode != kFori16;

  init_pass(w, g, disp, mask, lab[0], lo_bits, diff);
  cluster.sync();
  if (mode == kPyr) {
    hhead_pass(w, g, mask, head);
    for (int i = w.tid; i < g.npx; i += kClusterThreads)
      slot[0][i] = slot[1][i] = big;
    cluster.sync();
    vhead_pass(w, g, mask, head);
    cluster.sync();
  }

  int a = 0, b = 1, c = 2;      // lab[a]: the round's input; b, c: free
  int it = 0, changed = 0, flag = 0;
  for (;;) {
    for (int k = 0; k < (paired ? 2 : 1); ++k) {
      if (k > 0) cluster.sync();
      const bool seg = paired ? k == 0 : !(it & 1);
      if (!seg) {
        cheap_a_pass(w, g, mask, lab[a], lab[b]);
        cluster.sync();
        cheap_b_pass(w, g, mask, lab[b], lab[c]);
      } else if (mode == kPyr) {
        scatter_pass(w, g, head, lab[a], slot[0], false);
        cluster.sync();
        gather_pass(w, g, head, slot[0], lab[b], slot[1], false, big);
        cluster.sync();
        scatter_pass(w, g, head, lab[b], slot[1], true);
        cluster.sync();
        gather_pass(w, g, head, slot[1], lab[c], slot[0], true, big);
      } else {
        hrun_pass(w, g, mask, lab[a], lab[b], big);
        cluster.sync();
        vrun_pass(w, g, mask, lab[b], lab[c], big);
      }
      cluster.sync();
      diag_pass(w, g, mask, lab[c], lab[b], 2, nullptr);
      cluster.sync();
      diag_pass(w, g, mask, lab[b], lab[c], 3, nullptr);
      cluster.sync();
      diag_pass(w, g, mask, lab[c], lab[b], 4, nullptr);
      cluster.sync();
      changed |= diag_pass(w, g, mask, lab[b], lab[c], 5,
                           checked ? lab[a] : nullptr);
      ++it;
      const int t = a;      // the result becomes the next round's input
      a = c;
      c = b;
      b = t;
    }
    if (!checked) {
      cluster.sync();
      if (it >= kFixedRounds) break;
      continue;
    }
    // the fixed-point test: this block's flag, then every block's through
    // distributed shared memory; the barrier is also the last step's
    const int any = __syncthreads_or(changed);
    changed = 0;
    if (threadIdx.x == 0) block_changed[flag] = any;
    cluster.sync();
    int total = 0;
    for (int peer = 0; peer < kClusterBlocks; ++peer)
      total |= *cluster.map_shared_rank(&block_changed[flag], peer);
    flag ^= 1;
    if (!total) break;
  }

  for (int i = w.tid; i < g.npx; i += kClusterThreads) out[i] = ld(lab[a] + i);
  if (w.tid == 0) rounds[program] = it;
  cluster.sync();   // no block leaves while a peer may still read its flag
}

// --- S2-S4 ---------------------------------------------------------------------

// One pixel's count: at counts[key], or once per distinct key of the warp.
// Every lane of the warp must call it.
__device__ __forceinline__ void add_count(int* counts, bool valid, int key,
                                          int aggregate) {
  if (!aggregate) {
    if (valid) atomicAdd(counts + key, 1);
    return;
  }
  const unsigned peers = __match_any_sync(kFull, valid ? key : -1);
  if (valid && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(counts + key, __popc(peers));
}

// lab: int32 (B, per_frame); counts: int32 (B, size), zero on entry.
__global__ void hist_kernel(const int* __restrict__ lab, int* counts,
                            int total, int per_frame, int size,
                            int aggregate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < total;
  const int l = in ? lab[i] : -1;
  const bool valid = in && (unsigned)l < (unsigned)size;
  add_count(counts, valid, valid ? (i / per_frame) * size + l : 0, aggregate);
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

// A cluster per frame: zero the counts, count, then read the verdicts.
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
__launch_bounds__(kThreads)
fused_kernel(const int* __restrict__ lab, int* counts,
             float* __restrict__ out, int per_frame, int size, int min_area,
             int aggregate) {
  cg::cluster_group cluster = cg::this_cluster();
  const int frame = blockIdx.x / kClusterBlocks;
  const int tid = (int)cluster.block_rank() * kThreads + threadIdx.x;
  lab += (size_t)frame * per_frame;
  out += (size_t)frame * per_frame;
  counts += (size_t)frame * size;
  for (int i = tid; i < size; i += kClusterThreads) counts[i] = 0;
  cluster.sync();
  // whole warps go round together: add_count needs every lane
  const int padded = (per_frame + 31) / 32 * 32;
  for (int i = tid; i < padded; i += kClusterThreads) {
    const int l = i < per_frame ? lab[i] : -1;
    const bool valid = (unsigned)l < (unsigned)size;
    add_count(counts, valid, valid ? l : 0, aggregate);
  }
  cluster.sync();
  for (int i = tid; i < per_frame; i += kClusterThreads) {
    const int l = lab[i];
    const int n = (unsigned)l < (unsigned)size ? __ldcg(counts + l) : 0;
    out[i] = (n > 0 && n < min_area) ? 1.0f : 0.0f;
  }
}

bool fits_int(long long n) { return n >= 0 && n <= 0x7fffffffLL; }

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
  labels_kernel<<<programs * kClusterBlocks, kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const float*)disp, (int*)out, (int*)rounds, (int*)scratch, B, H, W,
      lo_bits, diff, mode);
  return (int)cudaGetLastError();
}

// lab: int32 (B, per_frame); counts: int32 (B, size) out.
extern "C" int sgm_probe_speckle_hist(const void* lab, void* counts, int B,
                                      int per_frame, int size, int aggregate,
                                      void* stream) {
  if (!fits_int((long long)B * per_frame + kFlatThreads) ||
      !fits_int((long long)B * size))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)B * size, s);
  if (err != cudaSuccess) return (int)err;
  const int total = B * per_frame;
  if (total == 0) return 0;
  hist_kernel<<<(total + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0,
                s>>>((const int*)lab, (int*)counts, total, per_frame, size,
                     aggregate);
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

// lab: int32 (B, per_frame); counts: int32 (B, size) scratch; out: f32
// (B, per_frame).
extern "C" int sgm_probe_speckle_fused(const void* lab, void* counts,
                                       void* out, int B, int per_frame,
                                       int size, int min_area, int aggregate,
                                       void* stream) {
  if (B == 0 || per_frame == 0) return 0;
  if (!fits_int((long long)per_frame + 32) ||
      !fits_int((long long)B * kClusterBlocks))
    return (int)cudaErrorInvalidValue;
  fused_kernel<<<B * kClusterBlocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)lab, (int*)counts, (float*)out, per_frame, size, min_area,
      aggregate);
  return (int)cudaGetLastError();
}
