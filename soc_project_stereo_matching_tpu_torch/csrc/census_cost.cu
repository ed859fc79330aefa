// K1: fused 5x5 census of both images + Hamming cost volume.
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   census_cost_volume_pallas / _census_cost_kernel, both modes: untiled,
//   and the tiled path's img_has_halo mode (mask_rows=False).
//
// What bounds it on the H100: bytes.  Per pixel it reads 2 image bytes and
// writes D cost bytes, so the uint8 volume store (B*H*D*W bytes) is the
// traffic: 345.6 MB at cone B=32, 0.103 ms at 3.35 TB/s.  Next comes the
// shared-memory pipe: a cost byte is two shared loads (the codes at w and
// w - d), one shared byte store into a staging ring and a sixteenth of a
// 16-byte load back, some 0.14 ms at cone B=32.
//
// Design: one block of kThreads per output row (b, h).
//   1. The image slab of that row, 5 x W bytes of both images, is staged in
//      shared memory (zeros beyond the image).
//   2. The row's census codes of both images are computed from the slab
//      into shared memory; no census plane reaches device memory.  The
//      right-image code row carries margins, so that w - d may leave the
//      image without a bounds check on the load.
//   3. The row's output, D "k-rows" of W bytes, is one contiguous range, cut
//      into kWarps runs of whole k-rows, one run a warp; no block barrier
//      follows the codes.  A warp writes a k-row's bytes into its own
//      staging row in shared memory, lane w on byte w (two shared loads, a
//      xor, a popcount and a byte store: the bytes whose w - d leaves the
//      image are set to 127 afterwards, in a short loop of their own).  The
//      staging row's position p stands for the output address base + p with
//      base on a 16-byte boundary, so after each k-row the warp copies the
//      whole 16-byte chunks out, one shared uint4 load and one uint4 store a
//      lane, 512 contiguous bytes a warp, and moves the few bytes after the
//      last whole chunk to the front for the next k-row.  Only a run's first
//      and last partial chunks are stored byte by byte: their other bytes
//      belong to the neighbouring run or row.
//
// Why the staging rows: a thread that stores its 16 bytes straight from
// registers either has chunks that cross a k-row (and then a per-byte
// path that nearly every warp takes) or has its warp's store spread over
// 16 k-rows, 16 lines of 128 bytes; both ran slower on the H100 than
// staging does.
//
// Rows in segments.  A row whose state does not fit one block (smem_bytes
// over the card's opt-in limit: past 8,924 columns at D = 64 on an H100)
// runs in segments of at most `seg` columns, a block each
// (census_segment_kernel).  A segment's block stages only what its columns
// read: the left image's slab over its columns and the census window's 2
// columns on each side, and the right image's slab over the seg + D - 1
// columns that w - d reaches from them (columns x0 - dmin - D + 1 ..
// x0 + seg - dmin - 1, wherever dmin puts them) and 2 on each side; the
// codes of both come from these slabs, zero outside the image's 2-px
// border, as the whole row's.  Its output is D runs of its columns, one a
// k-row, each staged in the warp's row at the run's own 16-byte phase and
// stored in whole 16-byte chunks, the partial chunks at the run's two ends
// byte by byte (their other bytes belong to the next segment or k-row).
// About 26 seg + 9 D bytes a block, so D = 16,384 still leaves segments of
// 3,262 columns: no (W, D) the JAX package takes needs D split too.  Where
// one block holds the row, the launch is the one above.
//
// It stays at about a third of its byte bound at cone B=32: the census
// window, the popcounts and the frame of the design (the slab's loads, two
// block barriers, the staging and the copy out) each cost more than its
// 16-byte stores; `python -m soc_project_stereo_matching_tpu_torch.kernel_ab`
// times this kernel with each of them taken out.

// Semantics: strict `<`, 25 bits MSB-first in window order, a 2-px zero
// border; cost = popcount(cl[w] ^ cr[w - d]) for d = dmin + k, 127 where
// w - d leaves the image.
//
// Halo mode (an H-tile of the spatially tiled path): the images have H+4
// rows, 2 halo rows from each neighbour tile above and below the H rows
// of the output, so every output row has its full 5x5 window and only the
// 2-px column border is zeroed.  The caller fixes the image's global
// border rows afterwards.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBorderCost = 127;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {
  int margin, right_pitch;  // of the right-image code row
  int stage;                // bytes of a warp's staging row: W + 15, to 16
};

__host__ __device__ inline Layout layout_of(int W, int dmin, int D) {
  // w - d ranges over [-(dmin + D - 1), W - 1 - dmin]
  const int left = dmin + D - 1 > 0 ? dmin + D - 1 : 0;
  const int right = dmin < 0 ? -dmin : 0;
  return {left, left + W + right, (W + 15 + 15) / 16 * 16};
}

// [kWarps staging rows][left codes W][right codes right_pitch][slab 2x5xW]
__host__ inline size_t smem_bytes(int W, int dmin, int D) {
  const Layout lay = layout_of(W, dmin, D);
  return (size_t)kWarps * lay.stage +
         sizeof(int) * ((size_t)W + lay.right_pitch) + 10 * (size_t)W;
}

// Census code at column w of the slab's centre row; zero on the border.
__device__ __forceinline__ int census_at(const uint8_t* slab, int W, int w,
                                         bool border_row) {
  if (border_row || w < 2 || w >= W - 2) return 0;
  const int center = slab[2 * W + w];
  int code = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const uint8_t* row = slab + r * W + w;
#pragma unroll
    for (int c = -2; c <= 2; ++c) code = (code << 1) | (row[c] < center);
  }
  return code;
}

// The same from a slab row of `pitch` bytes whose byte i + 2 holds image
// column x (a segment's window).
__device__ __forceinline__ int census_in(const uint8_t* slab, int pitch,
                                         int i, int x, int W,
                                         bool border_row) {
  if (border_row || x < 2 || x >= W - 2) return 0;
  const int center = slab[2 * pitch + i + 2];
  int code = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const uint8_t* row = slab + r * pitch + i + 2;
#pragma unroll
    for (int c = -2; c <= 2; ++c) code = (code << 1) | (row[c] < center);
  }
  return code;
}

__global__ void __launch_bounds__(kThreads)
census_cost_kernel(const uint8_t* __restrict__ left,
                   const uint8_t* __restrict__ right,
                   uint8_t* __restrict__ out, int H, int W, int dmin, int D,
                   int halo) {
  extern __shared__ uint4 smem16[];
  const Layout lay = layout_of(W, dmin, D);
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem16);
  int* codes_l = reinterpret_cast<int*>(stages + kWarps * lay.stage);
  int* codes_r = codes_l + W;  // column w at margin + w
  uint8_t* slab_l = reinterpret_cast<uint8_t*>(codes_r + lay.right_pitch);
  uint8_t* slab_r = slab_l + 5 * W;

  const int row = blockIdx.x;  // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const int h_in = H + 4 * halo;  // image rows
  const int y0 = h - 2 + 2 * halo;  // image row of slab row 0
  const uint8_t* L = left + (size_t)b * h_in * W;
  const uint8_t* R = right + (size_t)b * h_in * W;

  // 1. the slab
  for (int y = 0; y < 5; ++y) {
    const int yi = y0 + y;
    const bool inside = yi >= 0 && yi < h_in;
    for (int w = threadIdx.x; w < W; w += kThreads) {
      slab_l[y * W + w] = inside ? L[(size_t)yi * W + w] : 0;
      slab_r[y * W + w] = inside ? R[(size_t)yi * W + w] : 0;
    }
  }
  __syncthreads();

  // 2. the codes, and zeros in the right row's margins
  const bool border_row = !halo && (h < 2 || h >= H - 2);
  for (int w = threadIdx.x; w < W; w += kThreads) {
    codes_l[w] = census_at(slab_l, W, w, border_row);
    codes_r[lay.margin + w] = census_at(slab_r, W, w, border_row);
  }
  for (int i = threadIdx.x; i < lay.right_pitch - W; i += kThreads)
    codes_r[i < lay.margin ? i : i + W] = 0;
  __syncthreads();

  // 3. this warp's run of k-rows through its staging row.  Position p of
  // the staging row stands for the output address base + p, base on a
  // 16-byte boundary; after each k-row the whole chunks go out and the rest
  // (under 16 bytes) moves to the front, base moving on by the chunks.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_begin = warp * D / kWarps, k_end = (warp + 1) * D / kWarps;
  uint8_t* const stage = stages + warp * lay.stage;
  uint8_t* const start = out + ((size_t)row * D + k_begin) * W;
  const int lead = (int)((uintptr_t)start & 15);  // bytes before: not ours
  uint8_t* base = start - lead;
  int pos = lead;          // next position to write
  bool head = lead > 0;    // the run's first chunk is still to store
  for (int k = k_begin; k < k_end; ++k) {
    const int* r = codes_r + lay.margin - dmin - k;  // r[w]: the code at w - d
    uint8_t* const q = stage + pos;
#pragma unroll 4
    for (int w = lane; w < W; w += 32)
      q[w] = (uint8_t)__popc(codes_l[w] ^ r[w]);
    // 127 where w - d leaves the image: w < dmin + k or w >= W + dmin + k;
    // each lane rewrites only its own bytes
    const int first = dmin + k;
    for (int w = lane; w < min(first, W); w += 32) q[w] = kBorderCost;
    for (int w = max(W + first, 0) / 32 * 32 + lane; w < W; w += 32)
      if (w >= W + first) q[w] = kBorderCost;
    pos += W;
    __syncwarp();
    const int end = pos & ~15;  // the whole chunks
    for (int c = 16 * lane; c < end; c += 16 * 32) {
      if (c == 0 && head) {  // shared with the run or row before
        for (int j = lead; j < 16; ++j) base[j] = stage[j];
      } else {
        *reinterpret_cast<uint4*>(base + c) =
            *reinterpret_cast<const uint4*>(stage + c);
      }
    }
    const uint8_t rest = lane < pos - end ? stage[end + lane] : 0;
    __syncwarp();
    if (lane < pos - end) stage[lane] = rest;
    __syncwarp();
    if (end > 0) head = false;
    base += end;
    pos -= end;
  }
  // the run's last partial chunk, shared with the run or row after
  for (int i = (head ? lead : 0) + lane; i < pos; i += 32)
    base[i] = stage[i];
}

// A segment's staging rows: its columns at any 16-byte phase.
__host__ __device__ inline int segment_stage(int seg) {
  return (seg + 15 + 15) / 16 * 16;
}

// [kWarps staging rows][left codes seg][right codes seg + D - 1]
// [left slab 5 x (seg + 4)][right slab 5 x (seg + D - 1 + 4)]
__host__ inline size_t segment_smem_bytes(int seg, int D) {
  const size_t reach = (size_t)seg + D - 1;
  return (size_t)kWarps * segment_stage(seg) +
         sizeof(int) * ((size_t)seg + reach) + 5 * ((size_t)seg + 4) +
         5 * (reach + 4);
}

// One segment of a row: columns [x0, x0 + n) of row blockIdx.x / nseg, x0 =
// (blockIdx.x % nseg) * seg; the layout above.
__global__ void __launch_bounds__(kThreads)
census_segment_kernel(const uint8_t* __restrict__ left,
                      const uint8_t* __restrict__ right,
                      uint8_t* __restrict__ out, int H, int W, int dmin,
                      int D, int halo, int seg, int nseg) {
  extern __shared__ uint4 smem16[];
  const int stage_b = segment_stage(seg);
  const int reach = seg + D - 1;
  const int pitch_l = seg + 4, pitch_r = reach + 4;
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem16);
  int* codes_l = reinterpret_cast<int*>(stages + kWarps * stage_b);
  int* codes_r = codes_l + seg;   // column r0 + j at j
  uint8_t* slab_l = reinterpret_cast<uint8_t*>(codes_r + reach);
  uint8_t* slab_r = slab_l + 5 * pitch_l;

  const int row = blockIdx.x / nseg;   // b * H + h
  const int x0 = (blockIdx.x - row * nseg) * seg;
  const int n = min(seg, W - x0);      // this block's columns
  const int r0 = x0 - dmin - (D - 1);  // the right column of codes_r[0]
  const int rn = n + D - 1;            // right columns its costs read
  const int b = row / H;
  const int h = row - b * H;
  const int h_in = H + 4 * halo;
  const int y0 = h - 2 + 2 * halo;
  const uint8_t* L = left + (size_t)b * h_in * W;
  const uint8_t* R = right + (size_t)b * h_in * W;

  // 1. the slabs: image columns x0 - 2 .. x0 + n + 1 and r0 - 2 ..
  // r0 + rn + 1, zeros outside the image
  for (int y = 0; y < 5; ++y) {
    const int yi = y0 + y;
    const bool inside = yi >= 0 && yi < h_in;
    for (int i = threadIdx.x; i < n + 4; i += kThreads) {
      const int x = x0 - 2 + i;
      slab_l[y * pitch_l + i] =
          inside && x >= 0 && x < W ? L[(size_t)yi * W + x] : 0;
    }
    for (int i = threadIdx.x; i < rn + 4; i += kThreads) {
      const int x = r0 - 2 + i;
      slab_r[y * pitch_r + i] =
          inside && x >= 0 && x < W ? R[(size_t)yi * W + x] : 0;
    }
  }
  __syncthreads();

  // 2. the codes
  const bool border_row = !halo && (h < 2 || h >= H - 2);
  for (int i = threadIdx.x; i < n; i += kThreads)
    codes_l[i] = census_in(slab_l, pitch_l, i, x0 + i, W, border_row);
  for (int i = threadIdx.x; i < rn; i += kThreads)
    codes_r[i] = census_in(slab_r, pitch_r, i, r0 + i, W, border_row);
  __syncthreads();

  // 3. this warp's run of k-rows, each a run of n bytes at its own address:
  // staged at the address's 16-byte phase, whole chunks stored as uint4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_begin = warp * D / kWarps, k_end = (warp + 1) * D / kWarps;
  uint8_t* const stage = stages + warp * stage_b;
  for (int k = k_begin; k < k_end; ++k) {
    uint8_t* const dst = out + ((size_t)row * D + k) * W + x0;
    const int lead = (int)((uintptr_t)dst & 15);
    uint8_t* const q = stage + lead;
    const int* r = codes_r + (D - 1 - k);   // r[i]: the code at x0 + i - d
#pragma unroll 4
    for (int i = lane; i < n; i += 32)
      q[i] = (uint8_t)__popc(codes_l[i] ^ r[i]);
    // 127 where x0 + i - d leaves the image
    const int first = dmin + k - x0, last = W + dmin + k - x0;
    for (int i = lane; i < min(first, n); i += 32) q[i] = kBorderCost;
    for (int i = max(last, 0) / 32 * 32 + lane; i < n; i += 32)
      if (i >= last) q[i] = kBorderCost;
    __syncwarp();
    uint8_t* const base = dst - lead;
    const int end = lead + n;
    for (int c = 16 * lane; c < end; c += 16 * 32) {
      if (c >= lead && c + 16 <= end) {
        *reinterpret_cast<uint4*>(&base[c]) =
            *reinterpret_cast<const uint4*>(&stage[c]);
      } else {   // shared with the next segment or k-row
        for (int j = max(c, lead); j < min(c + 16, end); ++j) base[j] = stage[j];
      }
    }
    __syncwarp();
  }
}

// The dynamic shared memory a block of either kernel may take on the
// current device, asked once per device.
cudaError_t smem_limit(size_t* limit) {
  constexpr int kDevices = 64;
  static size_t known[kDevices] = {};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && known[dev] != 0) {
    *limit = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes whole, part;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&whole, census_cost_kernel);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&part, census_segment_kernel);
  if (err != cudaSuccess) return err;
  const size_t fixed = whole.sharedSizeBytes > part.sharedSizeBytes
                           ? whole.sharedSizeBytes : part.sharedSizeBytes;
  *limit = (size_t)optin - fixed;
  if (dev < kDevices) known[dev] = *limit;
  return cudaSuccess;
}

// The plan of a row of W columns at (dmin, D) under `limit` bytes: one
// block a row where smem_bytes fits (*segmented = false, *nseg = 1, *seg =
// W), else segments (census_segment_kernel) of equal width, as few as fit
// segment_smem_bytes; *nseg = 0 where not even one column does (D past
// about 25,000).
void plan(int W, int dmin, int D, size_t limit, int* nseg, int* seg,
          bool* segmented) {
  *nseg = 1, *seg = W;
  *segmented = smem_bytes(W, dmin, D) > limit;
  if (!*segmented) return;
  int lo = 0, hi = W;   // segment_smem_bytes grows with seg: the widest
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (segment_smem_bytes(mid, D) <= limit) lo = mid; else hi = mid - 1;
  }
  if (lo == 0) {
    *nseg = 0;
    return;
  }
  *nseg = (W + lo - 1) / lo;
  *seg = (W + *nseg - 1) / *nseg;
}

}  // namespace

// How a row of W columns runs at (dmin, D) on the current device, into the
// host int out[3]: the blocks a row takes (0: no plan), the columns a block
// takes, and 1 where they are segments (census_segment_kernel; 0: the
// whole row in one block).  ops/kernels.py's census_plan transcribes it
// (census_smem_bytes and census_segment_smem_bytes there transcribe
// smem_bytes and segment_smem_bytes).
extern "C" int sgm_census_cost_plan(int W, int dmin, int D, int* out) {
  size_t limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  bool segmented = false;
  plan(W, dmin, D, limit, out, out + 1, &segmented);
  out[2] = segmented;
  return 0;
}

// H is the output's row count; img_has_halo=1 takes (B, H+4, W) images.
// One block a row where it holds the row, else a block a segment
// (sgm_census_cost_plan); a (W, D) with no plan is refused
// (cudaErrorInvalidValue; the wrapper refuses it first).
extern "C" int sgm_census_cost(const void* left, const void* right, void* out,
                               int B, int H, int W, int dmin, int D,
                               int img_has_halo, void* stream) {
  if (B * H == 0 || W == 0 || D == 0) return 0;
  if ((long long)D * W > 0x7fffffff - 16) return (int)cudaErrorInvalidValue;
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  int nseg = 0, seg = 0;
  bool segmented = false;
  plan(W, dmin, D, limit, &nseg, &seg, &segmented);
  if (nseg == 0 || (long long)B * H * nseg > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t smem = segmented ? segment_smem_bytes(seg, D)
                                : smem_bytes(W, dmin, D);
  const auto st = (cudaStream_t)stream;
  if (!segmented) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(census_cost_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    census_cost_kernel<<<B * H, kThreads, smem, st>>>(
        (const uint8_t*)left, (const uint8_t*)right, (uint8_t*)out, H, W,
        dmin, D, img_has_halo);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(census_segment_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  census_segment_kernel<<<(unsigned)(B * H * nseg), kThreads, smem, st>>>(
      (const uint8_t*)left, (const uint8_t*)right, (uint8_t*)out, H, W, dmin,
      D, img_has_halo, seg, nseg);
  return (int)cudaGetLastError();
}
