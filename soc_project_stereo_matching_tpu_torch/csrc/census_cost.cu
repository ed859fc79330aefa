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

}  // namespace

// H is the output's row count; img_has_halo=1 takes (B, H+4, W) images.
// Refused where the staging rows, the codes and the slab of one row do not
// fit a block's 227 KB of shared memory, about 26 W + 4 D bytes: W above
// about 8,900 columns at D = 64.
extern "C" int sgm_census_cost(const void* left, const void* right, void* out,
                               int B, int H, int W, int dmin, int D,
                               int img_has_halo, void* stream) {
  if (B * H == 0 || W == 0 || D == 0) return 0;
  if ((long long)D * W > 0x7fffffff - 16) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W, dmin, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        census_cost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  census_cost_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)left, (const uint8_t*)right, (uint8_t*)out, H, W, dmin,
      D, img_has_halo);
  return (int)cudaGetLastError();
}
