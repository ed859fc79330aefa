// K1: fused 5x5 census of both images + Hamming cost volume.
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   census_cost_volume_pallas / _census_cost_kernel, both modes: untiled,
//   and the tiled path's img_has_halo mode (mask_rows=False).
//
// What bounds it on the H100: bytes.  Per pixel it reads 2 image bytes (plus
// a 5x5 window from cache) and writes D cost bytes, so the uint8 volume
// store (B*H*D*W bytes) is the traffic; the arithmetic is 50 compares, one
// popcount per d.
//
// Design: one block per image row (b, h).  The block computes the census
// codes of that row of both images into shared memory (2*W int32), so no
// census plane ever reaches device memory, then its threads walk the
// (d, w) plane of the output row with w fastest: consecutive threads store
// consecutive bytes, and the right-image code for column w - d comes from
// shared memory.
//
// Semantics: strict `<`, 25 bits MSB-first in window order, a 2-px zero
// border; cost = popcount(cl[j] ^ cr[j - d]) for d = dmin + k, 127 where
// j - d leaves the image.
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

// Census code at row h of an image with H rows; mask_rows zeroes the
// 2-row border.
__device__ __forceinline__ int census_at(const uint8_t* img, int H, int W,
                                         int h, int w, bool mask_rows) {
  if ((mask_rows && (h < 2 || h >= H - 2)) || w < 2 || w >= W - 2) return 0;
  const int center = img[h * W + w];
  int code = 0;
  for (int r = -2; r <= 2; ++r) {
    const uint8_t* row = img + (h + r) * W + w;
    for (int c = -2; c <= 2; ++c) code = (code << 1) | (row[c] < center);
  }
  return code;
}

__global__ void census_cost_kernel(const uint8_t* __restrict__ left,
                                   const uint8_t* __restrict__ right,
                                   uint8_t* __restrict__ out, int H, int W,
                                   int dmin, int D, int halo) {
  extern __shared__ int codes[];  // [0, W): left row, [W, 2W): right row
  int* cl = codes;
  int* cr = codes + W;
  const int row = blockIdx.x;  // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const int h_in = H + 4 * halo;  // image rows
  const uint8_t* L = left + (size_t)b * h_in * W;
  const uint8_t* R = right + (size_t)b * h_in * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    cl[w] = census_at(L, h_in, W, h + 2 * halo, w, !halo);
    cr[w] = census_at(R, h_in, W, h + 2 * halo, w, !halo);
  }
  __syncthreads();
  uint8_t* o = out + (size_t)row * D * W;
  const int n = D * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / W;
    const int w = i - k * W;
    const int src = w - (dmin + k);
    o[i] = (src >= 0 && src < W) ? (uint8_t)__popc(cl[w] ^ cr[src])
                                 : (uint8_t)kBorderCost;
  }
}

}  // namespace

// H is the output's row count; img_has_halo=1 takes (B, H+4, W) images.
extern "C" int sgm_census_cost(const void* left, const void* right, void* out,
                               int B, int H, int W, int dmin, int D,
                               int img_has_halo, void* stream) {
  if (B * H == 0 || W == 0 || D == 0) return 0;
  const size_t smem = 2 * (size_t)W * sizeof(int);
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
