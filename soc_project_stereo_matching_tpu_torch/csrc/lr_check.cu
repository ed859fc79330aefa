// K3: left-right consistency check.
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   lr_check_pallas / _lr_check_kernel.
//
// What bounds it on the H100: bytes.  Per pixel it reads the left
// disparity, one right-map sample from the same row (a gather that mostly
// hits cache, since |j - col| <= D) and writes one f32: 12 bytes a pixel.
//
// Design: one thread per pixel; consecutive threads take consecutive
// columns, so the left load and the store are coalesced.  On the TPU the
// gather was a (max_shift+2)-way select over lane-rolled copies; here it is
// one load, bounded by the same band so that the result equals the JAX
// op's on every input: the right map is read at col = trunc((j - d) + 0.5)
// (f32, IEEE: this file is built without fast-math) only while j - col lies
// in [-1, min(max_shift, W-1) + 2), and is 0.0 outside that band.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void lr_check_kernel(const float* __restrict__ disp_left,
                                const float* __restrict__ disp_right,
                                float* __restrict__ out, long long n, int W,
                                float thres, int kend) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = (int)(idx % W);
  const float* right_row = disp_right + (idx - j);
  const float d_raw = disp_left[idx];
  const bool valid = isfinite(d_raw);
  const float dl = valid ? d_raw : 0.0f;
  const float x = ((float)j - dl) + 0.5f;
  const int col = (int)truncf(x);
  const bool in_range = col >= 0 && col < W;
  const int shift = j - col;
  const float sample =
      (in_range && shift >= -1 && shift < kend) ? right_row[col] : 0.0f;
  const bool r_finite = isfinite(sample);
  const float dr = r_finite ? sample : 0.0f;
  const bool mismatch = fabsf(dl - dr) > thres;
  const bool kill = valid && (!in_range || (r_finite && mismatch));
  out[idx] = kill ? INFINITY : d_raw;
}

}  // namespace

extern "C" int sgm_lr_check(const void* disp_left, const void* disp_right,
                            void* out, int B, int H, int W, float thres,
                            int max_shift, void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  const int kend = (max_shift < W - 1 ? max_shift : W - 1) + 2;
  constexpr int kThreads = 256;
  lr_check_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>((const float*)disp_left,
                                            (const float*)disp_right,
                                            (float*)out, n, W, thres, kend);
  return (int)cudaGetLastError();
}
