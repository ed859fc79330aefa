// K4: speckle removal by connected-component labelling.
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   remove_speckles_pallas and its three kernels, _speckle_labels_kernel
//   (+ _cc_propagate), _speckle_hist_kernel and _speckle_verdict_kernel.
//
// What bounds it on the H100: bytes and launch latency.  Each of the four
// launches touches a few words per pixel (disparity, label, count); the
// union pass also chases parent pointers, whose chains union-by-min keeps
// short in practice.
//
// Design: union-find instead of the TPU's min-label propagation to a fixed
// point.  Labels are flat pixel indices over the whole batch; frames never
// connect because only in-frame neighbours are tested.
//   1. init:    label[p] = p, count[p] = 0;
//   2. union:   for each of the 4 "earlier" 8-neighbours q of p (the
//               relation is symmetric, so these cover every edge) that is
//               connected -- both finite and |d_p - d_q| <= diff in f32 --
//               unite the two trees with atomicMin on the larger root
//               (Playne & Hawick's lock-free union; retried when another
//               thread moved the root first);
//   3. flatten + count: label[p] = root(p), then atomicAdd(count[root], 1)
//               for finite p;
//   4. verdict: p becomes +inf iff it is finite and count[label[p]] < min_area.
// Roots are each component's minimum index, so the labels even equal the
// JAX op's; only the verdict is required to.
//
// Two further entries run the stages apart, for the speckle probes:
// sgm_speckle_union_labels (steps 1-3 without the count: the flattened
// labels) and sgm_speckle_count_verdict (the count and step 4 on given
// labels).  For them alone step 3 is split into a flatten and a count.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const volatile int* label, int x) {
  int parent = label[x];
  while (parent != x) {
    x = parent;
    parent = label[x];
  }
  return x;
}

__device__ void unite(int* label, int a, int b) {
  const volatile int* vl = label;
  while (true) {
    a = find_root(vl, a);
    b = find_root(vl, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(label + a, b);  // hang the larger root under b
    if (old == a) return;
    a = old;  // a stopped being a root meanwhile: unite from its new parent
  }
}

__device__ __forceinline__ bool connected(const float* disp, int p, int q,
                                          float diff) {
  const float dq = disp[q];
  return isfinite(dq) && fabsf(disp[p] - dq) <= diff;
}

__global__ void init_kernel(int* label, int* count, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) {
    label[p] = p;
    count[p] = 0;
  }
}

__global__ void union_kernel(const float* __restrict__ disp, int* label,
                             int n, int H, int W, float diff) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n || !isfinite(disp[p])) return;
  const int c = p % W;
  const int r = (p / W) % H;
  if (c > 0 && connected(disp, p, p - 1, diff)) unite(label, p, p - 1);
  if (r > 0) {
    const int up = p - W;
    if (c > 0 && connected(disp, p, up - 1, diff)) unite(label, p, up - 1);
    if (connected(disp, p, up, diff)) unite(label, p, up);
    if (c < W - 1 && connected(disp, p, up + 1, diff)) unite(label, p, up + 1);
  }
}

__global__ void flatten_count_kernel(const float* __restrict__ disp,
                                     int* label, int* count, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int root = find_root(label, p);
  label[p] = root;
  if (isfinite(disp[p])) atomicAdd(count + root, 1);
}

// The two halves of flatten_count_kernel, for the stage entries.
__global__ void iota_kernel(int* label, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) label[p] = p;
}

__global__ void flatten_kernel(int* label, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) label[p] = find_root(label, p);
}

__global__ void count_kernel(const float* __restrict__ disp,
                             const int* __restrict__ label, int* count,
                             int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n && isfinite(disp[p])) atomicAdd(count + label[p], 1);
}

__global__ void verdict_kernel(const float* __restrict__ disp,
                               const int* __restrict__ label,
                               const int* __restrict__ count,
                               float* __restrict__ out, int n, int min_area) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float d = disp[p];
  out[p] = (isfinite(d) && count[label[p]] < min_area) ? INFINITY : d;
}

}  // namespace

// disp, out: f32 (B, H, W); label, count: int32 scratch of B*H*W each.
extern "C" int sgm_remove_speckles(const void* disp, void* out, void* label,
                                   void* count, int B, int H, int W,
                                   float diff, int min_area, void* stream) {
  const long long n64 = (long long)B * H * W;
  if (n64 == 0) return 0;
  if (n64 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int n = (int)n64;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)disp;
  int* lab = (int*)label;
  int* cnt = (int*)count;
  init_kernel<<<blocks, kThreads, 0, s>>>(lab, cnt, n);
  union_kernel<<<blocks, kThreads, 0, s>>>(d, lab, n, H, W, diff);
  flatten_count_kernel<<<blocks, kThreads, 0, s>>>(d, lab, cnt, n);
  verdict_kernel<<<blocks, kThreads, 0, s>>>(d, lab, cnt, (float*)out, n,
                                             min_area);
  return (int)cudaGetLastError();
}

// disp: f32 (B, H, W); label: int32 (B, H, W) out, every pixel's root: the
// smallest flat index (over the batch) of its component.
extern "C" int sgm_speckle_union_labels(const void* disp, void* label, int B,
                                        int H, int W, float diff,
                                        void* stream) {
  const long long n64 = (long long)B * H * W;
  if (n64 == 0) return 0;
  if (n64 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int n = (int)n64;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  int* lab = (int*)label;
  iota_kernel<<<blocks, kThreads, 0, s>>>(lab, n);
  union_kernel<<<blocks, kThreads, 0, s>>>((const float*)disp, lab, n, H, W,
                                           diff);
  flatten_kernel<<<blocks, kThreads, 0, s>>>(lab, n);
  return (int)cudaGetLastError();
}

// disp, out: f32 (B, H, W); label: int32 flat roots in [0, B*H*W) as
// sgm_speckle_union_labels gives them; count: int32 scratch of B*H*W.
extern "C" int sgm_speckle_count_verdict(const void* disp, const void* label,
                                         void* count, void* out, int B, int H,
                                         int W, int min_area, void* stream) {
  const long long n64 = (long long)B * H * W;
  if (n64 == 0) return 0;
  if (n64 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int n = (int)n64;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)disp;
  const int* lab = (const int*)label;
  int* cnt = (int*)count;
  const cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  count_kernel<<<blocks, kThreads, 0, s>>>(d, lab, cnt, n);
  verdict_kernel<<<blocks, kThreads, 0, s>>>(d, lab, cnt, (float*)out, n,
                                             min_area);
  return (int)cudaGetLastError();
}
