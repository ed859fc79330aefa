// P1 `chain` and P2 `chainio`: the serial floor of the SGM recurrence.
//
// Replaces: scripts/recurrence_floor.py, `chain_kernel` (the pallas_call in
//   `make_chain`) and `chainio_kernel` (the pallas_call in `time_chainio`).
//
// What they compute.  `chain` runs only what the recurrence forces to be
// serial: per step and per direction, L(d-1) and L(d+1) of the carried row
// with 255 sentinels, m = min(prev, min(up, dn) + P1, pmin + P2),
// cs = (cost + m - pmin) & 0xFF and pmin' = min_d cs.  The cost row is a
// constant of the path, ((7 d + 13) & 0x7F) ^ (x & 1) with x the input
// element at the path's first pixel, and P2 is 150: nothing is loaded or
// stored per step, and one row leaves the kernel, so that the chain stays
// live.  `chainio` adds the per-step traffic of a production pass from
// on-chip memory: one cost row load, one P2 load, `extra` uint16 row
// read-adds and one uint16 row store.
//
// What bounds them on the H100: the latency of one step's dependent chain
// (two shuffles for d-1/d+1, five for the butterfly min, about a dozen
// integer operations), times the number of steps.  Neither bytes (one row in,
// one row out) nor the integer rate come near it.  That is the point: the
// time of `chain` is the floor under any K2 scan of this decomposition, the
// time of `chainio` the floor once the volume is staged on chip, and what a
// production pass takes beyond them is memory access, not the recurrence.
//
// Design.  Not the TPU block ((D, P) planes in vector registers, lane rolls
// for the diagonals) but the K2 scan's own decomposition (aggregate.cu): one
// warp per path, DPL disparities per lane, __shfl_up/down for d-1/d+1, a
// butterfly min, with the loads of cost and gray values and the volume's
// read-modify-write taken out.  The TPU's "roll" costs nothing here: a
// path's state lives in its warp, and a diagonal path only changes the
// column it is at.  So a group of n directions is n independent warps per
// column, all in one launch.  A block holds the n warps of up to 8 final
// columns and sums their rows through shared memory.  The TPU kernel's
// output row reads direction 0 only, since one program holds all of them;
// here the row of `chain` sums cost + min over all n directions, so that no
// warp's chain is dead code.
//
// The on-chip volumes of `chainio`.  The TPU version keeps the whole
// (steps, D, P) cost, P2 and output volumes in VMEM; 227 KB of shared memory
// cannot.  Each warp stages a ring of R steps: R cost rows and R P2 values,
// read from the (B, R, D, P) and (B, n, R, P) inputs at the columns of the
// path's first R steps before the loop starts, and R uint16 output rows,
// zero at the start.  Step s uses slot s mod R.  The ring travels with the
// path, so for a diagonal the row of slot r serves column
// col_r + roll * R * (s div R) at step s: the plain version in
// probes/kernels.py rolls the ring rows by that amount.  With R = steps the
// ring is the whole volume and the function is the TPU script's.  Ring
// words are laid out [slot][i][lane], so a warp's access has no bank
// conflict.  Each direction's warp makes its own row store, as each K2
// launch makes its own read-modify-write of the volume.  The `extra` reads
// go through a volatile pointer, or the compiler would merge them.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 255;
constexpr int kChainP2 = 150;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRolls = 8;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block can take

struct Rolls {
  int r[kMaxRolls];
};

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int wrap(long long v, int P) {
  int m = (int)(v % P);
  return m < 0 ? m + P : m;
}

// Block: cols * n warps; warp (c, k) walks direction k of the path that ends
// at column group_first + c.  Dynamic shared memory, in this order:
//   int      res[cols * n][32 * DPL]        the rows to sum per column
//   int      cost ring[cols * n][R][DPL][32]      (IO only)
//   int      p2 ring[cols * n][R]                 (IO only)
//   uint16_t out ring[cols * n][R][DPL][32]       (IO only)
template <int DPL, bool IO>
__global__ void __launch_bounds__(1024)
chain_kernel(const uint16_t* __restrict__ x, const int* __restrict__ cost_ring,
             const int* __restrict__ p2_ring, uint16_t* __restrict__ out,
             int B, int D, int P, int steps, int n, Rolls rolls, int cols,
             int R, int extra, int p1) {
  extern __shared__ int smem[];
  const int warps = cols * n;
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = wi / n;
  const int k = wi - c * n;
  const int groups = (P + cols - 1) / cols;
  const int b = blockIdx.x / groups;
  const int j = (blockIdx.x - b * groups) * cols + c;  // the final column
  const bool active = j < P;
  constexpr int kRow = 32 * DPL;

  int* res = smem + wi * kRow;
  int* cring = smem + warps * kRow + wi * (R * kRow);
  int* pring = smem + warps * kRow + warps * (R * kRow) + wi * R;
  uint16_t* oring =
      (uint16_t*)(smem + warps * kRow + warps * (R * kRow) + warps * R) +
      wi * (R * kRow);

  int prev[DPL];
  int pmin = 0;
  if (active) {
    const int roll = rolls.r[k];
    const int col0 = wrap((long long)j - (long long)roll * (steps - 1), P);
    int seed[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      seed[i] = d < D ? (x[((size_t)b * D + d) * P + col0] & 1) : 0;
      prev[i] = 0;
    }
    if (IO) {  // stage the ring at the columns of the first R steps
      for (int r = 0; r < R; ++r) {
        const int col = wrap((long long)col0 + (long long)roll * r, P);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane * DPL + i;
          cring[(r * DPL + i) * 32 + lane] =
              d < D ? cost_ring[(((size_t)b * R + r) * D + d) * P + col] : 0;
          oring[(r * DPL + i) * 32 + lane] = 0;
        }
        if (lane == 0)
          pring[r] = p2_ring[(((size_t)b * n + k) * R + r) * P + col];
      }
      __syncwarp();
    }

    int slot = 0;
    for (int s = 0; s < steps; ++s) {
      int cost[DPL];
      int p2 = kChainP2;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        if (IO)
          cost[i] = (cring[(slot * DPL + i) * 32 + lane] ^ seed[i]) & 0xFF;
        else
          cost[i] = d < D ? (((d * 7 + 13) & 0x7F) ^ seed[i]) : 0;
      }
      if (IO) p2 = pring[slot];

      const int up = __shfl_up_sync(kFull, prev[DPL - 1], 1);  // L(d-1), i=0
      const int dn = __shfl_down_sync(kFull, prev[0], 1);  // L(d+1), i=DPL-1
      int cur[DPL];
      int local_min = INT_MAX;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        const int lm = d == 0 ? kSentinel : (i > 0 ? prev[i - 1] : up);
        const int lp =
            d >= D - 1 ? kSentinel : (i < DPL - 1 ? prev[i + 1] : dn);
        const int m = min(min(prev[i], min(lm, lp) + p1), pmin + p2);
        cur[i] = (cost[i] + m - pmin) & 0xFF;
        if (d < D) local_min = min(local_min, cur[i]);
      }
      if (IO) {
        const volatile uint16_t* parked = oring;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int at = (slot * DPL + i) * 32 + lane;
          int total = cur[i];
          for (int e = 0; e < extra; ++e) total += (int)parked[at] + e;
          oring[at] = (uint16_t)total;
        }
        if (++slot == R) slot = 0;
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) prev[i] = cur[i];
      pmin = warp_min(local_min);
    }

    const int last = IO ? (steps - 1) % R : 0;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      if (IO)
        res[lane * DPL + i] = (int)oring[(last * DPL + i) * 32 + lane] +
                              (k == 0 ? prev[i] : 0);
      else
        res[lane * DPL + i] = prev[i] + pmin;
    }
  }
  __syncthreads();
  if (active && k == 0) {  // res of (c, 0..n-1) are consecutive rows
    for (int d = lane; d < D; d += 32) {
      int sum = 0;
      for (int kk = 0; kk < n; ++kk) sum += res[kk * kRow + d];
      out[((size_t)b * D + d) * P + j] = (uint16_t)sum;
    }
  }
}

template <int DPL, bool IO>
int launch_chain(const uint16_t* x, const int* cost_ring, const int* p2_ring,
                 uint16_t* out, int B, int D, int P, int steps, int n,
                 const Rolls& rolls, int R, int extra, int p1,
                 cudaStream_t stream) {
  const int cols = std::max(1, std::min(8, 32 / n));
  const int warps = cols * n;
  size_t bytes = (size_t)warps * 32 * DPL * sizeof(int);
  if (IO)
    bytes += (size_t)warps * R * (32 * DPL * (sizeof(int) + sizeof(uint16_t)) +
                                  sizeof(int));
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  auto kernel = chain_kernel<DPL, IO>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * ((P + cols - 1) / cols);
  kernel<<<(unsigned)blocks, warps * 32, bytes, stream>>>(
      x, cost_ring, p2_ring, out, B, D, P, steps, n, rolls, cols, R, extra,
      p1);
  return (int)cudaGetLastError();
}

template <bool IO>
int chain_entry(const void* x, const void* cost_ring, const void* p2_ring,
                void* out, int B, int D, int P, int steps, int n,
                const int* rolls_host, int R, int extra, int p1,
                void* stream) {
  if (B * D * P == 0) return 0;
  if (D > 256 || steps < 1 || n < 1 || n > kMaxRolls || R < 1 || extra < 0)
    return (int)cudaErrorInvalidValue;
  Rolls rolls{};
  for (int k = 0; k < n; ++k) rolls.r[k] = rolls_host[k];
  const uint16_t* xs = (const uint16_t*)x;
  const int* cr = (const int*)cost_ring;
  const int* pr = (const int*)p2_ring;
  uint16_t* o = (uint16_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
#define SGM_CHAIN_CASE(N)                                                  \
  case N:                                                                  \
    return launch_chain<N, IO>(xs, cr, pr, o, B, D, P, steps, n, rolls, R, \
                               extra, p1, s);
    SGM_CHAIN_CASE(1)
    SGM_CHAIN_CASE(2)
    SGM_CHAIN_CASE(3)
    SGM_CHAIN_CASE(4)
    SGM_CHAIN_CASE(5)
    SGM_CHAIN_CASE(6)
    SGM_CHAIN_CASE(7)
    SGM_CHAIN_CASE(8)
#undef SGM_CHAIN_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: uint16 (B, D, P).  rolls_host: n ints in host memory, the column
// step of each direction (0 straight, +-1 the wrapping diagonals).
extern "C" int sgm_probe_chain(const void* x, void* out, int B, int D, int P,
                               int steps, int n, const int* rolls_host,
                               int p1, void* stream) {
  return chain_entry<false>(x, nullptr, nullptr, out, B, D, P, steps, n,
                            rolls_host, 1, 0, p1, stream);
}

// As above, with cost_ring int32 (B, R, D, P) and p2_ring int32
// (B, n, R, P); `extra` uint16 row read-adds per step (0, 1 or 2 in the
// forward, accumulating and backward pass shapes).
extern "C" int sgm_probe_chainio(const void* x, const void* cost_ring,
                                 const void* p2_ring, void* out, int B, int D,
                                 int P, int steps, int n,
                                 const int* rolls_host, int R, int extra,
                                 int p1, void* stream) {
  return chain_entry<true>(x, cost_ring, p2_ring, out, B, D, P, steps, n,
                           rolls_host, R, extra, p1, stream);
}
