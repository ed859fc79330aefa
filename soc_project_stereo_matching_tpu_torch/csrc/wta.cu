// K2 WTA: the winner-take-all reduction of the aggregated volume, the
// forward view and the inverse (right-image) view from one read.
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   wta_reduce_pallas / _wta_kernel / _wta_reduce_block.  Like the online
//   pass of _wta_reduce_block's inverse view (running minima and latches,
//   no second read), for both views.
//
// Output: int32 (5 or 10, B, H, W) planes of a uint16 (B, H, D, W) volume:
// best (first argmin over k), min, sec_min (the min over k != best; 1 << 30
// for D = 1), c1 and c2 (the cost at clip(best -+ 1)), of the forward view
// cost[k][j] and then of the inverse view cost[k][j + dmin + k] (65535 where
// that column leaves the row).
//
// What bounds it on the H100: bytes.  It must read the volume once (2 bytes
// an element) and write 40 bytes a pixel: at the cone geometry, B = 32,
// 691 MB + 216 MB, 0.27 ms at 3.35 TB/s.  Next comes the integer pipe (64
// lanes an SM a clock), which the reduction keeps under the bytes' time.
// The first design took a thread per pixel: D dependent 2-byte loads at a
// stride of W per view, c1 and c2 re-read at data-dependent addresses, and
// the inverse view read every plane a second time, from device memory where
// a row no longer fits the L2 (Middlebury-half): a third to a half of the
// byte bound.
//
// Design.  A block takes a (b, h) row, or a segment of it: rows wider than
// kMaxSegment columns are cut into equal segments, each its own block.
//   * The row goes through shared memory in chunks of `planes` planes, two
//     buffers in turn, sized so that the blocks an SM holds fill its shared
//     memory.  Planes k0 .. k0 + K - 1 of a row are one contiguous
//     run, so a whole-row block stages a chunk with one bulk copy
//     (cp.async.bulk, the TMA) from the run's 16-byte aligned-down address
//     to its aligned-up end: every run qualifies whatever W (a row of 450
//     columns starts 4-byte aligned), and a whole granule that holds a byte
//     of the volume never lies outside its page.  A segment's planes are
//     not one run: a lane of warp 0 copies each plane's window (the
//     segment's columns and the inverse view's reach right of them).  Where
//     each staged plane's column 0 and its inverse shift lie goes into a
//     small table per buffer.  A chunk is asked for as soon as every thread
//     is done with the chunk two before it, so one chunk is in flight while
//     the block reduces the other; three or four buffers of smaller chunks
//     were slower.  A copy per plane for
//     whole rows too (900 bytes at the cone width) was slower: the TMA moves
//     copies that small well under the card's rate.
//   * The inverse view of column j reads plane k at staged column j + dmin
//     + k, so the volume leaves device memory once for both views.  Only
//     the warps whose columns lie within dmin + D of the row's end can read
//     past it; they test each inverse read (65535 past the end, and no load)
//     and the others run the same loop without the test.
//   * A thread owns two neighbouring columns (lanes on consecutive 4-byte
//     words: shared-memory loads without bank conflicts) and keeps each
//     view's pair in the 16-bit halves of a register: the min and the min
//     of the planes that lost to it (the min over k != best, ties
//     included), one Hopper VIMNMX.U16x2 each, whose two predicates say
//     where the min stays (m1 <= cost: ties keep the first plane).  Where
//     the min changes hands a column latches prev << 14 | k, c1 and best in
//     one word (a cost is at most 65535, so the latch fits an int32 for k <
//     2^14); c2 is the cost of the plane after one that took the min.
//     No branch depends on the data, and c1 and c2 need no second read.
//     Packed 24-bit keys cost << 8 | k per column, as the Pallas kernel
//     keeps them, took some six integer operations a column, plane and view
//     and left the kernel bound by the integer pipe; the two lanes take
//     about four.
//   * The ten planes leave as 8-byte stores of the column pair where W is
//     even (a row of 450 int32 starts 8-byte aligned), as 4-byte stores
//     otherwise.
// Rows of any width at any D in 1..16,384 (the JAX package's bound, the
// latch's) and any dmin >= 0.  A segment's plane is staged as one window,
// its columns and the inverse view's reach (min(dmin + D - 1, W) columns
// past them), where that fits half a block's shared memory (shape_of);
// where it does not (dmin in the tens of thousands, at rows wider still),
// as two (SPLIT): its own columns for the forward view, and for the
// inverse view only [s0 + dmin, min(W, s0 + seg + dmin + D - 1)), at most
// 2,048 + D - 1 columns whatever dmin, so every D up to 16,384 fits.
// Nothing else in the kernel depends on W: the grid is B * H * segments
// blocks, the offsets into the volume and the planes are 64-bit, a plane's
// table holds kMaxPlanes entries whatever W.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShift = 14;                    // latch = cost << kShift | k
constexpr int kMaxD = 1 << kShift;
constexpr int kBig = 1 << 30;                 // sec_min where D = 1
constexpr unsigned kSentinel = 0xFFFFu;       // the inverse view off the row
constexpr int kMaxThreads = 1024;
constexpr int kMaxSegment = 2 * kMaxThreads;  // columns of a block
constexpr int kMaxPlanes = 32;                // a copy per lane of warp 0
constexpr int kStages = 2;                    // buffers in the ring
constexpr int kSmRegisters = 65536;
constexpr int kSmemPerSm = 233472;            // 228 KB
constexpr int kHeader = 64 + kStages * kMaxPlanes * 8;  // barriers, tables
constexpr int kSmemMax = 232448;              // 227 KB, the most a block takes
constexpr long long kWaitCycles = 1LL << 32;  // about 2 s

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The launch shape; host and kernel agree on it.
struct Shape {
  int nseg;     // blocks of a row (1: the block stages whole runs)
  int seg;      // columns of a block (the last may have fewer)
  int threads;  // seg / 2, to whole warps
  int xs;       // staged columns of a segment's plane: its own + the reach
                // (SPLIT: of its inverse window alone)
  int pitch;    // bytes of a segment's staged plane (SPLIT: both windows)
  int planes;   // planes of a chunk
  int nchunks;
  int stage;    // bytes of a buffer
  int smem;     // dynamic shared memory
};

// The bytes of a SPLIT segment's forward window, which comes first.
__host__ __device__ inline int forward_pitch(int threads) {
  return round_up(4 * threads + 16, 16);
}

Shape shape_of(int W, int D, int dmin, bool split = false) {
  Shape s{};
  s.nseg = (W + kMaxSegment - 1) / kMaxSegment;
  s.seg = round_up((W + s.nseg - 1) / s.nseg, 2);
  s.threads = round_up(s.seg / 2, 32);
  // a segment's inverse view reads up to min(dmin + D - 1, W) columns
  // right of its own; split, its inverse window takes D - 1 more than
  // its own from dmin on
  const long long reach = (long long)dmin + D - 1;
  s.xs = split ? 2 * s.threads + D - 1
               : 2 * s.threads + (int)(reach < W ? reach : W);
  s.pitch = round_up(2 * s.xs + 16, 16) + (split ? forward_pitch(s.threads)
                                                 : 0);
  // a whole-row buffer: the run, its lead, and room for the forward reads
  // of the lanes past the row's end
  const int plane = s.nseg == 1 ? 2 * W : s.pitch;
  const int slack = s.nseg == 1 ? 16 + 4 * s.threads - 2 * W + 16 : 0;
  // the shared memory of the blocks an SM holds at 64 registers a thread,
  // split into kStages buffers
  int blocks = kSmRegisters / (64 * s.threads);
  blocks = blocks < 1 ? 1 : blocks;
  const int share = kSmemPerSm / blocks - kHeader - 1024;
  int planes = (share / kStages - slack - 127) / plane;
  while (planes > 1 &&
         kHeader + (long long)kStages * (planes * plane + slack) > kSmemMax)
    --planes;
  planes = planes < 1 ? 1 : planes > kMaxPlanes ? kMaxPlanes : planes;
  planes = planes > D ? D : planes;
  s.nchunks = (D + planes - 1) / planes;
  s.planes = (D + s.nchunks - 1) / s.nchunks;   // chunks of equal size
  s.stage = round_up(s.planes * plane + slack, 128);
  s.smem = kHeader + kStages * s.stage;
  return s;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase `parity` completes; a copy that never
// lands is a fault, and the kernel traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  unsigned done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > kWaitCycles) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into 16-byte
// aligned shared memory, counted on the barrier.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The uint16 at shared-memory address a (+ 2), zero-extended.
__device__ __forceinline__ int ld16(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(a));
  return (int)v;
}

__device__ __forceinline__ int ld16_next(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u16 %0, [%1+2];" : "=r"(v) : "r"(a));
  return (int)v;
}

__device__ __forceinline__ unsigned ld32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// A column pair of one view; m1 and m2 hold the two columns in their 16-bit
// halves (x low, x + 1 high).
struct Pair {
  unsigned m1, m2;  // the min and the min over the planes that lost, by half
  int rk[2];        // per column: cost at the plane before the min << 14 | k
  int rc2[2];       // per column: cost at the plane after the min, latched
  int prev[2];      // per column: cost at the plane before
  bool took[2];     // per column: the plane before took the min
};

__device__ __forceinline__ void pair_init(Pair& p, int v0, int v1) {
  p.m1 = (unsigned)v0 | ((unsigned)v1 << 16);
  p.m2 = 0xFFFFFFFFu;
  p.rk[0] = v0 << kShift;   // plane 0 holds the min; c1 = cost[clip(-1)]
  p.rk[1] = v1 << kShift;
  p.rc2[0] = p.rc2[1] = 0;
  p.prev[0] = v0;
  p.prev[1] = v1;
  p.took[0] = p.took[1] = true;
}

__device__ __forceinline__ void pair_step(Pair& p, unsigned vp, int v0,
                                          int v1, int k) {
  bool keep1, keep0;   // m1 <= v: the min stays (ties keep the first)
  const unsigned m1 = __vibmin_u16x2(p.m1, vp, &keep1, &keep0);
  p.m2 = __vminu2(p.m2, __vmaxu2(p.m1, vp));
  p.m1 = m1;
  int l0, l1;   // prev << kShift | k, on the multiply-add pipe
  static_assert(kMaxD == 16384, "the latch's multiplier below is kMaxD");
  asm("mad.lo.s32 %0, %1, 16384, %2;" : "=r"(l0) : "r"(p.prev[0]), "r"(k));
  asm("mad.lo.s32 %0, %1, 16384, %2;" : "=r"(l1) : "r"(p.prev[1]), "r"(k));
  p.rk[0] = keep0 ? p.rk[0] : l0;
  p.rk[1] = keep1 ? p.rk[1] : l1;
  p.rc2[0] = p.took[0] ? v0 : p.rc2[0];
  p.rc2[1] = p.took[1] ? v1 : p.rc2[1];
  p.prev[0] = v0;
  p.prev[1] = v1;
  p.took[0] = !keep0;
  p.took[1] = !keep1;
}

// best, min, sec_min, c1, c2 of the pair's column h, into r[0..4].
__device__ __forceinline__ void pair_result(const Pair& p, int h, int D,
                                            int* r) {
  r[0] = p.rk[h] & (kMaxD - 1);
  r[1] = (int)((p.m1 >> (16 * h)) & 0xFFFFu);
  r[2] = D > 1 ? (int)((p.m2 >> (16 * h)) & 0xFFFFu) : kBig;
  r[3] = p.rk[h] >> kShift;
  r[4] = r[0] == D - 1 ? p.prev[h] : p.rc2[h];
}

// The inverse view's costs of columns x and x + 1 at plane k, from the
// staged address a of column x; plane k of column x lies in the row for
// k < kx.
template <bool CHECKED>
__device__ __forceinline__ void inverse_costs(unsigned a, int k, int kx,
                                              int& v0, int& v1) {
  v0 = v1 = (int)kSentinel;
  if (!CHECKED || k < kx) v0 = ld16(a);
  if (!CHECKED || k < kx - 1) v1 = ld16_next(a);
}

// The forward view's costs of columns x and x + 1, one by one and as the
// halves of one word (EVEN: the staged address a is 4-byte aligned).
template <bool EVEN>
__device__ __forceinline__ unsigned forward_costs(unsigned a, int& v0,
                                                  int& v1) {
  v0 = ld16(a);
  v1 = ld16_next(a);
  if (EVEN) return ld32(a);
  return __byte_perm((unsigned)v0, (unsigned)v1, 0x5410);
}

// Planes k0 + kbegin .. k0 + kc - 1 of one staged chunk into the column
// pair's tracks (forward, inverse); `xb` is the shared address of column x
// at offset 0; CHECKED: the pair's inverse reads may leave the row.
template <bool INVERSE, bool CHECKED, bool EVEN>
__device__ __forceinline__ void reduce_chunk(const int2* tab, int k0,
                                             int kbegin, int kc, unsigned xb,
                                             int kx, Pair* pr) {
#pragma unroll 4
  for (int kk = kbegin; kk < kc; ++kk) {
    const int2 t = tab[kk];
    const int k = k0 + kk;
    int v0, v1;
    const unsigned vp = forward_costs<EVEN>(xb + t.x, v0, v1);
    pair_step(pr[0], vp, v0, v1, k);
    if (INVERSE) {
      inverse_costs<CHECKED>(xb + t.y, k, kx, v0, v1);
      pair_step(pr[1], __byte_perm((unsigned)v0, (unsigned)v1, 0x5410), v0,
                v1, k);
    }
  }
}

template <bool INVERSE, bool EVEN, bool SPLIT = false>
__global__ void __launch_bounds__(kMaxThreads)
    wta_kernel(const uint16_t* __restrict__ aggr, int* __restrict__ out,
               int D, int W, int dmin, long long n, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = (unsigned long long*)smem;   // a barrier and
  int2* table = (int2*)(smem + 64);   // [kMaxPlanes] byte offsets of a
                                      // staged plane's column 0, forward
                                      // and inverse, per stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int row = blockIdx.x / s.nseg;
  const int j0 = (blockIdx.x - row * s.nseg) * s.seg;
  const int avail = W - j0;                    // columns left in the row
  const int ncol = min(s.seg, avail);          // this block's own
  const bool whole = s.nseg == 1;
  const int L = whole ? W : min(s.xs, avail);  // columns staged per plane
  const uint16_t* g_row = aggr + (size_t)row * D * W + j0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_addr(full + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk c into stage c % kStages, by warp 0.
  auto issue = [&](int c) {
    const int b = c % kStages, k0 = c * s.planes;
    const int kc = min(s.planes, D - k0);
    const int base = kHeader + b * s.stage;
    int2* tab = table + b * kMaxPlanes;
    if (whole) {   // one run, one copy
      const uint16_t* g = g_row + (size_t)k0 * W;
      const int lead = (int)((uintptr_t)g & 15);
      for (int kk = lane; kk < kc; kk += 32) {
        const int f = base + lead + 2 * W * kk;
        tab[kk] = make_int2(f, f + 2 * min(dmin + k0 + kk, W));
      }
      if (lane == 0) {
        const int bytes = round_up(lead + 2 * W * kc, 16);
        mbar_expect(smem_addr(full + b), bytes);
        bulk_copy(smem_addr(smem + base), (const unsigned char*)g - lead,
                  bytes, smem_addr(full + b));
      }
    } else if constexpr (SPLIT) {   // each plane's two windows, a lane each
      int bytes = 0, inv_bytes = 0;
      const unsigned char *src = nullptr, *inv_src = nullptr;
      const int dst = base + lane * s.pitch;
      const int inv_dst = dst + forward_pitch(s.threads);
      if (lane < kc) {
        const uint16_t* g = g_row + (size_t)(k0 + lane) * W;
        const int lead = (int)((uintptr_t)g & 15);
        src = (const unsigned char*)g - lead;
        bytes = round_up(lead + 2 * ncol, 16);
        // plane k of column x's inverse view: column x + k of the window
        // from dmin on, where that lies in the row (kx below)
        int inv_lead = 0;
        if (dmin < avail) {
          const uint16_t* gi = g + dmin;
          inv_lead = (int)((uintptr_t)gi & 15);
          inv_src = (const unsigned char*)gi - inv_lead;
          inv_bytes = round_up(inv_lead + 2 * min(s.xs, avail - dmin), 16);
        }
        tab[lane] = make_int2(dst + lead,
                              inv_dst + inv_lead + 2 * (k0 + lane));
      }
      const int total = __reduce_add_sync(0xffffffffu, bytes + inv_bytes);
      if (lane == 0) mbar_expect(smem_addr(full + b), total);
      __syncwarp();
      if (lane < kc) {
        bulk_copy(smem_addr(smem + dst), src, bytes, smem_addr(full + b));
        if (inv_bytes)
          bulk_copy(smem_addr(smem + inv_dst), inv_src, inv_bytes,
                    smem_addr(full + b));
      }
    } else {       // a copy of each plane's window, a lane each
      int bytes = 0;
      const unsigned char* src = nullptr;
      const int dst = base + lane * s.pitch;
      if (lane < kc) {
        const uint16_t* g = g_row + (size_t)(k0 + lane) * W;
        const int lead = (int)((uintptr_t)g & 15);
        src = (const unsigned char*)g - lead;
        bytes = round_up(lead + 2 * L, 16);
        tab[lane] = make_int2(dst + lead,
                              dst + lead + 2 * min(dmin + k0 + lane, avail));
      }
      const int total = __reduce_add_sync(0xffffffffu, bytes);
      if (lane == 0) mbar_expect(smem_addr(full + b), total);
      __syncwarp();
      if (lane < kc)
        bulk_copy(smem_addr(smem + dst), src, bytes, smem_addr(full + b));
    }
  };
  if (warp == 0)
    for (int c = 0; c < min(kStages, s.nchunks); ++c) issue(c);

  Pair pr[2];   // forward, inverse
  const int x = 2 * tid;   // the block's columns x and x + 1
  const unsigned xb = smem_addr(smem) + 2 * x;
  // plane k of the inverse view of column x lies in the row for k < kx
  const long long room = (long long)(SPLIT ? avail : L) - x - dmin;
  const int kx = (int)(room < -1 ? -1 : room > D + 1 ? D + 1 : room);
  const bool checked = __any_sync(0xffffffffu, kx - 1 < D);

  for (int c = 0; c < s.nchunks; ++c) {
    const int b = c % kStages, k0 = c * s.planes;
    const int kc = min(s.planes, D - k0);
    const int2* tab = table + b * kMaxPlanes;
    if (warp == 0) {
      if (lane == 0) mbar_wait(smem_addr(full + b), (c / kStages) & 1);
      __syncwarp();
    }
    __syncthreads();   // chunk c is staged; chunk c - 1 is done with
    if (warp == 0 && c >= 1 && c - 1 + kStages < s.nchunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(c - 1 + kStages);
    }
    if (c == 0) {   // plane 0 starts the pair's tracks
      pair_init(pr[0], ld16(xb + tab[0].x), ld16_next(xb + tab[0].x));
      if (INVERSE) {
        int v0, v1;
        inverse_costs<true>(xb + tab[0].y, 0, kx, v0, v1);
        pair_init(pr[1], v0, v1);
      }
    }
    const int kbegin = c == 0 ? 1 : 0;
    if (checked)
      reduce_chunk<INVERSE, true, EVEN>(tab, k0, kbegin, kc, xb, kx, pr);
    else
      reduce_chunk<INVERSE, false, EVEN>(tab, k0, kbegin, kc, xb, kx, pr);
  }

  if (x >= ncol) return;
  int r0[10], r1[10];
  pair_result(pr[0], 0, D, r0);
  pair_result(pr[0], 1, D, r1);
  if (INVERSE) {
    pair_result(pr[1], 0, D, r0 + 5);
    pair_result(pr[1], 1, D, r1 + 5);
  }
  int* o = out + (size_t)row * W + j0 + x;
#pragma unroll
  for (int p = 0; p < (INVERSE ? 10 : 5); ++p, o += n) {
    if (EVEN) {   // x + 1 < ncol: W and the segments are even
      *(int2*)o = make_int2(r0[p], r1[p]);
    } else {
      o[0] = r0[p];
      if (x + 1 < ncol) o[1] = r1[p];
    }
  }
}

template <bool INVERSE, bool EVEN, bool SPLIT>
int launch(const uint16_t* aggr, int* out, int rows, int D, int W, int dmin,
           long long n, const Shape& s, cudaStream_t stream) {
  auto* kernel = wta_kernel<INVERSE, EVEN, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(rows * s.nseg), s.threads, s.smem, stream>>>(
      aggr, out, D, W, dmin, n, s);
  return (int)cudaGetLastError();
}

}  // namespace

// WTA planes of a uint16 (B, H, D, W) volume into out = int32 (5 or 10, B,
// H, W): best, min, sec_min, c1, c2 of the forward view, then of the
// inverse.  Refused (cudaErrorInvalidValue) outside D in 1..16,384 and dmin
// >= 0, or past 2^31 - 1 blocks.  A segment whose one window does not fit
// shared memory stages two (SPLIT), which fit at every D.
extern "C" int sgm_wta_reduce(const void* aggr, void* out, int B, int H,
                              int D, int W, int dmin, int include_inverse,
                              void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  if (D < 1 || D > kMaxD || dmin < 0 ||
      (long long)B * H * ((W + kMaxSegment - 1) / kMaxSegment) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Shape s = shape_of(W, D, dmin);
  const bool split = s.smem > kSmemMax;
  if (split) s = shape_of(W, D, dmin, true);
  if (s.smem > kSmemMax || (split && s.nseg == 1))
    return (int)cudaErrorInvalidValue;
  const bool even = W % 2 == 0 && (uintptr_t)out % 8 == 0 &&
                    (uintptr_t)aggr % 4 == 0;
  const auto* a = (const uint16_t*)aggr;
  auto* o = (int*)out;
  const auto st = (cudaStream_t)stream;
  const int rows = B * H;
  if (split && include_inverse)
    return even ? launch<true, true, true>(a, o, rows, D, W, dmin, n, s, st)
                : launch<true, false, true>(a, o, rows, D, W, dmin, n, s, st);
  if (split)
    return even ? launch<false, true, true>(a, o, rows, D, W, dmin, n, s, st)
                : launch<false, false, true>(a, o, rows, D, W, dmin, n, s, st);
  if (include_inverse)
    return even ? launch<true, true, false>(a, o, rows, D, W, dmin, n, s, st)
                : launch<true, false, false>(a, o, rows, D, W, dmin, n, s, st);
  return even ? launch<false, true, false>(a, o, rows, D, W, dmin, n, s, st)
              : launch<false, false, false>(a, o, rows, D, W, dmin, n, s, st);
}
