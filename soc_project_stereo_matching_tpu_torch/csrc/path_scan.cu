// K2's horizontal pair: both orders of the roll-0 direction on the
// transposed volume, a path's state in a warp's registers, no barrier wider
// than a warp on a step's chain.
//
// Replaces: ops/pallas_kernels.py:500 `_bidir_kernel` (TPU kernel row 3)
//   for the roll-0 pair that `horizontal_partial` runs on the transposed
//   (B, W, D, H) volume.  aggregate.cu's group kernel keeps row 3 for the
//   vertical pair and for the horizontal pair past D = 512 (past it, at a
//   full-size Middlebury frame, the scan's copies and the 25-33 words a
//   lane it would need lose to the group kernel on an H100: 45.8 against
//   44.6 ms at D = 760, 93.9 against 53.8 at D = 1,024).
//
// What it computes.  uint8 cost (B, S, D, H) and image (B, S, H), H a
// multiple of 16: every column h is a path along S, walked forward and in
// reverse with the recurrence of ops/aggregation.py (mod 256, 255 sentinels
// at d = -1 and d = D, P2' = max(P1, P2_init / (|dI| + 1))), and the two
// orders' uint16 sum is stored in (B, S, D, H).  The first pixel of each
// order contributes its raw cost.
//
// What bounds it.  A roll-0 path moves nothing across columns, so the paths
// are independent; the group kernel still gave each step a block barrier
// and a shared-memory round trip for the minimum over D, some 5-9 us a step
// at B = 1.  Here a warp paces itself: the bound is a step's dependent
// chain (pmin -> q -> min -> add -> mask -> a tree over the words -> rounds
// of shuffles -> pmin) and the warp's shared-memory traffic where the paths
// are few, and the bytes where they fill the card (the cost read by both
// orders, half of the sums stored, half added in L2).
//
// Layout.  A pair of neighbouring paths (h, h + 1) is L lanes of a warp;
// lane g holds W words, word i the disparity d = g W + i of both paths, h
// in the low 16-bit half, h + 1 in the high one.  L(d +- 1) is the word
// before or after, and crosses lanes only at a lane's end words, by one
// __shfl_up / __shfl_down of width L.  A step is __viaddmin_u16x2 twice
// (the neighbour minima + P1), __vminu2 with pmin + P2', one IADD3 (the
// cost, the bias of 256 and pmin folded in) and one LOP3 (& 0xFF | the
// dead words' 255) per word; the path minimum is a tree of __vminu2 over the
// words and one round of three shuffles per four lanes.  The two halves are
// two paths, so the sums of a word are the two uint16 of neighbouring
// columns.  L follows D (path_lanes): 4, 8, 16 or 32 lanes for D up to 64,
// 128, 256, 512; W the least of 1, 3, 5, 9, 13, 17 with L W >= D
// (odd: the L lanes' rows, W apart, fall into different banks of the
// slot's 16- and 32-byte rows).  Words past D hold 255 every step.
//
// Both orders in one warp.  The warp walks the forward order at row t and
// the reverse order at row S - 1 - t at the same time t, two independent
// chains that fill each other's latency.  Until they meet every row's sums
// are stored; at t = (S - 1) / 2 with S odd both are at the same row and
// their sum is stored; after that each order's sums are added onto the
// row the other order stored earlier.  S serial steps, no carries, one
// launch.
//
// The volume through the tensor memory accelerator.  A block takes HB = 16
// or 32 columns: HB / PW computing warps, PW = 64 / L columns each, and one
// producer thread.  Each step's rows travel as boxes of a tensor map (16
// bytes of a cost row, 32 of a sums row, D rows a box or boxes of at most
// 256), so no thread spends an instruction a row on them (copies a row an
// instruction by warps of the block's own measured 1.6x slower at KITTI
// B = 1: every row is a line of its own for the load-store unit, whose
// queue the computing warps' shared-memory reads share).  The producer loads step t's cost and gray
// rows of both orders into a ring of R slots in shared memory, R steps
// ahead, completing on the slot's "full" barrier; the computing warps write
// their sums into the slot and arrive on its "done" barrier (one arrival a
// warp, after a proxy fence); the producer then stores the slot's sums
// rows, or, after the meeting, adds them onto the rows stored before (a
// tensor reduce-add of the uint16 pairs as uint32: no half carries, a sum
// is at most 510), after waiting for the bulk group that stored those rows.
// The computing warps wait only on their slot's "full" barrier, for data
// asked for R steps before: no barrier wider than a warp on a step's chain.
// The host chooses the block's columns and R (plan_of).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace {
namespace paths {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPair255 = 0x00FF00FFu;  // sentinel, dead word, byte mask
constexpr unsigned kBias = 0x01000100u;     // 256 in both halves
constexpr int kMaxRange = 512;
constexpr int kPitch = 16;       // H must be a multiple (TRANSPOSED_PITCH)
constexpr int kBoxBytes = 16;    // a cost box's narrowest row: 16 columns
constexpr int kMaxBoxRows = 256; // a tensor map's box takes at most 256 rows
constexpr int kMaxRing = 8;
constexpr int kMinRing = 2;
constexpr int kMaxThreads = (32 / 2 + 1) * 32;  // HB = 32, L = 32: 16 + 1 warps
constexpr int kWideThreads = (16 / 2 + 1) * 32; // W > 13: the registers allow 9
constexpr int kTableBytes = 256 * 4;
constexpr int kRingAt = 2048;    // the ring's offset: the table, the barriers

int path_lanes(int D) { return D <= 64 ? 4 : D <= 128 ? 8 : D <= 256 ? 16 : 32; }

int path_words(int D, int L) {
  const int need = (D + L - 1) / L;
  for (int w : {1, 3, 5, 9, 13, 17})
    if (w >= need) return w;
  return 0;
}

__host__ __device__ constexpr int align512(int n) { return (n + 511) / 512 * 512; }
// The bytes of a cost row in the ring: 16 columns, or the block's HB.
__host__ __device__ constexpr int cost_row(int HB) { return HB < kBoxBytes ? kBoxBytes : HB; }

// Rows a box of the cost and sums maps: D in as few boxes as possible,
// several boxes a multiple of 8 rows each, so that each box's place in
// shared memory is 128-byte aligned, as the tensor copies need.
__host__ __device__ constexpr int box_count(int D) {
  return (D + kMaxBoxRows - 1) / kMaxBoxRows;
}
__host__ __device__ constexpr int box_rows(int D) {
  return box_count(D) == 1
             ? D
             : ((D + box_count(D) - 1) / box_count(D) + 7) / 8 * 8;
}
__host__ __device__ constexpr int ring_rows(int D) {
  return box_count(D) * box_rows(D);
}
// Bytes of one order's part of a ring slot at a block of HB columns: the
// cost rows (cost_row(HB) bytes each), the sums rows (2 HB bytes each), the
// gray row; each at a multiple of 512 bytes (the sums' swizzle below).
__host__ __device__ constexpr int sums_at(int D, int HB) {
  return align512(ring_rows(D) * cost_row(HB));
}
__host__ __device__ constexpr int gray_at(int D, int HB) {
  return sums_at(D, HB) + align512(ring_rows(D) * 2 * HB);
}
__host__ __device__ constexpr int order_bytes(int D, int HB) {
  return gray_at(D, HB) + 512;
}

// The byte of a sums row r (2 HB bytes) at x: with HB = 16 and 32 the map
// stores 32- and 64-byte rows with the tensor copies' 32- and 64-byte
// swizzles (address bit 7 into bit 4, bits 8-7 into bits 5-4: the 16-byte
// pieces of a row change places every 4 or every 2 rows), so that the L
// lanes' rows fall into more banks.
template <int HB>
__device__ __forceinline__ int sums_byte(int r, int x) {
  return r * 2 * HB + (HB == 16 ? x ^ (((r >> 2) & 1) << 4)
                                : x ^ (((r >> 1) & 3) << 4));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void arrive(unsigned bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::
          "r"(bar)
      : "memory");
}

__device__ __forceinline__ void arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of this parity to complete.  A protocol fault traps
// after 2 s instead of hanging the card.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  long long start = -1;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start < 0) start = now;
    else if (now - start > 2000000000LL) __trap();
  }
}

__device__ __forceinline__ void load_box(unsigned dst, const CUtensorMap* map,
                                         int x, int y, int z, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void load_row(unsigned dst, const CUtensorMap* map,
                                         int x, int y, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void store_box(const CUtensorMap* map, int x, int y,
                                          int z, unsigned src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(z), "r"(src)
      : "memory");
}

__device__ __forceinline__ void add_box(const CUtensorMap* map, int x, int y,
                                        int z, unsigned src) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%1, %2, %3}], [%4];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(z), "r"(src)
      : "memory");
}

// Until at most `pending` (0 .. 7) of this thread's newest bulk groups are
// not complete (their writes done).
__device__ __forceinline__ void wait_groups(int pending) {
  switch (pending < 0 ? 0 : pending > 7 ? 7 : pending) {
#define SGM_WAIT(N) \
  case N: asm volatile("cp.async.bulk.wait_group " #N ";" ::: "memory"); break;
    SGM_WAIT(0) SGM_WAIT(1) SGM_WAIT(2) SGM_WAIT(3) SGM_WAIT(4) SGM_WAIT(5)
    SGM_WAIT(6) SGM_WAIT(7)
#undef SGM_WAIT
  }
}

// Two bytes (the low half of x) into the two 16-bit halves.
__device__ __forceinline__ unsigned spread(unsigned x) {
  return __byte_perm(x, 0u, 0x4140);
}

// min over the path's L lanes (L >= 4), in both halves: three shuffles a
// round, started together.
template <int L>
__device__ __forceinline__ unsigned lanes_min(unsigned m) {
  {
    const unsigned a = __shfl_xor_sync(kFull, m, 1, L);
    const unsigned b = __shfl_xor_sync(kFull, m, 2, L);
    const unsigned c = __shfl_xor_sync(kFull, m, 3, L);
    m = __vimin3_u16x2(m, a, __vminu2(b, c));
  }
  if (L == 8) m = __vminu2(m, __shfl_xor_sync(kFull, m, 4, L));
  if (L >= 16) {
    const unsigned a = __shfl_xor_sync(kFull, m, 4, L);
    const unsigned b = __shfl_xor_sync(kFull, m, 8, L);
    const unsigned c = __shfl_xor_sync(kFull, m, 12, L);
    m = __vimin3_u16x2(m, a, __vminu2(b, c));
  }
  if (L == 32) m = __vminu2(m, __shfl_xor_sync(kFull, m, 16, L));
  return m;
}

template <int W>
__device__ __forceinline__ unsigned words_min(const unsigned (&w)[W]) {
  unsigned t[W];
#pragma unroll
  for (int i = 0; i < W; ++i) t[i] = w[i];
#pragma unroll
  for (int span = 1; span < W; span *= 2)
#pragma unroll
    for (int i = 0; i + span < W; i += 2 * span) t[i] = __vminu2(t[i], t[i + span]);
  return t[0];
}

// min(L(d-1) + P1, L(d+1) + P1, L(d)) of every word; the lane's end words
// take the neighbour lane's, or the 255 sentinel at the path's ends.
template <int L, int W>
__device__ __forceinline__ void near_mins(const unsigned (&cur)[W], int g,
                                          unsigned p1x2, unsigned (&nb)[W]) {
  const unsigned up = __shfl_up_sync(kFull, cur[W - 1], 1, L);
  const unsigned dn = __shfl_down_sync(kFull, cur[0], 1, L);
  const unsigned below = g > 0 ? up : kPair255;
  const unsigned above = g < L - 1 ? dn : kPair255;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const unsigned lm = i == 0 ? below : cur[i - 1];
    const unsigned lp = i == W - 1 ? above : cur[i + 1];
    nb[i] = __viaddmin_u16x2(lp, p1x2, __viaddmin_u16x2(lm, p1x2, cur[i]));
  }
}

// Block: columns [h0, h0 + HB) of image b (HB = 16 or 32); warps 0 ..
// NW - 1 compute (warp w: columns w PW .. + PW of the block, lane = grp L + g
// holding the words of columns 2 grp and 2 grp + 1 of them), warp NW's lane
// 0 produces.
// Dynamic shared memory: the P2' table (256 ints), the barriers full[R]
// and done[R], then from kRingAt R slots, a slot two orders of
// order_bytes(D, HB): the cost rows, the sums rows, the gray row.
template <int L, int W, int HB>
__global__ void __launch_bounds__(W > 13 ? kWideThreads : kMaxThreads)
scan_kernel(const __grid_constant__ CUtensorMap cost_map,
            const __grid_constant__ CUtensorMap img_map,
            const __grid_constant__ CUtensorMap out_map, int B, int S, int D,
            int H, int p1, int p2_init, int neg, int R) {
  constexpr int PW = 64 / L;
  constexpr int NW = HB / PW;
  constexpr int CB = cost_row(HB);
  extern __shared__ __align__(1024) unsigned char smem[];
  int* table = reinterpret_cast<int*>(smem);
  const unsigned bars = smem_addr(smem + kTableBytes);  // full[R], done[R]
  unsigned char* ring = smem + kRingAt;
  const unsigned ring_s = smem_addr(ring);
  const int tid = threadIdx.x;
  for (int k = tid; k < 256; k += blockDim.x) {
    const int v = max(p1, p2_init / (k + 1));
    table[k] = neg ? v : min(v, 255);
  }
  if (tid < R) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bars + 8 * tid),
                 "r"(2));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     bars + 8 * (R + tid)),
                 "r"(NW));
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();  // the block's only barrier, before any step

  const int lane = tid & 31;
  const int wib = tid >> 5;
  const int per_image = (H + HB - 1) / HB;  // the last block may pass H
  const int b = blockIdx.x / per_image;
  const int h0 = blockIdx.x % per_image * HB;
  const int hbox = h0 & ~(CB - 1);  // the cost box's first column
  const int ob = order_bytes(D, HB);
  const int s_at = sums_at(D, HB);
  const int g_at = gray_at(D, HB);

  if (wib == NW) {  // the producer
    if (lane != 0) return;
    const int rows = box_rows(D);
    const int boxes = box_count(D);
    const unsigned tx = 2u * (unsigned)(ring_rows(D) * CB + CB);
    // step t's cost and gray rows of both orders (forward row t, reverse
    // row S - 1 - t) into its slot, completing on its full barrier with
    // the arrival that says the slot's sums are read out (two arrivals)
    auto load = [&](int t) {
      const int slot = t % R;
      arrive_expect(bars + 8 * slot, tx);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int r = b * S + (o ? S - 1 - t : t);
        const unsigned base = ring_s + (unsigned)((slot * 2 + o) * ob);
        for (int k = 0; k < boxes; ++k)
          load_box(base + k * rows * CB, &cost_map, hbox, k * rows, r,
                   bars + 8 * slot);
        load_row(base + g_at, &img_map, hbox, r, bars + 8 * slot);
      }
    };
    for (int t = 0; t < R && t < S; ++t) {
      load(t);
      arrive(bars + 8 * t);
    }
    for (int u = 0; u < S; ++u) {
      const int slot = u % R;
      wait_phase(bars + 8 * (R + slot), (u / R) & 1);
      if (u + R < S) load(u + R);  // into the cost and gray rows, free now
      // step u's sums rows: the forward order's row u, the reverse order's
      // row S - 1 - u; stored until the meeting (at the meeting row the
      // forward order's rows hold both orders' sum), then added onto the
      // rows stored at step S - 1 - u, whose bulk group has to be complete
      const bool after = u > S - 1 - u;
      if (after) wait_groups(2 * u - S);
      for (int o = 0; o < (u == S - 1 - u ? 1 : 2); ++o) {
        const int r = b * S + (o ? S - 1 - u : u);
        const unsigned src = ring_s + (unsigned)((slot * 2 + o) * ob + s_at);
        for (int k = 0; k < boxes; ++k) {
          const unsigned at = src + k * rows * 2 * HB;
          if (after) add_box(&out_map, h0 / 2, k * rows, r, at);
          else store_box(&out_map, h0 / 2, k * rows, r, at);
        }
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the previous step's sums are read out of its slot: the slot's
      // second arrival, for its next step
      if (u > 0 && u - 1 + R < S) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        arrive(bars + 8 * ((u - 1) % R));
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  const int grp = lane / L;
  const int g = lane % L;
  const int col = wib * PW + 2 * grp;  // the pair's first column in the block
  const unsigned p1x2 = (unsigned)min(p1, 255) * 0x00010001u;
  unsigned dead[W], nb[2][W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    dead[i] = g * W + i < D ? 0u : kPair255;
    asm volatile("" : "+r"(dead[i]));  // kept in a register
    nb[0][i] = nb[1][i] = dead[i];
  }
  unsigned pm[2] = {0u, 0u};      // the path minima, both halves
  unsigned gprev[2] = {0u, 0u};   // the previous pixels' gray, both halves
  const int cost0 = g * W * CB + (h0 - hbox) + col;  // row g W's pair

  for (int t = 0; t < S; ++t) {
    const int slot = t % R;
    wait_phase(bars + 8 * slot, (t / R) & 1);
    unsigned char* sl = ring + slot * 2 * ob;
    unsigned cur[2][W];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const unsigned char* base = sl + o * ob;
      const unsigned gp =
          spread(*reinterpret_cast<const uint16_t*>(base + g_at + (h0 - hbox) + col));
      const unsigned diff = __vabsdiffu2(gp, gprev[o]);
      gprev[o] = gp;
      const int p2l = table[diff & 0xFFFFu];
      const int p2h = table[diff >> 16];
      unsigned q2, sub;
      if (!neg) {
        q2 = pm[o] + ((unsigned)p2l | ((unsigned)p2h << 16));
        sub = pm[o] - kBias;
      } else {  // t = pmin + P2' may wrap negative (int32): then m = t
        const int tl = (int)((pm[o] & 0xFFFFu) + (unsigned)p2l);
        const int th = (int)((pm[o] >> 16) + (unsigned)p2h);
        q2 = (unsigned)min(max(tl, 0), 255) |
             ((unsigned)min(max(th, 0), 255) << 16);
        sub = pm[o] - kBias -
              ((tl < 0 ? (unsigned)(tl & 0xFF) : 0u) |
               (th < 0 ? (unsigned)(th & 0xFF) << 16 : 0u));
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        unsigned cb = 0u;  // a dead word's row is not read
        if (g * W + i < D)
          cb = spread(*reinterpret_cast<const uint16_t*>(base + cost0 + i * CB));
        cur[o][i] = ((__vminu2(nb[o][i], q2) + cb - sub) & kPair255) | dead[i];
      }
    }
    // the path minima first: the neighbour minima and the sums fill the
    // latency of their shuffles
    const unsigned m0 = words_min<W>(cur[0]);
    const unsigned m1 = words_min<W>(cur[1]);
    pm[0] = lanes_min<L>(m0);
    pm[1] = lanes_min<L>(m1);
    near_mins<L, W>(cur[0], g, p1x2, nb[0]);
    near_mins<L, W>(cur[1], g, p1x2, nb[1]);

    // the rows' sums into the slot for the producer: each order's own, at
    // the meeting row both orders' in the forward order's rows
    const bool meet = t == S - 1 - t;
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (g * W + i < D) {
        const int at = s_at + sums_byte<HB>(g * W + i, 2 * col);
        unsigned* f = reinterpret_cast<unsigned*>(sl + at);
        unsigned* r = reinterpret_cast<unsigned*>(sl + ob + at);
        if (meet) {
          *f = cur[0][i] + cur[1][i];
        } else {
          *f = cur[0][i];
          *r = cur[1][i];
        }
      }
    // the sums seen by the tensor stores (the async proxy), then one
    // arrival for the warp
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) arrive(bars + 8 * (R + slot));
  }
}

struct Plan {
  int lanes, words, width, warps, ring, blocks;
  size_t smem;
};

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                        int, int, int, int, int, int, int, int);

// The kernel of lanes, words and a block's columns (path_lanes,
// path_words, plan_of); nullptr where the registers of W > 13 allow no
// block of 32 columns.
Kernel kernel_of(int L, int W, int HB) {
#define SGM_PATHS(l, w, hb) \
  if (L == l && W == w && HB == hb) return scan_kernel<l, w, hb>;
#define SGM_WIDTHS(l, w) SGM_PATHS(l, w, 16) SGM_PATHS(l, w, 32)
  SGM_WIDTHS(4, 1)
  SGM_WIDTHS(4, 3)
  SGM_WIDTHS(4, 5)
  SGM_WIDTHS(4, 9)
  SGM_WIDTHS(4, 13)
  SGM_WIDTHS(4, 17)
  SGM_WIDTHS(8, 9)
  SGM_WIDTHS(8, 13)
  SGM_WIDTHS(8, 17)
  SGM_WIDTHS(16, 9)
  SGM_WIDTHS(16, 13)
  SGM_WIDTHS(16, 17)
  SGM_WIDTHS(32, 9)
  SGM_WIDTHS(32, 13)
  SGM_PATHS(32, 17, 16)
#undef SGM_WIDTHS
#undef SGM_PATHS
  return nullptr;
}

// A launch's geometry: blocks of HB columns (16 or 32, at least a warp's
// 64 / L; the last block may pass H), HB / PW computing warps and the
// producer's.  HB: the fewest computing warps an SM takes (blocks an SM
// times the warps a block), the wider block where two tie (fewer tensor
// copies for the same columns).  The ring: the shallowest where the blocks
// fill nine tenths of the SMs or more, else the deepest (up to kMaxRing)
// with which every block is resident at once (registers and shared memory,
// as the runtime counts them), else 4.
int plan_of(int B, int D, int H, Plan* plan) {
  const int L = path_lanes(D);
  const int W = path_words(D, L);
  int dev = 0, sms = 0, smem_block = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int PW = 64 / L;
  int HB = 0;
  long long best = 0;
  for (int hb : {32, 16}) {
    if (kernel_of(L, W, hb) == nullptr) continue;
    const long long blocks = (long long)B * ((H + hb - 1) / hb);
    const long long load = (blocks + sms - 1) / sms * (hb / PW);
    if (HB == 0 || load < best) HB = hb, best = load;
  }
  if (HB == 0) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_of(L, W, HB);
  err = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_block);
  if (err != cudaSuccess) return (int)err;
  const int warps = HB / PW + 1;
  const long long blocks = (long long)B * ((H + HB - 1) / HB);
  auto smem_of = [&](int R) {
    return (size_t)kRingAt + 2 * (size_t)R * order_bytes(D, HB);
  };
  // a full card takes the shallowest ring (measured fastest there: fewer
  // tensor copies in flight); a card with SMs to spare the deepest that
  // keeps every block resident
  int R = 0;
  if (blocks * 10 >= (long long)sms * 9 &&
      smem_of(kMinRing) <= (size_t)smem_block)
    R = kMinRing;
  for (int r = kMaxRing; R == 0 && r >= kMinRing; --r) {
    if (smem_of(r) > (size_t)smem_block) continue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)kernel, warps * 32, smem_of(r));
    if (err != cudaSuccess) return (int)err;
    if ((long long)per_sm * sms >= blocks) R = r;
  }
  if (R == 0) R = 4;
  if (smem_of(R) > (size_t)smem_block) return (int)cudaErrorInvalidValue;
  *plan = {L, W, HB, warps, R, (int)blocks, smem_of(R)};
  return 0;
}

// The driver's tensor-map encoder, through the runtime (no libcuda link).
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    cudaDriverEntryPointQueryResult found;
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (PFN_cuTensorMapEncodeTiled_v12000)p;
  });
  return fn;
}

// A tensor map of rank 2 or 3 over a row-major array: dims innermost
// first, strides (bytes) of the outer dims, a box of `box` elements.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                const void* base, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const auto encode = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace paths
}  // namespace

// The plan of a launch: plan[0..6] = lanes a pair of paths, words a lane,
// columns a block, warps a block, ring slots, blocks, shared bytes a block.
extern "C" int sgm_path_scan_plan(int B, int D, int H, int* plan) {
  if (B < 1 || D < 1 || D > paths::kMaxRange || H < 1 ||
      H % paths::kPitch != 0)
    return (int)cudaErrorInvalidValue;
  // cached by device and shape: the search asks the runtime for occupancy
  static std::mutex lock;
  static std::map<std::tuple<int, int, int, int>, paths::Plan> plans;
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  const auto key = std::make_tuple(dev, B, D, H);
  std::lock_guard<std::mutex> hold(lock);
  auto it = plans.find(key);
  if (it == plans.end()) {
    paths::Plan p;
    const int err = paths::plan_of(B, D, H, &p);
    if (err != 0) return err;
    it = plans.emplace(key, p).first;
  }
  const paths::Plan& p = it->second;
  plan[0] = p.lanes, plan[1] = p.words, plan[2] = p.width, plan[3] = p.warps;
  plan[4] = p.ring, plan[5] = p.blocks, plan[6] = (int)p.smem;
  return 0;
}

// cost: uint8 (B, S, D, H); img: uint8 (B, S, H); out: uint16 (B, S, D, H),
// the sum of the forward and reverse scans along S; H a multiple of 16, the
// pointers 16-byte aligned; 1 <= D <= 512; 0 <= p1 <= INT_MAX - 255,
// p2_init >= 0.
extern "C" int sgm_path_scan(const void* cost, const void* img, void* out,
                             int B, int S, int D, int H, int p1, int p2_init,
                             void* stream) {
  if (B * S == 0) return 0;
  if (S < 0 || p1 < 0 || p1 > INT_MAX - 255 || p2_init < 0)
    return (int)cudaErrorInvalidValue;
  int plan[7];
  const int err = sgm_path_scan_plan(B, D, H, plan);
  if (err != 0) return err;
  const paths::Plan p{plan[0], plan[1], plan[2], plan[3],
                      plan[4], plan[5], (size_t)plan[6]};
  // the maps: cost (H, D, B S) bytes and image (H, B S) bytes in boxes of
  // cost_row(HB) columns, sums (H / 2, D, B S) uint32 pairs in boxes of
  // HB / 2 pairs, swizzled as sums_byte; box_rows(D) rows a box
  const cuuint64_t bs = (cuuint64_t)B * S, h = (cuuint64_t)H;
  const cuuint32_t rows = (cuuint32_t)paths::box_rows(D);
  const cuuint64_t cost_dims[3] = {h, (cuuint64_t)D, bs};
  const cuuint64_t cost_strides[2] = {h, h * D};
  const cuuint32_t cb = (cuuint32_t)paths::cost_row(p.width);
  const cuuint32_t cost_box[3] = {cb, rows, 1};
  const cuuint64_t img_dims[2] = {h, bs};
  const cuuint64_t img_strides[1] = {h};
  const cuuint32_t img_box[2] = {cb, 1};
  const cuuint64_t out_dims[3] = {h / 2, (cuuint64_t)D, bs};
  const cuuint64_t out_strides[2] = {2 * h, 2 * h * D};
  const cuuint32_t out_box[3] = {(cuuint32_t)p.width / 2, rows, 1};
  CUtensorMap maps[3];
  if (!paths::tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, cost,
                         cost_dims, cost_strides, cost_box) ||
      !paths::tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, img,
                         img_dims, img_strides, img_box) ||
      !paths::tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, out,
                         out_dims, out_strides, out_box,
                         p.width == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                       : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  // a P2' with pmin + P2' past INT_MAX takes the wrapping step
  int neg = std::max(p1, p2_init) > INT_MAX - 255;
  int R = p.ring;
  void* args[] = {&maps[0], &maps[1], &maps[2], &B, &S, &D, &H, &p1, &p2_init,
                  &neg, &R};
  const cudaError_t lerr = cudaLaunchKernel(
      (const void*)paths::kernel_of(p.lanes, p.words, p.width), dim3(p.blocks),
      dim3(p.warps * 32), args, p.smem, (cudaStream_t)stream);
  return lerr != cudaSuccess ? (int)lerr : (int)cudaGetLastError();
}
