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
// Design.  The TPU block keeps a path's state in bytes, (D, P) planes in
// vector registers; here the state is packed too, two disparities to a
// 32-bit register in 16-bit lanes, and the step is Hopper's DPX
// instructions: __viaddmin_u16x2 for min(L(d+-1) + P1, L(d)), __vminu2 for
// the min with pmin + P2, one IADD3 for m + cost + 256 - pmin and one LOP3
// for the & 0xFF and the dead lanes.  Byte lanes (four to a register, the
// TPU's packing) were measured and dropped: on this card the byte min, add
// and saturating add compile to several instructions each, with 25-30
// cycles of latency, where the 16-bit forms are one instruction of 5-8
// (isa_probe.py; PERF.md section 6).  The recurrence is modulo 256 with 255
// sentinels, and m <= prev <= 255, so P1 is clamped to 255 before the loop
// and pmin + P2 kept under 511 without changing m; every 16-bit lane stays
// under 1024 and no add carries into its neighbour.  A P2 that makes
// t = pmin + P2 negative (int32, wrapping, as in the plain version) is
// taken exactly: m is then t, so the step mins with 0 and adds t mod 256;
// a block with such a P2 anywhere takes that longer step.  P1 >= 0.
//
// A path is L lanes of a warp (L = 1, 2, 4 or 8), each holding W words
// (2W disparities, W <= 16): word i of lane g holds d = 2gW + i in its low
// half and d = 2gW + W + i in its high half.  So L(d-1) and L(d+1) of a
// word are the words before and after it, both halves at once, and only
// the lane's two end words take a __byte_perm (and, for L > 1, the
// neighbour lane's end word by one __shfl_up / __shfl_down of width L).
// What bounds a step where the paths leave the schedulers idle is its
// dependent chain (isa_probe.py on the card: ~5 cycles an integer or
// 16-bit min, ~8 a VIADDMNMX, ~25 a shuffle, ~42 a REDUX): pmin -> q -> the min
// with the neighbour mins -> the add -> the mask -> a tree over the W words
// -> the two halves -> the lanes (one round of shuffles, two for L = 8)
// -> pmin.  A step starts its path minimum first; the next step's
// neighbour mins (they need only the new row) and the rings' traffic fill
// the latency of its shuffles.  The first design (a warp per path) put
// seven shuffles on that chain.  Where the paths fill the schedulers (the
// three directions at cone B=32) the instruction rate bounds it, about five
// instructions a word and step, the DPX and __byte_perm ones at half rate
// (measured), and for `chainio` the rings' shared-memory traffic, which
// shares a queue with the shuffles.
// Bytes from device memory (one row in, one row out) never come near.  So
// `chain` is the floor of the recurrence at a launch's shape, `chainio` the
// same once the volume is staged on chip.
//
// L is chosen by the wrapper from the shape (probes/kernels.chain_lanes):
// four, eight where D > 128 (a lane holds at most 32 disparities) or where
// four would give the launch fewer warps than half the card's schedulers.
// More lanes cut a step's instructions but lengthen its chain; on an H100
// two lanes lost at every cone shape of the ladder, eight won only where
// the paths are few (PERF.md section 6).  Dead disparities (d >= D, when
// 2WL > D) are held at 255 every step, so that L(D) reads as a sentinel and
// a dead lane never lowers pmin.
//
// Block: cols final columns x n directions x L lanes, rounded up to whole
// warps (64 threads, 128 where n L > 16: blocks small enough to spread the
// few paths of a cone B=2 launch over the SMs).  Every thread runs the loop
// (the shuffles take full masks); a path past the frame computes on zeros
// and stores nothing.  The block sums its paths' rows per column through
// shared memory, each direction being its own path, so that no chain is
// dead code.
//
// The on-chip volumes of `chainio`.  The TPU version keeps the whole
// (steps, D, P) cost, P2 and output volumes in VMEM; 227 KB of shared memory
// cannot.  Each path stages a ring of R steps: R cost rows and R P2 values,
// read from the (B, R, D, P) and (B, n, R, P) inputs at the columns of the
// path's first R steps before the loop starts, and R uint16 output rows,
// zero at the start.  Step s uses slot s mod R.  The ring travels with the
// path, so for a diagonal the row of slot r serves column
// col_r + roll * R * (s div R) at step s: the plain version in
// probes/kernels.py rolls the ring rows by that amount.  With R = steps the
// ring is the whole volume and the function is the TPU script's.  The block
// stages all its rings at once, neighbouring threads reading neighbouring
// columns.  The cost ring is staged as the step reads it, (cost ^ seed) &
// 0xFF + 256 in the 16-bit halves of the word layout above (the step's add
// then needs no unpacking and no bias), the output ring holds the uint16
// pairs the step makes, read-added with __vadd2.  A thread's words of a
// slot are loaded and stored 16 bytes at a time, a warp's access covering
// consecutive words (no bank conflict).  Each path makes its own row
// store, as each K2 launch makes its own read-modify-write of the volume.
// The `extra` reads are volatile loads, or the compiler would merge them;
// the first two are started a step ahead, right after the store before
// them: a warp runs its instructions in order, and a load waited for
// where it is used puts its latency on the step.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChainP2 = 150;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSentinelPair = 0x00FF00FFu;  // 255 in both halves
constexpr unsigned kLowBytes = 0x00FF00FFu;
constexpr int kMaxRolls = 8;
constexpr int kMaxThreads = 128;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block can take

struct Rolls {
  int r[kMaxRolls];
};

__device__ __forceinline__ int wrap(long long v, int P) {
  int m = (int)(v % P);
  return m < 0 ? m + P : m;
}

__device__ __forceinline__ unsigned both(unsigned v) {  // v < 65536
  return v * 0x00010001u;
}

// Block geometry, the same on the host and in probes/kernels.chain_block.
struct Block {
  int threads, cols, paths;
};

Block chain_block(int n, int L) {
  const int target = n * L <= 16 ? 64 : kMaxThreads;
  const int cols = std::max(1, target / (n * L));
  const int threads = (cols * n * L + 31) / 32 * 32;
  return {threads, cols, threads / L};
}

// The words a lane holds: the smallest power of two with 2 W L >= D.
int chain_words(int D, int L) {
  int W = 1;
  while (2 * W * L < D) W *= 2;
  return W;
}

size_t chain_shared_bytes(int D, int n, int L, int R, bool io) {
  const int W = chain_words(D, L);
  const Block blk = chain_block(n, L);
  const size_t dpad = 2 * (size_t)W * L;
  const size_t ring = (size_t)W * blk.threads * 4;  // a slot of pair words
  size_t bytes = (size_t)blk.paths * dpad * sizeof(int);  // the rows to sum
  if (io)
    bytes += (size_t)R * (2 * ring + (size_t)blk.paths * 4);
  else
    bytes += ring;
  return bytes;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A thread's W words of a ring slot in accesses of V = min(W, 4) words:
// word i of thread t in slot r lies at ((r W / V + i / V) T + t) V + i % V,
// so that a warp's access covers 32 V consecutive words.
template <int W>
__device__ __forceinline__ int ring_word(int slot, int i, int T, int t) {
  constexpr int V = W < 4 ? W : 4;
  return ((slot * (W / V) + i / V) * T + t) * V + i % V;
}

template <int W>
__device__ __forceinline__ void load_slot(const unsigned* ring, int slot,
                                          int T, int t, unsigned (&w)[W]) {
  constexpr int V = W < 4 ? W : 4;
#pragma unroll
  for (int i = 0; i < W; i += V) {
    const unsigned* q = ring + ring_word<W>(slot, i, T, t);
    if (V == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(q);
      w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
    } else if (V == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(q);
      w[i] = v.x, w[i + 1] = v.y;
    } else {
      w[i] = *q;
    }
  }
}

// A vector store each (the compiler, left to itself, split them into
// single-word stores, four-way bank conflicts ahead of the step's
// shuffles in the same queue).
template <int W>
__device__ __forceinline__ void store_slot(unsigned* ring, int slot, int T,
                                           int t, const unsigned (&w)[W]) {
  constexpr int V = W < 4 ? W : 4;
#pragma unroll
  for (int i = 0; i < W; i += V) {
    const unsigned a = smem_addr(ring + ring_word<W>(slot, i, T, t));
    if (V == 4)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
                   "r"(w[i]), "r"(w[i + 1]), "r"(w[i + 2]), "r"(w[i + 3])
                   : "memory");
    else if (V == 2)
      asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(a), "r"(w[i]),
                   "r"(w[i + 1])
                   : "memory");
    else
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(w[i]) : "memory");
  }
}

// The read of a parked row: a real load every time (volatile), V words at
// once.
template <int W>
__device__ __forceinline__ void load_parked(const unsigned* ring, int slot,
                                            int T, int t, unsigned (&w)[W]) {
  constexpr int V = W < 4 ? W : 4;
#pragma unroll
  for (int i = 0; i < W; i += V) {
    const unsigned a = smem_addr(ring + ring_word<W>(slot, i, T, t));
    if (V == 4)
      asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w[i]), "=r"(w[i + 1]), "=r"(w[i + 2]),
                     "=r"(w[i + 3])
                   : "r"(a));
    else if (V == 2)
      asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];"
                   : "=r"(w[i]), "=r"(w[i + 1])
                   : "r"(a));
    else
      asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(w[i]) : "r"(a));
  }
}

// min(L(d-1) + P1, L(d+1) + P1, L(d)) of every word, from the row `cur` and
// the words next to the lane's ends (`below`: the previous lane's last
// word, `above`: the next lane's first).  Word i holds disparities
// 2 g W + i (low half) and 2 g W + W + i (high half), so L(d-1) of word i is
// word i - 1 and L(d+1) word i + 1, except at the two ends, where one
// __byte_perm each joins the halves that meet there.
template <int W>
__device__ __forceinline__ void near_mins(const unsigned (&cur)[W],
                                          unsigned below, unsigned above,
                                          unsigned p1x2, unsigned (&nb)[W]) {
  const unsigned lm0 = __byte_perm(below, cur[W - 1], 0x5432);
  const unsigned lpw = __byte_perm(cur[0], above, 0x5432);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const unsigned lm = i == 0 ? lm0 : cur[i - 1];
    const unsigned lp = i == W - 1 ? lpw : cur[i + 1];
    nb[i] = __viaddmin_u16x2(lp, p1x2, __viaddmin_u16x2(lm, p1x2, cur[i]));
  }
}

// The path minimum in both halves of a word: a tree over the lane's words,
// the two halves, then the path's L lanes: the three other lanes of a
// group of four in one round of shuffles started together (one shuffle's
// latency where a butterfly takes two), and lane 4 apart in a second round
// for L = 8.  (One REDUX.MIN over the path's lanes, 42 cycles, ran several
// times slower with a mask per path: the lanes of a warp that name
// different masks do not reduce at once.)
template <int L, int W>
__device__ __forceinline__ unsigned path_min(unsigned (&w)[W]) {
#pragma unroll
  for (int span = 1; span < W; span *= 2)
#pragma unroll
    for (int i = 0; i + span < W; i += 2 * span)
      w[i] = __vminu2(w[i], w[i + span]);
  unsigned m = __vminu2(w[0], __byte_perm(w[0], 0u, 0x1032));
  if (L == 2) m = __vminu2(m, __shfl_xor_sync(kFull, m, 1, L));
  if (L >= 4) {
    const unsigned a = __shfl_xor_sync(kFull, m, 1, L);
    const unsigned b = __shfl_xor_sync(kFull, m, 2, L);
    const unsigned c = __shfl_xor_sync(kFull, m, 3, L);
    m = __vimin3_u16x2(m, a, __vminu2(b, c));
  }
  if (L == 8) m = __vminu2(m, __shfl_xor_sync(kFull, m, 4, L));
  return m;
}

// The steps of one path.  NEG: the block holds a P2 < 0, so t = pmin + P2
// (int32, wrapping) may be negative, and then m = t: the min is with 0 and
// t mod 256 is added.  Else q = pmin + min(P2, 255) in both halves.
template <int L, int W, bool IO, bool NEG>
__device__ __forceinline__ void walk(unsigned (&prev)[W], unsigned& pm2,
                                     const unsigned (&dead)[W],
                                     const unsigned* cring, const int* pring,
                                     unsigned* oring, int steps, int R,
                                     int extra, unsigned p1x2, int T, int t,
                                     int p, int PB, int g) {
  unsigned cb[W], nb[W];
  load_slot<W>(cring, 0, T, t, cb);  // IO: slot 0's, then a step ahead
  {  // the first step's neighbour mins (zero rows; sentinels, dead lanes)
    unsigned below = kSentinelPair, above = kSentinelPair;
    if (L > 1) {
      const unsigned up = __shfl_up_sync(kFull, prev[W - 1], 1, L);
      const unsigned dn = __shfl_down_sync(kFull, prev[0], 1, L);
      if (g > 0) below = up;
      if (g < L - 1) above = dn;
    }
    near_mins<W>(prev, below, above, p1x2, nb);
  }
  // the sum of the 0, 1, ... that `extra` read-adds add (mod 2^16)
  const unsigned esum =
      both(((unsigned)extra * (unsigned)(extra - 1) / 2) & 0xFFFF);
  int slot = 0;
  int p2 = IO ? pring[p] : kChainP2;
  // the first two read-adds' loads of the parked row, started a step ahead
  // (after the store that leaves the slot as the step finds it), so that
  // their latency hides in the path minimum's
  unsigned park0[W], park1[W];
  if (IO && extra > 0) load_parked<W>(oring, 0, T, t, park0);
  if (IO && extra > 1) load_parked<W>(oring, 0, T, t, park1);
  for (int s = 0; s < steps; ++s) {
    unsigned q2, sub = pm2;
    if (!NEG) {
      q2 = pm2 + both((unsigned)min(p2, 255));
    } else {
      const int tm = (int)((pm2 & 0xFFFF) + (unsigned)p2);
      q2 = both((unsigned)min(max(tm, 0), 255));
      if (tm < 0) sub -= both((unsigned)(tm & 0xFF));
    }
    unsigned cur[W], red[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      cur[i] = ((__vminu2(nb[i], q2) + cb[i] - sub) & kLowBytes) | dead[i];
      red[i] = cur[i];
    }
    // The path minimum first: a warp runs its instructions in order, so
    // what follows it (the next step's neighbour mins, the rings' traffic)
    // fills the latency of its shuffles instead of delaying them.
    const unsigned next_pm2 = path_min<L, W>(red);
    unsigned below = kSentinelPair, above = kSentinelPair;
    if (L > 1) {
      const unsigned up = __shfl_up_sync(kFull, cur[W - 1], 1, L);
      const unsigned dn = __shfl_down_sync(kFull, cur[0], 1, L);
      if (g > 0) below = up;
      if (g < L - 1) above = dn;
    }
    near_mins<W>(cur, below, above, p1x2, nb);  // the next step's
    if (IO) {
      unsigned total[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        total[i] = cur[i];
        if (extra > 0) total[i] = __vadd2(total[i], park0[i]);
        if (extra > 1) total[i] = __vadd2(__vadd2(total[i], park1[i]), esum);
      }
#pragma unroll 1
      for (int e = 2; e < extra; ++e) {
        unsigned parked[W];
        load_parked<W>(oring, slot, T, t, parked);
#pragma unroll
        for (int i = 0; i < W; ++i) total[i] = __vadd2(total[i], parked[i]);
      }
      store_slot<W>(oring, slot, T, t, total);
      if (++slot == R) slot = 0;
      load_slot<W>(cring, slot, T, t, cb);  // the next step's
      p2 = pring[slot * PB + p];
      if (extra > 0) load_parked<W>(oring, slot, T, t, park0);
      if (extra > 1) load_parked<W>(oring, slot, T, t, park1);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) prev[i] = cur[i];
    pm2 = next_pm2;
  }
}

// Thread t of the block: path p = t / L of the block, lane g = t % L of the
// path; path p walks direction k = p % n of final column j0 + p / n.
// Dynamic shared memory, in this order:
//   int      res[paths][2 W L]        the rows to sum per column
//   unsigned cost[R or 1][W][threads]    cost + 256 in both 16-bit halves
//   int      p2[R][paths]                              (IO only)
//   unsigned out[R][W][threads]          uint16 pairs  (IO only)
// (the ring words in ring_word's order).
template <int L, int W, bool IO>
__global__ void __launch_bounds__(kMaxThreads)
chain_kernel(const uint16_t* __restrict__ x, const int* __restrict__ cost_ring,
             const int* __restrict__ p2_ring, uint16_t* __restrict__ out,
             int D, int P, int steps, int n, Rolls rolls, int cols, int R,
             int extra, int p1) {
  constexpr int kDpad = 2 * W * L;
  extern __shared__ int smem[];
  __shared__ int shift[kMaxRolls], step[kMaxRolls];
  const int T = blockDim.x;
  const int PB = T / L;
  const int t = threadIdx.x;
  const int g = t & (L - 1);
  const int p = t / L;
  const int groups = (P + cols - 1) / cols;
  const int b = blockIdx.x / groups;
  const int j0 = (blockIdx.x - b * groups) * cols;

  int* res = smem;
  unsigned* cring = (unsigned*)(res + PB * kDpad);
  int* pring = (int*)(cring + (IO ? R : 1) * W * T);
  unsigned* oring = (unsigned*)(pring + (IO ? R * PB : 0));
  uint16_t* chalf = (uint16_t*)cring;

  // a direction's first column is j - shift, its r-th j - shift + r step
  if (t < n) {
    shift[t] = wrap((long long)rolls.r[t] * (steps - 1), P);
    step[t] = wrap(rolls.r[t], P);
  }
  __syncthreads();
  // Stage the cost halves (and the P2 values, and zero the output ring).
  // A thread takes column c of the block's and rows (k, d) in turn, so
  // that neighbouring threads read neighbouring columns.  Paths past the
  // frame get the bias alone.
  const int c = t % cols;
  const int rows = T / cols;  // threads past rows * cols stage nothing
  const int j = j0 + c;
  const bool in = j < P && t < rows * cols;
  const uint16_t* xb = x + (size_t)b * D * P;
  const int* cb_in = cost_ring + (size_t)b * R * D * P;
  for (int kd = t / cols; kd < n * kDpad && t < rows * cols; kd += rows) {
    const int k = kd / kDpad;
    const int d = kd % kDpad;
    const bool live = in && d < D;
    int col = j - shift[k];
    if (col < 0) col += P;
    const int seed = live ? (xb[(size_t)d * P + col] & 1) : 0;
    const int e = d % (2 * W);
    const int tt = (c * n + k) * L + d / (2 * W);
    const int half = e >= W;
    const int i = e - half * W;
    if (IO) {
      const int* src = cb_in + (size_t)d * P;
      for (int r = 0; r < R; ++r, src += (size_t)D * P) {
        const int v = live ? ((src[col] ^ seed) & 0xFF) : 0;
        chalf[2 * ring_word<W>(r, i, T, tt) + half] = (uint16_t)(v + 0x100);
        col += step[k];
        if (col >= P) col -= P;
      }
    } else {
      chalf[2 * ring_word<W>(0, i, T, tt) + half] =
          (uint16_t)((live ? (((d * 7 + 13) & 0x7F) ^ seed) : 0) + 0x100);
    }
  }
  int neg = 0;
  if (IO) {
    const int* pb_in = p2_ring + (size_t)b * n * R * P;
    for (int kr = t / cols; kr < n * R && t < rows * cols; kr += rows) {
      const int k = kr / R;
      const int r = kr % R;
      int v = 0;
      if (in) {
        int col = j - shift[k] + (int)(((long long)step[k] * r) % P);
        if (col < 0) col += P;
        if (col >= P) col -= P;
        v = pb_in[(size_t)kr * P + col];
      }
      pring[r * PB + c * n + k] = v;
      neg |= v < 0;
    }
    for (int it = t; it < R * W * T; it += T) oring[it] = 0;
  }
  // a P2 < 0 anywhere in the block takes the exact but longer step
  neg = __syncthreads_or(neg);

  const unsigned p1x2 = both((unsigned)min(p1, 255));
  unsigned dead[W], prev[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int d = 2 * g * W + i;
    dead[i] = (d < D ? 0u : 0xFFu) | (d + W < D ? 0u : 0xFF0000u);
    asm volatile("" : "+r"(dead[i]));  // kept in a register, not recomputed
    prev[i] = dead[i];
  }
  unsigned pm2 = 0;  // the path minimum in both halves
  if (IO && neg)
    walk<L, W, IO, true>(prev, pm2, dead, cring, pring, oring, steps, R,
                         extra, p1x2, T, t, p, PB, g);
  else
    walk<L, W, IO, false>(prev, pm2, dead, cring, pring, oring, steps, R,
                          extra, p1x2, T, t, p, PB, g);

  const int last = IO ? (steps - 1) % R : 0;
  const int k = p % n;
  unsigned o[W];
  if (IO) load_slot<W>(oring, last, T, t, o);
  int* row = res + p * kDpad;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int d = 2 * g * W + i;
    unsigned lo, hi;
    if (IO) {
      const unsigned own = k == 0 ? prev[i] : 0u;
      lo = (o[i] & 0xFFFF) + (own & 0xFFFF);
      hi = (o[i] >> 16) + (own >> 16);
    } else {
      lo = (prev[i] & 0xFFFF) + (pm2 & 0xFFFF);
      hi = (prev[i] >> 16) + (pm2 & 0xFFFF);
    }
    row[d] = (int)lo;
    row[d + W] = (int)hi;
  }
  __syncthreads();
  for (int it = t; it < cols * D; it += T) {
    const int cc = it % cols;
    const int d = it / cols;
    const int jj = j0 + cc;
    if (jj >= P) continue;
    int sum = 0;
    for (int k2 = 0; k2 < n; ++k2) sum += res[(cc * n + k2) * kDpad + d];
    out[((size_t)b * D + d) * P + jj] = (uint16_t)sum;
  }
}

template <int L, int W, bool IO>
int launch_chain(const uint16_t* x, const int* cost_ring, const int* p2_ring,
                 uint16_t* out, int B, int D, int P, int steps, int n,
                 const Rolls& rolls, int R, int extra, int p1,
                 cudaStream_t stream) {
  const Block blk = chain_block(n, L);
  const size_t bytes = chain_shared_bytes(D, n, L, R, IO);
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  auto kernel = chain_kernel<L, W, IO>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * ((P + blk.cols - 1) / blk.cols);
  kernel<<<(unsigned)blocks, blk.threads, bytes, stream>>>(
      x, cost_ring, p2_ring, out, D, P, steps, n, rolls, blk.cols, R, extra,
      p1);
  return (int)cudaGetLastError();
}

template <int L, bool IO>
int launch_lanes(const uint16_t* x, const int* cr, const int* pr, uint16_t* o,
                 int B, int D, int P, int steps, int n, const Rolls& rolls,
                 int R, int extra, int p1, cudaStream_t s) {
  switch (chain_words(D, L)) {
#define SGM_CHAIN_WORDS(N)                                                  \
  case N:                                                                   \
    return launch_chain<L, N, IO>(x, cr, pr, o, B, D, P, steps, n, rolls, R, \
                                  extra, p1, s);
    SGM_CHAIN_WORDS(1)
    SGM_CHAIN_WORDS(2)
    SGM_CHAIN_WORDS(4)
    SGM_CHAIN_WORDS(8)
    SGM_CHAIN_WORDS(16)
#undef SGM_CHAIN_WORDS
  }
  return (int)cudaErrorInvalidValue;
}

template <bool IO>
int chain_entry(const void* x, const void* cost_ring, const void* p2_ring,
                void* out, int B, int D, int P, int steps, int n,
                const int* rolls_host, int R, int extra, int p1, int lanes,
                void* stream) {
  if (B * D * P == 0) return 0;
  if (D > 256 || steps < 1 || n < 1 || n > kMaxRolls || R < 1 || extra < 0 ||
      extra > 0xFFFF || p1 < 0 || 32 * lanes < D)
    return (int)cudaErrorInvalidValue;
  Rolls rolls{};
  for (int k = 0; k < n; ++k) rolls.r[k] = rolls_host[k];
  const uint16_t* xs = (const uint16_t*)x;
  const int* cr = (const int*)cost_ring;
  const int* pr = (const int*)p2_ring;
  uint16_t* o = (uint16_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
#define SGM_CHAIN_LANES(N)                                                   \
  case N:                                                                    \
    return launch_lanes<N, IO>(xs, cr, pr, o, B, D, P, steps, n, rolls, R, \
                               extra, p1, s);
    SGM_CHAIN_LANES(1)
    SGM_CHAIN_LANES(2)
    SGM_CHAIN_LANES(4)
    SGM_CHAIN_LANES(8)
#undef SGM_CHAIN_LANES
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: uint16 (B, D, P).  rolls_host: n ints in host memory, the column
// step of each direction (0 straight, +-1 the wrapping diagonals).  p1 >= 0;
// lanes (1, 2, 4 or 8, at least D / 32): a path's lanes, which the wrapper
// chooses from the shape (probes/kernels.chain_lanes).
extern "C" int sgm_probe_chain(const void* x, void* out, int B, int D, int P,
                               int steps, int n, const int* rolls_host,
                               int p1, int lanes, void* stream) {
  return chain_entry<false>(x, nullptr, nullptr, out, B, D, P, steps, n,
                            rolls_host, 1, 0, p1, lanes, stream);
}

// As above, with cost_ring int32 (B, R, D, P) and p2_ring int32
// (B, n, R, P); `extra` uint16 row read-adds per step (0, 1 or 2 in the
// forward, accumulating and backward pass shapes).
extern "C" int sgm_probe_chainio(const void* x, const void* cost_ring,
                                 const void* p2_ring, void* out, int B, int D,
                                 int P, int steps, int n,
                                 const int* rolls_host, int R, int extra,
                                 int p1, int lanes, void* stream) {
  return chain_entry<true>(x, cost_ring, p2_ring, out, B, D, P, steps, n,
                           rolls_host, R, extra, p1, lanes, stream);
}
