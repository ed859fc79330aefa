// P4: the SGM recurrence in 16-bit lanes: the rung ladder and `scan16`.
//
// Replaces: scripts/mosaic_int16_probe.py, the pallas_call in `compile_probe`
//   with its rung bodies `k_p0` .. `k_p10` and `k_p5b`, and rung p7, the group
//   scan with 16-bit state: the `compute16=True` branch of
//   `_scan_group_kernel` in
//   soc_project_stereo_matching_tpu/ops/pallas_kernels.py.
//
// On the TPU a rung is a compile that must not crash.  Here every rung is a
// kernel that must give the right numbers: each is one 16-bit operation of
// the recurrence on values packed two to a 32-bit register, the even
// disparity in the low half, as the TPU packs a sublane pair.
//
//   p0   widen uint8 and store
//   p1   x + (x shifted by 1 along the path axis W)
//   p2   x + (x shifted by 2 along D): an even shift moves whole registers
//   p3   x + (x shifted by 1 along D): an odd shift weaves the halves of two
//        registers, __byte_perm(a, b, 0x5432)
//   p4   the shift by 1 along D with the 255 sentinel selected in at d = 0
//   p5   a 16-bit state carried through a loop over rows: s = min(s, x + 1)
//   p5b  the same loop with s = s + x
//   p6   the circular doubling-tree min over D (shifts 1, 2, 4, ...)
//   p8   min(x, y), y = x shifted along W: __vminu2
//   p9   compare and select: __vcmpltu2 and a mask
//   p10  the arithmetic min y + ((x - y) & ((x - y) >> 15))
//
// `scan16` is p7: a group of up to three vertical directions that share a
// scan order over a (B, S, D, W) cost volume, in one launch on the frame of
// the shipped group scan (group_kernel in csrc/aggregate.cu: a cluster of
// blocks per image with column strips, the cost slab staged by cp.async, the
// strip-edge column handed over by st.async onto transaction barriers, the
// sum written once), with the TPU's packing: a thread owns one column and a
// chunk of D, two disparities to a 32-bit register, the state 16-bit in
// shared memory.  L(d-1) and L(d+1) are each one __byte_perm of neighbouring
// registers, the three mins, the adds and the subtract are two-lane
// instructions (__vminu2, __viaddmin_u16x2), and P2' and the path minimum,
// which belong to the column, are the same in both halves.  Every
// intermediate is at most 255 + 255 + max(P1, P2), and `& 0xFF` is a mask of
// both halves, so 16 bits are exact; the wrapper refuses penalties that
// could overflow.  The shipped kernel packs two COLUMNS to a register and
// keeps byte state in shared memory; that difference is what the probe
// measures.
//
// What bounds it on the H100: what bounds the group scan, a step's fixed
// latency (a block-wide barrier, the hand-off, the set-up of a step) times S
// steps, not bytes; see PERF.md for its time beside the group scan's.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kSentinel2 = 0x00FF00FFu;  // 255 in both halves
constexpr unsigned kLow = 0x0000FFFFu;
constexpr unsigned kHigh = 0xFFFF0000u;

__device__ __forceinline__ unsigned both(int v) {
  return (unsigned)v * 0x00010001u;
}

// (a's high half, b's low half): the packed pair one disparity further on.
__device__ __forceinline__ unsigned weave(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5432);
}

// ---- the rungs ----------------------------------------------------------------

// Pair dp (rows 2 dp, 2 dp + 1) of column w of a uint8 (D, W) plane.
__device__ __forceinline__ unsigned load_pair(const uint8_t* x, int W, int dp,
                                              int w) {
  return (unsigned)x[(size_t)(2 * dp) * W + w] |
         ((unsigned)x[(size_t)(2 * dp + 1) * W + w] << 16);
}

__device__ __forceinline__ int mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Pair dp of the packed column `col` (D/2 words at stride `stride`) shifted
// by `shift` along D, circularly: result[d] = col[d - shift].
__device__ __forceinline__ unsigned shift_d(const unsigned* col, int stride,
                                            int half, int dp, int shift) {
  shift = mod(shift, 2 * half);
  if (shift % 2 == 0) return col[mod(dp - shift / 2, half) * stride];
  const unsigned odd = col[mod(dp - (shift + 1) / 2, half) * stride];
  const unsigned even = col[mod(dp - (shift - 1) / 2, half) * stride];
  return weave(odd, even);
}

// One (D, W) plane per blockIdx.y; a block takes 32 columns and all D/2
// pairs, which it first packs into shared memory: buf[2][D/2][32].
template <int RUNG>
__global__ void rung_plane_kernel(const uint8_t* __restrict__ x,
                                  uint16_t* __restrict__ out, int D, int W) {
  extern __shared__ unsigned buf[];
  const int half = D / 2;
  const uint8_t* xp = x + (size_t)blockIdx.y * D * W;
  uint16_t* op = out + (size_t)blockIdx.y * D * W;
  const int tx = threadIdx.x;
  const int w = blockIdx.x * 32 + tx;
  const bool live = w < W;
  unsigned* cur = buf;
  unsigned* nxt = buf + half * 32;
  for (int dp = threadIdx.y; dp < half; dp += blockDim.y)
    cur[dp * 32 + tx] = live ? load_pair(xp, W, dp, w) : 0u;
  __syncthreads();

  if (RUNG == 6) {  // min over D by doubling shifts, in place of a reduction
    for (int shift = 1; shift < D; shift *= 2) {
      for (int dp = threadIdx.y; dp < half; dp += blockDim.y)
        nxt[dp * 32 + tx] = __vminu2(cur[dp * 32 + tx],
                                     shift_d(cur + tx, 32, half, dp, shift));
      __syncthreads();
      unsigned* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  if (!live) return;
  const int wl = mod(w - 1, W);  // the column a shift by 1 along W brings
  for (int dp = threadIdx.y; dp < half; dp += blockDim.y) {
    const unsigned xs = RUNG == 6 ? load_pair(xp, W, dp, w) : cur[dp * 32 + tx];
    unsigned r = xs;
    if (RUNG == 1) r = __vadd2(xs, load_pair(xp, W, dp, wl));
    if (RUNG == 2) r = __vadd2(xs, shift_d(cur + tx, 32, half, dp, 2));
    if (RUNG == 3) r = __vadd2(xs, shift_d(cur + tx, 32, half, dp, 1));
    if (RUNG == 4) {
      r = shift_d(cur + tx, 32, half, dp, 1);
      if (dp == 0) r = (r & kHigh) | (kSentinel2 & kLow);
    }
    if (RUNG == 6) r = __vadd2(xs, cur[dp * 32 + tx]);
    if (RUNG == 8) r = __vminu2(xs, load_pair(xp, W, dp, wl));
    if (RUNG == 9) {
      const unsigned y = load_pair(xp, W, dp, wl);
      const unsigned less = __vcmpltu2(xs, y);  // 0xFFFF where x < y
      r = (xs & less) | (y & ~less);
    }
    if (RUNG == 10) {
      const unsigned y = load_pair(xp, W, dp, wl);
      const unsigned diff = __vsub2(xs, y);
      // (diff >> 15) per signed half: all ones where the half is negative
      const unsigned sign = ((diff >> 15) & 0x00010001u) * 0xFFFFu;
      r = __vadd2(y, diff & sign);
    }
    op[(size_t)(2 * dp) * W + w] = (uint16_t)(r & kLow);
    op[(size_t)(2 * dp + 1) * W + w] = (uint16_t)(r >> 16);
  }
}

// p5 / p5b: a (1, W) 16-bit state carried over `rows` rows; a thread holds
// two neighbouring columns in one register.
template <bool ADD>
__global__ void rung_loop_kernel(const uint8_t* __restrict__ x,
                                 uint16_t* __restrict__ out, int rows, int W) {
  const int w = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (w >= W) return;
  const bool pair = w + 1 < W;
  const uint8_t* xp = x + (size_t)blockIdx.y * rows * W;
  uint16_t* op = out + (size_t)blockIdx.y * rows * W;
  unsigned state = 0;
  for (int s = 0; s < rows; ++s) {
    const size_t at = (size_t)s * W + w;
    const unsigned xs =
        (unsigned)xp[at] | (pair ? (unsigned)xp[at + 1] << 16 : 0u);
    state = ADD ? __vadd2(state, xs) : __vminu2(state, __vadd2(xs, both(1)));
    const unsigned r = __vadd2(xs, state);
    op[at] = (uint16_t)(r & kLow);
    if (pair) op[at + 1] = (uint16_t)(r >> 16);
  }
}

template <int RUNG>
int launch_plane(const uint8_t* x, uint16_t* out, int B, int D, int W,
                 cudaStream_t stream) {
  const int half = D / 2;
  const dim3 block(32, half < 32 ? half : 32);
  const dim3 grid((W + 31) / 32, B);
  rung_plane_kernel<RUNG><<<grid, block, 2 * half * 32 * sizeof(unsigned),
                            stream>>>(x, out, D, W);
  return (int)cudaGetLastError();
}

// ---- scan16: the group scan on the cluster frame, packed along D ----------
//
// The frame is group_kernel's (csrc/aggregate.cu): a cluster of CS blocks per
// image, block r owning the column strip [r*TW, (r+1)*TW); the cost slab of a
// step staged by 16-byte cp.async from aligned-down addresses into a ring of
// NST buffers; the one column of state that crosses a strip edge handed to the
// neighbour by st.async onto a transaction barrier (three slots, a token per
// step); the sum of the group written once.  What differs is the packing: a
// thread owns ONE column and a chunk of PC disparity pairs, a pair (2p, 2p+1)
// in the halves of a 32-bit word, as the TPU packs a sublane pair.  The state
// is that word in shared memory, (2 buffers, n, D/2 + 2 rows, TW + 2 words):
// rows 0 and D/2 + 1 are 255 sentinels, so L(d - 1) and L(d + 1) of a pair
// are weave(word[p - 1], word[p]) and weave(word[p], word[p + 1]) of a
// sliding window, with no edge case.  P2' and the path minimum belong to the
// column, so both halves share them.  For odd D the high half of the last
// pair is a dead lane held at 255.
//
// 16-bit state takes twice the shared memory of group_kernel's byte state:
// at 1000x1500, D = 256 one direction fills a block of a 16-cluster, so the
// capacity entry says how many directions a launch takes and the wrapper
// splits the group.  Where the grid has more blocks than the card has SMs,
// a block takes fewer chunks so that two fit on an SM (one wave at cone
// B = 32).  The cp.async, mbarrier and st.async helpers repeat
// aggregate.cu's: a header shared with the main path's scan would change
// that file's build, which this probe leaves as it is.

namespace cg = cooperative_groups;

constexpr int kMaxDirs = 3;          // directions of one launch
constexpr int kMaxCluster = 16;      // 8 is the portable limit
constexpr int kMaxStages = 4;        // cost slabs in flight
constexpr int kMaxChunks = 8;        // chunks of a column's pairs
constexpr int kScanThreads = 768;    // most threads of a block
constexpr int kClampP = 1024;        // P1, P2' beyond 255 never win a min
constexpr long long kWaitCycles = 1LL << 32;   // about 2 s
constexpr long long kHeavyStrip = 16384;       // columns x D of a strip
constexpr int kSmemMax = 232448;     // 227 KB, the most a block can take
constexpr int kSlots = 3;            // hand-off buffers
constexpr int kHeader = 576;         // table, barriers, tokens

struct Scan16Args {
  const uint8_t* cost;   // (B, S, D, W)
  const uint8_t* img;    // (B, S, W)
  uint16_t* out;         // (B, S, D, W)
  int B, S, D, W;
  int rolls[kMaxDirs];
  int reverse, restart, p1, p2_init, accumulate;
  int sms;       // of the card
  // the launch shape
  int TW;        // columns of a strip
  int NCH, PC;   // chunks of a column's D2 = ceil(D / 2) pairs, pairs each
  int NST;       // cost slabs in the ring
  int pitchC;    // bytes of a slab row (multiple of 16)
  int pitchS;    // words of a state row: TW + 2, the strip at word 1
  int pitchM;    // uint16 of a partial-min row: TW + 2, the strip at 1
  int stage_off; // the staged outgoing columns, (n, col_bytes)
  int col_bytes; // a handed-over column's words: NCH * PC, in sixteens
  int recv_off;  // the hand-off buffers, (slots, n, recv_dir)
  int recv_dir;  // 16 sentinel bytes, the column, 16 sentinel bytes, mins
  int smem_bytes;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` (0..2) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
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

// Spins; a peer that never answers is a fault of the protocol, and the
// kernel traps rather than hang the card.
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

// One word into a peer's shared memory, counted on the peer's barrier.
__device__ __forceinline__ void send_word(unsigned peer_dst, unsigned value,
                                          unsigned peer_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(peer_dst),
      "r"(value), "r"(peer_bar)
      : "memory");
}

// Sixteen bytes into a peer's shared memory (16-byte aligned there).
__device__ __forceinline__ void send_vec(unsigned peer_dst, const unsigned* w,
                                         unsigned peer_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(peer_dst),
      "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(peer_bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ int strip_cols(int rank, int TW, int W) {
  return min(W, (rank + 1) * TW) - rank * TW;
}

// ODD: D is odd, so the high half of the last pair is a dead lane.
template <int N, bool ODD>
__global__ void __launch_bounds__(kScanThreads)
scan16_kernel(const Scan16Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int D = a.D, W = a.W, S = a.S;
  const int D2 = (D + 1) / 2;
  const int pitchS = a.pitchS, pitchC = a.pitchC, pitchM = a.pitchM;

  // shared memory, by byte offset (Scan16Args and scan16_shape agree on it)
  uint16_t* lut = (uint16_t*)smem;                              // 256
  unsigned long long* bars = (unsigned long long*)(smem + 512); // kSlots
  unsigned* tokens = (unsigned*)(smem + 544);                   // kSlots x 2
  const int slab_bytes = D * pitchC;
  unsigned* state = (unsigned*)(smem + kHeader + a.NST * slab_bytes);
  const int state_dir = (D2 + 2) * pitchS, state_buf = N * state_dir;  // words
  uint16_t* pm = (uint16_t*)(state + 2 * state_buf);            // (2, N, NCH)
  const int pm_buf = N * a.NCH * pitchM;
  unsigned* stage = (unsigned*)(smem + a.stage_off);            // (N, col)
  const int col_words = a.col_bytes / 4;
  const int recv = a.recv_off, recv_dir = a.recv_dir, recv_slot = N * recv_dir;
  const int recv_pm = 32 + a.col_bytes;

  const int cstart = rank * a.TW;
  const int Lb = strip_cols(rank, a.TW, W);
  const uint8_t* cost_b = a.cost + (size_t)b * S * D * W;
  const uint8_t* cost_end = a.cost + (size_t)a.B * S * D * W;
  const uint8_t* img_b = a.img + (size_t)b * S * W;
  uint16_t* out_b = a.out + (size_t)b * S * D * W;

  int diagonals = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) diagonals += a.rolls[k] != 0;
  // bytes a step's hand-off brings in: a token from each neighbour, and per
  // diagonal direction a column's words and its chunks' partial minima
  const int step_bytes = 8 + diagonals * (a.NCH * a.PC * 4 + 4 * a.NCH);

  for (int i = tid; i < 256; i += blockDim.x)
    lut[i] = (uint16_t)min(max(a.p1, a.p2_init / (i + 1)), kClampP);
  if (tid == 0)
    for (int i = 0; i < kSlots; ++i) mbar_init(smem_addr(bars + i), 1);
  const unsigned p1pk = (unsigned)min(a.p1, kClampP) * 0x00010001u;
  // the sentinel rows of both buffers and every direction
  for (int i = tid; i < 2 * N * 2 * pitchS; i += blockDim.x) {
    const int row = i / pitchS;   // (buffer and direction, first or last)
    state[(row >> 1) * state_dir + (row & 1) * (D2 + 1) * pitchS +
          i % pitchS] = kSentinel2;
  }
  // the staged and the received columns start as sentinels: what no message
  // writes (p = -1, p >= D2) stays one
  for (int i = tid; i < (a.smem_bytes - a.stage_off) / 4; i += blockDim.x)
    stage[i] = kSentinel2;

  // One row's (D, Lb) cost slab into a ring buffer: per d, the 16-byte
  // chunks that cover the segment, from its aligned-down address.
  const int cpr = pitchC / 16;
  auto stage_row = [&](int step) {
    const int t = a.reverse ? S - 1 - step : step;
    uint8_t* slab = smem + kHeader + (step % a.NST) * slab_bytes;
    const uint8_t* g_row = cost_b + (size_t)t * D * W + cstart;
    for (int idx = tid; idx < D * cpr; idx += blockDim.x) {
      const int d = idx / cpr, j = idx - d * cpr;
      const uint8_t* g = g_row + (size_t)d * W;
      const int o = (int)((uintptr_t)g & 15);
      if (j * 16 < o + Lb) {
        const uint8_t* src = g - o + j * 16;
        const long long left = cost_end - src;
        cp_async16(slab + d * pitchC + j * 16, src,
                   left >= 16 ? 16 : (int)left);
      }
    }
  };
  for (int st = 0; st < a.NST - 1; ++st) {
    if (st < S) stage_row(st);
    cp_async_commit();
  }

  // This thread's column and chunk of pairs.
  const int j = tid % a.TW, ch = tid / a.TW;
  const int c0 = cstart + j;
  const bool active = ch < a.NCH && j < Lb;
  const int p_lo = ch * a.PC, p_hi = min(D2, p_lo + a.PC);
  // the pair whose high half is the dead lane, if this chunk holds it
  const int dead_at = ODD && p_hi == D2 ? D2 - 1 : -1;
  const int cm1 = (c0 + W - 1) % W, cp1 = (c0 + 1) % W;
  const int Wmod = W & 15;

  const int right = (rank + 1) % CS, left = (rank + CS - 1) % CS;
  const unsigned recv_right = peer_addr(smem_addr(smem + recv), right);
  const unsigned recv_left = peer_addr(smem_addr(smem + recv), left);
  const unsigned bars_right = peer_addr(smem_addr(bars), right);
  const unsigned bars_left = peer_addr(smem_addr(bars), left);
  const unsigned tokens_right = peer_addr(smem_addr(tokens), right);
  const unsigned tokens_left = peer_addr(smem_addr(tokens), left);
  // Per direction: the restart column, and whether this thread hands its
  // chunk of the edge column to a peer or takes the halo column from one.
  unsigned restart_mask[N];
  bool sends[N], takes[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int roll = a.rolls[k];
    restart_mask[k] = 0u;
    sends[k] = takes[k] = false;
    if (!active || roll == 0) continue;
    if (a.restart && c0 == (roll > 0 ? 0 : W - 1)) restart_mask[k] = ~0u;
    sends[k] = roll > 0 ? j == Lb - 1 : j == 0;   // to the right / left peer
    takes[k] = roll > 0 ? j == 0 : j == Lb - 1;   // from the left / right
  }

  // the gray values of the first step: this column's, and the previous
  // row's at c - 1, c, c + 1
  int gc = 0, gm = 0, g0 = 0, gp = 0;
  if (active && S > 0) gc = img_b[(size_t)(a.reverse ? S - 1 : 0) * W + c0];
  // two rows ahead of a sum's element, for the L2 prefetch of the read-add
  const long long ahead2 =
      2 * (a.reverse ? -(long long)D * W : (long long)D * W);

  cp_async_wait(a.NST - 2);
  cluster.sync();   // once: barriers initialised, every block resident

  int buf = 0;
  for (int s = 0; s < S; ++s) {
    const int t = a.reverse ? S - 1 - s : s;
    const bool hand_off = diagonals > 0 && s + 1 < S;   // this step sends
    const int slot = s % kSlots;
    if (s + a.NST - 1 < S) stage_row(s + a.NST - 1);
    cp_async_commit();
    if (hand_off && tid == 0) {
      // arm this step's barrier; tell both peers that this block has left
      // step s - 1 behind (a peer never runs more than a step ahead)
      mbar_expect(smem_addr(bars + slot), step_bytes);
      send_word(tokens_right + 4 * (slot * 2), (unsigned)s,
                bars_right + 8 * slot);
      send_word(tokens_left + 4 * (slot * 2 + 1), (unsigned)s,
                bars_left + 8 * slot);
    }
    const bool handed = diagonals > 0 && s > 0;
    if (handed) {
      if (tid == 0)
        mbar_wait(smem_addr(bars + (s - 1) % kSlots), ((s - 1) / kSlots) & 1);
      __syncthreads();
    }

    if (active) {
      const unsigned* st_prev = state + buf * state_buf;
      unsigned* st_next = state + (buf ^ 1) * state_buf;
      const uint16_t* pm_prev = pm + buf * pm_buf;
      uint16_t* pm_next = pm + (buf ^ 1) * pm_buf;

      // the next step's gray values, and the image rows a few steps ahead
      // asked into the L2
      int n_gc = 0, n_gm = 0, n_gp = 0;
      if (s + 1 < S) {
        const uint8_t* next = img_b + (size_t)(a.reverse ? t - 1 : t + 1) * W;
        const uint8_t* here = img_b + (size_t)t * W;
        n_gc = next[c0];
        n_gm = here[cm1], n_gp = here[cp1];
        if (s + 4 < S && ch == 0)
          prefetch_l2(img_b + (size_t)(a.reverse ? t - 4 : t + 4) * W + c0);
      }
      const uint8_t* from =
          smem + recv + ((s + kSlots - 1) % kSlots) * recv_slot;

      // the slab rows of pair p_lo at this column, and the sums' rows
      const uint8_t* cp =
          smem + kHeader + (s % a.NST) * slab_bytes + 2 * p_lo * pitchC + j;
      const size_t row_off = (size_t)t * D * W + c0;
      int coff =
          (int)(((uintptr_t)(cost_b + (row_off - j)) + 2 * p_lo * W) & 15);
      uint16_t* o = out_b + row_off + (size_t)2 * p_lo * W;
      auto load_cost = [&]() -> unsigned {
        const unsigned lo = cp[coff];
        const unsigned hi = cp[pitchC + ((coff + Wmod) & 15)];
        cp += 2 * pitchC;
        coff = (coff + 2 * Wmod) & 15;
        return lo | (hi << 16);
      };
      // the old sums of pair p (its high plane only if it exists)
      auto load_old = [&](const uint16_t* at, int p) -> unsigned {
        return (unsigned)at[0] |
               (ODD && p == dead_at ? 0u : (unsigned)at[W] << 16);
      };
      auto store_sum = [&](unsigned sum, int p) {
        o[0] = (uint16_t)sum;
        if (!ODD || p != dead_at) o[W] = (uint16_t)(sum >> 16);
        o += 2 * (size_t)W;
      };
      unsigned runmin[N];
#pragma unroll
      for (int k = 0; k < N; ++k) runmin[k] = 0xFFFFFFFFu;
      const int out_at = 1 + j;   // this column's word in a state row

      if (s == 0) {   // a path's first pixel contributes its raw cost
        for (int p = p_lo; p < p_hi; ++p) {
          const unsigned dead = ODD && p == dead_at ? kHigh : 0u;
          const unsigned cst = (load_cost() & ~dead) | (kSentinel2 & dead);
          unsigned sum = cst * N;
          if (a.accumulate) sum += load_old(o, p);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            st_next[k * state_dir + (p + 1) * pitchS + out_at] = cst;
            runmin[k] = __vminu2(runmin[k], cst | dead);
            if (sends[k]) stage[k * col_words + p] = cst;
          }
          store_sum(sum, p);
        }
      } else {
        unsigned pminb[N], pp2[N], wm[N], wc[N];
        const unsigned* pa[N];   // the previous state's word of pair p + 1
        int sa[N];               // and its stride, in words
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int roll = a.rolls[k];
          const int prev_gray = roll > 0 ? gm : roll < 0 ? gp : g0;
          const unsigned p2 = lut[abs(gc - prev_gray)];
          unsigned m = 0xFFFFu;
          if (takes[k]) {   // the halo column comes from the neighbour
            const unsigned* mins =
                (const unsigned*)(from + k * recv_dir + recv_pm);
            for (int c = 0; c < a.NCH; ++c) m = min(m, mins[c]);
            pa[k] = (const unsigned*)(from + k * recv_dir + 16) + p_lo - 1;
            sa[k] = 1;
          } else {
            const uint16_t* q = pm_prev + k * a.NCH * pitchM + out_at - roll;
            for (int c = 0; c < a.NCH; ++c) m = min(m, (unsigned)q[c * pitchM]);
            pa[k] = st_prev + k * state_dir + p_lo * pitchS + out_at - roll;
            sa[k] = pitchS;
          }
          pminb[k] = m * 0x00010001u;
          pp2[k] = (m + p2) * 0x00010001u;
          wm[k] = pa[k][0];
          pa[k] += sa[k];
          wc[k] = pa[k][0];
        }
        const bool far = s + 2 < S;
        unsigned old = a.accumulate && p_lo < p_hi ? load_old(o, p_lo) : 0u;
#pragma unroll 2
        for (int p = p_lo; p < p_hi; ++p) {
          const unsigned dead = ODD && p == dead_at ? kHigh : 0u;
          const unsigned cst = load_cost();
          unsigned sum = old;
          if (a.accumulate) {
            if (p + 1 < p_hi) old = load_old(o + 2 * (size_t)W, p + 1);
            if (far) prefetch_l2(o + ahead2);
          }
#pragma unroll
          for (int k = 0; k < N; ++k) {
            pa[k] += sa[k];
            const unsigned wp = pa[k][0];
            const unsigned up = weave(wm[k], wc[k]);   // L(d - 1), both halves
            const unsigned dn = weave(wc[k], wp);      // L(d + 1)
            const unsigned nb = __viaddmin_u16x2(__vminu2(up, dn), p1pk, wc[k]);
            const unsigned m = __vminu2(nb, pp2[k]);
            unsigned cur = (cst + m - pminb[k]) & kSentinel2;
            cur = (cur & ~restart_mask[k]) | (cst & restart_mask[k]);
            cur = (cur & ~dead) | (kSentinel2 & dead);
            wm[k] = wc[k];
            wc[k] = wp;
            runmin[k] = __vminu2(runmin[k], cur | dead);
            sum += cur;
            st_next[k * state_dir + (p + 1) * pitchS + out_at] = cur;
            if (sends[k]) stage[k * col_words + p] = cur;
          }
          store_sum(sum, p);
        }
      }

#pragma unroll
      for (int k = 0; k < N; ++k) {
        const unsigned mn = min(runmin[k] & kLow, runmin[k] >> 16);
        pm_next[(k * a.NCH + ch) * pitchM + out_at] = (uint16_t)mn;
        if (sends[k] && hand_off) {
          // this chunk of the column that crosses the strip edge, then its
          // partial minimum, into the peer's buffer of this step
          const bool to_right = a.rolls[k] > 0;
          const unsigned* src = stage + k * col_words + p_lo;
          const unsigned dst = (to_right ? recv_right : recv_left) +
                               slot * recv_slot + k * recv_dir;
          const unsigned bar = (to_right ? bars_right : bars_left) + 8 * slot;
          if (a.PC % 4 == 0) {
            for (int i = 0; i < a.PC; i += 4)
              send_vec(dst + 16 + 4 * (p_lo + i), src + i, bar);
          } else {
#pragma unroll 1
            for (int i = 0; i < a.PC; ++i)
              send_word(dst + 16 + 4 * (p_lo + i), src[i], bar);
          }
          send_word(dst + recv_pm + 4 * ch, mn, bar);
        }
      }
      gm = n_gm, g0 = gc, gp = n_gp, gc = n_gc;
    }
    cp_async_wait(a.NST - 2);
    __syncthreads();
    buf ^= 1;
  }
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The launch shape for a cluster of `cs` blocks per image; returns the
// dynamic shared memory it needs, or -1 if `cs` strips leave a block empty.
// Where the grid has more blocks than the card has SMs, a block takes at
// most its share of an SM's threads, so that all of them are resident at
// once (80 registers a thread: 768 threads fill an SM's register file).
int scan16_shape(Scan16Args& a, int n, int cs) {
  a.TW = (a.W + cs - 1) / cs;
  if ((cs - 1) * a.TW >= a.W) return -1;
  if (a.TW > kScanThreads) return kSmemMax + 1;   // a wider cluster
  const int d2 = (a.D + 1) / 2;
  const long long per_sm = ((long long)a.B * cs + a.sms - 1) / a.sms;
  int nch = (int)(kScanThreads / per_sm) / a.TW;
  nch = nch < 1 ? 1 : nch;
  nch = nch > kMaxChunks ? kMaxChunks : nch;
  nch = nch > d2 ? d2 : nch;
  a.PC = (d2 + nch - 1) / nch;
  a.NCH = (d2 + a.PC - 1) / a.PC;
  a.pitchC = round_up(a.TW + 15, 16);
  a.pitchS = a.TW + 2;
  a.pitchM = a.TW + 2;
  a.col_bytes = round_up(a.NCH * a.PC * 4, 16);
  a.recv_dir = 32 + a.col_bytes + round_up(4 * a.NCH, 16);
  const long long body =
      round_up(2 * n * (d2 + 2) * a.pitchS * 4 + 2 * n * a.NCH * a.pitchM * 2,
               16);
  const long long tail = (long long)n * a.col_bytes + 3LL * n * a.recv_dir;
  for (a.NST = kMaxStages; a.NST >= 2; --a.NST) {
    const long long at = kHeader + (long long)a.NST * a.D * a.pitchC + body;
    if (at + tail <= kSmemMax) {
      a.stage_off = (int)at;
      a.recv_off = a.stage_off + n * a.col_bytes;
      a.smem_bytes = (int)(at + tail);
      return a.smem_bytes;
    }
  }
  return kSmemMax + 1;
}

// A launch of `cs` blocks per image; `bytes` from scan16_shape at that size.
template <int N, bool ODD>
cudaError_t scan16_config(const Scan16Args& a, int cs, int bytes,
                          cudaLaunchAttribute* attr,
                          cudaLaunchConfig_t* config) {
  cudaError_t err = cudaFuncSetAttribute(
      scan16_kernel<N, ODD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scan16_kernel<N, ODD>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             cs > 8);
  if (err != cudaSuccess) return err;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3((unsigned)(a.B * cs));
  config->blockDim = dim3((unsigned)round_up(a.TW * a.NCH, 32));
  config->dynamicSmemBytes = (size_t)bytes;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

// The cluster size of a launch, decided before it, by group_kernel's rule:
// the smallest whose state fits shared memory, grown while the card has idle
// SMs; 16 blocks only if nothing smaller fits or a strip of 8 would still be
// heavy, and only if the card says it can place such a cluster.  *chosen = 0:
// no size takes N directions at this shape.
template <int N, bool ODD>
cudaError_t choose_cluster(const Scan16Args& a, int* chosen) {
  *chosen = 0;
  int cs = 0;
  cudaError_t err = cudaSuccess;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    Scan16Args trial = a;
    const int need = scan16_shape(trial, N, c);
    if (need < 0) break;
    if (need > kSmemMax) continue;
    if (cs != 0 && (long long)a.B * cs >= a.sms) break;
    if (c > 8) {
      if (cs != 0 && (long long)((a.W + 7) / 8) * a.D < kHeavyStrip) break;
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t config;
      err = scan16_config<N, ODD>(trial, c, need, attr, &config);
      if (err != cudaSuccess) return err;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, scan16_kernel<N, ODD>,
                                           &config);
      if (err != cudaSuccess) return err;
      if (clusters < 1) break;
    }
    cs = c;
  }
  *chosen = cs;
  return cudaSuccess;
}

template <int N, bool ODD>
int launch_scan16(Scan16Args a, cudaStream_t stream) {
  int cs = 0;
  cudaError_t err = choose_cluster<N, ODD>(a, &cs);
  if (err != cudaSuccess) return (int)err;
  if (cs == 0) return (int)cudaErrorInvalidConfiguration;
  const int bytes = scan16_shape(a, N, cs);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
  err = scan16_config<N, ODD>(a, cs, bytes, attr, &config);
  if (err != cudaSuccess) return (int)err;
  config.stream = stream;
  return (int)cudaLaunchKernelEx(&config, scan16_kernel<N, ODD>, a);
}

using Chooser = cudaError_t (*)(const Scan16Args&, int*);
using Launcher = int (*)(Scan16Args, cudaStream_t);
constexpr Chooser kChoose[kMaxDirs][2] = {
    {choose_cluster<1, false>, choose_cluster<1, true>},
    {choose_cluster<2, false>, choose_cluster<2, true>},
    {choose_cluster<3, false>, choose_cluster<3, true>}};
constexpr Launcher kLaunch[kMaxDirs][2] = {
    {launch_scan16<1, false>, launch_scan16<1, true>},
    {launch_scan16<2, false>, launch_scan16<2, true>},
    {launch_scan16<3, false>, launch_scan16<3, true>}};

// The card's SM count, which the launch shape depends on.
cudaError_t card_sms(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// One rung on uint8 (B, R, W) planes into uint16 (B, R, W): R = D (even) for
// the plane rungs, the number of rows for the loop rungs 5 and 11 (p5b).
extern "C" int sgm_probe_rung(const void* x, void* out, int rung, int B,
                              int R, int W, void* stream) {
  if ((long long)B * R * W == 0) return 0;
  const uint8_t* xs = (const uint8_t*)x;
  uint16_t* o = (uint16_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (rung == 5 || rung == 11) {
    const dim3 grid(((W + 1) / 2 + 127) / 128, B);
    if (rung == 5)
      rung_loop_kernel<false><<<grid, 128, 0, s>>>(xs, o, R, W);
    else
      rung_loop_kernel<true><<<grid, 128, 0, s>>>(xs, o, R, W);
    return (int)cudaGetLastError();
  }
  if (R % 2 || R > 256) return (int)cudaErrorInvalidValue;
  switch (rung) {
    case 0: return launch_plane<0>(xs, o, B, R, W, s);
    case 1: return launch_plane<1>(xs, o, B, R, W, s);
    case 2: return launch_plane<2>(xs, o, B, R, W, s);
    case 3: return launch_plane<3>(xs, o, B, R, W, s);
    case 4: return launch_plane<4>(xs, o, B, R, W, s);
    case 6: return launch_plane<6>(xs, o, B, R, W, s);
    case 8: return launch_plane<8>(xs, o, B, R, W, s);
    case 9: return launch_plane<9>(xs, o, B, R, W, s);
    case 10: return launch_plane<10>(xs, o, B, R, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A group of up to 3 vertical directions that share a scan order, in one
// launch with packed 16-bit state (rolls r0..r2, the first n count): the sum
// of their contributions stored (accumulate=0) or added (1) to the uint16
// volume; the arguments of sgm_scan_group without the carries.  A group that
// no cluster takes at this shape is refused (cudaErrorInvalidConfiguration;
// see sgm_probe_scan16_capacity).
extern "C" int sgm_probe_scan16(const void* cost, const void* img, void* aggr,
                                int B, int S, int D, int W, int n, int r0,
                                int r1, int r2, int reverse, int restart,
                                int p1, int p2_init, int accumulate,
                                void* stream) {
  if ((long long)B * S * W == 0) return 0;
  if (D < 1 || D > 256 || n < 1 || n > kMaxDirs || p1 < 0 || p2_init < 0)
    return (int)cudaErrorInvalidValue;
  const int rolls[kMaxDirs] = {r0, r1, r2};
  Scan16Args a{};
  a.cost = (const uint8_t*)cost;
  a.img = (const uint8_t*)img;
  a.out = (uint16_t*)aggr;
  a.B = B, a.S = S, a.D = D, a.W = W;
  for (int k = 0; k < n; ++k) {
    if (rolls[k] < -1 || rolls[k] > 1) return (int)cudaErrorInvalidValue;
    a.rolls[k] = rolls[k];
  }
  a.reverse = reverse, a.restart = restart;
  a.p1 = p1, a.p2_init = p2_init, a.accumulate = accumulate;
  const cudaError_t err = card_sms(&a.sms);
  if (err != cudaSuccess) return (int)err;
  return kLaunch[n - 1][D % 2](a, (cudaStream_t)stream);
}

// The most directions (0..3) one sgm_probe_scan16 launch takes at this shape
// on the current card, into the host int *dirs (3 for an empty volume).
extern "C" int sgm_probe_scan16_capacity(int B, int D, int W, void* dirs) {
  *(int*)dirs = kMaxDirs;
  if ((long long)B * W == 0) return 0;
  *(int*)dirs = 0;
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  Scan16Args a{};
  a.B = B, a.D = D, a.W = W;
  cudaError_t err = card_sms(&a.sms);
  if (err != cudaSuccess) return (int)err;
  for (int n = kMaxDirs; n >= 1; --n) {
    int cs = 0;
    err = kChoose[n - 1][D % 2](a, &cs);
    if (err != cudaSuccess) return (int)err;
    if (cs != 0) {
      *(int*)dirs = n;
      break;
    }
  }
  return 0;
}
