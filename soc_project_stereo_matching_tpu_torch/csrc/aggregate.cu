// K2: SGM path aggregation (one launch per direction group).
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   _directional_scan_group / _scan_group_kernel (with and without its
//   cross-tile carry-in/out refs) and
//   _directional_scan_group_bidir / _bidir_kernel, as driven by
//   aggregate_paths, aggregate_paths_wta and parallel/tiles.py.  The WTA
//   reduction that follows is csrc/wta.cu.
//
// Two scan kernels live here.  `group_kernel` (sgm_scan_group) is the one the
// port runs: up to three directions that share a scan order in one launch.
// `scan_kernel` (sgm_scan_direction) is the first design, one warp per path
// and one launch per direction; it stays as the entry the measurement tools
// time one direction with and as a second reference on the card.
//
// What a scan must do on the H100 is move bytes: a group reads the uint8 cost
// once and writes the uint16 sum once (reads it too when it adds onto earlier
// groups); the recurrence is about ten 32-bit operations per element and
// direction, far under the card's rate.  The first design missed that bound
// by 20-50x because of how it touched memory: a warp walked one path, so its
// lanes read D single bytes at stride W per step and read-modify-wrote the
// uint16 sum at stride 2W, once per direction (38 bytes per volume element
// over the 8 directions), and the horizontal warps kept one 32-byte sector
// per lane alive for 32 steps.  `group_kernel` moves whole sectors and 24
// bytes per element; what bounds it now is not bytes but a step's fixed
// latency (below, after the design).
//
// Design of `group_kernel`.  The volume is (B, S, D, W) with W fastest and
// the scan runs over S, so the kernel owns columns, not paths (the jnp
// formulation: the state is indexed by column and a diagonal rolls it by one
// column per step).
//   * A thread-block cluster of CS blocks owns all W columns of one image;
//     block r owns the strip [r*TW, (r+1)*TW).  CS is the smallest of 1, 2,
//     4, 8 whose state fits shared memory, grown while B * CS blocks leave
//     SMs idle; 16 (not a portable size: the card is asked before the launch
//     whether it can place such a cluster) where D x W needs it, as at 1500
//     columns and D = 256.  The size is chosen before the one launch an entry
//     makes; a group that no size takes is refused, and the wrapper, which
//     asks sgm_scan_group_capacity first, splits it into smaller groups.
//   * Per step the block stages its (D, TW) slab of the cost row into a ring
//     of 2 to 4 shared-memory buffers with 16-byte cp.async copies, up to
//     three steps ahead.  Rows of W bytes are not 16-byte aligned (W = 450),
//     so each row segment is copied from its aligned-down address and the
//     reader adds the segment's offset: every sector fetched is used whole.
//     The gray values are asked for a step ahead, their rows into the L2
//     four steps ahead, and P2' comes from a 256-entry table (no divide).
//   * A thread owns two neighbouring columns and a chunk of D (a multiple of
//     4 disparities).  It keeps the two columns in the halves of one
//     register (the values are < 2^16), so the recurrence is Hopper's
//     two-lane DPX arithmetic: min(lm, lp), min(x + P1, prev) as one
//     __viaddmin_u16x2, min with pmin + P2', then (cost + m - pmin) & 0xFF
//     per lane: 3 DPX and 5 integer instructions per direction and pair.
//     Lanes of a warp are neighbouring column pairs, so shared-memory reads
//     have no bank conflict and the global stores of the sum are whole
//     128-byte lines per warp.
//   * The state L(p - r, .) of every direction lives in shared memory as
//     bytes, (2 buffers, n, D + 2 rows, TW + halo): rows 0 and D + 1 hold
//     the 255 sentinels of d = -1 and d = D, so the loop has no edge case;
//     a step reads the previous buffer at column c - roll and writes the
//     next one, so a diagonal costs no data movement inside a strip.  The
//     min over D of a column goes through per-chunk partial minima in shared
//     memory, read back (at column c - roll) at the next step.
//   * The one column of state (D bytes and the partial minima) that crosses
//     a strip edge each step is collected in a staging column by the edge
//     pair's threads and sent into the neighbour block's shared memory with
//     asynchronous remote stores that count on a transaction barrier there
//     (st.async, mbarrier; three buffers in turn, a token each step keeps a
//     peer at most a step ahead).  The receiver's edge threads read the
//     column where it landed.  The wrap at the image edge is the ring's last
//     hop.  One thread per block waits on the barrier, then __syncthreads:
//     measured, that beats both cluster.sync() per step (a GPU-wide fence
//     and an L1 invalidate, 3 us a step on an NVIDIA H100 80GB HBM3 at
//     700.00 W) and many spinning edge threads
//     (they starve the warps that compute).  Restart mode is a lane mask on
//     the column.
//   * The n contributions of a volume element are added in a register and
//     the uint16 volume is touched once per group: a store for the first
//     group, one coalesced read-add-store for the others (the old sums are
//     loaded two planes ahead, their rows asked into the L2 two steps
//     ahead).  The cost slab is read once for all n directions.
//   * Carry mode: the carry-in (int32, by column: the Pallas layout) is the
//     initial state buffer, halos included; the carry-out is the last one; a
//     zero carry is neutral; a reverse group walks the rows backwards.
// What bounds it now (measured, PERF.md): not bytes yet but a step's fixed
// latency (one block-wide barrier, the hand-off, some 150 instructions of
// set-up per thread) times S steps; a launch of the cone's 375 steps takes
// 2 to 4 ms whatever the batch up to 32 (NVIDIA H100 80GB HBM3, 700.00 W).
// What was tried on the way, every variant bit-equal (same card and limit,
// cone shape, B = 2; times per step of a three-direction launch):
//   * The hand-off.  (1) Plain remote stores and cluster.sync() per step:
//     5.8 us; the SASS shows MEMBAR.ALL.GPU and CCTL.IVALL in every
//     cluster.sync(), so each step waited for its global stores and lost its
//     L1.  (2) st.async onto a transaction barrier, a word per disparity,
//     every edge thread waiting: 9.8 us (146 tiny transactions a step, 16
//     spinning warps).  (3) As shipped, one 4- or 16-byte message per chunk
//     from a staged column, one waiting thread and a __syncthreads: 4.9 us.
//   * The inner loop took some 120 instructions per pair, disparity and
//     direction with parity tests on every load, 64-bit addresses and the
//     sentinel and fresh-step branches inside it; sentinel rows in the state,
//     byte offsets into shared memory, a separate fresh step and templates on
//     the direction count and on "W even" brought it to about 20.
//   * The read-add.  The old sum loaded one plane ahead left its latency in
//     the loop (+0.6 ms a launch); two planes ahead with the rows asked into
//     the L2 two steps ahead costs 0.35 ms; four planes ahead spilled (376
//     bytes) and was slower.
//   * nvcc 12.8 unrolled a short copy loop bounded by min()/max() to the next
//     multiple of 4; such loops next to inline asm carry #pragma unroll 1.
// The horizontal pair runs as two one-direction groups on the transposed
// volume (csrc/transpose.cu), so nothing walks the volume at stride W.
// Bytes per volume element over the 8 directions: 2
// (cost transposed) + 3 + 5 (horizontal groups) + 4 (sum transposed back) +
// 5 + 5 (vertical groups) = 24, all in whole sectors, against 38 before.
//
// Wrap diagonals: the path that starts at column k of its first row is at
// column (k + roll*s) mod W at step s, so the previous pixel of a path is
// the wrapped one.  In restart mode the path restarts (raw cost) whenever it
// is at column 0 (roll > 0) or W-1 (roll < 0) after its first step.
//
// Carry mode (sgm_scan_group, vertical scans of an
// H-tile): the DP state crosses tile boundaries as int32 planes indexed by
// column, the layout of the Pallas entry (cost (B, n, D, W), min (B, n, 1,
// W)).  A path's first step reads the state at column (col - roll) mod W of
// the carry-in and the upstream tile's boundary gray row there, for P2; its
// last step writes the state at its own column of the carry-out.  A reverse
// scan takes the carry at the tile's last row and emits it at the first.
// Only a first step without a carry-in starts fresh; a zero carry-in is
// neutral (m = 0, so the first row contributes its raw cost).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace {

constexpr int kSentinel = 255;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int DPL>
__global__ void scan_kernel(const uint8_t* __restrict__ cost,
                            const uint8_t* __restrict__ img,
                            uint16_t* __restrict__ aggr, int B, int H, int D,
                            int W, int vertical, int reverse, int roll,
                            int restart, int p1, int p2_init,
                            int accumulate) {
  const int paths = vertical ? W : H;  // paths per image
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  if (warp >= B * paths) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int b = warp / paths;
  const int path = warp - b * paths;
  const int steps = vertical ? H : W;
  const size_t plane = (size_t)W;  // stride between d planes of one row
  const uint8_t* cost_b = cost + (size_t)b * H * D * W;
  const uint8_t* img_b = img + (size_t)b * H * W;
  uint16_t* aggr_b = aggr + (size_t)b * H * D * W;

  int prev[DPL];
  int prev_min = 0;
  int prev_gray = 0;
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    int row, col;
    if (vertical) {
      row = t;
      col = path;
      if (roll) {
        col = (path + roll * (s % W)) % W;
        if (col < 0) col += W;
      }
    } else {
      row = path;
      col = t;
    }
    const int gray = img_b[row * W + col];
    const size_t base = (size_t)row * D * W + col;
    int c[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      c[i] = d < D ? cost_b[base + d * plane] : 0;
    }

    int cur[DPL];
    const bool fresh =
        s == 0 ||
        (restart && roll &&
         ((roll > 0 && col == 0) || (roll < 0 && col == W - 1)));
    if (fresh) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) cur[i] = c[i];
    } else {
      const int p2 = max(p1, p2_init / (abs(gray - prev_gray) + 1));
      const int up = __shfl_up_sync(kFull, prev[DPL - 1], 1);   // L(d-1), i=0
      const int dn = __shfl_down_sync(kFull, prev[0], 1);       // L(d+1), i=DPL-1
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        const int lm = d == 0 ? kSentinel : (i > 0 ? prev[i - 1] : up);
        const int lp = d >= D - 1 ? kSentinel : (i < DPL - 1 ? prev[i + 1] : dn);
        const int m = min(min(prev[i], lm + p1), min(lp + p1, prev_min + p2));
        cur[i] = (c[i] + m - prev_min) & 0xFF;
      }
    }

    int local_min = INT_MAX;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane * DPL + i;
      if (d < D) {
        uint16_t* a = aggr_b + base + d * plane;
        *a = (uint16_t)(accumulate ? *a + cur[i] : cur[i]);
        local_min = min(local_min, cur[i]);
      }
      prev[i] = cur[i];
    }
    prev_min = warp_min(local_min);
    prev_gray = gray;
  }
}

template <int DPL>
int launch_scan(const uint8_t* cost, const uint8_t* img, uint16_t* aggr,
                int B, int H, int D, int W, int vertical, int reverse,
                int roll, int restart, int p1, int p2_init, int accumulate,
                cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps = 8 paths per block
  const long long warps = (long long)B * (vertical ? W : H);
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  scan_kernel<DPL><<<(unsigned)blocks, kThreads, 0, stream>>>(
      cost, img, aggr, B, H, D, W, vertical, reverse, roll, restart, p1,
      p2_init, accumulate);
  return (int)cudaGetLastError();
}

int scan_direction(const void* cost, const void* img, void* aggr, int B,
                   int H, int D, int W, int vertical, int reverse, int roll,
                   int restart, int p1, int p2_init, int accumulate,
                   void* stream) {
  if (B * H * W == 0) return 0;
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  const uint8_t* c = (const uint8_t*)cost;
  const uint8_t* g = (const uint8_t*)img;
  uint16_t* a = (uint16_t*)aggr;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
#define SGM_SCAN_CASE(N)                                                  \
  case N:                                                                 \
    return launch_scan<N>(c, g, a, B, H, D, W, vertical, reverse, roll,  \
                          restart, p1, p2_init, accumulate, s);
    SGM_SCAN_CASE(1)
    SGM_SCAN_CASE(2)
    SGM_SCAN_CASE(3)
    SGM_SCAN_CASE(4)
    SGM_SCAN_CASE(5)
    SGM_SCAN_CASE(6)
    SGM_SCAN_CASE(7)
    SGM_SCAN_CASE(8)
#undef SGM_SCAN_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// --- the group scan ---------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kMaxDirs = 3;        // directions of one launch
constexpr int kMaxCluster = 16;    // 8 is the portable limit
constexpr int kMaxStages = 4;      // cost slabs in flight
constexpr int kMaxChunks = 8;      // chunks of D per column pair
constexpr int kGroupThreads = 768; // most threads of a block: 85 registers each
constexpr int kClampP = 1024;      // P1, P2' beyond 255 never win a min
constexpr long long kWaitCycles = 1LL << 32;   // about 2 s
constexpr long long kHeavyStrip = 16384;   // columns x D of a strip
constexpr int kGroupSmem = 232448; // 227 KB, the most a block can take
constexpr unsigned kByte2 = 0x00FF00FFu;

struct GroupArgs {
  const uint8_t* cost;        // (B, S, D, W)
  const uint8_t* img;         // (B, S, W)
  uint16_t* out;              // (B, S, D, W)
  const int* cin_cost;        // (B, carry_n, D, W), at this launch's first
  const int* cin_min;         // (B, carry_n, 1, W)   direction; or null
  const uint8_t* prev_gray;   // (B, W)
  int* cout_cost;             // as cin_*, or null
  int* cout_min;
  int B, S, D, W;
  int rolls[kMaxDirs];
  int carry_n, reverse, restart, p1, p2_init, accumulate;
  // the launch shape
  int TW;       // columns of a block's strip (even)
  int NP;       // column pairs of a strip
  int NCH, DC;  // chunks of D, disparities per chunk
  int NST;      // cost slabs in the ring
  int pitchC;   // bytes of a slab row (multiple of 16)
  int pitchS;   // bytes of a state row: 4 + TW + 4, the strip at byte 4
  int pitchM;   // uint16 of a partial-min row: 2 + TW + 2, the strip at 2
  int stage_off;   // byte offset of the staged outgoing columns
  int col_bytes;   // bytes of a handed-over column: NCH * DC, in sixteens
  int recv_off;    // byte offset of the hand-off buffers
  int recv_dir;    // bytes of one direction's hand-off buffer
  int smem_bytes;  // all of the dynamic shared memory
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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

__device__ __forceinline__ int strip_cols(int rank, int TW, int W) {
  return min(W, (rank + 1) * TW) - rank * TW;
}

// --- cluster hand-off: asynchronous remote stores that complete a barrier ---
// cluster.sync() costs a GPU-wide memory fence and an L1 invalidate per step
// (it must order global memory too).  The strips only hand one column of
// shared-memory state to a neighbour, so each block owns three transaction
// barriers (one per step modulo 3); a neighbour's st.async delivers words
// into this block's shared memory and counts their bytes on the barrier, and
// one thread of the block waits for the barrier's phase.  No fence is
// involved.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
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

// Spins (a suspended try_wait wakes late); a peer that never answers is a
// fault of the protocol, and the kernel traps rather than hang the card.
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

constexpr int kSlots = 3;   // hand-off buffers: a peer is at most a step apart

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

// Two neighbouring bytes as the 16-bit lanes of a register, any alignment.
__device__ __forceinline__ unsigned ld_bytes(const uint8_t* p) {
  return __byte_perm((unsigned)p[0], (unsigned)p[1], 0x5410);
}

// The same from an even address.
__device__ __forceinline__ unsigned ld_even(const uint8_t* p) {
  return __byte_perm((unsigned)*(const uint16_t*)p, 0u, 0x4140);
}

// EVEN: W is even, the cost volume starts at an even address and the sum at
// a multiple of 4, so a column pair of the cost slab is one 16-bit load and a
// pair of sums one 32-bit access; else bytes and halves.
template <int N, bool EVEN>
__global__ void __launch_bounds__(kGroupThreads) group_kernel(const GroupArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int D = a.D, W = a.W, S = a.S;
  const int pitchS = a.pitchS, pitchC = a.pitchC, pitchM = a.pitchM;

  // shared memory, by byte offset (GroupArgs and group_shape agree on it)
  uint16_t* lut = (uint16_t*)smem;                              // 256
  unsigned long long* bars = (unsigned long long*)(smem + 512); // kSlots
  unsigned* tokens = (unsigned*)(smem + 544);                   // kSlots x 2
  const int ring = 576;                                         // NST slabs
  const int slab_bytes = D * pitchC;
  // state rows 0 and D + 1 hold the sentinels of d = -1 and d = D
  const int state = ring + a.NST * slab_bytes;                  // (2, N, D+2)
  const int state_dir = (D + 2) * pitchS, state_buf = N * state_dir;
  uint16_t* pm = (uint16_t*)(smem + state + 2 * state_buf);     // (2, N, NCH)
  const int pm_buf = N * a.NCH * pitchM;
  // the column that leaves the strip, per direction: written in the loop by
  // the edge pair's threads, sent from here
  const int stage = a.stage_off, col_bytes = a.col_bytes;       // (N, col)
  // what the neighbours hand over, per slot and direction: 16 sentinel
  // bytes, the column (a byte per disparity), 16 sentinel bytes, then a
  // word per chunk with its partial minimum
  const int recv = a.recv_off, recv_dir = a.recv_dir, recv_slot = N * recv_dir;
  const int recv_pm = 32 + col_bytes;

  const int cstart = rank * a.TW;
  const int Lb = strip_cols(rank, a.TW, W);
  const uint8_t* cost_b = a.cost + (size_t)b * S * D * W;
  const uint8_t* cost_end = a.cost + (size_t)a.B * S * D * W;
  const uint8_t* img_b = a.img + (size_t)b * S * W;
  uint16_t* out_b = a.out + (size_t)b * S * D * W;
  const bool carried = a.cin_cost != nullptr;

  int diagonals = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) diagonals += a.rolls[k] != 0;
  // bytes a step's hand-off brings in: a token from each neighbour, and
  // per diagonal direction a column and its partial minima
  const int dir_bytes = a.NCH * a.DC + 4 * a.NCH;
  const int step_bytes = 8 + diagonals * dir_bytes;

  for (int i = tid; i < 256; i += blockDim.x)
    lut[i] = (uint16_t)min(max(a.p1, a.p2_init / (i + 1)), kClampP);
  if (tid == 0)
    for (int i = 0; i < kSlots; ++i) mbar_init(smem_addr(bars + i), 1);
  const unsigned p1pk = (unsigned)min(a.p1, kClampP) * 0x00010001u;
  for (int i = tid; i < 2 * N * 2 * pitchS; i += blockDim.x) {
    const int row = i / pitchS;   // (buffer, direction, first or last row)
    smem[state + (row >> 1) * state_dir + (row & 1) * (D + 1) * pitchS +
         i % pitchS] = (uint8_t)kSentinel;
  }
  // the staged and the received columns start as sentinels: what no message
  // writes (d = -1, d >= D) stays one
  for (int i = tid; i < (a.smem_bytes - stage) / 4; i += blockDim.x)
    ((unsigned*)(smem + stage))[i] = 0xFFFFFFFFu;

  // One row's (D, Lb) cost slab into a ring buffer: per d, the 16-byte
  // chunks that cover the segment, from its aligned-down address.
  const int cpr = pitchC / 16;
  auto stage_row = [&](int step) {
    const int t = a.reverse ? S - 1 - step : step;
    uint8_t* slab = smem + ring + (step % a.NST) * slab_bytes;
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

  // The carry-in is the first state buffer, halo columns included.
  if (carried) {
    const int span = Lb + 2;  // columns -1 .. Lb of the strip
    for (int idx = tid; idx < N * D * span; idx += blockDim.x) {
      const int j = idx % span - 1;
      const int kd = idx / span;  // k * D + d
      const int col = (cstart + j + W) % W;
      const int k = kd / D, d = kd - k * D;
      smem[state + k * state_dir + (d + 1) * pitchS + 4 + j] =
          (uint8_t)a.cin_cost[((size_t)b * a.carry_n * D + (size_t)k * D + d) *
                                  W + col];
    }
    for (int idx = tid; idx < N * a.NCH * span; idx += blockDim.x) {
      const int j = idx % span - 1;
      const int kc = idx / span;  // k * NCH + ch
      const int k = kc / a.NCH;
      const int col = (cstart + j + W) % W;
      pm[kc * pitchM + 2 + j] =
          kc - k * a.NCH == 0
              ? (uint16_t)a.cin_min[((size_t)b * a.carry_n + k) * W + col]
              : (uint16_t)0xFFFF;
    }
  }

  // This thread's columns and chunk of D.
  const int p = tid % a.NP, ch = tid / a.NP;
  const int lc = 2 * p;
  const int c0 = cstart + lc;
  const bool active = ch < a.NCH && lc < Lb;
  const bool valid1 = lc + 1 < Lb;
  const int d_lo = ch * a.DC, d_hi = min(D, d_lo + a.DC);
  const int cm1 = (c0 + W - 1) % W, cp1 = (c0 + 1) % W, cp2 = (c0 + 2) % W;
  const unsigned dead = valid1 ? 0u : 0xFFFF0000u;  // lane 1 holds no column
  const bool first_col = lc == 0;
  const bool last_col = lc == Lb - 1 || lc + 1 == Lb - 1;
  const int Wmod = W & 15;

  // Per direction: the restart lanes, and whether this thread hands its
  // chunk of a column over to a peer or takes one from a peer.
  const int right = (rank + 1) % CS, left = (rank + CS - 1) % CS;
  const unsigned recv_right = peer_addr(smem_addr(smem + recv), right);
  const unsigned recv_left = peer_addr(smem_addr(smem + recv), left);
  const unsigned bars_right = peer_addr(smem_addr(bars), right);
  const unsigned bars_left = peer_addr(smem_addr(bars), left);
  const unsigned tokens_right = peer_addr(smem_addr(tokens), right);
  const unsigned tokens_left = peer_addr(smem_addr(tokens), left);
  unsigned restart_mask[N];
  bool sends[N], takes[N];
  int soff[N];   // a direction's previous state, at this pair's column - roll
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int roll = a.rolls[k];
    restart_mask[k] = 0u;
    sends[k] = takes[k] = false;
    soff[k] = state + k * state_dir + (d_lo + 1) * pitchS + 4 + lc - roll;
    if (!active || roll == 0) continue;
    const int reset = roll > 0 ? 0 : W - 1;
    if (a.restart) {
      if (c0 == reset) restart_mask[k] = 0x0000FFFFu;
      if (valid1 && c0 + 1 == reset) restart_mask[k] = 0xFFFF0000u;
    }
    sends[k] = roll > 0 ? last_col : first_col;   // to the right / left peer
    takes[k] = roll > 0 ? first_col : last_col;   // the left / right halo
  }
  // this pair's new state
  const int noff = state + (d_lo + 1) * pitchS + 4 + lc;
  // the lane of the column that leaves to the right (the strip's last)
  const bool last_hi = lc != Lb - 1;

  // the gray values of the first step
  int gc0 = 0, gc1 = 0, g0 = 0, g1 = 0, g2 = 0, g3 = 0;
  if (active && S > 0) {
    const int t = a.reverse ? S - 1 : 0;
    gc0 = img_b[(size_t)t * W + c0];
    gc1 = valid1 ? img_b[(size_t)t * W + c0 + 1] : 0;
    if (carried) {
      const uint8_t* pr = a.prev_gray + (size_t)b * W;
      g0 = pr[cm1], g1 = pr[c0], g2 = pr[cp1], g3 = pr[cp2];
    }
  }
  // two rows ahead of a sum's element, for the L2 prefetch of the read-add
  const long long ahead2 = 2 * (a.reverse ? -(long long)D * W : (long long)D * W);

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
      // step s - 1 behind (a peer never runs more than a step ahead, so a
      // hand-off buffer is free again two steps after it was read)
      mbar_expect(smem_addr(bars + slot), step_bytes);
      send_word(tokens_right + 4 * (slot * 2), (unsigned)s,
                bars_right + 8 * slot);
      send_word(tokens_left + 4 * (slot * 2 + 1), (unsigned)s,
                bars_left + 8 * slot);
    }

    // one thread waits for what the neighbours handed over at the last step
    // (many spinning warps starve the ones that still compute); the edge
    // pairs read it where it landed
    const bool handed = diagonals > 0 && s > 0;
    if (handed) {
      if (tid == 0)
        mbar_wait(smem_addr(bars + (s - 1) % kSlots), ((s - 1) / kSlots) & 1);
      __syncthreads();
    }

    if (active) {
      const bool fresh = s == 0 && !carried;
      const int prev_buf = buf * state_buf, next_buf = (buf ^ 1) * state_buf;
      const uint16_t* pm_prev = pm + buf * pm_buf;
      uint16_t* pm_next = pm + (buf ^ 1) * pm_buf;
      const size_t row_off = (size_t)t * D * W + c0;

      // the next step's gray values, asked for a step ahead, and the rows
      // of the image a few steps ahead, asked into the L2
      int n_gc0 = 0, n_gc1 = 0, n_g0 = 0, n_g2 = 0, n_g3 = 0;
      if (s + 1 < S) {
        const uint8_t* next = img_b + (size_t)(a.reverse ? t - 1 : t + 1) * W;
        const uint8_t* here = img_b + (size_t)t * W;
        n_gc0 = next[c0];
        n_gc1 = valid1 ? next[c0 + 1] : 0;
        n_g0 = here[cm1], n_g2 = here[cp1], n_g3 = here[cp2];
        if (s + 4 < S && ch == 0)
          prefetch_l2(img_b + (size_t)(a.reverse ? t - 4 : t + 4) * W + c0);
      }

      const int from = recv + ((s + kSlots - 1) % kSlots) * recv_slot;

      // the slab row of plane d_lo at this pair, and the sums' row
      int cp = ring + (s % a.NST) * slab_bytes + d_lo * pitchC + lc;
      int coff = (int)(((uintptr_t)(cost_b + (row_off - lc)) + d_lo * W) & 15);
      uint16_t* o = out_b + row_off + (size_t)d_lo * W;
      unsigned runmin[N];
#pragma unroll
      for (int k = 0; k < N; ++k) runmin[k] = 0xFFFFFFFFu;

      if (fresh) {   // a path's first pixel contributes its raw cost
        for (int d = d_lo; d < d_hi; ++d) {
          const unsigned cst = EVEN ? ld_even(smem + cp + coff)
                                    : ld_bytes(smem + cp + coff);
          const unsigned packed = __byte_perm(cst, 0u, 0x4420);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            *(uint16_t*)(smem + next_buf + k * state_dir + noff +
                         (d - d_lo) * pitchS) = (uint16_t)packed;
            runmin[k] = __vminu2(runmin[k], cst | dead);
            if (sends[k])
              smem[stage + k * col_bytes + d] =
                  (uint8_t)(a.rolls[k] > 0 && last_hi ? cst >> 16 : cst);
          }
          unsigned sum = cst * N;
          if (EVEN && valid1) {
            if (a.accumulate) sum += *(const unsigned*)o;
            *(unsigned*)o = sum;
          } else {
            if (a.accumulate)
              sum += (unsigned)o[0] | (valid1 ? (unsigned)o[1] << 16 : 0u);
            o[0] = (uint16_t)sum;
            if (valid1) o[1] = (uint16_t)(sum >> 16);
          }
          cp += pitchC;
          coff = (coff + Wmod) & 15;
          o += W;
        }
      } else {
        unsigned pmin[N], pp2[N], wm[N], wc[N];
        int pa[N], pb[N], sa[N], sb[N];   // the pair's two bytes: at, stride
        int sn[N], sg[N];                 // new state; staged column or -1
        bool hi_out[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int roll = a.rolls[k];
          const int ga = roll > 0 ? g0 : roll < 0 ? g2 : g1;
          const int gb = roll > 0 ? g1 : roll < 0 ? g3 : g2;
          const unsigned p2 = (unsigned)lut[abs(gc0 - ga)] |
                              ((unsigned)lut[abs(gc1 - gb)] << 16);
          // min over D of the previous columns: the chunks' partial minima
          const uint16_t* q = pm_prev + k * a.NCH * pitchM + 2 + lc - roll;
          unsigned m0 = 0xFFFFu, m1 = 0xFFFFu;
          if (roll == 0) {
            unsigned m = 0xFFFFFFFFu;
            for (int c = 0; c < a.NCH; ++c)
              m = __vminu2(m, *(const unsigned*)(q + c * pitchM));
            m0 = m & 0xFFFFu, m1 = m >> 16;
          } else {
            for (int c = 0; c < a.NCH; ++c) {
              m0 = min(m0, (unsigned)q[c * pitchM]);
              m1 = min(m1, (unsigned)q[c * pitchM + 1]);
            }
          }
          pa[k] = prev_buf + soff[k];
          pb[k] = pa[k] + 1;
          sa[k] = sb[k] = pitchS;
          if (takes[k] && handed) {   // one lane comes from the neighbour
            const int col = from + k * recv_dir + 16 + d_lo;
            const unsigned* mins =
                (const unsigned*)(smem + from + k * recv_dir + recv_pm);
            unsigned mh = 0xFFFFu;
            for (int c = 0; c < a.NCH; ++c) mh = min(mh, mins[c]);
            if (roll < 0 && valid1) {
              pb[k] = col, sb[k] = 1, m1 = mh;
            } else {
              pa[k] = col, sa[k] = 1, m0 = mh;
            }
          }
          if (!valid1) m1 = 0;
          pmin[k] = m0 | (m1 << 16);
          pp2[k] = pmin[k] + p2;
          sn[k] = next_buf + k * state_dir + noff;
          sg[k] = sends[k] ? stage + k * col_bytes + d_lo : -1;
          hi_out[k] = roll > 0 && last_hi;
          wm[k] = __byte_perm((unsigned)smem[pa[k] - sa[k]],
                              (unsigned)smem[pb[k] - sb[k]], 0x5410);
          wc[k] = __byte_perm((unsigned)smem[pa[k]], (unsigned)smem[pb[k]],
                              0x5410);
        }
        // the sums this step adds onto, two planes ahead of their use (the
        // rows themselves were asked into the L2 two steps ago)
        auto load_old = [&](const uint16_t* at) -> unsigned {
          return EVEN && valid1
                     ? *(const unsigned*)at
                     : (unsigned)at[0] | (valid1 ? (unsigned)at[1] << 16 : 0u);
        };
        const bool far = s + 2 < S;
        unsigned old0 = 0, old1 = 0;
        if (a.accumulate) {
          old0 = load_old(o);
          if (d_lo + 1 < d_hi) old1 = load_old(o + W);
        }
#pragma unroll 2
        for (int d = d_lo; d < d_hi; ++d) {
          const unsigned cst = EVEN ? ld_even(smem + cp + coff)
                                    : ld_bytes(smem + cp + coff);
          unsigned sum = old0;
          old0 = old1;
          if (a.accumulate) {
            if (d + 2 < d_hi) old1 = load_old(o + 2 * (size_t)W);
            if (far) prefetch_l2(o + ahead2);
          }
#pragma unroll
          for (int k = 0; k < N; ++k) {
            pa[k] += sa[k];
            pb[k] += sb[k];
            const unsigned wp = __byte_perm((unsigned)smem[pa[k]],
                                            (unsigned)smem[pb[k]], 0x5410);
            const unsigned nb = __viaddmin_u16x2(__vminu2(wm[k], wp), p1pk,
                                                 wc[k]);
            const unsigned m = __vminu2(nb, pp2[k]);
            unsigned cur = (cst + m - pmin[k]) & kByte2;
            cur = (cur & ~restart_mask[k]) | (cst & restart_mask[k]);
            wm[k] = wc[k];
            wc[k] = wp;
            runmin[k] = __vminu2(runmin[k], cur | dead);
            sum += cur;
            *(uint16_t*)(smem + sn[k]) = (uint16_t)__byte_perm(cur, 0u, 0x4420);
            sn[k] += pitchS;
            if (sg[k] >= 0)
              smem[sg[k]++] = (uint8_t)(hi_out[k] ? cur >> 16 : cur);
          }
          if (EVEN && valid1) {
            *(unsigned*)o = sum;
          } else {
            o[0] = (uint16_t)sum;
            if (valid1) o[1] = (uint16_t)(sum >> 16);
          }
          cp += pitchC;
          coff = (coff + Wmod) & 15;
          o += W;
        }
      }

#pragma unroll
      for (int k = 0; k < N; ++k) {
        uint16_t* q = pm_next + (k * a.NCH + ch) * pitchM + 2 + lc;
        if (valid1)
          *(unsigned*)q = runmin[k];
        else
          q[0] = (uint16_t)runmin[k];
        if (sends[k] && hand_off) {
          // this chunk of the column that crosses the strip edge, then its
          // partial minimum, into the peer's buffer of this step
          const bool to_right = a.rolls[k] > 0;
          const unsigned mn =
              to_right && last_hi ? runmin[k] >> 16 : runmin[k] & 0xFFFFu;
          const unsigned* src =
              (const unsigned*)(smem + stage + k * col_bytes + d_lo);
          const unsigned dst = (to_right ? recv_right : recv_left) +
                               slot * recv_slot + k * recv_dir;
          const unsigned bar = (to_right ? bars_right : bars_left) + 8 * slot;
          if (a.DC % 16 == 0) {
            for (int i = 0; i < a.DC; i += 16)
              send_vec(dst + 16 + d_lo + i, src + i / 4, bar);
          } else {
            for (int i = 0; i < a.DC; i += 4)
              send_word(dst + 16 + d_lo + i, src[i / 4], bar);
          }
          send_word(dst + recv_pm + 4 * ch, mn, bar);
        }
      }
      g0 = n_g0, g1 = gc0, g2 = n_g2, g3 = n_g3;
      gc0 = n_gc0, gc1 = n_gc1;
    }
    cp_async_wait(a.NST - 2);
    __syncthreads();
    buf ^= 1;
  }

  if (a.cout_cost != nullptr) {  // the state after the last step
    const uint8_t* st = smem + state + buf * state_buf;
    const uint16_t* pmv = pm + buf * pm_buf;
    for (int idx = tid; idx < N * D * Lb; idx += blockDim.x) {
      const int j = idx % Lb, kd = idx / Lb, k = kd / D, d = kd - k * D;
      a.cout_cost[((size_t)b * a.carry_n * D + (size_t)k * D + d) * W +
                  cstart + j] = st[k * state_dir + (d + 1) * pitchS + 4 + j];
    }
    for (int idx = tid; idx < N * Lb; idx += blockDim.x) {
      const int j = idx % Lb, k = idx / Lb;
      int m = 0xFFFF;
      for (int c = 0; c < a.NCH; ++c)
        m = min(m, (int)pmv[(k * a.NCH + c) * pitchM + 2 + j]);
      a.cout_min[((size_t)b * a.carry_n + k) * W + cstart + j] = m;
    }
  }
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The launch shape for a cluster of `cs` blocks per image; returns the
// dynamic shared memory it needs, or -1 if `cs` strips leave a block empty.
int group_shape(GroupArgs& a, int n, int cs) {
  a.TW = round_up((a.W + cs - 1) / cs, 2);
  if ((cs - 1) * a.TW >= a.W) return -1;
  a.NP = a.TW / 2;
  if (a.NP > kGroupThreads) return kGroupSmem + 1;   // a wider cluster
  int nch = kGroupThreads / a.NP;
  nch = nch < 1 ? 1 : nch;
  nch = nch > kMaxChunks ? kMaxChunks : nch;
  nch = nch > a.D ? a.D : nch;
  a.DC = round_up((a.D + nch - 1) / nch, 4);   // whole words to hand over
  a.NCH = (a.D + a.DC - 1) / a.DC;
  a.pitchC = round_up(a.TW + 15, 16);
  a.pitchS = round_up(4 + a.TW + 4, 4);
  a.pitchM = 2 + a.TW + 2;
  // the table, barriers and tokens; then the ring, the state, the partial
  // minima and the hand-off buffers (3 slots of a column per direction)
  a.col_bytes = round_up(a.NCH * a.DC, 16);
  a.recv_dir = 32 + a.col_bytes + round_up(4 * a.NCH, 16);
  const long long body = round_up(2 * n * (a.D + 2) * a.pitchS +
                                  2 * n * a.NCH * a.pitchM * 2, 16);
  const long long tail = (long long)n * a.col_bytes + 3LL * n * a.recv_dir;
  for (a.NST = kMaxStages; a.NST >= 2; --a.NST) {
    const long long at = 576 + (long long)a.NST * a.D * a.pitchC + body;
    if (at + tail <= kGroupSmem) {
      a.stage_off = (int)at;
      a.recv_off = a.stage_off + n * a.col_bytes;
      a.smem_bytes = (int)(at + tail);
      return a.smem_bytes;
    }
  }
  return kGroupSmem + 1;
}

// A launch of `cs` blocks per image; `bytes` from group_shape at that size.
template <int N, bool EVEN>
cudaError_t group_config(const GroupArgs& a, int cs, int bytes,
                         cudaLaunchAttribute* attr,
                         cudaLaunchConfig_t* config) {
  cudaError_t err = cudaFuncSetAttribute(
      group_kernel<N, EVEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(group_kernel<N, EVEN>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             cs > 8);
  if (err != cudaSuccess) return err;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3((unsigned)(a.B * cs));
  config->blockDim = dim3((unsigned)round_up(a.NP * a.NCH, 32));
  config->dynamicSmemBytes = (size_t)bytes;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

// The cluster size of a launch, decided before it: the smallest whose state
// fits shared memory, grown while the card has idle SMs; 16 blocks (not a
// portable size) only if nothing smaller fits or a strip of 8 would still be
// heavy (columns x D), and only if the card says it can place such a
// cluster.  *chosen = 0: no size takes N directions at this shape.
template <int N, bool EVEN>
cudaError_t choose_cluster(const GroupArgs& a, int* chosen) {
  *chosen = 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int cs = 0;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    GroupArgs trial = a;
    const int need = group_shape(trial, N, c);
    if (need < 0) break;
    if (need > kGroupSmem) continue;
    if (cs != 0 && (long long)a.B * cs >= sms) break;
    if (c > 8) {
      if (cs != 0 &&
          (long long)round_up((a.W + 7) / 8, 2) * a.D < kHeavyStrip)
        break;
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t config;
      err = group_config<N, EVEN>(trial, c, need, attr, &config);
      if (err != cudaSuccess) return err;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, group_kernel<N, EVEN>,
                                           &config);
      if (err != cudaSuccess) return err;
      if (clusters < 1) break;
    }
    cs = c;
  }
  *chosen = cs;
  return cudaSuccess;
}

// One launch; its error is the entry's.
template <int N, bool EVEN>
int launch_group(GroupArgs a, cudaStream_t stream) {
  int cs = 0;
  cudaError_t err = choose_cluster<N, EVEN>(a, &cs);
  if (err != cudaSuccess) return (int)err;
  if (cs == 0) return (int)cudaErrorInvalidConfiguration;
  const int bytes = group_shape(a, N, cs);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
  err = group_config<N, EVEN>(a, cs, bytes, attr, &config);
  if (err != cudaSuccess) return (int)err;
  config.stream = stream;
  return (int)cudaLaunchKernelEx(&config, group_kernel<N, EVEN>, a);
}

using Chooser = cudaError_t (*)(const GroupArgs&, int*);
using Launcher = int (*)(GroupArgs, cudaStream_t);
constexpr Chooser kChoose[kMaxDirs][2] = {
    {choose_cluster<1, false>, choose_cluster<1, true>},
    {choose_cluster<2, false>, choose_cluster<2, true>},
    {choose_cluster<3, false>, choose_cluster<3, true>}};
constexpr Launcher kLaunch[kMaxDirs][2] = {
    {launch_group<1, false>, launch_group<1, true>},
    {launch_group<2, false>, launch_group<2, true>},
    {launch_group<3, false>, launch_group<3, true>}};

// Whether the kernel may take column pairs as one 16- or 32-bit access.
bool even_access(const GroupArgs& a) {
  return a.W % 2 == 0 && (uintptr_t)a.cost % 2 == 0 &&
         (uintptr_t)a.out % 4 == 0;
}

}  // namespace

// One direction of the aggregation: vertical (scan over H; roll -1/0/+1
// selects the wrap diagonals) or horizontal (scan over W).  accumulate=0
// stores the contribution, 1 adds it to the volume.
extern "C" int sgm_scan_direction(const void* cost, const void* img,
                                  void* aggr, int B, int H, int D, int W,
                                  int vertical, int reverse, int roll,
                                  int restart, int p1, int p2_init,
                                  int accumulate, void* stream) {
  return scan_direction(cost, img, aggr, B, H, D, W, vertical, reverse, roll,
                        restart, p1, p2_init, accumulate, stream);
}

// A group of up to 3 vertical directions that share a scan order, in one
// launch (see the header): rolls r0..r2 (the first n count), contributions
// summed on chip and stored (accumulate=0) or added (1) to the uint16
// volume once; a group that no cluster takes at this shape is refused
// (cudaErrorInvalidConfiguration; see sgm_scan_group_capacity).  cin_cost
// may be null (fresh paths; then cin_min and
// prev_gray are unused) and cout_cost null (no carry-out wanted); both point
// at (B, carry_n, ...) int32 tensors, at the plane of direction r0.
extern "C" int sgm_scan_group(const void* cost, const void* img, void* aggr,
                              const void* cin_cost, const void* cin_min,
                              const void* prev_gray, void* cout_cost,
                              void* cout_min, int B, int S, int D, int W,
                              int n, int r0, int r1, int r2, int carry_n,
                              int reverse, int restart, int p1, int p2_init,
                              int accumulate, void* stream) {
  if ((long long)B * S * W == 0) return 0;
  if (D < 1 || D > 256 || n < 1 || n > kMaxDirs || p1 < 0 || p2_init < 0)
    return (int)cudaErrorInvalidValue;
  const int rolls[kMaxDirs] = {r0, r1, r2};
  GroupArgs a{};
  a.cost = (const uint8_t*)cost;
  a.img = (const uint8_t*)img;
  a.out = (uint16_t*)aggr;
  a.cin_cost = (const int*)cin_cost;
  a.cin_min = (const int*)cin_min;
  a.prev_gray = (const uint8_t*)prev_gray;
  a.cout_cost = (int*)cout_cost;
  a.cout_min = (int*)cout_min;
  a.B = B, a.S = S, a.D = D, a.W = W;
  for (int k = 0; k < n; ++k) {
    if (rolls[k] < -1 || rolls[k] > 1) return (int)cudaErrorInvalidValue;
    a.rolls[k] = rolls[k];
  }
  a.carry_n = carry_n, a.reverse = reverse, a.restart = restart;
  a.p1 = p1, a.p2_init = p2_init, a.accumulate = accumulate;
  return kLaunch[n - 1][even_access(a)](a, (cudaStream_t)stream);
}

// The most directions (0..3) one sgm_scan_group launch takes for these
// volumes at this shape on the current card, into the host int *dirs (3 for
// an empty volume: its launch does nothing).
extern "C" int sgm_scan_group_capacity(const void* cost, const void* aggr,
                                       int B, int D, int W, void* dirs) {
  *(int*)dirs = kMaxDirs;
  if ((long long)B * W == 0) return 0;
  *(int*)dirs = 0;
  if (D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  GroupArgs a{};
  a.cost = (const uint8_t*)cost;
  a.out = (uint16_t*)aggr;
  a.B = B, a.D = D, a.W = W;
  for (int n = kMaxDirs; n >= 1; --n) {
    int cs = 0;
    const cudaError_t err = kChoose[n - 1][even_access(a)](a, &cs);
    if (err != cudaSuccess) return (int)err;
    if (cs != 0) {
      *(int*)dirs = n;
      break;
    }
  }
  return 0;
}
