// K2: SGM path aggregation (one launch per direction group).
//
// Replaces: soc_project_stereo_matching_tpu/ops/pallas_kernels.py:
//   _directional_scan_group / _scan_group_kernel (with and without its
//   cross-tile carry-in/out refs, and with its `wta` epilogue) and
//   _directional_scan_group_bidir / _bidir_kernel (both scan orders, the
//   volume or the WTA planes only, here two launches that each carry both
//   orders and meet at the middle row), as driven by
//   aggregate_paths, aggregate_paths_wta and parallel/tiles.py.  The WTA
//   reduction of a stored volume is csrc/wta.cu.
//
// Two scan kernels live here.  `group_kernel` (sgm_scan_group) is the one the
// port runs: up to three directions that share a scan order in one launch,
// in one order or, in the two-order scan's two launches, both, optionally
// ending in the WTA epilogue (below, after the scan's design).
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
//     makes; a group that no size takes in one cluster is split by the
//     wrapper, which asks sgm_scan_group_capacity first, into smaller groups
//     where one direction fits, else runs over several clusters (below).
//   * Several clusters an image (MULTI, where no cluster holds a row's state
//     for even one direction: D x W large, as at full-resolution Middlebury
//     or D > 256).  G clusters of CS = 16 blocks (8 where the card places no
//     16) own the image's G * CS strips in order, the row's column pairs
//     shared out as evenly as they can be (strip_start); G is the fewest
//     that holds the state (plan_multi; kernels.group_clusters transcribes
//     it).  Inside a cluster the strips hand over as below; at a cluster's
//     edge (and at the image's wrap, the last cluster to the first) the one
//     column a diagonal moves goes through device memory (`xchg`, three
//     slots by receiving block) and a block's step count (`ticks`,
//     published with release at GPU scope after the step's block barrier,
//     read with acquire) says it is there; each edge block waits for both
//     neighbours' counts, so they stay a step apart and a slot is free again
//     when it is written.  The roll-0 direction hands nothing over.  An
//     image's clusters wait on each other, so all of them must be resident
//     at once: the launch runs the images in waves of as many as the card
//     holds at once (cudaOccupancyMaxActiveClusters), and an image that
//     does not fit is refused before any launch.  With the epilogue, a row's
//     columns come from every cluster, so the ring's "ready" and "free" are
//     every block's step and row counts there instead of mbarriers.
//   * D split over the blocks of a cluster (SPLIT, with MULTI's hand-off):
//     from D = 280 on where no one cluster holds a row (measured faster
//     there, PERF.md section 6), and wherever strips of two columns do not
//     hold one direction's state (the slab ring and two state buffers of
//     D + 2 rows: D above 2,515).  A cluster of KR blocks (8, else 16, 4,
//     2; plan_split) is one of the image's G strips, block r holds the
//     disparities [r DK, (r + 1) DK) of its state and cost slabs, DK a
//     multiple of 4 (the last block the rest), with up to kSplitChunks
//     chunks a column pair.  A step needs from the other blocks only the
//     state at d0 - 1 and d0 + DK (rows 0 and DK + 1 of its state, which
//     hold the sentinels at D's ends) and each column's minimum over all
//     D: after the step's block barrier every block sends its range's
//     minimum of each column pair to every block of the cluster (row r of
//     their range minima, three slots by step) and its two edge rows to
//     the blocks below and above, all by st.async onto the receiver's
//     hand-off barrier of the step.  Every block waits for every other
//     block's message each step, so the blocks stay a step apart and need
//     no tokens.  The strip's edge column goes to the neighbour strip's
//     cluster through device memory (`xchg`, by receiving strip: each
//     block writes its range of the column, thread 0 its range minimum,
//     then its step count); a block waits for the counts of every block of
//     both neighbour strips and copies rows d0 - 1 .. d0 + DK of the column
//     and the KR minima into its hand-off buffer.  With one strip (G = 1)
//     the wrap is the strip's hand-off to itself.  The epilogue's reducers
//     need no merge across blocks: the ring holds whole rows in device
//     memory, so the KR blocks of a strip share its column pairs, each
//     over all D, with up to kSplitChunks chunks a pair.
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
// The horizontal pair runs as the two-order scan of the direction (0,) on
// the transposed volume (csrc/transpose.cu), so nothing walks the volume
// at stride W.
// Bytes per volume element over the 8 directions: 2
// (cost transposed) + 3 + 5 (horizontal groups) + 4 (sum transposed back) +
// 5 + 5 (vertical groups) = 24, all in whole sectors, against 38 before.
//
//
// Passes and sets (ScanPass): a launch takes one or two passes, each one
// scan order of the group over a range of rows [lo, hi) with its own rolls,
// carry-in and carry-out, and runs them on one or two sets of B clusters.
// A set's passes run one after the other (its later passes adding onto the
// sums of the earlier; every pass's state, gray values and cost ring set up
// afresh, the hand-off's barrier phases carried over, a cluster.sync()
// between passes); two sets run side by side on clusters of their own.
//
// The two-order scan (kernels.bidir_launches): both orders of a group, the
// TPU kernel's _bidir_kernel, which keeps the first order's sums in VMEM
// and adds the second's.  No shared memory here holds a frame's sums
// (21.6 MB at the cone size), so they are parked where the volume goes
// (added in place onto `acc`).  One launch of the two orders in turn takes
// 2 S dependent steps, and a step costs 2-5 us whatever the batch; but the
// orders are independent until their sums meet, and the carry mode cuts an
// order anywhere.  So the scan is two launches, each with the two orders
// on sets of their own, meeting at the middle row m = S / 2: the first
// launch scans the forward order over [0, m) and the reverse order over
// [m, S), each parking its sums and writing its state at the meeting row
// as a carry (int32 by column, the tiles' layout; the prev_gray row is the
// image's row beside the meeting row); the second continues each order over
// the other half from its carry, adding onto the other order's sums, which
// are final there.  S steps in all and twice the clusters a launch, which
// fills the card where one launch left SMs idle (B <= 8, a B = 1 frame).
// The sums are uint16 adds, so the order of the adds changes no bit; at
// S = 1 the forward order's first half is empty and it starts fresh in the
// second launch.  A thread owns the same columns and chunk of D in both
// launches, so each read of a parked sum is of a store of a launch before.
//
// The WTA epilogue (views > 0, each set's last pass) stores no volume: the
// step's finished totals go into `finished`, a ring of kRing rows a cluster
// in device memory (the L2), and warps of their own reduce each row while
// the recurrence goes on.  A block holds at most kWtaThreads recurrence
// threads and then kReducers reducers (two warpgroups); they meet only at
// the cluster barriers of a pass's start and of the kernel's end, and at
// the ring's mbarriers: after a step's block barrier, threads 0..CS-1 of the
// recurrence arrive on that row's "ready" barrier in every block of the
// cluster (release at cluster scope); one reducer waits for it (acquire)
// and a barrier of the reducers passes it on; the reducers reduce the row,
// then, after another barrier of theirs, arrive on its slot's "free"
// barrier in every block; the recurrence's thread 0 waits for that before
// its block writes the slot again, kRing steps later, at the step's start
// where it already waits for the hand-off.  So the reducers may lag
// kRing - 1 rows, and every wait has a bound that traps.  The inverse view
// of column j reads plane k at column j + dmin + k, up to dmin + D - 1
// columns past a strip's edge (63 at the cone, 151 at KITTI-2012, 255 at
// Middlebury-half): through the ring every block reads every column of its
// image.  A reducer takes a chunk of D at a column pair of its block's
// strip, both views: the best of its planes (the min, the min over the
// other planes, the first plane that holds the min) from batches of loads
// issued together, the two columns in the 16-bit lanes of a word (one
// 4-byte load where the pair is aligned), five instructions a plane; the
// chunks of a pair are neighbouring lanes of a warp, and their bests merge
// in a tree by shuffles (a tie keeps the earlier plane), so the epilogue
// holds no shared memory and costs a launch no directions; then the pair's
// first lane reads the costs beside each column's best plane and stores
// the five planes.  The planes equal csrc/wta.cu's, bit for bit, as
// kernels.wta_online_plain's; kernels.wta_epilogue_plain transcribes this
// decomposition.  A kernel with the epilogue takes at most kWtaThreads
// recurrence threads so that the block, reducers included, has 96
// registers a thread (at 80 its recurrence spilled more), and grows its
// cluster only while every cluster of the launch fits the card at once.
// What it costs, what bounds it and what was tried: PERF.md section 6,
// the two-order scan redesigned.

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
  // the first design keeps a lane's DPL = D / 32 disparities in registers:
  // D <= 256, for the tools (the group kernel takes D up to kMaxRange)
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
// With the WTA epilogue the recurrence takes at most kWtaThreads threads
// and the reducers, two warpgroups of their own, kReducers: 640 threads at
// 96 registers each.
constexpr int kWtaThreads = 384;
constexpr int kReducers = 256;
constexpr int kRing = 4;           // finished rows of an image in flight
constexpr int kClampP = 1024;      // P1, P2' beyond 255 never win a min
constexpr long long kWaitCycles = 1LL << 32;   // about 2 s
constexpr long long kHeavyStrip = 16384;   // columns x D of a strip
constexpr int kGroupSmem = 232448; // 227 KB, the most a block can take
constexpr unsigned kByte2 = 0x00FF00FFu;
constexpr int kMaxRange = 16384;   // D: the WTA's key, cost << 14 | k
// D split over the blocks of a cluster (SPLIT): chunks of a range per
// column pair, the recurrence's and the reducers'
constexpr int kSplitChunks = 32;
// From this D on the split takes the place of several clusters an image
// where no one cluster holds a row: measured faster at D = 280 and 760
// (PERF.md section 6), not measured below
constexpr int kSplitFrom = 280;

// One scan order of a group over the rows [lo, hi) (reverse: hi - 1 down to
// lo).  The host's layout is kernels.ScanPass (ctypes).
struct ScanPass {
  const int* cin_cost;        // (B, carry_n, D, W) at this launch's first
  const int* cin_min;         // direction, (B, carry_n, 1, W); or null: fresh
  const uint8_t* prev_gray;   // the row before the first, image b's at
                              // b * gray_stride
  int* cout_cost;             // as cin_*, or null (no carry-out wanted)
  int* cout_min;
  int rolls[kMaxDirs];
  int reverse, lo, hi, gray_stride;
};

struct GroupArgs {
  const uint8_t* cost;        // (B, S, D, W)
  const uint8_t* img;         // (B, S, W)
  uint16_t* out;              // (B, S, D, W)
  // `sets` sets of B clusters; set k runs the passes
  // pass[k * npass .. k * npass + npass) in order, each later pass adding
  // onto what the one before stored
  ScanPass pass[2];
  int npass, sets;
  int B, S, D, W;
  int carry_n, restart, p1, p2_init, accumulate;
  // the WTA epilogue (the last pass): `views` (1 forward, 2 with the
  // inverse view) x 5 int32 (B, S, W) planes, no volume store; the finished
  // rows go through `finished`, a ring of kRing uint16 (D, W) rows a cluster
  int views, dmin;
  uint16_t* finished;
  int* planes;
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
  int fill_end;    // end of the staged and received columns
  int rec_threads; // the recurrence's threads (a multiple of 32)
  int red_chunks;  // the reducers' chunks of D a column pair (a power of 2)
  int red_dc;      // ... and planes a chunk
  int ring_bars;   // byte offset of the ring's barriers (kRing "ready",
                   // kRing "free"), or -1 without the epilogue
  int smem_bytes;  // all of the dynamic shared memory
  // several clusters an image (MULTI): G clusters of CS blocks own the
  // image's G * CS strips in order; the launch (a wave) runs the images
  // img0 .. img0 + gridDim.x / (G * CS) - 1 of the sets x B
  int G, img0;
  int* ticks;      // (sets * B, 2, G * CS) int32, zero at the launch: per
                   // block, the steps its recurrence has finished and the
                   // rows its reducers have reduced
  uint8_t* xchg;   // (sets * B, G * CS, kSlots, n, recv_dir) bytes: the
                   // columns handed over between clusters, by receiving
                   // block; SPLIT: (sets * B, G, kSlots, n, xchg_dir), by
                   // receiving strip
  // (last, so that the fields before keep their offsets)
  // D split over the blocks of a cluster (SPLIT, with MULTI's hand-off):
  // a cluster of KR blocks owns one of the image's G strips, block r the
  // disparities [r * DK, min(D, (r + 1) * DK)); 1 and D otherwise
  int KR, DK;
  int red_np;      // the reducers' rounds of column pairs (NP unless SPLIT)
  int rm_off;      // SPLIT: byte offset of the range minima, (kSlots, n,
                   // KR, pitchM) uint16: block r's minimum over its range
                   // of each column, row r, slot step % kSlots; else -1
  int xchg_dir;    // SPLIT: bytes of a direction's column in xchg: 16, the
                   // D bytes at 16 + d, then at xchg_pm a word per block
  int xchg_pm;
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

// Several clusters an image (MULTI): the first column of strip r of
// `strips`, which share the row's column pairs as evenly as they can (a
// strip of width TW each would leave the last ones empty at many strip
// counts); strip_start(strips, ...) = W.
__host__ __device__ __forceinline__ int strip_start(int r, int strips, int W) {
  const long long pairs = (W + 1) / 2;
  const long long c = 2 * ((long long)r * pairs / strips);
  return (int)(c < W ? c : W);
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

// --- the WTA epilogue ------------------------------------------------------
// The reducers, warps of their own, reduce each finished row while the
// recurrence's warps go on to the next.  A row reaches them through the
// ring in device memory (the L2), and two sets of kRing barriers in each
// block pace the hand-over: "ready" (a slot holds its row: one arrival from
// each block's recurrence, after all its stores) and "free" (every block's
// reducers are done with a slot: one arrival from each block's reducers).
// Both are arrived on remotely with release at cluster scope and waited on
// with acquire at cluster scope, each by one thread between two barriers
// of its role, so the stores of every thread of one role are ordered before
// the loads of every thread of the other.

// A block barrier of `count` threads (a role's warps), barrier `id`.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on a barrier of a block of the cluster (its shared::cluster
// address), releasing what this thread and the threads of its last block
// barrier wrote.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned peer_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               ::"r"(peer_bar)
               : "memory");
}

// mbar_wait with acquire at cluster scope: what the arrivals released is
// seen by this thread and, after its next block barrier, by its role.
__device__ __forceinline__ void mbar_wait_cluster(unsigned bar, int parity) {
  unsigned done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > kWaitCycles) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- between clusters (MULTI) ----------------------------------------------
// Clusters of one image meet only in device memory: a block publishes how
// many steps (or rows) it has finished with release at GPU scope, after a
// block barrier that orders its threads' stores before it; a waiter reads
// the count with acquire at GPU scope and passes it on with a barrier of
// its role, whose threads then read the data from the L2 (__ldcg).

__device__ __forceinline__ void tick_publish(int* at, int value) {
  asm volatile("fence.acq_rel.gpu;\n"
               "st.relaxed.gpu.global.s32 [%0], %1;\n" ::"l"(at),
               "r"(value)
               : "memory");
}

__device__ __forceinline__ int tick_read(const int* at) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(at)
               : "memory");
  return v;
}

// One thread: until *at >= target; traps after kWaitCycles, as mbar_wait.
__device__ __forceinline__ void tick_wait(const int* at, int target) {
  const long long start = clock64();
  while (tick_read(at) < target)
    if (clock64() - start > kWaitCycles) __trap();
}

// A whole warp: until at[i] >= target for every i < n, 32 at a time.
__device__ __forceinline__ void ticks_wait_all(const int* at, int n,
                                               int target) {
  const int lane = threadIdx.x & 31;
  const long long start = clock64();
  for (int i0 = 0; i0 < n; i0 += 32) {
    bool ok = i0 + lane >= n;
    while (!__all_sync(kFull, ok)) {
      if (!ok) ok = tick_read(at + i0 + lane) >= target;
      if (clock64() - start > kWaitCycles) __trap();
    }
  }
}

constexpr int kBig = 1 << 30;   // sec_min where D = 1
constexpr int kWtaBatch = 4;    // planes whose loads a reducer issues at once

// The best of a view's planes [k0, k1) at a reducer's two columns, in the
// 16-bit lanes of a word: the min m1 and the min m2 over the range's other
// planes (0xFFFF, neutral, for one plane), and in bk the first plane that
// holds m1 (column 0 in the low half).  A step is one VIMNMX.U16x2, whose
// predicates say where the min stays (so a tie keeps the first plane), a
// max and a min for m2 and two selects; the costs beside the min are read
// once the row's best is known.
struct Best2 {
  unsigned m1, m2, bk;
};

__device__ __forceinline__ void best_init(Best2& t, unsigned vp, int k) {
  t.m1 = vp;
  t.m2 = 0xFFFFFFFFu;
  t.bk = (unsigned)k * 0x00010001u;
}

__device__ __forceinline__ void best_step(Best2& t, unsigned vp, int k) {
  bool keep1, keep0;   // m1 <= v: the min stays
  const unsigned m1 = __vibmin_u16x2(t.m1, vp, &keep1, &keep0);
  t.m2 = __vminu2(t.m2, __vmaxu2(t.m1, vp));
  t.m1 = m1;
  t.bk = __byte_perm(keep0 ? t.bk : (unsigned)k, keep1 ? t.bk : (unsigned)k << 16,
                     0x7610);
}

// l (planes [.., kr)) followed by r (planes [kr, ..)), into l: exact for
// any two neighbouring ranges, so the chunks of a pair merge in a tree.  A
// tie keeps l's plane; m2 = min(max(l.m1, r.m1), l.m2, r.m2), since a
// range's m2 is never below its m1.
__device__ __forceinline__ void best_merge(Best2& l, const Best2& r) {
  bool keep1, keep0;   // l.m1 <= r.m1: l keeps the min
  const unsigned m1 = __vibmin_u16x2(l.m1, r.m1, &keep1, &keep0);
  l.m2 = __vminu2(__vmaxu2(l.m1, r.m1), __vminu2(l.m2, r.m2));
  l.m1 = m1;
  l.bk = __byte_perm(keep0 ? l.bk : r.bk, keep1 ? l.bk : r.bk, 0x7610);
}

// The costs of a view's plane at a reducer's two columns c0 (even) and
// c0 + 1, in the 16-bit lanes of a word, 65535 past the row's end; one
// 4-byte load where the pair is 4-byte aligned (EVEN and an even column),
// else two 2-byte loads.  From the L2: other blocks wrote the row.
template <bool EVEN>
__device__ __forceinline__ unsigned pair_of(const uint16_t* at, int col, int W,
                                            bool valid1) {
  if (EVEN && valid1 && !(col & 1))
    return col < W ? __ldcg((const unsigned*)at) : 0xFFFFFFFFu;
  const unsigned lo = col < W ? (unsigned)__ldcg(at) : 0xFFFFu;
  const unsigned hi = valid1 && col + 1 < W ? (unsigned)__ldcg(at + 1) : 0xFFFFu;
  return lo | hi << 16;
}

// A view's cost at plane k of column x of a finished row: the forward view
// reads (k, x), the inverse view (k, x + dmin + k), 65535 past the row's
// end.
__device__ __forceinline__ int cost_at(const uint16_t* row, int v, int dmin,
                                       int W, int x, int k) {
  const int col = x + (v ? dmin + k : 0);
  return col < W ? (int)__ldcg(row + (size_t)k * W + col) : 0xFFFF;
}

// A reducer's best of a finished row (in the ring, `row`) over its chunk of
// planes [d_lo, d_hi) at its columns c0 and c0 + 1, per view (t[view]).
// The inverse view of column x reads plane d at column x + dmin + d,
// wherever in the image's row that lies.  The loads of a batch of planes,
// both views, are issued before any is used: each batch is one round trip
// to the L2.
template <bool EVEN>
__device__ __forceinline__ void wta_best(const uint16_t* row, Best2 (&t)[2],
                                         int views, int dmin, int W, int c0,
                                         bool on, bool valid1, int d_lo,
                                         int d_hi) {
  best_init(t[0], 0xFFFFFFFFu, d_lo);
  best_init(t[1], 0xFFFFFFFFu, d_lo);
#pragma unroll 1
  for (int d0 = d_lo; on && d0 < d_hi; d0 += kWtaBatch) {
    unsigned c[2][kWtaBatch];
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int i = 0; i < kWtaBatch; ++i) {
        const int d = d0 + i;
        const int col = c0 + (v ? dmin + d : 0);
        c[v][i] = d < d_hi && v < views
                      ? pair_of<EVEN>(row + (size_t)d * W + col, col, W, valid1)
                      : 0xFFFFFFFFu;
      }
#pragma unroll
    for (int i = 0; i < kWtaBatch; ++i) {
      const int d = d0 + i;
      if (d >= d_hi) break;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (i == 0 && d0 == d_lo)
          best_init(t[v], c[v][i], d);
        else
          best_step(t[v], c[v][i], d);
      }
    }
  }
}

// The reducers' part of a block (threads R .. R + kReducers - 1 of it) in
// the last pass: for each of the pass's rows, wait until every block of
// the cluster has stored it, reduce the block's strip of it (both views)
// and store its planes, then free its ring slot in every block.  A reducer
// takes a chunk of D at a column pair; the chunks of a pair are
// neighbouring lanes of a warp, whose bests merge in a tree by shuffles
// (no shared memory); the first lane of a pair then reads the costs beside
// each column's best plane (one round trip) and stores the five planes.
// Pairs beyond the reducers' count take further rounds.  MULTI: the row's
// columns come from every cluster of the image, so "ready" is every block's
// step count (ticks[0 .. GR), ahead by `base` steps of the earlier passes)
// and "free" this block's row count (ticks[GR + R]), both in device memory.
template <bool EVEN, bool MULTI, bool SPLIT>
__device__ __forceinline__ void reduce_rows(const GroupArgs& a,
                                            const ScanPass& P, int rt, int b,
                                            int cstart, int Lb, int CS,
                                            const uint16_t* fin,
                                            unsigned long long* ready,
                                            unsigned long long* freed,
                                            int* ticks, int GR, int R,
                                            int base) {
  const int D = a.D, W = a.W, dmin = a.dmin;
  const int np = SPLIT ? a.red_np : a.NP;   // rounds of column pairs
  const int nchr = a.red_chunks, dcr = a.red_dc, per = kReducers / nchr;
  const int chunk = rt % nchr;
  const int d_lo = chunk * dcr, d_hi = min(D, d_lo + dcr);
  const size_t plane = (size_t)a.B * a.S * W;
  const int steps = P.hi - P.lo;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kRing;
    if (MULTI) {
      if (rt < 32) ticks_wait_all(ticks, GR, base + s + 1);
    } else if (rt == 0) {
      mbar_wait_cluster(smem_addr(ready + slot), (s / kRing) & 1);
    }
    bar_sync(2, kReducers);
    const uint16_t* row = fin + (size_t)slot * D * W;
    const int t = P.reverse ? P.hi - 1 - s : P.lo + s;
    int* out = a.planes + ((size_t)b * a.S + t) * W;
#pragma unroll 1
    for (int p0 = 0; p0 < np; p0 += per) {   // the same rounds for all
      const int lc = 2 * (p0 + rt / nchr), c0 = cstart + lc;
      const bool on = lc < Lb && d_lo < D;
      const bool valid1 = lc + 1 < Lb;
      Best2 best[2];
      wta_best<EVEN>(row, best, a.views, dmin, W, c0, on, valid1, d_lo, d_hi);
#pragma unroll 1
      for (int o = 1; o < nchr; o <<= 1) {
        const bool take = chunk % (2 * o) == 0 && d_lo + o * dcr < D;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          Best2 r;   // every lane shuffles
          r.m1 = __shfl_down_sync(kFull, best[v].m1, o);
          r.m2 = __shfl_down_sync(kFull, best[v].m2, o);
          r.bk = __shfl_down_sync(kFull, best[v].bk, o);
          if (take) best_merge(best[v], r);
        }
      }
      if (on && chunk == 0) {
        int beside[2][2][2];   // [view][column][below, above]
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int bk = (int)(best[v].bk >> (16 * h)) & 0xFFFF;
            const bool in = v < a.views && (h == 0 || valid1);
            beside[v][h][0] = in && bk > 0
                                  ? cost_at(row, v, dmin, W, c0 + h, bk - 1) : 0;
            beside[v][h][1] = in && bk < D - 1
                                  ? cost_at(row, v, dmin, W, c0 + h, bk + 1) : 0;
          }
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (v >= a.views || (h && !valid1)) continue;
            const int bk = (int)(best[v].bk >> (16 * h)) & 0xFFFF;
            const int m1 = (int)(best[v].m1 >> (16 * h)) & 0xFFFF;
            const int m2 = (int)(best[v].m2 >> (16 * h)) & 0xFFFF;
            int* o = out + (size_t)v * 5 * plane + c0 + h;
            o[0] = bk;
            o[plane] = m1;
            o[2 * plane] = D > 1 ? m2 : kBig;
            o[3 * plane] = bk == 0 ? m1 : beside[v][h][0];
            o[4 * plane] = bk == D - 1 ? m1 : beside[v][h][1];
          }
      }
    }
    bar_sync(2, kReducers);   // every reducer is done with the slot
    if (MULTI) {
      if (rt == 0) tick_publish(ticks + GR + R, s + 1);
    } else if (rt < CS) {
      mbar_arrive_cluster(peer_addr(smem_addr(freed + slot), rt));
    }
  }
}

// EVEN: W is even, the cost volume starts at an even address and the sum at
// a multiple of 4, so a column pair of the cost slab is one 16-bit load and a
// pair of sums one 32-bit access; else bytes and halves.  WTA: the last pass
// carries the epilogue (a.views > 0), reduced by warps of their own.
// MULTI: an image takes a.G clusters; the strips at a cluster's two edges
// hand over through device memory (a.xchg) and the reducers pace the ring
// by counts there (a.ticks).  SPLIT (with MULTI): a cluster is one strip
// and its blocks split D (see the header).
template <int N, bool EVEN, bool WTA, bool MULTI, bool SPLIT = false>
__global__ void __launch_bounds__(WTA ? kWtaThreads + kReducers
                                      : kGroupThreads)
    group_kernel(const __grid_constant__ GroupArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int G = MULTI ? a.G : 1;
  const int cl = blockIdx.x / CS;       // the launch's cluster
  const int image = a.img0 + cl / G;    // of the sets x B
  const int GR = G * CS;                // strips of the image
  const int strip = (cl - (cl / G) * G) * CS + rank;   // this block's
  const int set = image / a.B, b = image - set * a.B;
  const int tid = threadIdx.x;
  const int R = a.rec_threads;   // the recurrence's; the reducers follow
  const int D = a.D, W = a.W, S = a.S;
  const int pitchS = a.pitchS, pitchC = a.pitchC, pitchM = a.pitchM;
  // SPLIT: this block's strip of the image, its disparities [d0, d0 + DL)
  // and the range every block's layout is sized for (DS)
  const int sg = cl - (cl / G) * G;
  const int d0 = SPLIT ? rank * a.DK : 0;
  const int DL = SPLIT ? min(D, d0 + a.DK) - d0 : D;
  const int DS = SPLIT ? a.DK : D;

  // shared memory, by byte offset (GroupArgs and group_shape agree on it)
  uint16_t* lut = (uint16_t*)smem;                              // 256
  unsigned long long* bars = (unsigned long long*)(smem + 512); // kSlots
  unsigned* tokens = (unsigned*)(smem + 544);                   // kSlots x 2
  const int ring = 576;                                         // NST slabs
  const int slab_bytes = DS * pitchC;
  // state rows 0 and D + 1 hold the sentinels of d = -1 and d = D (SPLIT:
  // rows 0 and DL + 1, the state at d0 - 1 and d0 + DL, from the blocks of
  // the ranges below and above, or the sentinels at D's ends)
  const int state = ring + a.NST * slab_bytes;                  // (2, N, D+2)
  const int state_dir = (DS + 2) * pitchS, state_buf = N * state_dir;
  uint16_t* pm = (uint16_t*)(smem + state + 2 * state_buf);     // (2, N, NCH)
  const int pm_buf = N * a.NCH * pitchM;
  // SPLIT: every block's range minima, by step (kSlots, N, KR, pitchM)
  uint16_t* rm = SPLIT ? (uint16_t*)(smem + a.rm_off) : nullptr;
  const int rm_slot = N * CS * pitchM;
  // the column that leaves the strip, per direction: written in the loop by
  // the edge pair's threads, sent from here
  const int stage = a.stage_off, col_bytes = a.col_bytes;       // (N, col)
  // what the neighbours hand over, per slot and direction: 16 sentinel
  // bytes, the column (a byte per disparity), 16 sentinel bytes, then a
  // word per chunk with its partial minimum
  const int recv = a.recv_off, recv_dir = a.recv_dir, recv_slot = N * recv_dir;
  const int recv_pm = 32 + col_bytes;
  // the epilogue's ring barriers
  unsigned long long* ready =
      WTA ? (unsigned long long*)(smem + a.ring_bars) : nullptr;
  unsigned long long* freed = WTA ? ready + kRing : nullptr;

  const int cstart = SPLIT   ? strip_start(sg, G, W)
                     : MULTI ? strip_start(strip, GR, W)
                             : strip * a.TW;
  const int Lb = SPLIT   ? strip_start(sg + 1, G, W) - cstart
                 : MULTI ? strip_start(strip + 1, GR, W) - cstart
                         : strip_cols(strip, a.TW, W);
  // MULTI: the neighbour strips in other clusters, and this image's counts
  // (SPLIT: every block is at both edges of its strip)
  const bool gleft = MULTI && (SPLIT || rank == 0);
  const bool gright = MULTI && (SPLIT || rank == CS - 1);
  const int left_strip = (strip + GR - 1) % GR, right_strip = (strip + 1) % GR;
  const int left_g = (sg + G - 1) % G, right_g = (sg + 1) % G;   // SPLIT
  int* ticks = MULTI ? a.ticks + (size_t)image * 2 * GR : nullptr;
  // the planes of this block's range: the cost, the sums, the ring's rows
  const uint8_t* cost_b = a.cost + (size_t)b * S * D * W + (size_t)d0 * W;
  const uint8_t* cost_end = a.cost + (size_t)a.B * S * D * W;
  const uint8_t* img_b = a.img + (size_t)b * S * W;
  uint16_t* out_b = a.out + (size_t)b * S * D * W + (size_t)d0 * W;
  const uint16_t* fin = WTA ? a.finished + (size_t)image * kRing * D * W
                            : nullptr;
  uint16_t* fin_d = WTA ? (uint16_t*)fin + (size_t)d0 * W : nullptr;

  for (int i = tid; i < 256; i += blockDim.x)
    lut[i] = (uint16_t)min(max(a.p1, a.p2_init / (i + 1)), kClampP);
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(smem_addr(bars + i), 1);
    if (WTA)
      for (int i = 0; i < 2 * kRing; ++i) mbar_init(smem_addr(ready + i), CS);
    mbar_fence_init();
  }
  for (int i = tid; i < 2 * N * 2 * pitchS; i += blockDim.x) {
    const int row = i / pitchS;   // (buffer, direction, first or last row)
    smem[state + (row >> 1) * state_dir + (row & 1) * (DL + 1) * pitchS +
         i % pitchS] = (uint8_t)kSentinel;
  }
  // the staged and the received columns start as sentinels: what no message
  // writes (d = -1, d >= D) stays one
  for (int i = tid; i < (a.fill_end - stage) / 4; i += blockDim.x)
    ((unsigned*)(smem + stage))[i] = 0xFFFFFFFFu;

  if (WTA && tid >= R) {
    // the reducers: a cluster barrier with the recurrence at each pass's
    // start, the rows of the last pass as they are finished
    int base = 0;   // the recurrence's steps in the passes before
    for (int pass = 0; pass < a.npass; ++pass) {
      const ScanPass& P = a.pass[set * a.npass + pass];
      cluster.sync();
      if (pass == a.npass - 1) {
        // SPLIT: the blocks of a strip share its column pairs, each over
        // all D (the ring holds whole rows)
        const int sp = (Lb + 1) / 2;
        const int r0 = SPLIT ? min(Lb, 2 * (rank * sp / CS)) : 0;
        const int r1 = SPLIT ? min(Lb, 2 * ((rank + 1) * sp / CS)) : Lb;
        reduce_rows<EVEN, MULTI, SPLIT>(a, P, tid - R, b, cstart + r0,
                                        r1 - r0, CS, fin, ready, freed, ticks,
                                        GR, strip, base);
      }
      base += P.hi - P.lo;
    }
    cluster.sync();   // no block leaves while a peer may still arrive
    return;
  }

  // The recurrence's threads; their block barrier leaves the reducers out.
  auto rec_sync = [&]() {
    if (WTA)
      bar_sync(1, R);
    else
      __syncthreads();
  };

  const unsigned p1pk = (unsigned)min(a.p1, kClampP) * 0x00010001u;

  // One row's (D, Lb) cost slab into a ring buffer: per d, the 16-byte
  // chunks that cover the segment, from its aligned-down address.
  const int cpr = pitchC / 16;
  int reverse = 0, lo = 0, hi = 0;   // this pass's
  auto stage_row = [&](int step) {
    const int t = reverse ? hi - 1 - step : lo + step;
    uint8_t* slab = smem + ring + (step % a.NST) * slab_bytes;
    const uint8_t* g_row = cost_b + (size_t)t * D * W + cstart;
    for (int idx = tid; idx < DL * cpr; idx += R) {
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

  // This thread's columns and chunk of D.
  const int p = tid % a.NP, ch = tid / a.NP;
  const int lc = 2 * p;
  const int c0 = cstart + lc;
  const bool active = ch < a.NCH && lc < Lb;
  const bool valid1 = lc + 1 < Lb;
  const int d_lo = ch * a.DC, d_hi = min(DL, d_lo + a.DC);
  const int cm1 = (c0 + W - 1) % W, cp1 = (c0 + 1) % W, cp2 = (c0 + 2) % W;
  const unsigned dead = valid1 ? 0u : 0xFFFF0000u;  // lane 1 holds no column
  const bool first_col = lc == 0;
  const bool last_col = lc == Lb - 1 || lc + 1 == Lb - 1;
  const int Wmod = W & 15;
  const int right = (rank + 1) % CS, left = (rank + CS - 1) % CS;
  const unsigned recv_right = peer_addr(smem_addr(smem + recv), right);
  const unsigned recv_left = peer_addr(smem_addr(smem + recv), left);
  const unsigned bars_right = peer_addr(smem_addr(bars), right);
  const unsigned bars_left = peer_addr(smem_addr(bars), left);
  const unsigned tokens_right = peer_addr(smem_addr(tokens), right);
  const unsigned tokens_left = peer_addr(smem_addr(tokens), left);
  // the next parity of each hand-off barrier (thread 0 waits on them)
  unsigned phases = 0;
  int tick0 = 0;   // MULTI: the steps of the passes before, as published

  for (int pass = 0; pass < a.npass; ++pass) {
    const ScanPass& P = a.pass[set * a.npass + pass];
    reverse = P.reverse, lo = P.lo, hi = P.hi;
    const int steps = hi - lo;
    const bool accumulate = pass > 0 || a.accumulate;
    const bool epi = WTA && pass == a.npass - 1;
    const bool fresh_start = P.cin_cost == nullptr;
    int rolls[N];
#pragma unroll
    for (int k = 0; k < N; ++k) rolls[k] = P.rolls[k];
    int diagonals = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) diagonals += rolls[k] != 0;
    // bytes a step's hand-off brings in: a token from each neighbour, and
    // per diagonal direction a column and its partial minima; MULTI: only
    // what comes from a neighbour in the cluster (the next cluster's comes
    // through device memory, `gtake` the directions that do)
    const int dir_bytes = a.NCH * a.DC + 4 * a.NCH;
    int step_bytes = 8 + diagonals * dir_bytes;
    bool gtake[N];
    bool any_gtake = false;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      gtake[k] = (rolls[k] > 0 && gleft) || (rolls[k] < 0 && gright);
      any_gtake |= gtake[k];
      if (MULTI && gtake[k]) step_bytes -= dir_bytes;
    }
    if (MULTI) step_bytes -= (gleft ? 4 : 0) + (gright ? 4 : 0);
    // SPLIT: every block's range minima of the strip's column pairs, and
    // the rows at d0 - 1 and d0 + DL from the blocks below and above
    if (SPLIT)
      step_bytes = CS * N * a.NP * 4 +
                   ((rank > 0) + (rank < CS - 1)) * N * ((a.TW + 3) / 4 * 4);
    const bool smem_link = step_bytes > 0;   // the cluster has a peer

    // The carry-in is the first state buffer, halo columns included.
    if (SPLIT && !fresh_start) {
      // rows 0 .. DL + 1: the disparities d0 - 1 .. d0 + DL, sentinels
      // past D's ends; the minima as block 0's range minima of the step
      // before the first, the other blocks' neutral
      const int span = Lb + 2;
      for (int idx = tid; idx < N * (DL + 2) * span; idx += R) {
        const int j = idx % span - 1;
        const int kd = idx / span;  // k * (DL + 2) + row
        const int k = kd / (DL + 2), row = kd - k * (DL + 2);
        const int d = d0 + row - 1, col = (cstart + j + W) % W;
        smem[state + k * state_dir + row * pitchS + 4 + j] =
            d >= 0 && d < D
                ? (uint8_t)P.cin_cost[((size_t)b * a.carry_n * D +
                                       (size_t)k * D + d) * W + col]
                : (uint8_t)kSentinel;
      }
      uint16_t* rm0 = rm + (kSlots - 1) * rm_slot;
      for (int idx = tid; idx < N * CS * span; idx += R) {
        const int j = idx % span - 1;
        const int kr = idx / span;  // k * CS + r
        const int k = kr / CS, col = (cstart + j + W) % W;
        rm0[kr * pitchM + 2 + j] =
            kr - k * CS == 0
                ? (uint16_t)P.cin_min[((size_t)b * a.carry_n + k) * W + col]
                : (uint16_t)0xFFFF;
      }
    } else if (!fresh_start) {
      const int span = Lb + 2;  // columns -1 .. Lb of the strip
      for (int idx = tid; idx < N * D * span; idx += R) {
        const int j = idx % span - 1;
        const int kd = idx / span;  // k * D + d
        const int col = (cstart + j + W) % W;
        const int k = kd / D, d = kd - k * D;
        smem[state + k * state_dir + (d + 1) * pitchS + 4 + j] =
            (uint8_t)P.cin_cost[((size_t)b * a.carry_n * D + (size_t)k * D + d) *
                                    W + col];
      }
      for (int idx = tid; idx < N * a.NCH * span; idx += R) {
        const int j = idx % span - 1;
        const int kc = idx / span;  // k * NCH + ch
        const int k = kc / a.NCH;
        const int col = (cstart + j + W) % W;
        pm[kc * pitchM + 2 + j] =
            kc - k * a.NCH == 0
                ? (uint16_t)P.cin_min[((size_t)b * a.carry_n + k) * W + col]
                : (uint16_t)0xFFFF;
      }
    }

    if (pass > 0) cp_async_wait(0);   // the first pass's copies have landed
    for (int st = 0; st < a.NST - 1; ++st) {
      if (st < steps) stage_row(st);
      cp_async_commit();
    }

    // Per direction: the restart lanes, and whether this thread hands its
    // chunk of a column over to a peer or takes one from a peer.
    unsigned restart_mask[N];
    bool sends[N], takes[N];
    int soff[N];   // a direction's previous state, at this pair's column - roll
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int roll = rolls[k];
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
    if (active && steps > 0) {
      const int t = reverse ? hi - 1 : lo;
      gc0 = img_b[(size_t)t * W + c0];
      gc1 = valid1 ? img_b[(size_t)t * W + c0 + 1] : 0;
      if (!fresh_start) {
        const uint8_t* pr = P.prev_gray + (size_t)b * P.gray_stride;
        g0 = pr[cm1], g1 = pr[c0], g2 = pr[cp1], g3 = pr[cp2];
      }
    }
    // two rows ahead of a sum's element, for the L2 prefetch of the read-add
    const long long ahead2 = 2 * (reverse ? -(long long)D * W : (long long)D * W);

    cp_async_wait(a.NST - 2);
    // once a pass: the barriers are initialised, the carry-in is in, every
    // block is resident; before the second, every hand-off of the first
    // has been read
    cluster.sync();

    int buf = 0;
    for (int s = 0; s < steps; ++s) {
      const int t = reverse ? hi - 1 - s : lo + s;
      const bool hand_off = diagonals > 0 && s + 1 < steps;   // this step sends
      // SPLIT: this step's range minima and edge rows go to the cluster's
      // blocks (after the last step only for the carry-out's minima)
      const bool exch = SPLIT && (s + 1 < steps || P.cout_cost != nullptr);
      const int slot = s % kSlots;
      if (s + a.NST - 1 < steps) stage_row(s + a.NST - 1);
      cp_async_commit();
      if (SPLIT ? exch && tid == 0 : hand_off && tid == 0 && smem_link) {
        // arm this step's barrier; tell both peers that this block has left
        // step s - 1 behind (a peer never runs more than a step ahead, so a
        // hand-off buffer is free again two steps after it was read)
        mbar_expect(smem_addr(bars + slot), step_bytes);
        if (!gright)
          send_word(tokens_right + 4 * (slot * 2), (unsigned)s,
                    bars_right + 8 * slot);
        if (!gleft)
          send_word(tokens_left + 4 * (slot * 2 + 1), (unsigned)s,
                    bars_left + 8 * slot);
      }

      // one thread waits for what the neighbours handed over at the last
      // step (many spinning warps starve the ones that still compute) and,
      // in the epilogue, until every block's reducers are done with the
      // ring slot this step overwrites; the edge pairs read the hand-off
      // where it landed
      const bool handed = (SPLIT || diagonals > 0) && s > 0;
      const bool reuse = epi && s >= kRing;
      // MULTI: a later pass starts when the neighbour clusters have left the
      // one before (the hand-off buffers in device memory are used again),
      // and a step when they have finished the step before it, which also
      // keeps them at most a step apart
      const bool rejoin = MULTI && diagonals > 0 && s == 0 && pass > 0;
      if (handed || reuse || rejoin) {
        if (MULTI && tid < 32) {
          if (SPLIT) {   // every block of both neighbour strips
            if (diagonals > 0 && (handed || rejoin)) {
              ticks_wait_all(ticks + left_g * CS, CS, tick0 + s);
              ticks_wait_all(ticks + right_g * CS, CS, tick0 + s);
            }
          } else if ((handed || rejoin) && tid == 0) {
            if (gleft) tick_wait(ticks + left_strip, tick0 + s);
            if (gright) tick_wait(ticks + right_strip, tick0 + s);
          }
          if (reuse) ticks_wait_all(ticks + GR, GR, s - kRing + 1);
        }
        if (tid == 0) {
          if (handed && smem_link) {
            const int prev_slot = (s - 1) % kSlots;
            mbar_wait(smem_addr(bars + prev_slot), (phases >> prev_slot) & 1);
            phases ^= 1u << prev_slot;
          }
          if (reuse && !MULTI)
            mbar_wait_cluster(smem_addr(freed + s % kRing),
                              (s / kRing - 1) & 1);
        }
        rec_sync();
        if (SPLIT && diagonals > 0 && handed) {
          // the neighbour strip's column, d0 - 1 .. d0 + DL of it (written
          // by up to three of its blocks; sentinels stay past D's ends),
          // and its blocks' range minima there
          const int slot_in = (s - 1) % kSlots;
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (!gtake[k]) continue;
            const uint8_t* src =
                a.xchg + ((((size_t)image * G + sg) * kSlots + slot_in) * N +
                          k) * a.xchg_dir;
            uint8_t* dst = smem + recv + slot_in * recv_slot + k * recv_dir;
            for (int i = tid; i < DL + 2 + CS; i += R) {
              const int d = d0 - 1 + i;
              if (i >= DL + 2)
                *(unsigned*)(dst + recv_pm + 4 * (i - DL - 2)) = __ldcg(
                    (const unsigned*)(src + a.xchg_pm + 4 * (i - DL - 2)));
              else if (d >= 0 && d < D)
                dst[15 + i] = __ldcg(src + 16 + d);
            }
          }
          rec_sync();
        } else if (MULTI && handed && any_gtake) {
          // the columns from the next cluster, into the hand-off buffer
          // where a peer's would land: the bytes and the partial minima
          const int slot_in = (s - 1) % kSlots;
          const int cw = a.NCH * a.DC / 4;
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (!gtake[k]) continue;
            const uint8_t* src =
                a.xchg + ((((size_t)image * GR + strip) * kSlots + slot_in) *
                              N + k) * a.recv_dir;
            uint8_t* dst = smem + recv + slot_in * recv_slot + k * recv_dir;
            for (int i = tid; i < cw + a.NCH; i += R) {
              const int off = i < cw ? 16 + 4 * i : recv_pm + 4 * (i - cw);
              *(unsigned*)(dst + off) = __ldcg((const unsigned*)(src + off));
            }
          }
          rec_sync();
        }
      }

      if (active) {
        const bool fresh = s == 0 && fresh_start;
        const int prev_buf = buf * state_buf, next_buf = (buf ^ 1) * state_buf;
        const uint16_t* pm_prev = pm + buf * pm_buf;
        uint16_t* pm_next = pm + (buf ^ 1) * pm_buf;
        const size_t row_off = (size_t)t * D * W + c0;

        // the next step's gray values, asked for a step ahead, and the rows
        // of the image a few steps ahead, asked into the L2
        int n_gc0 = 0, n_gc1 = 0, n_g0 = 0, n_g2 = 0, n_g3 = 0;
        if (s + 1 < steps) {
          const uint8_t* next = img_b + (size_t)(reverse ? t - 1 : t + 1) * W;
          const uint8_t* here = img_b + (size_t)t * W;
          n_gc0 = next[c0];
          n_gc1 = valid1 ? next[c0 + 1] : 0;
          n_g0 = here[cm1], n_g2 = here[cp1], n_g3 = here[cp2];
          if (s + 4 < steps && ch == 0)
            prefetch_l2(img_b + (size_t)(reverse ? t - 4 : t + 4) * W + c0);
        }

        const int from = recv + ((s + kSlots - 1) % kSlots) * recv_slot;

        // the slab row of plane d_lo at this pair; the sums' row it adds
        // onto (src) and the row it stores (o): the volume, or in the
        // epilogue the ring of finished rows
        int cp = ring + (s % a.NST) * slab_bytes + d_lo * pitchC + lc;
        int coff = (int)(((uintptr_t)(cost_b + (row_off - lc)) +
                          (uintptr_t)d_lo * W) & 15);
        const uint16_t* src = out_b + row_off + (size_t)d_lo * W;
        uint16_t* o = epi ? fin_d + (size_t)(s % kRing) * D * W +
                                (size_t)d_lo * W + c0
                          : out_b + row_off + (size_t)d_lo * W;
        unsigned runmin[N];
#pragma unroll
        for (int k = 0; k < N; ++k) runmin[k] = 0xFFFFFFFFu;
        auto load_old = [&](const uint16_t* at) -> unsigned {
          return EVEN && valid1
                     ? *(const unsigned*)at
                     : (unsigned)at[0] | (valid1 ? (unsigned)at[1] << 16 : 0u);
        };
        auto store = [&](unsigned sum) {
          if (EVEN && valid1) {
            *(unsigned*)o = sum;
          } else {
            o[0] = (uint16_t)sum;
            if (valid1) o[1] = (uint16_t)(sum >> 16);
          }
        };

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
                    (uint8_t)(rolls[k] > 0 && last_hi ? cst >> 16 : cst);
            }
            unsigned sum = cst * N;
            if (accumulate) sum += load_old(src);
            store(sum);
            cp += pitchC;
            coff = (coff + Wmod) & 15;
            src += W;
            o += W;
          }
        } else {
          unsigned pmin[N], pp2[N], wm[N], wc[N];
          int pa[N], pb[N], sa[N], sb[N];   // the pair's two bytes: at, stride
          int sn[N], sg[N];                 // new state; staged column or -1
          bool hi_out[N];
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const int roll = rolls[k];
            const int ga = roll > 0 ? g0 : roll < 0 ? g2 : g1;
            const int gb = roll > 0 ? g1 : roll < 0 ? g3 : g2;
            const unsigned p2 = (unsigned)lut[abs(gc0 - ga)] |
                                ((unsigned)lut[abs(gc1 - gb)] << 16);
            // min over D of the previous columns: the chunks' partial minima
            // (SPLIT: every block's range minima)
            const uint16_t* q =
                SPLIT ? rm + ((s + kSlots - 1) % kSlots) * rm_slot +
                            k * CS * pitchM + 2 + lc - roll
                      : pm_prev + k * a.NCH * pitchM + 2 + lc - roll;
            unsigned m0 = 0xFFFFu, m1 = 0xFFFFu;
            if (roll == 0) {
              unsigned m = 0xFFFFFFFFu;
              for (int c = 0; c < (SPLIT ? CS : a.NCH); ++c)
                m = __vminu2(m, *(const unsigned*)(q + c * pitchM));
              m0 = m & 0xFFFFu, m1 = m >> 16;
            } else {
              for (int c = 0; c < (SPLIT ? CS : a.NCH); ++c) {
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
              for (int c = 0; c < (SPLIT ? CS : a.NCH); ++c)
                mh = min(mh, mins[c]);
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
          const bool far = s + 2 < steps;
          unsigned old0 = 0, old1 = 0;
          if (accumulate) {
            old0 = load_old(src);
            if (d_lo + 1 < d_hi) old1 = load_old(src + W);
          }
#pragma unroll 2
          for (int d = d_lo; d < d_hi; ++d) {
            const unsigned cst = EVEN ? ld_even(smem + cp + coff)
                                      : ld_bytes(smem + cp + coff);
            unsigned sum = old0;
            old0 = old1;
            if (accumulate) {
              if (d + 2 < d_hi) old1 = load_old(src + 2 * (size_t)W);
              if (far) prefetch_l2(src + ahead2);
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
            store(sum);
            cp += pitchC;
            coff = (coff + Wmod) & 15;
            src += W;
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
            const bool to_right = rolls[k] > 0;
            const unsigned mn =
                to_right && last_hi ? runmin[k] >> 16 : runmin[k] & 0xFFFFu;
            const unsigned* src_col =
                (const unsigned*)(smem + stage + k * col_bytes + d_lo);
            const unsigned dst = (to_right ? recv_right : recv_left) +
                                 slot * recv_slot + k * recv_dir;
            const unsigned bar = (to_right ? bars_right : bars_left) + 8 * slot;
            if (SPLIT) {
              // to the next strip's cluster, this block's range of the
              // column (whole words: a range but the last is one); its range
              // minimum follows after the step (split_exchange)
              uint8_t* g =
                  a.xchg + ((((size_t)image * G + (to_right ? right_g : left_g)) *
                                 kSlots + slot) * N + k) * a.xchg_dir;
              for (int i = 0; i < d_hi - d_lo; i += 4)
                *(unsigned*)(g + 16 + d0 + d_lo + i) = src_col[i / 4];
            } else if (MULTI && (to_right ? gright : gleft)) {
              // to the next cluster: its buffer of this step in device
              // memory, published with this block's step count
              uint8_t* g =
                  a.xchg + ((((size_t)image * GR +
                              (to_right ? right_strip : left_strip)) *
                                 kSlots + slot) * N + k) * a.recv_dir;
              for (int i = 0; i < a.DC; i += 4)
                *(unsigned*)(g + 16 + d_lo + i) = src_col[i / 4];
              *(unsigned*)(g + recv_pm + 4 * ch) = mn;
            } else {
              if (a.DC % 16 == 0) {
                for (int i = 0; i < a.DC; i += 16)
                  send_vec(dst + 16 + d_lo + i, src_col + i / 4, bar);
              } else {
                for (int i = 0; i < a.DC; i += 4)
                  send_word(dst + 16 + d_lo + i, src_col[i / 4], bar);
              }
              send_word(dst + recv_pm + 4 * ch, mn, bar);
            }
          }
        }
        g0 = n_g0, g1 = gc0, g2 = n_g2, g3 = n_g3;
        gc0 = n_gc0, gc1 = n_gc1;
      }
      cp_async_wait(a.NST - 2);
      rec_sync();
      // row s is in the ring: tell every block's reducers (MULTI: by this
      // block's step count, which also tells the next clusters that this
      // step's hand-off is in device memory)
      if (!MULTI && epi && tid < CS)
        mbar_arrive_cluster(peer_addr(smem_addr(ready + s % kRing), tid));
      if (SPLIT && exch) {
        const uint16_t* pmn = pm + (buf ^ 1) * pm_buf;   // this step's
        const uint8_t* nst = smem + state + (buf ^ 1) * state_buf;
        const unsigned bar = smem_addr(bars + slot);
        // each column pair's minimum over this block's range, to row
        // `rank` of every block's range minima (its own included)
        for (int i = tid; i < N * a.NP; i += R) {
          const int k = i / a.NP, pp = i - k * a.NP;
          unsigned m = 0xFFFFFFFFu;
          for (int c = 0; c < a.NCH; ++c)
            m = __vminu2(m, *(const unsigned*)(pmn + (k * a.NCH + c) * pitchM +
                                               2 + 2 * pp));
          const unsigned at = smem_addr(rm + slot * rm_slot +
                                        (k * CS + rank) * pitchM + 2 + 2 * pp);
#pragma unroll 1
          for (int r = 0; r < CS; ++r)
            send_word(peer_addr(at, r), m, peer_addr(bar, r));
        }
        // the rows at the range's two ends, to the blocks below (their row
        // DK + 1) and above (their row 0), whole words of the strip
        const int nw = (a.TW + 3) / 4;
        for (int i = tid; i < N * 2 * nw; i += R) {
          const int k = i / (2 * nw), up = (i / nw) & 1, wi = i % nw;
          const int peer = up ? rank + 1 : rank - 1;
          if (peer < 0 || peer >= CS) continue;
          const int off = k * state_dir + 4 + 4 * wi;
          const unsigned v =
              *(const unsigned*)(nst + off + (up ? DL : 1) * pitchS);
          send_word(peer_addr(smem_addr(nst + off + (up ? 0 : DS + 1) * pitchS),
                              peer),
                    v, peer_addr(bar, peer));
        }
        // the range minimum of the column each diagonal hands to the next
        // strip, beside its bytes (tick_publish below orders them)
        if (tid == 0 && hand_off) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (rolls[k] == 0) continue;
            const int col = rolls[k] > 0 ? Lb - 1 : 0;
            unsigned m = 0xFFFFu;
            for (int c = 0; c < a.NCH; ++c)
              m = min(m, (unsigned)pmn[(k * a.NCH + c) * pitchM + 2 + col]);
            uint8_t* g =
                a.xchg + ((((size_t)image * G + (rolls[k] > 0 ? right_g : left_g)) *
                               kSlots + slot) * N + k) * a.xchg_dir;
            *(unsigned*)(g + a.xchg_pm + 4 * rank) = m;
          }
        }
      }
      if (MULTI && tid == 0 && (epi || (diagonals > 0 && (gleft || gright))))
        tick_publish(ticks + strip, tick0 + s + 1);
      buf ^= 1;
    }
    tick0 += steps;
    if (MULTI && tid == 0) tick_publish(ticks + strip, tick0);   // the pass
    if (P.cout_cost != nullptr) {  // the state after the last step
      if (SPLIT && steps > 0) {    // every block's range minima of it
        if (tid == 0) {
          const int last = (steps - 1) % kSlots;
          mbar_wait(smem_addr(bars + last), (phases >> last) & 1);
          phases ^= 1u << last;
        }
        rec_sync();
      }
      const uint8_t* st = smem + state + buf * state_buf;
      const uint16_t* pmv = pm + buf * pm_buf;
      for (int idx = tid; idx < N * DL * Lb; idx += R) {
        const int j = idx % Lb, kd = idx / Lb, k = kd / DL, d = kd - k * DL;
        P.cout_cost[((size_t)b * a.carry_n * D + (size_t)k * D + d0 + d) * W +
                    cstart + j] = st[k * state_dir + (d + 1) * pitchS + 4 + j];
      }
      const uint16_t* rmv = SPLIT ? rm + ((steps + kSlots - 1) % kSlots) * rm_slot
                                  : nullptr;
      for (int idx = tid; idx < (SPLIT && rank > 0 ? 0 : N * Lb); idx += R) {
        const int j = idx % Lb, k = idx / Lb;
        int m = 0xFFFF;
        if (SPLIT) {
          for (int r = 0; r < CS; ++r)
            m = min(m, (int)rmv[(k * CS + r) * pitchM + 2 + j]);
        } else {
          for (int c = 0; c < a.NCH; ++c)
            m = min(m, (int)pmv[(k * a.NCH + c) * pitchM + 2 + j]);
        }
        P.cout_min[((size_t)b * a.carry_n + k) * W + cstart + j] = m;
      }
      rec_sync();   // before a next pass's carry-in overwrites the state
    }
  }
  if (WTA) cluster.sync();   // as the reducers: the kernel's end
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The launch shape for clusters of `cs` blocks, `g` of them an image;
// returns the dynamic shared memory it needs, or -1 if g * cs strips leave
// a block empty (g = 1: strips of TW columns, the last the rest; g > 1:
// strip_start's).  With `wta` the recurrence takes at most kWtaThreads
// threads, the reducers' partition is chosen and the ring's barriers are
// held too.  kr > 1 (SPLIT): a cluster of cs = kr blocks is one of g
// strips, its blocks split D in ranges of DK (a multiple of 4; -1 where
// that leaves a block without a disparity), with up to kSplitChunks chunks
// a pair and the range minima of every block held beside the state.
// (kernels.group_smem_bytes transcribes it.)
int group_shape(GroupArgs& a, int n, int cs, int g, bool wta, int kr = 1) {
  const int strips = kr > 1 ? g : cs * g;
  if (g == 1 && kr == 1) {
    a.TW = round_up((a.W + strips - 1) / strips, 2);
    if ((strips - 1) * a.TW >= a.W) return -1;
  } else {   // strip_start: the pairs shared out, the widest strip's
    const int pairs = (a.W + 1) / 2;
    if (strips > pairs) return -1;
    a.TW = 2 * ((pairs + strips - 1) / strips);
  }
  a.KR = kr;
  a.DK = kr > 1 ? round_up((a.D + kr - 1) / kr, 4) : a.D;
  if ((long long)(kr - 1) * a.DK >= a.D) return -1;
  a.NP = a.TW / 2;
  const int threads = wta ? kWtaThreads : kGroupThreads;
  if (a.NP > threads) return kGroupSmem + 1;   // a wider cluster
  const int max_chunks = kr > 1 ? kSplitChunks : kMaxChunks;
  int nch = threads / a.NP;
  nch = nch < 1 ? 1 : nch;
  nch = nch > max_chunks ? max_chunks : nch;
  nch = nch > a.DK ? a.DK : nch;
  a.DC = round_up((a.DK + nch - 1) / nch, 4);   // whole words to hand over
  a.NCH = (a.DK + a.DC - 1) / a.DC;
  a.rec_threads = round_up(a.NP * a.NCH, 32);
  // the reducers: a power of two of chunks a pair, as many as fill them
  // (SPLIT: the strip's pairs shared out over its blocks)
  a.red_np = (a.NP + kr - 1) / kr;
  int rch = 1;
  while (2 * rch <= max_chunks && 2 * rch <= a.D &&
         2 * rch * a.red_np <= kReducers)
    rch *= 2;
  a.red_chunks = rch;
  a.red_dc = (a.D + rch - 1) / rch;
  a.pitchC = round_up(a.TW + 15, 16);
  a.pitchS = round_up(4 + a.TW + 4, 4);
  a.pitchM = 2 + a.TW + 2;
  // the table, barriers and tokens; then the ring, the state, the partial
  // minima (SPLIT: and every block's range minima), the hand-off buffers
  // (3 slots of a column per direction) and the epilogue's ring barriers
  a.col_bytes = round_up(a.NCH * a.DC, 16);
  a.recv_dir = 32 + a.col_bytes +
               round_up(4 * (a.NCH > kr ? a.NCH : kr), 16);
  const long long state_pm = round_up(2 * n * (a.DK + 2) * a.pitchS +
                                      2 * n * a.NCH * a.pitchM * 2, 16);
  const long long minima = kr > 1 ? round_up(kSlots * n * kr * a.pitchM * 2, 16)
                                  : 0;
  const long long body = state_pm + minima;
  a.xchg_pm = 16 + round_up(a.D + 4, 16);
  a.xchg_dir = a.xchg_pm + round_up(4 * kr, 16);
  const long long tail = (long long)n * a.col_bytes + 3LL * n * a.recv_dir;
  const long long ring_bars = wta ? 2LL * kRing * 8 : 0;
  for (a.NST = kMaxStages; a.NST >= 2; --a.NST) {
    const long long at = 576 + (long long)a.NST * a.DK * a.pitchC + body;
    if (at + tail + ring_bars <= kGroupSmem) {
      a.rm_off = kr > 1 ? (int)(at - minima) : -1;
      a.stage_off = (int)at;
      a.recv_off = a.stage_off + n * a.col_bytes;
      a.fill_end = (int)(at + tail);
      a.ring_bars = wta ? a.fill_end : -1;
      a.smem_bytes = (int)(at + tail + ring_bars);
      return a.smem_bytes;
    }
  }
  return kGroupSmem + 1;
}

// A launch of `images` images, a.G clusters of `cs` blocks each; `bytes`
// from group_shape at that size.
template <int N, bool EVEN, bool WTA, bool MULTI, bool SPLIT = false>
cudaError_t group_config(const GroupArgs& a, int cs, int bytes, int images,
                         cudaLaunchAttribute* attr,
                         cudaLaunchConfig_t* config) {
  auto* kernel = group_kernel<N, EVEN, WTA, MULTI, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             cs > 8);
  if (err != cudaSuccess) return err;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3((unsigned)((long long)images * a.G * cs));
  config->blockDim = dim3((unsigned)(a.rec_threads + (WTA ? kReducers : 0)));
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
template <int N, bool EVEN, bool WTA>
cudaError_t choose_cluster(const GroupArgs& a, int* chosen) {
  *chosen = 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long clusters_wanted = (long long)a.sets * a.B;
  int cs = 0;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    GroupArgs trial = a;
    trial.G = 1;
    const int need = group_shape(trial, N, c, 1, WTA);
    if (need < 0) break;
    if (need > kGroupSmem) continue;
    if (cs != 0 && clusters_wanted * cs >= sms) break;
    if (c > 8 && cs != 0 &&
        (long long)round_up((a.W + 7) / 8, 2) * a.D < kHeavyStrip)
      break;
    if (c > 8 || (WTA && cs != 0)) {
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t config;
      err = group_config<N, EVEN, WTA, false>(trial, c, need, a.sets * a.B,
                                               attr, &config);
      if (err != cudaSuccess) return err;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(
          &clusters, group_kernel<N, EVEN, WTA, false>, &config);
      if (err != cudaSuccess) return err;
      if (clusters < 1) break;
      // the epilogue's clusters wait on each other's rows: grow a cluster
      // only while the launch's clusters still fit the card at once
      if (WTA && cs != 0 && clusters < clusters_wanted) break;
    }
    cs = c;
  }
  *chosen = cs;
  return cudaSuccess;
}

// Where no cluster holds an image's row: clusters of the largest size the
// card places (16 blocks, else 8), as few of them an image as hold its
// state (g = 2, 3, ...).  An image's clusters wait on each other's steps,
// so they must all be resident at once: the launch runs the images in
// waves of as many as the card holds at once (per_wave, asked of the card
// for this kernel and shape); per_wave = 0 where one image's clusters do
// not fit the card at once.  G = 0: no number of clusters takes N
// directions (strips of two columns still do not fit).  KR: the blocks a
// strip's D is split over (plan_split), 1 here.
struct Plan {
  long long G, CS, per_wave, clusters, work;   // work: bytes of ticks + xchg
  long long KR;
};

template <int N, bool EVEN, bool WTA>
cudaError_t plan_multi(const GroupArgs& a, Plan* p) {
  *p = Plan{};
  for (int cs = kMaxCluster; cs >= 8; cs /= 2) {
    for (int g = 2;; ++g) {
      GroupArgs trial = a;
      trial.G = g;
      const int need = group_shape(trial, N, cs, g, WTA);
      if (need < 0) break;
      if (need > kGroupSmem) continue;
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t config;
      cudaError_t err =
          group_config<N, EVEN, WTA, true>(trial, cs, need, 1, attr, &config);
      if (err != cudaSuccess) return err;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(
          &clusters, group_kernel<N, EVEN, WTA, true>, &config);
      if (err != cudaSuccess) return err;
      if (clusters < 1) break;   // the card places no cluster of cs blocks
      const long long images = (long long)a.sets * a.B, strips = (long long)g * cs;
      *p = Plan{g, cs, clusters / g, clusters,
                round_up((int)(images * 2 * strips * 4), 256) +
                    images * strips * kSlots * N * trial.recv_dir,
                1};
      if (p->per_wave >= 1) return cudaSuccess;
      break;
    }
  }
  return cudaSuccess;
}

// D split over the blocks of a cluster (SPLIT): where no one cluster holds
// a row's state and D >= kSplitFrom, or where not even strips of two
// columns hold it for one direction (D above about 2,515), or where the
// caller asks for it (ranges >= 2).  A cluster of KR blocks takes one of
// the image's G strips, block r the disparities [r DK, (r + 1) DK); G is
// the fewest strips whose blocks fit shared memory.  KR is the first of
// 8, 16, 4, 2 (or `ranges` alone) whose clusters the card holds at once:
// 8 blocks were the fastest at 2964x1988 D = 280 and 760 for the vertical
// pair with the epilogue, and within 1.15x of the fastest (16) for the
// horizontal pair at D = 760 (PERF.md section 6).  Where none fits, the plan
// reported is KR = 16's (the widest rows), else the last that splits; as
// plan_multi, per_wave = 0 then, and G = 0 where no KR takes N directions.
template <int N, bool EVEN, bool WTA>
cudaError_t plan_split(const GroupArgs& a, int ranges, Plan* p) {
  *p = Plan{};
  constexpr int kOrder[] = {8, 16, 4, 2};
  for (int i = 0; i < (ranges ? 1 : 4); ++i) {
    const int kr = ranges ? ranges : kOrder[i];
    for (int g = 1;; ++g) {
      GroupArgs trial = a;
      trial.G = g;
      const int need = group_shape(trial, N, kr, g, WTA, kr);
      if (need < 0) break;
      if (need > kGroupSmem) continue;
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t config;
      cudaError_t err = group_config<N, EVEN, WTA, true, true>(
          trial, kr, need, 1, attr, &config);
      if (err != cudaSuccess) return err;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(
          &clusters, group_kernel<N, EVEN, WTA, true, true>, &config);
      if (err != cudaSuccess) return err;
      if (clusters < 1) break;   // the card places no cluster of kr blocks
      const long long images = (long long)a.sets * a.B;
      const Plan q{g, kr, clusters / g, clusters,
                   round_up((int)(images * 2 * g * kr * 4), 256) +
                       images * g * kSlots * N * trial.xchg_dir,
                   kr};
      if (q.per_wave >= 1) {
        *p = q;
        return cudaSuccess;
      }
      if (p->KR != 16) *p = q;   // the plan to report if none fits
      break;
    }
  }
  return cudaSuccess;
}

// The plan of a launch that no one cluster an image takes.  From D =
// kSplitFrom on, D split (plan_split) where it fits the card at once;
// else, and below kSplitFrom, several clusters an image where strips of
// two columns hold the state of N directions (from kSplitFrom on, only
// where they fit at once; where neither does, the split's plan is the one
// reported); D split where strips do not hold even one direction's; the
// split alone where the caller asks for it (ranges >= 2).  G = 0 where
// strips hold one direction but not N: the group is split over launches
// (sgm_scan_group_capacity), as before the split existed.
template <int N, bool EVEN, bool WTA>
cudaError_t plan_wide(const GroupArgs& a, int ranges, Plan* p) {
  if (ranges == 0) {
    Plan split{};
    cudaError_t err;
    if (a.D >= kSplitFrom) {
      err = plan_split<N, EVEN, WTA>(a, 0, &split);
      if (err != cudaSuccess) return err;
      if (split.G != 0 && split.per_wave >= 1) {
        *p = split;
        return err;
      }
    }
    err = plan_multi<N, EVEN, WTA>(a, p);
    if (err != cudaSuccess) return err;
    // neither fits the card at once: the split's plan is the one reported
    if (split.G != 0 && !(p->G != 0 && p->per_wave >= 1)) *p = split;
    if (p->G != 0) return err;
    if (N > 1) {
      Plan one;
      err = plan_multi<1, EVEN, WTA>(a, &one);
      if (err != cudaSuccess || one.G != 0) return err;
    }
  }
  return plan_split<N, EVEN, WTA>(a, ranges, p);
}

// One wave-launched plan (MULTI or SPLIT): a launch per wave of images,
// with `work` (zeroed, plan.work bytes) for the counts and the hand-off
// between clusters.
template <int N, bool EVEN, bool WTA, bool SPLIT>
int launch_waves(GroupArgs a, const Plan& p, void* work, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
  a.G = (int)p.G;
  const int bytes = group_shape(a, N, (int)p.CS, a.G, WTA, (int)p.KR);
  const int images = a.sets * a.B;
  a.ticks = (int*)work;
  a.xchg = (uint8_t*)work + round_up(images * 2 * a.G * (int)p.CS * 4, 256);
  for (int img0 = 0; img0 < images; img0 += (int)p.per_wave) {
    a.img0 = img0;
    const int n_img = images - img0 < p.per_wave ? images - img0
                                                 : (int)p.per_wave;
    cudaError_t err = group_config<N, EVEN, WTA, true, SPLIT>(
        a, (int)p.CS, bytes, n_img, attr, &config);
    if (err != cudaSuccess) return (int)err;
    config.stream = stream;
    err = cudaLaunchKernelEx(&config, group_kernel<N, EVEN, WTA, true, SPLIT>,
                             a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One entry call: one launch where a cluster holds an image's row (G = 1),
// else a launch per wave of images over several clusters an image (MULTI)
// or with D split over a cluster's blocks (SPLIT; also where the caller
// asks for it, ranges >= 2).
template <int N, bool EVEN, bool WTA>
int launch_group(GroupArgs a, void* work, int ranges, cudaStream_t stream) {
  int cs = 0;
  cudaError_t err = cudaSuccess;
  if (ranges == 0) {
    err = choose_cluster<N, EVEN, WTA>(a, &cs);
    if (err != cudaSuccess) return (int)err;
  }
  if (cs != 0) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config;
    a.G = 1, a.img0 = 0;
    const int bytes = group_shape(a, N, cs, 1, WTA);
    err = group_config<N, EVEN, WTA, false>(a, cs, bytes, a.sets * a.B, attr,
                                            &config);
    if (err != cudaSuccess) return (int)err;
    config.stream = stream;
    return (int)cudaLaunchKernelEx(&config, group_kernel<N, EVEN, WTA, false>,
                                   a);
  }
  Plan p;
  err = plan_wide<N, EVEN, WTA>(a, ranges, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.G == 0 || p.per_wave < 1) return (int)cudaErrorInvalidConfiguration;
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  return p.KR > 1 ? launch_waves<N, EVEN, WTA, true>(a, p, work, stream)
                  : launch_waves<N, EVEN, WTA, false>(a, p, work, stream);
}

using Chooser = cudaError_t (*)(const GroupArgs&, int*);
using Planner = cudaError_t (*)(const GroupArgs&, int, Plan*);
using Launcher = int (*)(GroupArgs, void*, int, cudaStream_t);
// [directions - 1][even][wta]
#define SGM_GROUP_TABLE(F, N)                                   \
  {{F<N, false, false>, F<N, false, true>},                     \
   {F<N, true, false>, F<N, true, true>}}
constexpr Chooser kChoose[kMaxDirs][2][2] = {
    SGM_GROUP_TABLE(choose_cluster, 1), SGM_GROUP_TABLE(choose_cluster, 2),
    SGM_GROUP_TABLE(choose_cluster, 3)};
constexpr Planner kPlan[kMaxDirs][2][2] = {
    SGM_GROUP_TABLE(plan_wide, 1), SGM_GROUP_TABLE(plan_wide, 2),
    SGM_GROUP_TABLE(plan_wide, 3)};
constexpr Planner kSplit[kMaxDirs][2][2] = {
    SGM_GROUP_TABLE(plan_split, 1), SGM_GROUP_TABLE(plan_split, 2),
    SGM_GROUP_TABLE(plan_split, 3)};
constexpr Launcher kLaunch[kMaxDirs][2][2] = {
    SGM_GROUP_TABLE(launch_group, 1), SGM_GROUP_TABLE(launch_group, 2),
    SGM_GROUP_TABLE(launch_group, 3)};
#undef SGM_GROUP_TABLE

// Whether the kernel may take column pairs as one 16- or 32-bit access.
bool even_access(const GroupArgs& a) {
  return a.W % 2 == 0 && (uintptr_t)a.cost % 2 == 0 &&
         (uintptr_t)a.out % 4 == 0 &&
         (a.finished == nullptr || (uintptr_t)a.finished % 4 == 0);
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

// A group of up to 3 vertical directions in one launch (see the header):
// `passes` points at sets x npass ScanPass (host memory, read before the
// launch), each with the first n of its rolls; sets 1 or 2 sets of B
// clusters, set k running its npass passes (1 or 2) in order.  A set's
// first pass stores its contributions' sum into the uint16 volume
// (accumulate=0) or adds it (1); a later pass adds.  A pass's carry-in may
// be null (fresh paths; its prev_gray unused) and its carry-out null; both
// point at (B, carry_n, ...) int32 tensors, at the plane of the launch's
// first direction.  views=1 or 2: the WTA epilogue on each set's last
// pass, which stores no volume but the int32 (views * 5, B, S, W) planes of
// its rows' totals (forward view, then the inverse view at dmin), through
// `finished`, a uint16 (sets * B, kRing, D, W) scratch ring.  Where no
// cluster holds a row, an image takes several (sgm_scan_group_plan) and
// `work` must point at that plan's `work` bytes of zeros in device memory
// (else it may be null).  ranges = 0: the plan's own choice; 2..16: D split
// over that many blocks of a cluster whatever D (for measurements).  A
// group that no plan takes at this shape is refused
// (cudaErrorInvalidConfiguration; see sgm_scan_group_capacity).
extern "C" int sgm_scan_group(const void* cost, const void* img, void* aggr,
                              void* finished, void* planes, void* work,
                              const void* passes, int npass, int sets, int B,
                              int S, int D, int W, int n, int carry_n,
                              int restart, int p1, int p2_init,
                              int accumulate, int views, int dmin, int ranges,
                              void* stream) {
  if ((long long)B * S * W == 0) return 0;
  if (D < 1 || D > kMaxRange || n < 1 || n > kMaxDirs || p1 < 0 ||
      p2_init < 0 || views < 0 || views > 2 || npass < 1 || sets < 1 ||
      npass * sets > 2 || passes == nullptr || ranges == 1 || ranges < 0 ||
      ranges > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (views && (finished == nullptr || planes == nullptr || dmin < 0))
    return (int)cudaErrorInvalidValue;
  GroupArgs a{};
  const ScanPass* ps = (const ScanPass*)passes;
  for (int i = 0; i < npass * sets; ++i) {
    const ScanPass& q = ps[i];
    if (q.lo < 0 || q.lo > q.hi || q.hi > S ||
        (q.cin_cost != nullptr && (q.cin_min == nullptr ||
                                   q.prev_gray == nullptr)) ||
        (q.cout_cost != nullptr && q.cout_min == nullptr))
      return (int)cudaErrorInvalidValue;
    a.pass[i] = q;
    for (int k = 0; k < kMaxDirs; ++k) {
      if (k < n && (q.rolls[k] < -1 || q.rolls[k] > 1))
        return (int)cudaErrorInvalidValue;
      if (k >= n) a.pass[i].rolls[k] = 0;
    }
  }
  a.cost = (const uint8_t*)cost;
  a.img = (const uint8_t*)img;
  a.out = (uint16_t*)aggr;
  a.npass = npass, a.sets = sets;
  a.B = B, a.S = S, a.D = D, a.W = W;
  a.carry_n = carry_n, a.restart = restart;
  a.p1 = p1, a.p2_init = p2_init, a.accumulate = accumulate;
  a.views = views, a.dmin = dmin;
  a.finished = views ? (uint16_t*)finished : nullptr;
  a.planes = (int*)planes;
  return kLaunch[n - 1][even_access(a)][views > 0](a, work, ranges,
                                                   (cudaStream_t)stream);
}

// How a launch of n directions on `sets` sets of B images runs at this
// shape on the current card, into the host int64 out[6]: G (clusters an
// image; 0: no plan), CS (blocks a cluster), the images a launch (a wave)
// takes, the clusters of that shape the card holds at once (0 where G = 1:
// no wave is needed), the bytes of `work` sgm_scan_group needs (0 where
// G = 1) and KR (the blocks a strip's D is split over; 1: no split).  An
// empty volume's launch does nothing: G = 1, no work.  ranges as
// sgm_scan_group's.
extern "C" int sgm_scan_group_plan(const void* cost, const void* aggr, int B,
                                   int D, int W, int n, int wta, int sets,
                                   int ranges, void* out) {
  long long* o = (long long*)out;
  for (int i = 0; i < 6; ++i) o[i] = 0;
  if (D < 1 || D > kMaxRange || n < 1 || n > kMaxDirs || B < 0 || W < 0 ||
      sets < 1 || sets > 2 || ranges == 1 || ranges < 0 ||
      ranges > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  o[5] = 1;
  if ((long long)B * W == 0) {
    o[0] = 1;
    return 0;
  }
  GroupArgs a{};
  a.cost = (const uint8_t*)cost;
  a.out = (uint16_t*)aggr;
  a.npass = 1, a.sets = sets;
  a.B = B, a.D = D, a.W = W;
  const bool even = even_access(a);
  int cs = 0;
  cudaError_t err = cudaSuccess;
  if (ranges == 0) {
    err = kChoose[n - 1][even][wta != 0](a, &cs);
    if (err != cudaSuccess) return (int)err;
  }
  if (cs != 0) {
    o[0] = 1, o[1] = cs, o[2] = (long long)sets * B;
    return 0;
  }
  Plan p;
  err = kPlan[n - 1][even][wta != 0](a, ranges, &p);
  if (err != cudaSuccess) return (int)err;
  o[0] = p.G, o[1] = p.CS, o[2] = p.per_wave, o[3] = p.clusters, o[4] = p.work;
  o[5] = p.KR ? p.KR : 1;
  return 0;
}

// The most directions (0..3) one sgm_scan_group launch takes for these
// volumes at this shape on the current card, with (wta=1) or without the
// WTA epilogue, into the host int *dirs (3 for an empty volume: its launch
// does nothing): the most that one cluster an image takes, else the most
// that several clusters take with one image's clusters resident at once
// (plan_wide: with D split where strips of two columns do not hold one
// direction).  From D = kSplitFrom on, a group one cluster does not hold
// whole takes D split with all its directions where that fits, rather than
// launches of fewer directions in one cluster each (2 launches instead of
// 4 for the vertical pair at 2964x1988 D = 280: 42.2 ms against 90.5,
// PERF.md section 6).  ranges as sgm_scan_group's: the most the split takes.
extern "C" int sgm_scan_group_capacity(const void* cost, const void* aggr,
                                       int B, int D, int W, int wta,
                                       int ranges, void* dirs) {
  *(int*)dirs = kMaxDirs;
  if ((long long)B * W == 0) return 0;
  *(int*)dirs = 0;
  if (D < 1 || D > kMaxRange || ranges == 1 || ranges < 0 ||
      ranges > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  GroupArgs a{};
  a.cost = (const uint8_t*)cost;
  a.out = (uint16_t*)aggr;
  a.npass = a.sets = 1;
  a.B = B, a.D = D, a.W = W;
  const bool even = even_access(a);
  if (ranges == 0 && D >= kSplitFrom) {
    int cs = 0;
    cudaError_t err = kChoose[kMaxDirs - 1][even][wta != 0](a, &cs);
    if (err != cudaSuccess) return (int)err;
    for (int n = kMaxDirs; n >= 1 && cs == 0; --n) {
      Plan p;
      err = kSplit[n - 1][even][wta != 0](a, 0, &p);
      if (err != cudaSuccess) return (int)err;
      if (p.G != 0 && p.per_wave >= 1) {
        *(int*)dirs = n;
        return 0;
      }
    }
  }
  for (int n = kMaxDirs; n >= 1 && ranges == 0; --n) {
    int cs = 0;
    const cudaError_t err = kChoose[n - 1][even][wta != 0](a, &cs);
    if (err != cudaSuccess) return (int)err;
    if (cs != 0) {
      *(int*)dirs = n;
      return 0;
    }
  }
  for (int n = kMaxDirs; n >= 1; --n) {
    Plan p;
    const cudaError_t err = kPlan[n - 1][even][wta != 0](a, ranges, &p);
    if (err != cudaSuccess) return (int)err;
    if (p.G != 0 && p.per_wave >= 1) {
      *(int*)dirs = n;
      return 0;
    }
  }
  return 0;
}
