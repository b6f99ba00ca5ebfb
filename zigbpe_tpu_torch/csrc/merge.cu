// Fused greedy merge + row-local compaction pass, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel zigbpe_tpu/ops/pallas/merge.py::_merge_kernel
// (entry points merge_pass_pallas_multi and merge_pass_pallas). It computes
// the same function: one leftmost-greedy pass that applies K <= 4 merges
// (a_m, b_m) -> x_m at once to an int32 token stream in ROW-LOCAL PREFIX
// layout (each 128-token row holds its valid tokens, then PAD = -1), kills
// each hit's partner (within a row, across rows, across tiles), compacts
// every row stably in place and reports
// stats = [nhits_0 .. nhits_{K-1}, new_length, min_kept].
// Slot 0 may have a == b; its overlapping runs resolve by rank parity
// (``aaa`` -> [X, a]). min_kept is the smallest post-pass population of any
// non-empty input row other than the stream's last non-empty row (BIG if
// there is none).
//
// What bounds it on an H100: bytes of the token stream. A pass reads the
// stream and rewrites the rows it changes; at 2^25 tokens that is 128 MiB
// each way, about 80 us at 3.35 TB/s, against a few integer operations per
// token. What the design does about it:
//
// * The TPU kernel walks its grid in order and carries the rank offset, the
//   parity of slot 0, the head-kill flag, the kept count and the deferred
//   min_kept from block to block. Blocks on a GPU run at once in no order,
//   so the pass is four launches on one stream instead:
//     1. summary (read-only, one block per 4096-token tile): snapshots the
//        tile's head token, which the previous tile needs as its look-ahead,
//        before any tile is rewritten, and the tile's edge candidates. Only
//        when slot 0 has a == b does it read the whole tile, for its
//        population and the rank of its last slot-0 non-candidate.
//     2. scan (one block): exclusive scans over the tile summaries give each
//        tile its rank offset, its incoming last non-candidate rank and its
//        incoming head-kill flag.
//     3. apply (one block per tile): loads the tile into shared memory,
//        finds hits, kills partners and compacts each row with one warp per
//        row (ballot / popc / shuffle scans, 16-byte accesses). Rows that
//        do not change are not written.
//     4. reduce (one block): folds the per-tile partial stats.
//   The parity carry uses -1 as "no non-candidate yet", not the TPU
//   kernel's wrapping NEG constant.
// * Only the a == b case reads the stream twice; otherwise the summary
//   reads one row per tile, and the pass is close to one read plus the
//   writes of the rows that change.
//
// The kernels allocate nothing: the caller passes a work array of
// zbpe_merge_work_ints(n) int32s and a stats array of K + 2 int32s. The
// launch runs on the caller's stream and returns cudaGetLastError().
//
// Ablated passes. The kernels take a compile-time bit mask ABL of pieces to
// switch off; the production pass is mask 0, and zbpe_merge_pass_ablated
// runs the other masks. They replace the ablated copies of the Pallas
// kernel in scripts/probe_merge_budget.py (make_variant): each is this
// kernel minus one piece, so the difference of two pass times is that
// piece's cost. Variants and what each one leaves in tokens and stats:
//   full      (0)            nothing off; equal to the production pass.
//   nofast    ABL_NOFAST     every row is written, not only changed rows;
//                            tokens and stats equal full's.
//   noparity  ABL_NOPARITY   no slot-0 rank parity and no whole-tile
//                            summary read for a == b: every candidate
//                            hits; equal to full when no slot has a == b.
//   nominkept ABL_NOMINKEPT  no kept-row minimum upkeep and no min pass in
//                            the reduce: tokens, hits, length = full's,
//                            min_kept = BIG.
//   noedgek   ABL_NOEDGEK    no head kill across rows and tiles: a hit
//                            kills its partner only within its row.
//   nocompact ABL_NOCOMPACT  no warp scan and no compaction: a hit's token
//                            becomes x in place and its partner stays in
//                            the array; stats (hits, kept count, min_kept)
//                            equal full's.
//   nokills   ABL_NOKILLS | ABL_NOCOMPACT | ABL_NOEDGEK | ABL_NOMINKEPT
//                            no partner is killed: hits written in place,
//                            length = input length, min_kept = BIG.
//   nostore   ABL_NOSTORE    no global store of tokens: tokens unchanged,
//                            stats equal full's.
//   copy      ABL_COPY       the apply launch alone loads each tile into
//                            shared memory and stores every row back: no
//                            summary, scan, hits or reduce; tokens
//                            unchanged, stats zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int TILE_ROWS = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = TILE_ROWS / WARPS;
constexpr int SCAN_THREADS = 1024;
constexpr int MAXK = 4;
constexpr int PAD = -1;
constexpr int BIG = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// Ablation bits (see the header); ops/kernels/merge.py mirrors them.
constexpr unsigned ABL_NOFAST = 1;
constexpr unsigned ABL_NOPARITY = 2;
constexpr unsigned ABL_NOMINKEPT = 4;
constexpr unsigned ABL_NOEDGEK = 8;
constexpr unsigned ABL_NOCOMPACT = 16;
constexpr unsigned ABL_NOKILLS = 32;
constexpr unsigned ABL_NOSTORE = 64;
constexpr unsigned ABL_COPY = 128;

// Fields of the work array, G int32s each (G = number of tiles).
enum Field {
  F_HEAD,      // tile's first token, snapshot taken before any write
  F_CNT,       // tile population (a == b only)
  F_LASTNC,    // local rank of the tile's last slot-0 non-candidate, or -1
  F_EDGE,      // (local rank of the edge token << 2) | edge candidate bits
  F_KILL,      // 1 if the tile's head token dies (previous tile's edge hit)
  F_RANK,      // logical rank of the tile's first token
  F_NCIN,      // last slot-0 non-candidate rank before the tile, or -1
  F_KEPT,      // tokens the tile keeps
  F_MABL,      // min kept over the tile's non-empty rows but its last one
  F_LASTKEPT,  // kept count of the tile's last non-empty row, -1 if empty
  F_HITS,      // MAXK fields: hits per slot
  NFIELDS = F_HITS + MAXK
};

struct Slots {
  int a[MAXK], b[MAXK], x[MAXK];
};

__device__ __forceinline__ Slots load_slots(const int* __restrict__ table, int K) {
  Slots s;
#pragma unroll
  for (int m = 0; m < MAXK; ++m) {
    s.a[m] = m < K ? table[3 * m] : -2;
    s.b[m] = m < K ? table[3 * m + 1] : -2;
    s.x[m] = m < K ? table[3 * m + 2] : -2;
  }
  return s;
}

template <unsigned ABL>
__device__ __forceinline__ bool parity_mode(const Slots& s) {
  return !(ABL & ABL_NOPARITY) && s.a[0] == s.b[0] && s.a[0] >= 0;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = max(v, t);
  }
  return v;
}

// One lane's view of 4 consecutive tokens t[0..3] at row positions
// 4*lane .. 4*lane+3: validity, "last valid before PAD" and the next
// logical token (within the row, else the next row's head ``hn``).
struct Quad {
  int t[4];
  int nxt[4];
  unsigned valid;  // bit q: t[q] >= 0
  unsigned last;   // bit q: valid and the next slot in the row is PAD
};

__device__ __forceinline__ void make_quad(Quad& v, int hn, int lane) {
  int right = __shfl_down_sync(FULL, v.t[0], 1);
  if (lane == 31) right = PAD;
  v.valid = 0;
  v.last = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int nin = q < 3 ? v.t[q + 1] : right;
    bool ok = v.t[q] >= 0;
    v.valid |= (unsigned)ok << q;
    v.last |= (unsigned)(ok && nin < 0) << q;
    v.nxt[q] = nin >= 0 ? nin : hn;
  }
}

// 4-bit candidate mask of slot m: (t, next) == (a_m, b_m).
__device__ __forceinline__ unsigned cand_mask(const Quad& v, int a, int b) {
  unsigned c = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    c |= (unsigned)(((v.valid >> q) & 1u) && v.t[q] == a && v.nxt[q] == b &&
                    v.nxt[q] >= 0) << q;
  return c;
}

// Largest row position 4*lane+q that is valid and not in ``cand0``, or -1.
__device__ __forceinline__ int last_noncand(const Quad& v, unsigned cand0, int lane) {
  int r = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (((v.valid & ~cand0) >> q) & 1u) r = 4 * lane + q;
  return r;
}

__device__ __forceinline__ int4 load_row4(const int* __restrict__ tok, long long row,
                                          long long nrows, int lane) {
  if (row < nrows) return reinterpret_cast<const int4*>(tok)[row * 32 + lane];
  return make_int4(PAD, PAD, PAD, PAD);
}

// ---------------------------------------------------------------- launch 1

// ABL here is the caller's mask & ABL_NOPARITY: no other piece changes it.
template <unsigned ABL>
__global__ void __launch_bounds__(THREADS)
summary_kernel(const int* __restrict__ tok, const int* __restrict__ table, int K,
               long long nrows, int G, int* __restrict__ work) {
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Slots s = load_slots(table, K);
  const bool parity = parity_mode<ABL>(s);
  const long long row0 = (long long)g * TILE_ROWS;
  const bool has_next = g + 1 < G;
  const int peek = has_next ? tok[(row0 + TILE_ROWS) * LANES] : PAD;

  __shared__ int s_pop[TILE_ROWS];
  __shared__ int s_nc[TILE_ROWS];
  __shared__ int s_edge;

  if (threadIdx.x == 0) {
    work[F_HEAD * G + g] = tok[row0 * LANES];
    s_edge = 0;
  }
  if (!parity) {
    // every candidate is a hit: only the last row's edge token matters
    if (warp == 0 && has_next) {
      Quad v;
      int4 w = load_row4(tok, row0 + TILE_ROWS - 1, nrows, lane);
      v.t[0] = w.x; v.t[1] = w.y; v.t[2] = w.z; v.t[3] = w.w;
      make_quad(v, peek, lane);
      unsigned c0 = cand_mask(v, s.a[0], s.b[0]);
      unsigned co = 0;
#pragma unroll
      for (int m = 1; m < MAXK; ++m) co |= cand_mask(v, s.a[m], s.b[m]);
      bool e0 = __any_sync(FULL, (c0 & v.last) != 0);
      bool eo = __any_sync(FULL, (co & v.last) != 0);
      if (lane == 0) work[F_EDGE * G + g] = (int)e0 | ((int)eo << 1);
    } else if (threadIdx.x == 0 && !has_next) {
      work[F_EDGE * G + g] = 0;
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const long long row = row0 + r;
    Quad v;
    int4 w = load_row4(tok, row, nrows, lane);
    v.t[0] = w.x; v.t[1] = w.y; v.t[2] = w.z; v.t[3] = w.w;
    int hn;
    if (r + 1 < TILE_ROWS) hn = row + 1 < nrows ? tok[(row + 1) * LANES] : PAD;
    else hn = peek;
    make_quad(v, hn, lane);
    unsigned c0 = cand_mask(v, s.a[0], s.b[0]);
    int pop = warp_sum(__popc(v.valid));
    int nc = warp_max(last_noncand(v, c0, lane));
    if (r == TILE_ROWS - 1) {
      unsigned co = 0;
#pragma unroll
      for (int m = 1; m < MAXK; ++m) co |= cand_mask(v, s.a[m], s.b[m]);
      // row position of the edge token (the row's last valid slot)
      int epos = -1;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((v.last >> q) & 1u) epos = 4 * lane + q;
      epos = warp_max(epos);
      bool e0 = __any_sync(FULL, (c0 & v.last) != 0);
      bool eo = __any_sync(FULL, (co & v.last) != 0);
      if (lane == 0) s_edge = ((int)e0 | ((int)eo << 1)) | (max(epos, 0) << 2);
    }
    if (lane == 0) {
      s_pop[r] = pop;
      s_nc[r] = nc;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int pop = s_pop[lane];
    int pre = warp_incl_sum(pop, lane) - pop;
    int nc = s_nc[lane] >= 0 ? pre + s_nc[lane] : -1;
    int cnt = warp_sum(pop);
    int lastnc = warp_max(nc);
    // the edge token's local rank: row 31's prefix plus its row position
    int pre31 = __shfl_sync(FULL, pre, TILE_ROWS - 1);
    if (lane == 0) {
      work[F_CNT * G + g] = cnt;
      work[F_LASTNC * G + g] = lastnc;
      int e = s_edge;
      work[F_EDGE * G + g] = (e & 3) | (((e >> 2) + pre31) << 2);
    }
  }
}

// ---------------------------------------------------------------- launch 2

struct OpSum {
  __device__ int operator()(int x, int y) const { return x + y; }
};
struct OpMax {
  __device__ int operator()(int x, int y) const { return max(x, y); }
};

// Exclusive block scan (blockDim.x a multiple of 32, at most 1024). s holds
// 33 ints. Returns the exclusive prefix; ``total`` gets the block total.
template <class Op>
__device__ int block_excl_scan(int v, int identity, Op op, int* s, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = op(incl, t);
  }
  int excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s[lane] : identity;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi = op(wi, t);
    }
    int wex = __shfl_up_sync(FULL, wi, 1);
    if (lane == 0) wex = identity;
    s[lane] = wex;
    if (lane == 31) s[32] = wi;
  }
  __syncthreads();
  excl = op(s[warp], excl);
  total = s[32];
  __syncthreads();
  return excl;
}

// ABL here is the caller's mask & ABL_NOPARITY.
template <unsigned ABL>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int* __restrict__ table, int K, int G, int* __restrict__ work) {
  const Slots s = load_slots(table, K);
  if (!parity_mode<ABL>(s)) {
    for (int g = threadIdx.x; g < G; g += blockDim.x)
      work[F_KILL * G + g] = g > 0 && (work[F_EDGE * G + g - 1] & 3) != 0;
    return;
  }
  __shared__ int sh[33];
  int carry_sum = 0, carry_max = -1;
  for (int base = 0; base < G; base += blockDim.x) {
    const int g = base + threadIdx.x;
    const int cnt = g < G ? work[F_CNT * G + g] : 0;
    const int ln = g < G ? work[F_LASTNC * G + g] : -1;
    int tot_sum, tot_max;
    const int rank = carry_sum + block_excl_scan(cnt, 0, OpSum(), sh, tot_sum);
    const int v = ln >= 0 ? rank + ln : -1;
    const int ncin = max(carry_max, block_excl_scan(v, -1, OpMax(), sh, tot_max));
    if (g < G) {
      work[F_RANK * G + g] = rank;
      work[F_NCIN * G + g] = ncin;
      const int e = work[F_EDGE * G + g];
      // the edge token is a slot-0 candidate: it hits iff its distance to
      // the last non-candidate before it is odd
      const int rank_e = rank + (e >> 2);
      const bool hit0 = (e & 1) && (((rank_e - max(ncin, v)) & 1) == 1);
      if (g + 1 < G) work[F_KILL * G + g + 1] = hit0 || (e & 2);
      if (g == 0) work[F_KILL * G] = 0;
    }
    carry_sum += tot_sum;
    carry_max = max(carry_max, tot_max);
  }
}

// ---------------------------------------------------------------- launch 3

// The production pass compiles to 64 registers a thread, which lets 4 blocks
// of 256 threads share an SM. The bound holds every ablated instantiation to
// that occupancy too: left free, some took 73-86 registers and ran 2-3
// blocks per SM, so their times measured register allocation, not the work
// they leave out.
constexpr int APPLY_BLOCKS_PER_SM = 4;

template <unsigned ABL>
__global__ void __launch_bounds__(THREADS, APPLY_BLOCKS_PER_SM)
apply_kernel(int* __restrict__ tok, const int* __restrict__ table, int K,
             long long nrows, int G, int* __restrict__ work) {
  constexpr bool kFast = !(ABL & ABL_NOFAST);
  constexpr bool kMinKept = !(ABL & ABL_NOMINKEPT);
  constexpr bool kEdgeKill = !(ABL & ABL_NOEDGEK);
  constexpr bool kCompact = !(ABL & ABL_NOCOMPACT);
  constexpr bool kKills = !(ABL & ABL_NOKILLS);
  constexpr bool kStore = !(ABL & ABL_NOSTORE);
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Slots s = load_slots(table, K);
  const bool parity = parity_mode<ABL>(s);
  const long long row0 = (long long)g * TILE_ROWS;

  __shared__ int4 s_tile4[TILE_ROWS * 32];
  int* s_tile = reinterpret_cast<int*>(s_tile4);
  __shared__ int s_pop[TILE_ROWS], s_nc[TILE_ROWS], s_pre[TILE_ROWS];
  __shared__ int s_in[TILE_ROWS], s_ehit[TILE_ROWS];
  __shared__ int s_lastne, s_kept, s_mabl, s_lastkept, s_hits[MAXK];

  for (int idx = threadIdx.x; idx < TILE_ROWS * 32; idx += THREADS)
    s_tile4[idx] = load_row4(tok, row0 + idx / 32, nrows, idx % 32);
  if constexpr ((ABL & ABL_COPY) != 0) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < TILE_ROWS * 32; idx += THREADS)
      if (row0 + idx / 32 < nrows) reinterpret_cast<int4*>(tok)[row0 * 32 + idx] = s_tile4[idx];
    return;
  }
  if (threadIdx.x == 0) {
    s_kept = 0;
    s_mabl = BIG;
    s_lastkept = -1;
#pragma unroll
    for (int m = 0; m < MAXK; ++m) s_hits[m] = 0;
  }
  // the next tile may already be rewritten: its head comes from the
  // snapshot the summary launch took
  const int peek = g + 1 < G ? work[F_HEAD * G + g + 1] : PAD;
  const int kill_in = kEdgeKill ? work[F_KILL * G + g] : 0;
  __syncthreads();

  Quad v[ROWS_PER_WARP];
  unsigned cand[ROWS_PER_WARP][MAXK];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    int4 w = s_tile4[r * 32 + lane];
    v[i].t[0] = w.x; v[i].t[1] = w.y; v[i].t[2] = w.z; v[i].t[3] = w.w;
    const int hn = r + 1 < TILE_ROWS ? s_tile[(r + 1) * LANES] : peek;
    make_quad(v[i], hn, lane);
#pragma unroll
    for (int m = 0; m < MAXK; ++m) cand[i][m] = cand_mask(v[i], s.a[m], s.b[m]);
    const int pop = warp_sum(__popc(v[i].valid));
    const int nc = parity ? warp_max(last_noncand(v[i], cand[i][0], lane)) : -1;
    if (lane == 0) {
      s_pop[r] = pop;
      s_nc[r] = nc;
    }
  }
  __syncthreads();  // s_tile is free for staging from here on

  if (warp == 0) {
    const int pop = s_pop[lane];
    const int pre = warp_incl_sum(pop, lane) - pop;
    s_pre[lane] = pre;
    if constexpr (kMinKept) {
      const unsigned ne = __ballot_sync(FULL, pop > 0);
      if (lane == 0) s_lastne = ne ? 31 - __clz(ne) : -1;
    }
    if (parity) {
      const int rank = work[F_RANK * G + g];
      const int ncin = work[F_NCIN * G + g];
      const int nc = s_nc[lane] >= 0 ? rank + pre + s_nc[lane] : -1;
      const int incl = warp_incl_max(nc, lane);
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = -1;
      s_in[lane] = max(ncin, excl);
    }
  }
  __syncthreads();

  unsigned hit[ROWS_PER_WARP];
  const int rank_off = parity ? work[F_RANK * G + g] : 0;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    unsigned h0 = cand[i][0];
    if (parity) {
      // leftmost-greedy: a slot-0 candidate hits iff its rank minus the
      // rank of the last non-candidate before it is odd
      const int base = rank_off + s_pre[r];
      int lane_nc = -1;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (((v[i].valid & ~cand[i][0]) >> q) & 1u) lane_nc = base + 4 * lane + q;
      const int incl = warp_incl_max(lane_nc, lane);
      int run = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) run = -1;
      run = max(run, s_in[r]);
      h0 = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rk = base + 4 * lane + q;
        if ((cand[i][0] >> q) & 1u) {
          h0 |= (unsigned)(((rk - run) & 1) == 1) << q;
        } else if ((v[i].valid >> q) & 1u) {
          run = rk;
        }
      }
    }
    hit[i] = h0 | cand[i][1] | cand[i][2] | cand[i][3];
    cand[i][0] = h0;  // from here on cand[i][m] are the hits of slot m
    if constexpr (kEdgeKill) {
      const bool eh = __any_sync(FULL, (hit[i] & v[i].last) != 0);
      if (lane == 0) s_ehit[r] = eh;
    }
#pragma unroll
    for (int m = 0; m < MAXK; ++m) {
      const int n = warp_sum(__popc(cand[i][m]));
      if (lane == 0 && n) atomicAdd(&s_hits[m], n);
    }
  }
  __syncthreads();

  const int lastne = kMinKept ? s_lastne : -1;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    unsigned killed = 0;
    if constexpr (kKills) {
      const int prev_edge = kEdgeKill ? (r == 0 ? kill_in : s_ehit[r - 1]) : 0;
      const unsigned left = __shfl_up_sync(FULL, hit[i], 1);
      const bool head_kill = lane == 0 ? prev_edge != 0 : ((left >> 3) & 1u);
      killed = ((hit[i] << 1) | (unsigned)head_kill) & v[i].valid & 0xfu;
    }
    const unsigned keep = v[i].valid & ~killed;
    const int kc = __popc(keep);
    int incl = 0, total;
    if constexpr (kCompact) {
      incl = warp_incl_sum(kc, lane);
      total = __shfl_sync(FULL, incl, 31);
    } else {
      total = warp_sum(kc);
    }
    if (!kFast || __any_sync(FULL, (hit[i] | killed) != 0)) {
      if constexpr (kCompact) {
        int p = incl - kc;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((keep >> q) & 1u) {
            int val = v[i].t[q];
#pragma unroll
            for (int m = 0; m < MAXK; ++m)
              if ((cand[i][m] >> q) & 1u) val = s.x[m];
            s_tile[r * LANES + p++] = val;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * lane + q >= total) s_tile[r * LANES + 4 * lane + q] = PAD;
        __syncwarp();
        if (kStore && row0 + r < nrows)
          reinterpret_cast<int4*>(tok)[(row0 + r) * 32 + lane] = s_tile4[r * 32 + lane];
      } else {
        // hits become x where they stand; partners stay
        int o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = v[i].t[q];
#pragma unroll
          for (int m = 0; m < MAXK; ++m)
            if ((cand[i][m] >> q) & 1u) o[q] = s.x[m];
        }
        if (kStore && row0 + r < nrows)
          reinterpret_cast<int4*>(tok)[(row0 + r) * 32 + lane] = make_int4(o[0], o[1], o[2], o[3]);
      }
    }
    if (lane == 0) {
      atomicAdd(&s_kept, total);
      if (kMinKept && s_pop[r] > 0) {
        if (r == lastne) s_lastkept = total;
        else atomicMin(&s_mabl, total);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    work[F_KEPT * G + g] = s_kept;
    if constexpr (kMinKept) {
      work[F_MABL * G + g] = s_mabl;
      work[F_LASTKEPT * G + g] = s_lastkept;
    }
#pragma unroll
    for (int m = 0; m < MAXK; ++m) work[(F_HITS + m) * G + g] = s_hits[m];
  }
}

// ---------------------------------------------------------------- launch 4

// ABL here is the caller's mask & ABL_NOMINKEPT.
template <unsigned ABL>
__global__ void __launch_bounds__(SCAN_THREADS)
reduce_kernel(int K, int G, const int* __restrict__ work, int* __restrict__ stats) {
  constexpr bool kMinKept = !(ABL & ABL_NOMINKEPT);
  __shared__ int s_sum[MAXK + 1], s_glast, s_min;
  if (threadIdx.x == 0) {
    for (int m = 0; m <= MAXK; ++m) s_sum[m] = 0;
    s_glast = -1;
    s_min = BIG;
  }
  __syncthreads();
  int sum[MAXK + 1] = {0, 0, 0, 0, 0};
  int glast = -1, mn = BIG;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
#pragma unroll
    for (int m = 0; m < MAXK; ++m) sum[m] += work[(F_HITS + m) * G + g];
    sum[MAXK] += work[F_KEPT * G + g];
    if constexpr (kMinKept) {
      if (work[F_LASTKEPT * G + g] >= 0) glast = g;
      mn = min(mn, work[F_MABL * G + g]);
    }
  }
#pragma unroll
  for (int m = 0; m <= MAXK; ++m) {
    const int t = warp_sum(sum[m]);
    if ((threadIdx.x & 31) == 0) atomicAdd(&s_sum[m], t);
  }
  if constexpr (kMinKept) atomicMax(&s_glast, glast);
  __syncthreads();
  if constexpr (kMinKept) {
    // the last non-empty row of every non-empty tile but the stream's last
    // one is interior
    const int gl = s_glast;
    for (int g = threadIdx.x; g < gl; g += blockDim.x) {
      const int lk = work[F_LASTKEPT * G + g];
      if (lk >= 0) mn = min(mn, lk);
    }
    atomicMin(&s_min, mn);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int m = 0; m < K; ++m) stats[m] = s_sum[m];
    stats[K] = s_sum[MAXK];
    stats[K + 1] = s_min;
  }
}

inline int num_tiles(long long n) {
  const long long nrows = n / LANES;
  return (int)((nrows + TILE_ROWS - 1) / TILE_ROWS);
}

inline bool bad_args(long long n, int K) {
  return n <= 0 || n % LANES != 0 || K < 1 || K > MAXK;
}

template <unsigned ABL>
int run_pass(int* tokens, long long n, const int* table, int K, int* work, int* stats,
             cudaStream_t st) {
  const long long nrows = n / LANES;
  const int G = num_tiles(n);
  if constexpr ((ABL & ABL_COPY) != 0) {
    const cudaError_t e = cudaMemsetAsync(stats, 0, sizeof(int) * (K + 2), st);
    if (e != cudaSuccess) return (int)e;
    apply_kernel<ABL><<<G, THREADS, 0, st>>>(tokens, table, K, nrows, G, work);
  } else {
    constexpr unsigned P = ABL & ABL_NOPARITY, M = ABL & ABL_NOMINKEPT;
    summary_kernel<P><<<G, THREADS, 0, st>>>(tokens, table, K, nrows, G, work);
    scan_kernel<P><<<1, SCAN_THREADS, 0, st>>>(table, K, G, work);
    apply_kernel<ABL><<<G, THREADS, 0, st>>>(tokens, table, K, nrows, G, work);
    reduce_kernel<M><<<1, SCAN_THREADS, 0, st>>>(K, G, work, stats);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32s of scratch the pass needs for a stream of n tokens.
long long zbpe_merge_work_ints(long long n) { return (long long)NFIELDS * num_tiles(n); }

// One fused merge pass over tokens[n] (n > 0, a multiple of 128), in place.
// table: int32[K][3] device array of (a, b, new) slots, 1 <= K <= 4, a
// disabled slot is (-2, -2, -2). work: zbpe_merge_work_ints(n) int32s.
// stats: int32[K + 2]. Returns cudaGetLastError() after the launches.
int zbpe_merge_pass(int* tokens, long long n, const int* table, int K, int* work,
                    int* stats, void* stream) {
  if (bad_args(n, K)) return (int)cudaErrorInvalidValue;
  return run_pass<0>(tokens, n, table, K, work, stats, static_cast<cudaStream_t>(stream));
}

// The same pass with the pieces of mask ``variant`` switched off (one of the
// variants in the header; any other mask is refused).
int zbpe_merge_pass_ablated(int* tokens, long long n, const int* table, int K, int* work,
                            int* stats, int variant, void* stream) {
  if (bad_args(n, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((unsigned)variant) {
    case 0:
      return run_pass<0>(tokens, n, table, K, work, stats, st);
    case ABL_NOFAST:
      return run_pass<ABL_NOFAST>(tokens, n, table, K, work, stats, st);
    case ABL_NOPARITY:
      return run_pass<ABL_NOPARITY>(tokens, n, table, K, work, stats, st);
    case ABL_NOMINKEPT:
      return run_pass<ABL_NOMINKEPT>(tokens, n, table, K, work, stats, st);
    case ABL_NOEDGEK:
      return run_pass<ABL_NOEDGEK>(tokens, n, table, K, work, stats, st);
    case ABL_NOCOMPACT:
      return run_pass<ABL_NOCOMPACT>(tokens, n, table, K, work, stats, st);
    case ABL_NOKILLS | ABL_NOCOMPACT | ABL_NOEDGEK | ABL_NOMINKEPT:
      return run_pass<ABL_NOKILLS | ABL_NOCOMPACT | ABL_NOEDGEK | ABL_NOMINKEPT>(
          tokens, n, table, K, work, stats, st);
    case ABL_NOSTORE:
      return run_pass<ABL_NOSTORE>(tokens, n, table, K, work, stats, st);
    case ABL_COPY:
      return run_pass<ABL_COPY>(tokens, n, table, K, work, stats, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
