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
// there is none). Rows that do not change are not written.
//
// What bounds it on an H100: bytes of the token stream. A pass reads the
// stream and rewrites the rows it changes; at 2^25 tokens that is 128 MiB
// each way, about 80 us at 3.35 TB/s, against a few integer operations per
// token. Three things kept an earlier four-launch design near twice that:
// launches around the work (a summary, a one-block scan and a one-block
// reduce, about 25 us a pass), tiles whose load, work and store ran one
// after another, and a slot loop compiled for four slots whatever K was.
// What this design does about them:
//
// * ONE LAUNCH A PASS. A persistent grid (SMs x blocks per SM from the
//   occupancy API, at most one block a tile) takes 4096-token tiles (32
//   rows) IN ORDER from an atomic tile counter: the GPU form of the TPU
//   kernel's sequential grid carry. Each tile publishes one 64-bit status
//   word, tagged in its high half with the pass's epoch, so that nothing is
//   reset between passes:
//     - without a == b in slot 0, the word is final at once: the tile's edge
//       hit (its last token hits and kills the next tile's head). The next
//       tile looks back one tile.
//     - with a == b, a slot-0 candidate hits iff its rank minus the rank of
//       the last non-candidate before it is odd. The carry is the pair
//       (count sum s, rank-shifted last non-candidate m), combined as
//       (s1 + s2, max(m1, m2 >= 0 ? s1 + m2 : -1)), identity (0, -1). Only
//       h = (s - m) mod 2 decides a hit, and the pair maps onto it as a
//       homomorphism: a tile acts on h as "h' = Q" when it holds a
//       non-candidate and as "h' = h ^ Q" when it does not (two bits), and
//       its edge hit is EC | (ED & (h ^ EX)) (three bits). A tile publishes
//       these as an AGGREGATE, then runs a decoupled look-back (one warp, a
//       window of 32 predecessors a step, composed with shuffles; a window
//       waits only for the words up to its first INCLUSIVE one) and
//       publishes its own inclusive word (h after the tile, its edge hit).
//       No second read of the stream. The a == b loop is compiled apart
//       from the a != b loop (one kernel, a branch on the table at entry),
//       so that the a != b pass carries none of the parity code.
//     - stats: each block sums its tiles' hits and kept counts in shared
//       memory, keeps the minimum of its rows but its last non-empty tile's
//       last non-empty row (the deferred row), and writes one partial. The
//       last block to finish (a done ticket) folds the partials, leaving
//       out the deferred row of the stream's last non-empty tile, writes
//       the stats, resets the ticket and the tile counter and advances the
//       epoch. No memset per pass.
// * THE IN-PLACE HAZARD. Tile g needs tile g+1's head token (its last
//   token's look-ahead). Its load brings the head along (16 bytes behind
//   the tile), and tile g publishes its status word only after that load
//   has landed; tile g+1 stores its row 0 only after reading tile g's word
//   (the warp that owns row 0 waits on it, with an acquire load). So no
//   head is rewritten before its reader has it.
// * WHY NO WAIT CAN DEADLOCK. A block takes tiles in increasing order and
//   works them in that order; every wait of tile g is on a word of a tile
//   j < g, and each tile publishes a word (aggregate at least) before any
//   wait of its own. A tile is taken only by a block that is running. So the
//   smallest unfinished tile's block has finished its earlier tiles, and
//   the tiles it waits on are earlier still, hence finished: it finishes.
//   By induction every tile does. No block waits on a successor, and no
//   block waits for another block to become resident.
// * OVERLAP. Two 16 KiB tile buffers in shared memory. In an a != b pass a
//   block takes its next tile at the current tile's hits and loads it with
//   cp.async (16-byte, L2-only) under the current tile's compaction and
//   stores, which are streaming 16-byte stores (st.global.cs); the other
//   blocks of the SM (4, or 3 with more slots) fill the rest. An a == b
//   pass takes and loads the next tile after the stores: taking late keeps
//   tiles starting in the order they are taken, so that few look-backs find
//   a predecessor that was taken but has not started.
// * THE SLOT LOOP IS COMPILED FOR K. The kernel is a template on KT, the
//   number of slots it tests (1 to 4), and the C entry dispatches the
//   table's K: a K = 1 pass computes one candidate mask. Per-slot hit
//   counts are summed in registers over a warp's four rows and reduced
//   once per tile. Between phases a lane keeps only its rows' hits, a 4-bit
//   mask a slot, and reads the tokens again from shared memory. A K = 1
//   pass runs at 64 registers and 4 blocks an SM; more slots spilled at 64,
//   so they run at 80 and 3 (blocks_per_sm).
//
// The kernel allocates nothing: the caller passes a work array of
// zbpe_merge_work_ints(n) int32s, zeroed once when it is allocated and kept
// for later passes over the same capacity (the kernel leaves it ready for
// the next pass), and a stats array of K + 2 int32s. Passes that share a
// work array must run in order on one stream. The launch runs on the
// caller's stream and returns cudaGetLastError().
//
// Ablated passes. The kernel takes a compile-time bit mask ABL of pieces to
// switch off; the production pass is mask 0, and zbpe_merge_pass_ablated
// runs the other masks. They replace the ablated copies of the Pallas
// kernel in scripts/probe_merge_budget.py (make_variant): each is this
// kernel minus one piece, so the difference of two pass times is that
// piece's cost. The ablated masks are compiled for KT = 1 and KT = 4 only
// (a table of 2 or 3 slots runs the KT = 4 kernel with the rest disabled),
// which halves the build; the production pass is compiled for every K.
// Variants and what each one leaves in tokens and stats:
//   full      (0)            nothing off; equal to the production pass.
//   nofast    ABL_NOFAST     every row is written, not only changed rows;
//                            tokens and stats equal full's.
//   noparity  ABL_NOPARITY   no slot-0 rank parity and no look-back past one
//                            tile: every candidate hits; equal to full when
//                            no slot has a == b.
//   nominkept ABL_NOMINKEPT  no kept-row minimum upkeep and no min fold:
//                            tokens, hits, length = full's, min_kept = BIG.
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
//   copy      ABL_COPY       the kernel's own tile loop, double-buffered
//                            load and store of every row, and nothing else:
//                            the pass's floor. Tokens unchanged, stats zero.
//   noparity is compiled for the a != b loop alone, and copy too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int TILE_ROWS = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = TILE_ROWS / WARPS;
constexpr int TILE_VECS = TILE_ROWS * 32;  // 16-byte vectors in a tile
constexpr int VECS_PER_THREAD = TILE_VECS / THREADS;
constexpr int MAXK = 4;
// Blocks an SM the launch bounds hold the kernel to: 4 (64 registers) for
// one slot; 3 (80) for more, whose slot loop spilled at 64. Neither spills.
constexpr int blocks_per_sm(int KT) { return KT == 1 ? 4 : 3; }
constexpr int MAX_DEVICES = 64;
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

// The work array: a header, one 64-bit status word a tile, then one
// partial of NPART int32s a block (the grid has at most one block a tile).
constexpr int HDR_INTS = 4;
enum Header { H_NEXT, H_DONE, H_EPOCH };
enum Part { P_HITS = 0, P_KEPT = MAXK, P_MIN, P_LASTTILE, P_LASTKEPT, NPART };

// Low half of a status word. A parity function f(h) is two bits: FN_NC set
// means f(h) = FN_Q, else f(h) = h ^ FN_Q; identity 0.
constexpr unsigned FN_Q = 1;
constexpr unsigned FN_NC = 2;
constexpr unsigned ST_INCL = 1u << 2;  // inclusive; else an aggregate
constexpr unsigned ST_H = 1u << 3;     // inclusive: h after the tile
constexpr unsigned ST_EHIT = 1u << 4;  // inclusive: the tile's edge token hits
constexpr unsigned ST_EC = 1u << 5;    // aggregate: edge hit = EC | (ED & (h ^ EX)),
constexpr unsigned ST_ED = 1u << 6;    //   h the parity carry entering the tile
constexpr unsigned ST_EX = 1u << 7;

__device__ __forceinline__ unsigned fn_compose(unsigned later, unsigned earlier) {
  return (later & FN_NC) ? later : (earlier & FN_NC) | ((earlier ^ later) & FN_Q);
}

__device__ __forceinline__ unsigned fn_apply(unsigned f, unsigned h) {
  return (f & FN_NC) ? (f & FN_Q) : (h ^ (f & FN_Q));
}

__device__ __forceinline__ unsigned edge_apply(unsigned w, unsigned h) {
  return ((w & ST_EC) != 0) | (((w & ST_ED) != 0) & (h ^ ((w & ST_EX) != 0)));
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Spin until tile j's word carries this pass's tag.
__device__ __forceinline__ unsigned wait_word(const unsigned long long* status, int j,
                                              unsigned epoch) {
  unsigned long long w = ld_acquire(status + j);
  while ((unsigned)(w >> 32) != epoch) {
    __nanosleep(32);
    w = ld_acquire(status + j);
  }
  return (unsigned)w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start loading tile g into buf, and with kHead the next tile's first 16
// bytes behind it (PAD past the last tile); rows past the stream become
// PAD. Always commits one group, so that group counts stay in step.
template <bool kHead>
__device__ __forceinline__ void load_tile(int4* buf, const int* tok, int g, int G,
                                          long long nrows) {
  const long long row0 = (long long)g * TILE_ROWS;
  const int4* src = reinterpret_cast<const int4*>(tok) + row0 * 32;
#pragma unroll
  for (int u = 0; u < VECS_PER_THREAD; ++u) {
    const int idx = threadIdx.x + u * THREADS;
    if (row0 + idx / 32 < nrows)
      cp_async16(buf + idx, src + idx);
    else
      buf[idx] = make_int4(PAD, PAD, PAD, PAD);
  }
  if (kHead && threadIdx.x == 0) {
    if (g + 1 < G)
      cp_async16(buf + TILE_VECS, src + TILE_VECS);
    else
      buf[TILE_VECS] = make_int4(PAD, PAD, PAD, PAD);
  }
  cp_async_commit();
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

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
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

// 4-bit candidate mask of a slot: (t, next) == (a, b).
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

// Warp 0 of tile g > 0 with a == b: the parity carry h entering tile g and
// the edge hit of tile g-1, by a decoupled look-back over the predecessors'
// words. Lane l of a window reads tile base - l, the first window from g-1,
// so that one round trip often suffices. A window waits only for the words
// up to its first inclusive one: the tiles past it may not have started.
// When the first window holds an inclusive word, h after each tile between
// is known, and the warp publishes their inclusive words too: a tile's
// aggregate is out before anyone can compute its inclusive word, which
// holds the value the tile itself would write, so no word ever goes back
// to an aggregate. That keeps the next look-backs short.
__device__ __forceinline__ void look_back(unsigned long long* status, int g,
                                          unsigned epoch, int lane, unsigned& h_in,
                                          unsigned& ehit_prev) {
  const unsigned long long tag = (unsigned long long)epoch << 32;
  unsigned acc = 0;   // the composition of the tiles before g-1 passed so far
  unsigned prev = 0;  // tile g-1's word
  for (int base = g - 1;; base -= 32) {
    const int j = base - lane;
    unsigned w;
    int first;
    for (;;) {
      // tile 0 is always inclusive, so j < 0 lies past the first inclusive lane
      bool here = true;
      w = ST_INCL | ST_H;
      if (j >= 0) {
        const unsigned long long v = ld_acquire(status + j);
        here = (unsigned)(v >> 32) == epoch;
        w = (unsigned)v;
      }
      const unsigned incl = __ballot_sync(FULL, here && (w & ST_INCL));
      const unsigned have = __ballot_sync(FULL, here);
      first = incl ? __ffs(incl) - 1 : 32;
      const unsigned need = first == 32 ? FULL : (2u << first) - 1u;
      if ((have & need) == need) break;
      __nanosleep(32);
    }
    const bool head = base == g - 1;
    if (head) {
      prev = __shfl_sync(FULL, w, 0);
      if (first == 0) {
        h_in = (prev & ST_H) != 0;
        ehit_prev = (prev & ST_EHIT) != 0;
        return;
      }
    }
    // suffix scan: lane l gets the composition of lanes l..31, lane l last
    unsigned f = lane < first ? (w & (FN_NC | FN_Q))
                 : lane == first ? (FN_NC | ((w & ST_H) != 0)) : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_down_sync(FULL, f, o);
      if (lane + o < 32) f = fn_compose(f, t);
    }
    const unsigned before = __shfl_down_sync(FULL, f, 1);  // h entering lane l's tile
    if (head && first < 32) {
      if (lane >= 1 && lane < first)  // the tiles between, now inclusive
        st_release(status + j, tag | ST_INCL | ((f & FN_Q) ? ST_H : 0u) |
                                   (edge_apply(w, before & FN_Q) ? ST_EHIT : 0u));
      const unsigned h_prev = __shfl_sync(FULL, f, 1) & FN_Q;  // h after tile g-2
      h_in = fn_apply(prev & (FN_NC | FN_Q), h_prev);
      ehit_prev = edge_apply(prev, h_prev);
      return;
    }
    // tile g-1 itself (lane 0 of the first window) is applied at the end
    acc = fn_compose(acc, __shfl_sync(FULL, f, head ? 1 : 0));
    if (first < 32) break;
  }
  const unsigned h_prev = acc & FN_Q;  // constant: the walk ended inclusive
  h_in = fn_apply(prev & (FN_NC | FN_Q), h_prev);
  ehit_prev = edge_apply(prev, h_prev);
}

// A row's quad from the tile in shared memory, ``hn`` the next row's head.
__device__ __forceinline__ void row_quad(Quad& v, const int4* s_tile4, int r, int hn, int lane) {
  const int4 w = s_tile4[r * 32 + lane];
  v.t[0] = w.x; v.t[1] = w.y; v.t[2] = w.z; v.t[3] = w.w;
  make_quad(v, hn, lane);
}

// A block's shared memory: two tile buffers, each with the next tile's
// first 16 bytes behind it, per-row values of the tile at work, and the
// block's running stats.
struct Smem {
  int4 buf[2][TILE_VECS + 1];
  int pop[TILE_ROWS], nc[TILE_ROWS], in[TILE_ROWS], ehit[TILE_ROWS];
  int a[MAXK], b[MAXK], x[MAXK];  // the slots
  int acc[WARPS][MAXK + 2];  // per warp: hits, kept, min kept
  int take, edge, lk, last, bmin, lasttile, lastkept;
  int htile, hready;  // a == b: the carry entering the tile, and the tile it is for
  int sum[MAXK + 1], tmax, minkept;  // the last block's fold
};

// The block's tile loop. PAR: slot 0 has a == b (rank parity and the
// decoupled look-back); compiled apart from the a != b loop, so that
// neither pays for the other's code.
template <int KT, unsigned ABL, bool PAR>
__device__ __forceinline__ void tile_loop(Smem& sm, int* __restrict__ tok, long long nrows,
                                          int G, int* hdr, unsigned long long* status,
                                          unsigned epoch, int a0, int b0) {
  constexpr bool kCopy = (ABL & ABL_COPY) != 0;
  constexpr bool kFast = !(ABL & ABL_NOFAST);
  constexpr bool kMinKept = !(ABL & ABL_NOMINKEPT);
  constexpr bool kEdgeKill = !(ABL & ABL_NOEDGEK);
  constexpr bool kCompact = !(ABL & ABL_NOCOMPACT);
  constexpr bool kKills = !(ABL & ABL_NOKILLS);
  constexpr bool kStore = !(ABL & ABL_NOSTORE);
  // When a block takes its next tile: an a != b pass at the hits, so that
  // the load runs under this tile's stores; an a == b pass after the
  // stores, so that tiles start in the order they are taken and few
  // look-backs wait on a tile that was taken but has not started (0.241 ms
  // against 0.203 at 2^25 tokens on an H100; taking late slows a != b 10%).
  constexpr bool kLate = PAR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned long long tag = (unsigned long long)epoch << 32;

  if (threadIdx.x == 0) sm.take = atomicAdd(hdr + H_NEXT, 1);
  __syncthreads();
  int g = sm.take, cur = 0;
  int prev_g = -1, prev_lastne = -1;  // thread 0: the last tile's row to defer
  if (g < G) load_tile<!kCopy>(sm.buf[0], tok, g, G, nrows);

  while (g < G) {
    cp_async_wait<0>();
    __syncthreads();  // tile g is in buf[cur]; the last tile is done
    if (kMinKept && !kCopy && threadIdx.x == 0 && prev_lastne >= 0) {
      // defer the last tile's last non-empty row: it may be the stream's last
      if (sm.lasttile >= 0) sm.bmin = min(sm.bmin, sm.lastkept);
      sm.lasttile = prev_g;
      sm.lastkept = sm.lk;
    }
    const long long row0 = (long long)g * TILE_ROWS;
    const int4* s_tile4 = sm.buf[cur];
    int* s_tile = reinterpret_cast<int*>(sm.buf[cur]);
    // the next tile is taken late (here for the copy, else at the hits or,
    // with a == b, after the stores), so that tiles start in about the
    // order they are taken
    int took = 0;
    if (kCopy && threadIdx.x == 0) took = atomicAdd(hdr + H_NEXT, 1);
    unsigned kill_prev = 0;  // warp 0, a == b: tile g-1's edge hit
    unsigned hs[ROWS_PER_WARP];  // per row: a lane's hits, 4 bits a slot

    if constexpr (!kCopy) {
      // the next tile's head, read with the tile (before the next tile can
      // rewrite it: this tile's word is published after the read)
      const int peek = s_tile[TILE_ROWS * LANES];

      // ---- rows: population, last slot-0 non-candidate, the edge token
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp * ROWS_PER_WARP + i;
        Quad v;
        row_quad(v, s_tile4, r, r + 1 < TILE_ROWS ? s_tile[(r + 1) * LANES] : peek, lane);
        const unsigned c0 = cand_mask(v, a0, b0);
        const int pop = warp_sum(__popc(v.valid));
        if (r == TILE_ROWS - 1) {  // the tile's edge token: its last
          unsigned other = 0;
#pragma unroll
          for (int m = 1; m < KT; ++m) other |= cand_mask(v, sm.a[m], sm.b[m]);
          const int edge = (int)__any_sync(FULL, (c0 & v.last) != 0) |
                           ((int)__any_sync(FULL, (other & v.last) != 0) << 1);
          if (lane == 0) {
            sm.edge = edge;
            // without parity the tile's word is final: its edge hit
            if (!PAR) st_release(status + g, tag | ST_INCL | (edge ? ST_EHIT : 0u));
          }
        }
        if (lane == 0) sm.pop[r] = pop;
        if (PAR) {
          const int nc = warp_max(last_noncand(v, c0, lane));
          if (lane == 0) sm.nc[r] = nc;
        }
      }

      unsigned tile_fn_agg = 0;  // warp 0, a == b: the tile's function | aggregate << 8
      if constexpr (PAR) {
        __syncthreads();
        // ---- the tile's carry: its function and aggregate, published
        if (warp == 0) {
          const int pop = sm.pop[lane];
          const int edge = sm.edge;
          // row r's parity function, then their exclusive composition
          const int ncr = sm.nc[lane];
          unsigned f = ncr >= 0 ? (FN_NC | ((pop - ncr) & 1)) : (unsigned)(pop & 1);
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const unsigned t = __shfl_up_sync(FULL, f, o);
            if (lane >= o) f = fn_compose(f, t);
          }
          const unsigned tile_fn = __shfl_sync(FULL, f, 31);
          unsigned excl = __shfl_up_sync(FULL, f, 1);
          if (lane == 0) excl = 0;
          // the edge function: the edge token sits at position pop - 1 of row 31
          unsigned agg = tile_fn;
          if (lane == 31) {
            const int p = pop - 1;
            if (edge & 2) agg |= ST_EC;
            else if (edge & 1) {
              if (ncr >= 0) agg |= ((p - ncr) & 1) ? ST_EC : 0u;
              else if (excl & FN_NC) agg |= (((excl & FN_Q) + p) & 1) ? ST_EC : 0u;
              else agg |= ST_ED | ((((excl & FN_Q) ^ p) & 1) ? ST_EX : 0u);
            }
          }
          agg = __shfl_sync(FULL, agg, 31);
          tile_fn_agg = tile_fn | (agg << 8);
          if (lane == 0) {
            // tile 0's carry is the identity (0, -1): h = 1
            st_release(status + g, g > 0 ? tag | agg
                                         : tag | ST_INCL | (fn_apply(tile_fn, 1) ? ST_H : 0u) |
                                               (edge_apply(agg, 1) ? ST_EHIT : 0u));
          }
          // the run start a row sees before its first non-candidate: a
          // position of h's parity below every real position, known when a
          // non-candidate precedes the row in the tile; else 2 + Q, h of the
          // row being the tile's h ^ Q
          sm.in[lane] = (excl & FN_NC) ? ((excl & FN_Q) ? -1 : -2) : 2 + (int)(excl & FN_Q);
        }
        __syncthreads();
      }

      // ---- hits: slot-0 parity, edge hits, per-slot counts
      if (!kLate && threadIdx.x == 0) took = atomicAdd(hdr + H_NEXT, 1);
      if constexpr (PAR) {
        if (warp == 0) {
          // the decoupled look-back, under the other warps' rows: only rows
          // before the tile's first non-candidate wait for its result
          unsigned h_in = 1;
          if (g > 0) {
            look_back(status, g, epoch, lane, h_in, kill_prev);
            if (lane == 0) {
              const unsigned agg = tile_fn_agg >> 8;
              st_release(status + g, tag | ST_INCL |
                                         (fn_apply(tile_fn_agg & 0xffu, h_in) ? ST_H : 0u) |
                                         (edge_apply(agg, h_in) ? ST_EHIT : 0u));
            }
          }
          if (lane == 0) {
            sm.htile = (int)h_in;
            __threadfence_block();
            *reinterpret_cast<volatile int*>(&sm.hready) = g;
          }
          __syncwarp();
        }
      }
      int hc[KT];
#pragma unroll
      for (int m = 0; m < KT; ++m) hc[m] = 0;
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp * ROWS_PER_WARP + i;
        Quad v;
        row_quad(v, s_tile4, r, r + 1 < TILE_ROWS ? s_tile[(r + 1) * LANES] : peek, lane);
        unsigned c0 = cand_mask(v, a0, b0);
        if constexpr (PAR) {
          // leftmost-greedy: a slot-0 candidate hits iff its position minus
          // that of the last non-candidate before it is odd
          int lane_nc = -3;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (((v.valid & ~c0) >> q) & 1u) lane_nc = 4 * lane + q;
          const int incl = warp_incl_max(lane_nc, lane);
          int run = __shfl_up_sync(FULL, incl, 1);
          if (lane == 0) run = -3;
          int start = sm.in[r];
          if (start >= 2) {  // the row waits for the tile's carry
            while (*reinterpret_cast<volatile int*>(&sm.hready) != g) {
            }
            start = ((start - 2) ^ *reinterpret_cast<volatile int*>(&sm.htile)) ? -1 : -2;
          }
          run = max(run, start);
          unsigned h0 = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = 4 * lane + q;
            if ((c0 >> q) & 1u) {
              h0 |= (unsigned)(((p - run) & 1) == 1) << q;
            } else if ((v.valid >> q) & 1u) {
              run = p;
            }
          }
          c0 = h0;
        }
        unsigned hit = c0, packed = c0;
        hc[0] += __popc(c0);
#pragma unroll
        for (int m = 1; m < KT; ++m) {
          const unsigned c = cand_mask(v, sm.a[m], sm.b[m]);
          hit |= c;
          hc[m] += __popc(c);
          packed |= c << (4 * m);
        }
        hs[i] = packed;
        if constexpr (kEdgeKill) {
          const bool eh = __any_sync(FULL, (hit & v.last) != 0);
          if (lane == 0) sm.ehit[r] = eh;
        }
      }
#pragma unroll
      for (int m = 0; m < KT; ++m) {
        const int n = warp_sum(hc[m]);
        if (lane == 0) sm.acc[warp][m] += n;
      }
    }
    if (!kLate && threadIdx.x == 0) sm.take = took;
    __syncthreads();
    int gn = sm.take;
    if (!kLate && gn < G) load_tile<!kCopy>(sm.buf[cur ^ 1], tok, gn, G, nrows);

    if constexpr (kCopy) {
#pragma unroll
      for (int u = 0; u < VECS_PER_THREAD; ++u) {
        const int idx = threadIdx.x + u * THREADS;
        if (row0 + idx / 32 < nrows)
          __stcs(reinterpret_cast<int4*>(tok) + row0 * 32 + idx, s_tile4[idx]);
      }
    } else {
      // ---- kills, compaction, stores
      int lastne = -1;
      if constexpr (kMinKept) {
        const unsigned ne = __ballot_sync(FULL, sm.pop[lane] > 0);
        lastne = ne ? 31 - __clz(ne) : -1;
      }
      int kill_in = 0;
      if (warp == 0 && g > 0) {
        // row 0 is stored only once tile g-1 has read it (its word is out)
        if constexpr (PAR) {
          kill_in = kill_prev;
        } else {
          unsigned w = 0;
          if (lane == 0) w = wait_word(status, g - 1, epoch);
          kill_in = (__shfl_sync(FULL, w, 0) & ST_EHIT) != 0;
        }
      }
      int kept = 0, mn = BIG;
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp * ROWS_PER_WARP + i;
        const int4 w4 = s_tile4[r * 32 + lane];
        const int t[4] = {w4.x, w4.y, w4.z, w4.w};
        const unsigned valid = (unsigned)(t[0] >= 0) | ((unsigned)(t[1] >= 0) << 1) |
                               ((unsigned)(t[2] >= 0) << 2) | ((unsigned)(t[3] >= 0) << 3);
        unsigned hit = 0;
#pragma unroll
        for (int m = 0; m < KT; ++m) hit |= (hs[i] >> (4 * m)) & 0xfu;
        unsigned killed = 0;
        if constexpr (kKills) {
          const int prev_edge = kEdgeKill ? (r == 0 ? kill_in : sm.ehit[r - 1]) : 0;
          const unsigned left = __shfl_up_sync(FULL, hit, 1);
          const bool head_kill = lane == 0 ? prev_edge != 0 : ((left >> 3) & 1u);
          killed = ((hit << 1) | (unsigned)head_kill) & valid & 0xfu;
        }
        const unsigned keep = valid & ~killed;
        const int kc = __popc(keep);
        int incl = 0, total;
        if constexpr (kCompact) {
          incl = warp_incl_sum(kc, lane);
          total = __shfl_sync(FULL, incl, 31);
        } else {
          total = warp_sum(kc);
        }
        if (!kFast || __any_sync(FULL, (hit | killed) != 0)) {
          int o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            o[q] = t[q];
#pragma unroll
            for (int m = 0; m < KT; ++m)
              if ((hs[i] >> (4 * m + q)) & 1u) o[q] = sm.x[m];
          }
          int4 out;
          if constexpr (kCompact) {
            __syncwarp();  // the row is read; now rewrite it compacted
            int p = incl - kc;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if ((keep >> q) & 1u) s_tile[r * LANES + p++] = o[q];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (4 * lane + q >= total) s_tile[r * LANES + 4 * lane + q] = PAD;
            __syncwarp();
            out = s_tile4[r * 32 + lane];
          } else {
            // hits become x where they stand; partners stay
            out = make_int4(o[0], o[1], o[2], o[3]);
          }
          if (kStore && row0 + r < nrows)
            __stcs(reinterpret_cast<int4*>(tok) + (row0 + r) * 32 + lane, out);
        }
        kept += total;
        if (kMinKept && sm.pop[r] > 0) {
          if (r == lastne) {
            if (lane == 0) sm.lk = total;
          } else {
            mn = min(mn, total);
          }
        }
      }
      if (lane == 0) {
        sm.acc[warp][MAXK] += kept;
        sm.acc[warp][MAXK + 1] = min(sm.acc[warp][MAXK + 1], mn);
      }
      prev_g = g;
      prev_lastne = lastne;
    }
    if constexpr (kLate) {
      if (threadIdx.x == 0) sm.take = atomicAdd(hdr + H_NEXT, 1);
      __syncthreads();
      gn = sm.take;
      if (gn < G) load_tile<!kCopy>(sm.buf[cur ^ 1], tok, gn, G, nrows);
    }
    g = gn;
    cur ^= 1;
  }
  __syncthreads();
  if (kMinKept && !kCopy && threadIdx.x == 0 && prev_lastne >= 0) {
    if (sm.lasttile >= 0) sm.bmin = min(sm.bmin, sm.lastkept);
    sm.lasttile = prev_g;
    sm.lastkept = sm.lk;
  }
}

template <int KT, unsigned ABL>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(KT))
merge_kernel(int* __restrict__ tok, const int* __restrict__ table, int K, long long nrows,
             int G, int* __restrict__ work, int* __restrict__ stats) {
  constexpr bool kCopy = (ABL & ABL_COPY) != 0;
  constexpr bool kMinKept = !(ABL & ABL_NOMINKEPT);
  const int lane = threadIdx.x & 31;
  __shared__ Smem sm;

  int* hdr = work;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(work + HDR_INTS);
  int* part = work + HDR_INTS + 2 * G;
  // this pass's tag; the last block advances the stored epoch after every
  // block has read it
  const unsigned epoch = (unsigned)*reinterpret_cast<volatile int*>(hdr + H_EPOCH) + 1u;

  // slot 0 stays in registers; the other slots are read from shared memory
  const int a0 = table[0], b0 = table[1];
  if (threadIdx.x < WARPS * (MAXK + 2))
    (&sm.acc[0][0])[threadIdx.x] = threadIdx.x % (MAXK + 2) == MAXK + 1 ? BIG : 0;
  if (threadIdx.x < MAXK) {
    const bool on = threadIdx.x < K;
    sm.a[threadIdx.x] = on ? table[3 * threadIdx.x] : -2;
    sm.b[threadIdx.x] = on ? table[3 * threadIdx.x + 1] : -2;
    sm.x[threadIdx.x] = on ? table[3 * threadIdx.x + 2] : -2;
  }
  if (threadIdx.x == 0) {
    sm.bmin = BIG;
    sm.lasttile = -1;
    sm.lastkept = -1;
    sm.hready = -1;
  }
  if constexpr ((ABL & ABL_NOPARITY) != 0 || kCopy) {
    tile_loop<KT, ABL, false>(sm, tok, nrows, G, hdr, status, epoch, a0, b0);
  } else {
    if (a0 == b0 && a0 >= 0)
      tile_loop<KT, ABL, true>(sm, tok, nrows, G, hdr, status, epoch, a0, b0);
    else
      tile_loop<KT, ABL, false>(sm, tok, nrows, G, hdr, status, epoch, a0, b0);
  }

  // ---- the block's partial, then the last block folds the stats
  if (threadIdx.x == 0) {
    int* pb = part + (long long)blockIdx.x * NPART;
    int mn = sm.bmin;
    for (int w = 0; w < WARPS; ++w) mn = min(mn, sm.acc[w][MAXK + 1]);
#pragma unroll
    for (int m = 0; m <= MAXK; ++m) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) s += sm.acc[w][m];
      pb[P_HITS + m] = s;  // m == MAXK is P_KEPT
    }
    pb[P_MIN] = mn;
    pb[P_LASTTILE] = sm.lasttile;
    pb[P_LASTKEPT] = sm.lastkept;
    __threadfence();
    sm.last = atomicAdd(hdr + H_DONE, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!sm.last) return;
  __threadfence();

  int sum[MAXK + 1] = {0, 0, 0, 0, 0};
  int tmax = -1;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
    const int* pb = part + (long long)b * NPART;
#pragma unroll
    for (int m = 0; m <= MAXK; ++m) sum[m] += __ldcg(pb + P_HITS + m);
    tmax = max(tmax, __ldcg(pb + P_LASTTILE));
  }
  if (threadIdx.x == 0) {
    for (int m = 0; m <= MAXK; ++m) sm.sum[m] = 0;
    sm.tmax = -1;
    sm.minkept = BIG;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m <= MAXK; ++m) {
    const int t = warp_sum(sum[m]);
    if (lane == 0) atomicAdd(&sm.sum[m], t);
  }
  tmax = warp_max(tmax);
  if (lane == 0) atomicMax(&sm.tmax, tmax);
  __syncthreads();
  // every block's minimum, and every deferred row but the stream's last
  int mn = BIG;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
    const int* pb = part + (long long)b * NPART;
    mn = min(mn, __ldcg(pb + P_MIN));
    const int lt = __ldcg(pb + P_LASTTILE);
    if (lt >= 0 && lt != sm.tmax) mn = min(mn, __ldcg(pb + P_LASTKEPT));
  }
  mn = warp_min(mn);
  if (lane == 0) atomicMin(&sm.minkept, mn);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int m = 0; m < K; ++m) stats[m] = kCopy ? 0 : sm.sum[m];
    stats[K] = kCopy ? 0 : sm.sum[MAXK];
    stats[K + 1] = kCopy ? 0 : (kMinKept ? sm.minkept : BIG);
    hdr[H_NEXT] = 0;
    hdr[H_DONE] = 0;
    hdr[H_EPOCH] = (int)epoch;
  }
}

inline int num_tiles(long long n) {
  const long long nrows = n / LANES;
  return (int)((nrows + TILE_ROWS - 1) / TILE_ROWS);
}

inline bool bad_args(long long n, int K) {
  return n <= 0 || n % LANES != 0 || K < 1 || K > MAXK;
}

// SMs of the current device, asked once per device.
int sm_count() {
  static int cache[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < MAX_DEVICES && cache[dev]) return cache[dev];
  int n = 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 1;
  if (dev < MAX_DEVICES) cache[dev] = n;
  return n;
}

// The persistent grid: the blocks that fit on the card at once (occupancy
// API, asked once per instantiation), at most one a tile.
template <int KT, unsigned ABL>
int grid_for(long long n) {
  static int per_sm = 0;
  if (!per_sm) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, merge_kernel<KT, ABL>, THREADS, 0) !=
            cudaSuccess || b < 1)
      b = 1;
    per_sm = b;
  }
  const long long resident = (long long)sm_count() * per_sm;
  const int G = num_tiles(n);
  return (int)(G < resident ? G : resident);
}

template <int KT, unsigned ABL>
int run_pass(int* tokens, long long n, const int* table, int K, int* work, int* stats,
             cudaStream_t st) {
  merge_kernel<KT, ABL><<<grid_for<KT, ABL>(n), THREADS, 0, st>>>(
      tokens, table, K, n / LANES, num_tiles(n), work, stats);
  return (int)cudaGetLastError();
}

int run_production(int* tokens, long long n, const int* table, int K, int* work, int* stats,
                   cudaStream_t st) {
  if (K == 1) return run_pass<1, 0>(tokens, n, table, K, work, stats, st);
  if (K == 2) return run_pass<2, 0>(tokens, n, table, K, work, stats, st);
  if (K == 3) return run_pass<3, 0>(tokens, n, table, K, work, stats, st);
  return run_pass<4, 0>(tokens, n, table, K, work, stats, st);
}

// An ablated mask runs its KT = 1 instantiation for K = 1, else KT = 4.
template <unsigned ABL>
int run_ablated(int* tokens, long long n, const int* table, int K, int* work, int* stats,
                cudaStream_t st) {
  if (K == 1) return run_pass<1, ABL>(tokens, n, table, K, work, stats, st);
  return run_pass<4, ABL>(tokens, n, table, K, work, stats, st);
}

}  // namespace

extern "C" {

// int32s of scratch the pass needs for a stream of n tokens: a header, a
// 64-bit status word a tile and a partial a block (at most a block a tile).
long long zbpe_merge_work_ints(long long n) {
  return HDR_INTS + (long long)(2 + NPART) * num_tiles(n);
}

// One fused merge pass over tokens[n] (n > 0, a multiple of 128), in place.
// table: int32[K][3] device array of (a, b, new) slots, 1 <= K <= 4, a
// disabled slot is (-2, -2, -2). work: zbpe_merge_work_ints(n) int32s,
// zeroed before the first pass and kept between passes. stats: int32[K + 2].
// One launch; returns cudaGetLastError() after it.
int zbpe_merge_pass(int* tokens, long long n, const int* table, int K, int* work,
                    int* stats, void* stream) {
  if (bad_args(n, K)) return (int)cudaErrorInvalidValue;
  return run_production(tokens, n, table, K, work, stats, static_cast<cudaStream_t>(stream));
}

// The same pass with the pieces of mask ``variant`` switched off (one of the
// variants in the header; any other mask is refused).
int zbpe_merge_pass_ablated(int* tokens, long long n, const int* table, int K, int* work,
                            int* stats, int variant, void* stream) {
  if (bad_args(n, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((unsigned)variant) {
    case 0:
      return run_production(tokens, n, table, K, work, stats, st);
    case ABL_NOFAST:
      return run_ablated<ABL_NOFAST>(tokens, n, table, K, work, stats, st);
    case ABL_NOPARITY:
      return run_ablated<ABL_NOPARITY>(tokens, n, table, K, work, stats, st);
    case ABL_NOMINKEPT:
      return run_ablated<ABL_NOMINKEPT>(tokens, n, table, K, work, stats, st);
    case ABL_NOEDGEK:
      return run_ablated<ABL_NOEDGEK>(tokens, n, table, K, work, stats, st);
    case ABL_NOCOMPACT:
      return run_ablated<ABL_NOCOMPACT>(tokens, n, table, K, work, stats, st);
    case ABL_NOKILLS | ABL_NOCOMPACT | ABL_NOEDGEK | ABL_NOMINKEPT:
      return run_ablated<ABL_NOKILLS | ABL_NOCOMPACT | ABL_NOEDGEK | ABL_NOMINKEPT>(
          tokens, n, table, K, work, stats, st);
    case ABL_NOSTORE:
      return run_ablated<ABL_NOSTORE>(tokens, n, table, K, work, stats, st);
    case ABL_COPY:
      return run_ablated<ABL_COPY>(tokens, n, table, K, work, stats, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the persistent grid the production pass over n tokens launches
// with a K-slot table: the blocks that fit on the current device at once,
// at most one a tile; -1 for arguments the pass refuses. Launches nothing.
long long zbpe_merge_grid(long long n, int K) {
  if (bad_args(n, K)) return -1;
  if (K == 1) return grid_for<1, 0>(n);
  if (K == 2) return grid_for<2, 0>(n);
  if (K == 3) return grid_for<3, 0>(n);
  return grid_for<4, 0>(n);
}

}  // extern "C"
