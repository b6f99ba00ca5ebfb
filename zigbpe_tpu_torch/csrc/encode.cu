// Batched merge-table replay (the serving path), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel zigbpe_tpu/ops/pallas/encode.py::_encode_kernel
// (entry points encode_rows_grouped and encode_rows_pallas). It computes the
// same function: for every document row of a [B, L] int32 batch (byte
// tokens, then PAD = -1), replay a grouped merge table gtable[P][cap][3] with
// group sizes glens[P]. Every member of a group applies at once, with its
// candidates (tok[i], tok[i+1]) == (a, b) taken from the row as it stood
// before the pass; a group whose only member has a == b resolves runs
// leftmost-greedy by parity (``aaa`` -> [X, a]); members with j >= glen, a
// negative token or a negative new id do nothing. The row comes out as one
// prefix with a PAD tail, and lengths[row] is its token count. Rows never
// link.
//
// What bounds it on an H100: not device memory. A row is read once and
// written once (8 bytes a token), while the replay makes P passes over it
// on chip, each a hash probe per token and an in-place compaction. So the
// work is shared-memory traffic and instructions per pass. An earlier design
// (one 1024-thread block a row, 33-token chunks a thread, the group staged
// into a hash table by warp 0 at the head of every pass, six barriers a
// pass, probes chained token to token, 64-bit masks and spills) reached
// 0.028 of the shared-memory bound. What this design does about each thing
// that held it back:
//
// * ONE BLOCK A ROW, THE ROW FLAT IN SHARED MEMORY (128 KiB at L = 32768,
//   so one block an SM at that length; shorter rows take fewer warps and
//   share an SM). A pass compacts IN PLACE: every lane loads its tokens into
//   registers, a barrier follows, and the kept tokens go to their places,
//   which never lie after their sources. Rows are taken one block each, not
//   by a persistent grid: a row is the unit of work, so a persistent grid
//   would end with the same short last wave.
// * WARPS STRIPED OVER THE ROW. Warp w holds the 1024 positions from
//   W = 1024w; lane l holds W + 32k + l at step k < 32, so every load and
//   store of a step touches 32 consecutive words (no bank conflict) and a
//   lane's masks are 32 bits. The word after the row is PAD (a sentinel: no
//   pair with it matches), so the unrolled loops load and probe every step
//   and only the valid mask knows where the row ends.
// * STAGING OFF THE PASS. The tables are double-buffered. During pass p the
//   last warp builds pass p + 1's table in the other buffer: it starts
//   copying the group's first 32 members with cp.async at the head of pass
//   p and hashes them after its own tokens, so no barrier waits on a load
//   from device memory. The presence bitmap that skipped members whose ids
//   were absent from the row is gone: it needed pass p's hits before pass
//   p + 1's table could be built.
// * ONE SHARED LOAD FOR A MISS. A group of at most 32 live members whose ids
//   are all below 65535 goes into a table of >= 16 x cap slots (4 x cap at
//   cap 1024) under one packed 32-bit key (a << 16 | b), with a multiplier
//   chosen by the staging warp (up to SEEDS tried, __match_any_sync over the
//   slots) so that no two members share a slot: a probe is one load and one
//   compare, hit or miss (and a width test, since a row may carry wider
//   ids). Any other group (more members, wider ids, or no collision-free
//   multiplier) goes into a linear-probing table keyed by the full (a, b),
//   so every int32 id >= 0 is taken.
// * INDEPENDENT PROBES. The pair at a position is its token and the next
//   word of the row as loaded, with no test of whether the pair before it
//   hit. That is sound because groups are chain-free (group_merges /
//   schedule_merges in ops/kernels/encode.py): the token after a hit is
//   some member's b, which is never a member's a, so it cannot open a hit;
//   and it is what the plain twin computes for any table. A hit drops the
//   next position: the next lane's at the same step (a shuffle of the hit
//   mask) or lane 0's at the next step; lane 0 probes the pair across the
//   warp boundary itself.
// * TWO BARRIERS A PASS. Each warp publishes one word: its kept count, with
//   a bit saying whether it dropped a token. After one barrier every warp forms its offset and the new length
//   from the 32 words with shuffles; a second barrier follows the writes,
//   and a pass that dropped nothing writes nothing and needs only the
//   first. An a == b pass first publishes each warp's last non-candidate
//   position behind a barrier of its own (the hits depend on it). So a
//   fused pass takes one or two barriers, an a == b pass two or three, a
//   pass with no live member one.
// * FEW QUARTER-RATE INSTRUCTIONS. POPC and FLO issue at a quarter of the
//   integer rate, and a ballot a step measured as costly: a loop of 32 of
//   them a warp cost more than the probes. The a == b pass transposes the warp's candidate bits with five
//   rounds of shuffles (lane k then holds step k's lanes, in position
//   order), marks each run's hits with one add (the run starts of even
//   parity, added to the mask, carry through their runs) and transposes the
//   hits back; the writes take a ballot and a count only at the steps that
//   hold a drop (one OR-reduction finds them).
// * NO SPILLS: 32 tokens and 32-bit masks a lane under 64 registers.
// * One launch replays the whole table over all rows; there is no host sync
//   inside it.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;  // steps of a warp: lane l holds positions W + 32k + l, k < C
constexpr int SPAN = 32 * C;  // positions of a warp
constexpr int MAX_THREADS = 1024;
constexpr int MIN_L = 1024;
constexpr int MAX_L = 32768;
constexpr int MAX_CAP = 1024;
constexpr int MIN_SLOTS = 64;
constexpr int MAX_SLOTS = 4096;
constexpr int SLOTS_PER_MEMBER = 16;
constexpr int SEEDS = 32;  // multipliers tried for a collision-free table
constexpr int PAD = -1;
constexpr int CTL = 4;     // control words of a buffer: mode, multiplier, parity a, x
constexpr int RAW = 100;   // the next group's first 32 members (3 words each), its length
constexpr int DROP_BIT = 1 << 16;  // published with a warp's kept count
constexpr unsigned EMPTY = 0xffffffffu;
constexpr unsigned NARROW = 65535;  // ids below this pack two to a key
constexpr unsigned MULT0 = 0x9E3779B1u;      // seed s multiplies by MULT0 + s * MULT_STEP
constexpr unsigned MULT_STEP = 0x7F4A7C16u;
constexpr unsigned HASH_A = 0x9E3779B1u;     // the linear-probing table's hash
constexpr unsigned HASH_B = 0x85EBCA77u;
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_THREADS / 32 * SPAN >= MAX_L, "a block's warps cover the longest row");
static_assert(MAX_THREADS / 32 == 32, "one published word a warp, read by one lane each");

enum Mode { SKIP = 0, PERFECT = 1, GENERAL = 2, PARITY = 3 };

struct Layout {
  int threads;  // one warp for each SPAN positions of the row
  int row;      // row words: the warps' spans, the PAD sentinel, rounded to 16 bytes
  int slots;    // slots of a table, a power of two
  int shift;    // 32 - log2(slots)
};

__host__ __device__ inline Layout layout_of(int L, int cap) {
  Layout l;
  const int warps = (L + SPAN - 1) / SPAN;
  l.threads = 32 * warps;
  l.row = warps * SPAN + 4;
  l.slots = MIN_SLOTS;
  l.shift = 26;
  while (l.slots < SLOTS_PER_MEMBER * cap && l.slots < MAX_SLOTS) {
    l.slots *= 2;
    --l.shift;
  }
  return l;
}

// row + two tables of 3 words a slot + control (2 x 8) + raw + published
// words (2 x 32 kept counts, 32 last non-candidates)
__host__ __device__ inline long long smem_words(const Layout& l) {
  return (long long)l.row + 6LL * l.slots + 2 * CTL + RAW + 3 * 32;
}

__device__ __forceinline__ unsigned general_hash(int a, int b, int shift) {
  return ((unsigned)a * HASH_A + (unsigned)b * HASH_B) >> shift;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The staging warp: start copying group p's length and first 32 members
// into raw. Nothing waits on it until stage().
__device__ __forceinline__ void fetch(const int* __restrict__ gtable,
                                      const int* __restrict__ glens, int p, int cap,
                                      int* raw, int lane) {
  const int* g = gtable + (long long)p * cap * 3;
  if (lane < cap)
    for (int w = 0; w < 3; ++w) cp_async4(raw + 3 * lane + w, g + 3 * lane + w);
  if (lane == 0) cp_async4(raw + 96, glens + p);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Linear-probing insert of the live member (a, b) -> x.
__device__ __forceinline__ void insert(unsigned* k0, unsigned* k1, int* xs, int a, int b,
                                       int x, const Layout& lay) {
  unsigned h = general_hash(a, b, lay.shift);
  while (atomicCAS(&k0[h], EMPTY, (unsigned)a) != EMPTY) h = (h + 1) & (lay.slots - 1);
  k1[h] = (unsigned)b;
  xs[h] = x;
}

// The staging warp: build group p's table in t (k0, k1, x arrays of slots
// words each) and its control words c, from raw (and, past 32 members,
// from device memory).
__device__ void stage(const int* __restrict__ gtable, int p, int cap, int* raw, unsigned* t,
                      int* c, const Layout& lay, int lane) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  unsigned* k0 = t;
  unsigned* k1 = t + lay.slots;
  int* xs = reinterpret_cast<int*>(t + 2 * lay.slots);
  for (int s = lane; s < lay.slots; s += 32) k0[s] = EMPTY;
  const int glen = min(raw[96], cap);
  int a = PAD, b = PAD, x = PAD;
  if (lane < glen) {
    a = raw[3 * lane];
    b = raw[3 * lane + 1];
    x = raw[3 * lane + 2];
  }
  __syncwarp();  // raw is read and the table clear before any insert or the next fetch
  int mode = GENERAL;
  unsigned mult = 0;
  const int a0 = __shfl_sync(FULL, a, 0), x0 = __shfl_sync(FULL, x, 0);
  if (glen <= 32) {
    const bool live = a >= 0 && b >= 0 && x >= 0;
    const bool narrow = __all_sync(FULL, !live || max((unsigned)a, (unsigned)b) < NARROW);
    if (!__any_sync(FULL, live)) {
      mode = SKIP;
    } else if (glen == 1 && a0 == __shfl_sync(FULL, b, 0)) {
      mode = PARITY;
    } else if (narrow) {
      const unsigned key = __byte_perm((unsigned)b, (unsigned)a, 0x5410);
      for (int s = 0; s < SEEDS; ++s) {
        const unsigned m = MULT0 + (unsigned)s * MULT_STEP;
        const unsigned h = (key * m) >> lay.shift;
        const unsigned peers = __match_any_sync(FULL, live ? h : 0x80000000u | lane);
        if (!__any_sync(FULL, live && __popc(peers) > 1)) {
          mode = PERFECT;
          mult = m;
          break;
        }
      }
      if (mode == PERFECT && live) {
        const unsigned h = (key * mult) >> lay.shift;
        k0[h] = key;
        xs[h] = x;
      }
    }
    if (mode == GENERAL && live) insert(k0, k1, xs, a, b, x, lay);
  } else {
    bool any = false;
    for (int j = lane; j < glen; j += 32) {
      const int* m = gtable + ((long long)p * cap + j) * 3;
      const int ja = __ldg(m), jb = __ldg(m + 1), jx = __ldg(m + 2);
      if (ja >= 0 && jb >= 0 && jx >= 0) {
        insert(k0, k1, xs, ja, jb, jx, lay);
        any = true;
      }
    }
    if (!__any_sync(FULL, any)) mode = SKIP;
  }
  if (lane == 0) {
    c[0] = mode;
    c[1] = (int)mult;
    c[2] = a0;
    c[3] = x0;
  }
  __syncwarp();
}

// Linear-probing lookup: the slot of the live member (a, b), or -1.
__device__ __forceinline__ int lookup(const unsigned* k0, const unsigned* k1, int a, int b,
                                      const Layout& lay) {
  if ((a | b) < 0) return -1;
  unsigned h = general_hash(a, b, lay.shift);
  for (unsigned ka; (ka = k0[h]) != EMPTY; h = (h + 1) & (lay.slots - 1))
    if (ka == (unsigned)a && k1[h] == (unsigned)b) return (int)h;
  return -1;
}

// The warp's 32 x 32 bit matrix transposed: lane i's bit j becomes lane
// j's bit i. Five rounds of shuffles, each swapping the off-diagonal
// blocks of half the size (in place of a ballot a bit).
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  constexpr unsigned LOW[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int j = 16 >> r;
    const unsigned m = LOW[r];
    const unsigned t = __shfl_xor_sync(FULL, x, j);
    x = lane & j ? (x & ~m) | ((t >> j) & m) : (x & m) | ((t << j) & ~m);
  }
  return x;
}

// Steps k of a lane whose positions W + 32k + lane lie before n, as bits.
__device__ __forceinline__ unsigned valid_steps(int n, int W, int lane) {
  const int rem = n - W - lane;
  const int steps = rem <= 0 ? 0 : min(C, (rem + 31) >> 5);
  return steps == 32 ? FULL : (1u << steps) - 1;
}

// A pass's probes in a collision-free table, step by step: token k (at
// position p = W + 32k + lane) and the token after it (p + 1) form one
// packed key, one load and one compare a pair, no pair waiting on another;
// a hit takes its new id at once. Both ids must be below NARROW: a row may
// carry wider ids, whose low halves could alias a member's key. Returns the
// hit steps.
__device__ __forceinline__ unsigned probe_perfect(int (&tok)[C], const int* s_tok, int p0,
                                                  const unsigned* k0, int xoff,
                                                  unsigned mult, int shift) {
  unsigned hit = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const unsigned a = (unsigned)tok[k], b = (unsigned)s_tok[p0 + 32 * k + 1];
    const unsigned key = __byte_perm(b, a, 0x5410);
    const unsigned* slot = k0 + ((key * mult) >> shift);
    if (*slot == key && max(a, b) < NARROW) {  // the load first: it need not wait
      tok[k] = (int)slot[xoff];  // the slot's new id, xoff words on
      hit |= 1u << k;
    }
  }
  return hit;
}

// Publish this warp's kept count (with a bit saying whether it dropped a
// token), wait for every warp's, and write the kept tokens to their places: the warp's go to one
// range from its offset, step by step, each step's kept lanes to
// consecutive words (their rank among the step's kept lanes), so no two
// lanes of a store share a bank. A warp that dropped nothing moves as one
// block, and stays where it is unless it rewrote a token (its last pair
// hit and dropped the next warp's first token). Returns the new row
// length; a pass in which no warp dropped a token writes nothing and takes
// this one barrier.
__device__ __forceinline__ int compact(int* s_tok, int* words, const int (&tok)[C],
                                       unsigned keep, unsigned valid, unsigned hit, int W,
                                       int lane, int warp, int warps, int n) {
  const bool dropped = __any_sync(FULL, keep != valid);
  const int kept = __reduce_add_sync(FULL, __popc(keep));
  if (lane == 0) words[warp] = kept | (dropped ? DROP_BIT : 0);
  __syncthreads();  // every load of the row is done
  const int w = lane < warps ? words[lane] : 0;
  const int wc = w & (DROP_BIT - 1);
  int incl = wc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  const int offset = __shfl_sync(FULL, incl - wc, warp);
  if (!__any_sync(FULL, w & DROP_BIT)) return n;  // the same in every warp
  const bool rewrote = __any_sync(FULL, hit);
  if (!dropped) {
    if (offset != W || rewrote) {  // the warp's tokens move as one block
#pragma unroll
      for (int k = 0; k < C; ++k)
        if ((valid >> k) & 1) s_tok[offset + 32 * k + lane] = tok[k];
    }
  } else {
    // a kept token's place is its position's rank in the warp's span less
    // the drops before it. Drops are rare: one reduction finds the steps
    // that hold any, and only those take a ballot and count (POPC issues at
    // a quarter of the integer rate).
    const unsigned below = (1u << lane) - 1;
    const unsigned drops = valid & ~keep;
    const unsigned dsteps = __reduce_or_sync(FULL, drops);
    int base = offset;  // the place of the step's lane 0
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int d = base + lane;
      if ((dsteps >> k) & 1) {
        const unsigned drop = __ballot_sync(FULL, (drops >> k) & 1);
        d -= __popc(drop & below);
        base -= __popc(drop);
      }
      if ((keep >> k) & 1) s_tok[d] = tok[k];
      base += 32;
    }
  }
  if (threadIdx.x == 0) s_tok[total] = PAD;  // the sentinel after the row
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
encode_rows_kernel(const int* __restrict__ tokens, int* __restrict__ out,
                   int* __restrict__ lengths, int L, const int* __restrict__ gtable,
                   const int* __restrict__ glens, int P, int cap) {
  extern __shared__ __align__(16) int smem[];
  const Layout lay = layout_of(L, cap);
  int* s_tok = smem;
  unsigned* s_tab = reinterpret_cast<unsigned*>(smem + lay.row);
  int* s_ctl = reinterpret_cast<int*>(s_tab + 6 * lay.slots);
  int* s_raw = s_ctl + 2 * CTL;
  int* s_words = s_raw + RAW;   // [2][32]: kept counts, by pass parity (the PAD pass: 1)
  int* s_runs = s_words + 64;   // [32]: last non-candidate positions

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const bool stager = warp == warps - 1;
  const int W = warp * SPAN;  // the warp's first position
  const int p0 = W + lane;    // the lane's position at step 0
  const long long row = blockIdx.x;

  if (stager) fetch(gtable, glens, 0, cap, s_raw, lane);
  const int4* src = reinterpret_cast<const int4*>(tokens + row * L);
  for (int i = tid; i < L / 4; i += blockDim.x) reinterpret_cast<int4*>(s_tok)[i] = __ldcs(src + i);
  for (int i = L + tid; i < lay.row; i += blockDim.x) s_tok[i] = PAD;
  if (stager) stage(gtable, 0, cap, s_raw, s_tab, s_ctl, lay, lane);
  __syncthreads();

  int tok[C];
  // the first pass drops PAD wherever it stands
  int n = L;
  {
    const unsigned valid = valid_steps(n, W, lane);
    unsigned keep = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      tok[k] = s_tok[p0 + 32 * k];
      keep |= (unsigned)(tok[k] >= 0) << k;
    }
    n = compact(s_tok, s_words + 32, tok, keep & valid, valid, 0, W, lane, warp, warps, n);
  }

  for (int p = 0; p < P; ++p) {
    const int* c = s_ctl + CTL * (p & 1);
    const int mode = c[0];
    const bool more = p + 1 < P;
    unsigned* next_tab = s_tab + 3 * lay.slots * ((p + 1) & 1);
    int* next_ctl = s_ctl + CTL * ((p + 1) & 1);
    if (stager && more) fetch(gtable, glens, p + 1, cap, s_raw, lane);
    if (mode == SKIP) {
      if (stager && more) stage(gtable, p + 1, cap, s_raw, next_tab, next_ctl, lay, lane);
      __syncthreads();
      continue;
    }
    const bool live = W < n;  // the warp holds tokens (the same in every lane)
    const unsigned valid = valid_steps(n, W, lane);
    if (live) {
#pragma unroll
      for (int k = 0; k < C; ++k) tok[k] = s_tok[p0 + 32 * k];
    }
    unsigned hit = 0;   // steps whose pair hits
    unsigned kill0 = 0; // 1 if the pair before the warp's first token hits
    if (mode == PARITY) {
      // a == b: a candidate hits iff its distance to the last
      // non-candidate before it is odd
      const int a = c[2], x = c[3];
      unsigned cand = 0;
      if (live) {
#pragma unroll
        for (int k = 0; k < C; ++k)
          cand |= (unsigned)((tok[k] == a) & (s_tok[p0 + 32 * k + 1] == a)) << k;
        cand &= valid;
      }
      // transpose the warp's candidates: lane k takes step k's mask (bit l:
      // the position W + 32k + l), whose runs lie in position order
      const unsigned cm = transpose32(cand, lane);
      const int step_last = ~cm ? W + 32 * lane + 31 - __clz(~cm) : -1;
      const int last = __reduce_max_sync(FULL, live ? step_last : -1);
      if (lane == 0) s_runs[warp] = last;
      __syncthreads();  // the last non-candidate of every warp
      const int before = __reduce_max_sync(FULL, lane < warp ? s_runs[lane] : -1);
      if (live) {
        // the last non-candidate before each step: a max-scan over the
        // lanes (steps). Then a run of candidates that starts at lane s
        // after a non-candidate hits at the lanes of s's parity; the run at
        // lane 0 continues from the step before, at the parity of run + 1.
        // The run starts of even parity, added to cm, carry through their
        // runs and mark them.
        int run = step_last;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) run = max(run, __shfl_up_sync(FULL, run, o));
        const int up = __shfl_up_sync(FULL, run, 1);  // every lane takes part
        run = max(before, lane > 0 ? up : -1);
        constexpr unsigned EVEN = 0x55555555u;
        const unsigned starts = cm & ~(cm << 1);
        const unsigned first_even = (cm & 1) && !((run + 1) & 1);
        const unsigned even_starts = (starts & EVEN & ~1u) | first_even;
        const unsigned even_runs = cm & ((cm + even_starts) ^ cm);
        const unsigned hits = (even_runs & EVEN) | (cm & ~even_runs & ~EVEN);
        // and back: lane l takes bit l of every step's hits
        hit = transpose32(hits, lane);
        if (hit) {
#pragma unroll
          for (int k = 0; k < C; ++k) tok[k] = (hit >> k) & 1 ? x : tok[k];
        }
        // position W - 1 is a candidate that hits: it kills position W
        kill0 = W > 0 && s_tok[W - 1] == a && s_tok[W] == a && ((W - 1 - before) & 1);
      }
    } else {
      const unsigned* k0 = s_tab + 3 * lay.slots * (p & 1);
      const unsigned* k1 = k0 + lay.slots;
      const int* xs = reinterpret_cast<const int*>(k0 + 2 * lay.slots);
      const unsigned mult = (unsigned)c[1];
      if (live) {
        // every pair from the row as it stands, with no pair waiting on
        // another (chain-freedom, see the note above)
        if (mode == PERFECT) {
          hit = probe_perfect(tok, s_tok, p0, k0, 2 * lay.slots, mult, lay.shift);
        } else {
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int h = lookup(k0, k1, tok[k], s_tok[p0 + 32 * k + 1], lay);
            if (h >= 0) {
              tok[k] = xs[h];
              hit |= 1u << k;
            }
          }
        }
        // the pair across the boundary with the warp before
        if (W > 0) {
          const int a = s_tok[W - 1], b = s_tok[W];
          if (mode == PERFECT) {
            const unsigned key = __byte_perm((unsigned)b, (unsigned)a, 0x5410);
            kill0 = max((unsigned)a, (unsigned)b) < NARROW &&
                    k0[(key * mult) >> lay.shift] == key;
          } else {
            kill0 = lookup(k0, k1, a, b, lay) >= 0;
          }
        }
      }
    }
    if (stager && more) stage(gtable, p + 1, cap, s_raw, next_tab, next_ctl, lay, lane);
    // a hit drops the token after it: lane l + 1's at the same step, or
    // lane 0's at the next step after lane 31
    hit &= valid;
    unsigned kill = __shfl_up_sync(FULL, hit, 1);
    const unsigned last = __shfl_sync(FULL, hit, 31);
    if (lane == 0) kill = last << 1 | kill0;
    n = compact(s_tok, s_words + 32 * (p & 1), tok, valid & ~kill, valid, hit, W, lane, warp,
                warps, n);
  }

  int4* dst = reinterpret_cast<int4*>(out + row * L);
  for (int i = tid; i < L / 4; i += blockDim.x) {
    int4 v = reinterpret_cast<const int4*>(s_tok)[i];
    if (4 * i >= n) v.x = PAD;
    if (4 * i + 1 >= n) v.y = PAD;
    if (4 * i + 2 >= n) v.z = PAD;
    if (4 * i + 3 >= n) v.w = PAD;
    __stcs(dst + i, v);
  }
  if (tid == 0) lengths[row] = n;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes, for rows of L tokens and a
// table of P groups of cap members.
long long zbpe_encode_smem_bytes(int L, int P, int cap) {
  (void)P;
  return smem_words(layout_of(L, cap)) * (long long)sizeof(int);
}

// Replay gtable[P][cap][3] / glens[P] over tokens[B][L] (L a multiple of 128
// in [1024, 32768], 1 <= cap <= 1024, P >= 1, B >= 1, tokens 16-byte
// aligned) into out[B][L] and lengths[B]. Returns cudaGetLastError() after
// the launch.
int zbpe_encode_rows(const int* tokens, int* out, int* lengths, long long B, int L,
                     const int* gtable, const int* glens, int P, int cap, void* stream) {
  if (B < 1 || B > 0x7fffffffLL || L % 128 != 0 || L < MIN_L || L > MAX_L || P < 1 ||
      cap < 1 || cap > MAX_CAP)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout_of(L, cap);
  const size_t bytes = (size_t)smem_words(lay) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      encode_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  encode_rows_kernel<<<(unsigned)B, lay.threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tokens, out, lengths, L, gtable, glens, P, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
