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
// on chip, each a hash probe per token and a block-wide scan. So the work
// is shared-memory traffic and integer operations per pass. The design:
//
// * One block of 1024 threads per row. The row lives in shared memory as
//   one flat prefix of n tokens (128 KiB of int32 at L = 32768); there is
//   no room for a second buffer, so a pass compacts IN PLACE: every thread
//   first loads its C consecutive tokens (C odd, so the loads do not
//   conflict on the banks) into registers, a barrier follows, and the kept
//   tokens go to their destinations, which never lie after their sources.
//   The TPU kernel's (R, 128) sub-row layout, its edge kills, the self-heal
//   of drained sub-rows, the packed bit-move and the cached next view have
//   no counterpart: the row is flat.
// * The group is staged once per pass by warp 0 into a small open-addressed
//   hash table in shared memory, keyed by (a, b); each token then costs one
//   probe instead of a compare per member. Chain-freedom means hits never
//   touch each other, so a thread walks its tokens left to right, writing
//   the new id at each hit and dropping the token after it.
// * The a == b singleton needs the last non-candidate before each
//   candidate: one block-wide max-scan over the threads' last
//   non-candidate positions, then a walk within the thread.
// * A presence bitmap over ids [0, min(256 + P*cap, 65536)) skips members
//   whose tokens cannot be in the row: byte ids start set, ids of the input
//   row are set at load, a new id is set when its member fires, and ids at
//   or above the bound always count as present. It only skips work.
// * One launch replays the whole table over all rows; there is no host
//   sync inside it.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAXC = 33;  // tokens per thread: the odd ceiling of 32768 / 1024
constexpr int MIN_L = 1024;
constexpr int MAX_L = 32768;
constexpr int MAX_CAP = 1024;
constexpr int MAX_BITS = 65536;
constexpr int PAD = -1;
constexpr int EMPTY = -1;
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS == 32, "the block scans keep one partial per warp in one warp");

enum Mode { SKIP = 0, FUSED = 1, PARITY = 2 };

// Shared-memory layout, in int32 words (see smem_words).
struct Layout {
  int hslots;   // hash table slots, a power of two >= 2 * cap
  int words;    // presence bitmap words
  int bits;     // ids below this are tracked; the rest count as present
};

__host__ __device__ inline Layout layout_of(int P, int cap) {
  Layout l;
  l.hslots = 32;
  while (l.hslots < 2 * cap) l.hslots *= 2;
  long long b = 256LL + (long long)P * cap;
  l.bits = (int)(b < MAX_BITS ? b : MAX_BITS);
  l.words = (l.bits + 31) / 32;
  return l;
}

// tokens + 4 hash arrays + bitmap + scan scratch (33) + control (2 x 4)
__host__ __device__ inline long long smem_words(int L, const Layout& l) {
  return (long long)L + 4LL * l.hslots + l.words + 33 + 8;
}

__device__ __forceinline__ unsigned hash_pair(int a, int b, int mask) {
  unsigned h = (unsigned)a * 0x9E3779B1u + (unsigned)b * 0x85EBCA77u;
  h ^= h >> 15;
  return h & (unsigned)mask;
}

struct Table {
  int* ha;   // member's first token, EMPTY if the slot is free
  int* hb;   // member's second token
  int* hx;   // member's new token
  int* hf;   // 1 once the member fired in this pass
  int mask;  // hslots - 1
};

// Slot of the live member (a, b), or -1. a and b are >= 0.
__device__ __forceinline__ int lookup(const Table& t, int a, int b) {
  unsigned h = hash_pair(a, b, t.mask);
  while (true) {
    const int ka = t.ha[h];
    if (ka == EMPTY) return -1;
    if (ka == a && t.hb[h] == b) return (int)h;
    h = (h + 1) & (unsigned)t.mask;
  }
}

__device__ __forceinline__ bool present(const unsigned* bitmap, int bits, int v) {
  return v >= bits || ((bitmap[v >> 5] >> (v & 31)) & 1u);
}

// Exclusive block scan over THREADS threads (s: 33 ints of scratch); total
// gets the block total. Ends with a barrier, so s may be reused at once.
template <bool MAX>
__device__ int block_excl_scan(int v, int* s, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int identity = MAX ? -1 : 0;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = MAX ? max(incl, t) : incl + t;
  }
  int excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi = MAX ? max(wi, t) : wi + t;
    }
    int wex = __shfl_up_sync(FULL, wi, 1);
    if (lane == 0) wex = identity;
    s[lane] = wex;
    if (lane == 31) s[32] = wi;
  }
  __syncthreads();
  excl = MAX ? max(s[warp], excl) : s[warp] + excl;
  total = s[32];
  __syncthreads();
  return excl;
}

// Warp 0: mark the ids minted by the last group, clear the table, and
// insert the live members of group p. Writes the pass mode and, for a
// parity group, its pair, new id and slot into ctl.
__device__ void stage(const int* __restrict__ gtable, const int* __restrict__ glens,
                      int p, int cap, const Table& t, unsigned* bitmap, int bits,
                      int* ctl) {
  const int lane = threadIdx.x & 31;
  for (int s = lane; s <= t.mask; s += 32) {
    if (t.hf[s]) {
      const int x = t.hx[s];
      if (x < bits) atomicOr(&bitmap[x >> 5], 1u << (x & 31));
    }
    t.ha[s] = EMPTY;
    t.hf[s] = 0;
  }
  __syncwarp();
  const int glen = __ldg(&glens[p]);
  const int* g = gtable + (long long)p * cap * 3;
  const int a0 = __ldg(&g[0]), b0 = __ldg(&g[1]), x0 = __ldg(&g[2]);
  bool any = false;
  for (int j0 = 0; j0 < cap; j0 += 32) {
    const int j = j0 + lane;
    bool live = false;
    int a = 0, b = 0, x = 0;
    if (j < cap && j < glen) {
      a = __ldg(&g[3 * j]);
      b = __ldg(&g[3 * j + 1]);
      x = __ldg(&g[3 * j + 2]);
      live = x >= 0 && a >= 0 && b >= 0 && present(bitmap, bits, a) &&
             present(bitmap, bits, b);
    }
    if (live) {
      unsigned h = hash_pair(a, b, t.mask);
      while (atomicCAS(&t.ha[h], EMPTY, a) != EMPTY) h = (h + 1) & (unsigned)t.mask;
      t.hb[h] = b;
      t.hx[h] = x;
      if (j == 0) ctl[3] = (int)h;
    }
    any |= __any_sync(FULL, live);
  }
  if (lane == 0) {
    ctl[0] = !any ? SKIP : (glen == 1 && a0 == b0) ? PARITY : FUSED;
    ctl[1] = a0;
    ctl[2] = x0;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
encode_rows_kernel(const int* __restrict__ tokens, int* __restrict__ out,
                   int* __restrict__ lengths, int L, const int* __restrict__ gtable,
                   const int* __restrict__ glens, int P, int cap) {
  extern __shared__ int smem[];
  const Layout lay = layout_of(P, cap);
  int* s_tok = smem;
  Table tab;
  tab.ha = s_tok + L;
  tab.hb = tab.ha + lay.hslots;
  tab.hx = tab.hb + lay.hslots;
  tab.hf = tab.hx + lay.hslots;
  tab.mask = lay.hslots - 1;
  unsigned* bitmap = reinterpret_cast<unsigned*>(tab.hf + lay.hslots);
  int* s_scan = reinterpret_cast<int*>(bitmap + lay.words);
  int* ctl = s_scan + 33;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int* src = tokens + row * L;

  for (int w = tid; w < lay.words; w += THREADS) bitmap[w] = w < 8 ? FULL : 0u;
  for (int s = tid; s < lay.hslots; s += THREADS) {
    tab.ha[s] = EMPTY;
    tab.hf[s] = 0;
  }
  __syncthreads();
  for (int i = 4 * tid; i < L; i += 4 * THREADS) {
    const int4 v = *reinterpret_cast<const int4*>(src + i);
    s_tok[i] = v.x;
    s_tok[i + 1] = v.y;
    s_tok[i + 2] = v.z;
    s_tok[i + 3] = v.w;
    // ids the row brings with it (not bytes) are present from the start
    const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (vs[q] >= 256 && vs[q] < lay.bits) atomicOr(&bitmap[vs[q] >> 5], 1u << (vs[q] & 31));
  }
  __syncthreads();

  // Pass -1 compacts the row to a prefix (drops PAD wherever it stands);
  // passes 0 .. P-1 replay the groups.
  int n = L;
  for (int p = -1; p < P; ++p) {
    int mode = FUSED;
    // the control words alternate between two buffers: a thread that reads
    // them late in a skipped pass never sees the next pass's staging
    int* c = ctl + 4 * (p & 1);
    if (p >= 0) {
      if (tid < 32) stage(gtable, glens, p, cap, tab, bitmap, lay.bits, c);
      __syncthreads();
      mode = c[0];
      if (mode == SKIP) continue;
    }
    int C = (n + THREADS - 1) / THREADS;
    C |= 1;  // odd stride: the 32 lanes of a warp hit 32 distinct banks
    const int base = tid * C;
    const int cnt = max(0, min(C, n - base));
    int tok[MAXC];
#pragma unroll
    for (int k = 0; k < MAXC; ++k) tok[k] = k < cnt ? s_tok[base + k] : PAD;
    const int nxt = base + cnt < n ? s_tok[base + cnt] : PAD;
    const int prev = cnt > 0 && base > 0 ? s_tok[base - 1] : PAD;
    const uint64_t cntmask = cnt >= 64 ? ~0ull : ((1ull << cnt) - 1);

    uint64_t kill = 0;
    if (p < 0) {
#pragma unroll
      for (int k = 0; k < MAXC; ++k)
        if (k < cnt && tok[k] < 0) kill |= 1ull << k;
    } else if (mode == FUSED) {
      // the token before this thread's first one may open a hit
      if (cnt > 0 && prev >= 0 && lookup(tab, prev, tok[0]) >= 0) kill |= 1;
#pragma unroll
      for (int k = 0; k < MAXC; ++k) {
        if (k < cnt && !((kill >> k) & 1)) {
          const int nx = k + 1 < cnt ? tok[k + 1 < MAXC ? k + 1 : MAXC - 1] : nxt;
          if (nx >= 0) {
            const int s = lookup(tab, tok[k], nx);
            if (s >= 0) {
              tok[k] = tab.hx[s];
              tab.hf[s] = 1;
              kill |= 2ull << k;
            }
          }
        }
      }
    } else {  // PARITY
      const int a = c[1];
      uint64_t cand = 0;
      int lnc = -1;  // this thread's last non-candidate position
#pragma unroll
      for (int k = 0; k < MAXC; ++k) {
        if (k < cnt) {
          const int nx = k + 1 < cnt ? tok[k + 1 < MAXC ? k + 1 : MAXC - 1] : nxt;
          if (tok[k] == a && nx == a) cand |= 1ull << k;
          else lnc = base + k;
        }
      }
      int unused;
      int run = block_excl_scan<true>(lnc, s_scan, unused);
      // the previous thread's last token is a candidate that hits
      if (cnt > 0 && prev == a && tok[0] == a && (((base - 1) - run) & 1)) kill |= 1;
      uint64_t hit = 0;
#pragma unroll
      for (int k = 0; k < MAXC; ++k) {
        if (k < cnt) {
          if ((cand >> k) & 1) {
            if (((base + k) - run) & 1) hit |= 1ull << k;
          } else {
            run = base + k;
          }
        }
      }
      const int x = c[2];
#pragma unroll
      for (int k = 0; k < MAXC; ++k)
        if ((hit >> k) & 1) tok[k] = x;
      if (hit) tab.hf[c[3]] = 1;
      kill |= hit << 1;
    }
    kill &= cntmask;
    if (!__syncthreads_or(kill != 0)) continue;  // every token stays put
    const uint64_t keep = cntmask & ~kill;
    int total;
    int dst = block_excl_scan<false>(__popcll(keep), s_scan, total);
#pragma unroll
    for (int k = 0; k < MAXC; ++k)
      if ((keep >> k) & 1) s_tok[dst++] = tok[k];
    n = total;
    __syncthreads();
  }

  int* dst = out + row * L;
  for (int i = 4 * tid; i < L; i += 4 * THREADS) {
    int4 v;
    v.x = i < n ? s_tok[i] : PAD;
    v.y = i + 1 < n ? s_tok[i + 1] : PAD;
    v.z = i + 2 < n ? s_tok[i + 2] : PAD;
    v.w = i + 3 < n ? s_tok[i + 3] : PAD;
    *reinterpret_cast<int4*>(dst + i) = v;
  }
  if (tid == 0) lengths[row] = n;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes, for rows of L tokens and a
// table of P groups of cap members.
long long zbpe_encode_smem_bytes(int L, int P, int cap) {
  return smem_words(L, layout_of(P, cap)) * (long long)sizeof(int);
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
  const size_t bytes = (size_t)zbpe_encode_smem_bytes(L, P, cap);
  cudaError_t err = cudaFuncSetAttribute(
      encode_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  encode_rows_kernel<<<(unsigned)B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tokens, out, lengths, L, gtable, glens, P, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
