// The exact-count verify pass of lazy selection, hand-written for Hopper
// (sm_90a): out[i] = the number of slots of an int32 pair-id stream that hold
// queries[i]. Slots with no pair hold -1; queries are >= 0 and may repeat
// (equal queries get equal counts).
//
// Replaces no Pallas kernel: the JAX package counts these in XLA, one fused
// compare-and-sum over the packed pair-id stream for each query
// (zigbpe_tpu/ops/core.py select_top_pair_lazy, count_fn at :301). The plain
// PyTorch twin (ops/kernels/count.py) compares the stream with every query
// in chunks of 2^20 slots, building a Q x 2^20 matrix each time.
//
// What bounds it on an H100: bytes, one read of the stream (N x 4 B: 0.020
// ms at N = 2^24 and 3.35 TB/s); the queries and the output are a few KiB.
// What the design does about it:
// - A persistent grid: a few 512-thread blocks an SM (the occupancy at the
//   block's shared memory, at most BLOCKS_PER_SM), each walking steps of
//   the stream in a grid-stride loop. A step is THREADS x VECS 16-byte
//   vectors; a thread loads its VECS vectors with the streaming cache hint
//   (ld.global.cs) before it looks at any, neighbouring threads on
//   neighbouring addresses, so each byte is read once and the loads of a
//   step are in flight together.
// - The queries in shared memory as an open-addressed hash table of
//   2^bits entries (at least 16 Q, up to 2^14: at most a sixteenth full up
//   to 1024 queries, half full at 8192), each entry a key and its dense
//   index among the distinct queries in one 8-byte word: a multiplicative
//   hash and linear probing. Each block builds its own copy (atomicCAS on
//   the key; a repeated query finds its key already there and takes no
//   index). A token costs one probe, not Q compares: the four tokens of a
//   vector load their home entries together, with no branch, and only a
//   lane whose home entry holds another key walks on, which a table that
//   sparse makes rare for a whole warp. A PAD slot (-1) counts nowhere.
//   (With a table a quarter full, at 4 Q, most warps had a lane walking on
//   every token: 0.058 against 0.036 ms at N = 2^24, Q = 105.)
// - The count: the few pairs at the head of the table are a large share of
//   the stream, so many lanes of a warp find the same key at once, and one
//   shared counter would take their atomics one after another. Each count
//   is kept in `copies` copies side by side (32 up to 256 queries, as
//   48 KiB allows; fewer above), lane l adding to copy l mod copies: with
//   32 copies every lane of a warp adds in its own bank, whatever it found.
//   (Agreeing first on equal slots with __match_any_sync ran at 0.19 of the
//   bound at N = 2^24, Q = 105; the match alone took about 50 cycles of an
//   SM a token.)
// - The fold: after its last step a block probes each query once more and
//   adds the sum of its count's copies to out[i] with one global atomicAdd,
//   where the sum is nonzero. The counts are integers, so the sum does not
//   depend on the blocks' order. The C entry zeroes out on the caller's
//   stream first (a memset, no kernel).
// - The last N mod 4 slots (at most 3) are read one by one by block 0.
// Queries are int64, as the trainer makes them, narrowed to int32 in the
// kernel as a cast to the stream's type would, so the wrapper makes no
// conversion launch on the trainer's path. The entry
// computes its geometry (count_geometry); zbpe_count_plan reports it
// without a launch, and ops/kernels/count.py states it again (count_plan)
// for the CPU tests.
//
// The entry runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int VECS = 4;             // 16-byte vectors a thread a step
constexpr int BLOCKS_PER_SM = 4;    // at most; fewer where shared memory or registers allow fewer
constexpr int MAX_QUERIES = 8192;
constexpr int MIN_BITS = 8;         // the smallest table: 256 entries
constexpr int LOAD_BITS = 4;        // entries >= 16 Q, up to 2^MAX_BITS
constexpr int MAX_BITS = 14;        // 2^14 entries of 8 bytes, 128 KiB
constexpr int COPIES = 32;          // copies of a count, at most: one a lane
constexpr int COUNT_BYTES = 49152;  // a block's counts, at most
constexpr int EMPTY = -1;           // a free key; every query is >= 0
constexpr unsigned HASH = 2654435761u;  // Knuth's multiplicative constant, 2^32 / phi

__device__ __forceinline__ unsigned home(int key, int bits) {
  return ((unsigned)key * HASH) >> (32 - bits);
}

// The dense index of key t, whose probe starts at entry h holding e, or -1
// where t is no key (or PAD).
__device__ __forceinline__ int walk(const int2* table, int t, unsigned h, int2 e, int bits) {
  if (t < 0) return -1;
  const unsigned mask = (1u << bits) - 1;
  while (e.x != t) {
    if (e.x == EMPTY) return -1;
    h = (h + 1) & mask;
    e = table[h];
  }
  return e.y;
}

__device__ __forceinline__ int find(const int2* table, int t, int bits) {
  const unsigned h = home(t < 0 ? 0 : t, bits);
  return walk(table, t, h, table[h], bits);
}

// See the note above. Dynamic shared memory: 2^bits entries (key, index),
// then 2^qbits rows of `copies` counts. out: Q int32, zero on entry.
__global__ void __launch_bounds__(THREADS)
count_queries_kernel(const int4* __restrict__ s4, const int* __restrict__ s, long long n4,
                     long long n, long long steps, const long long* __restrict__ q, int nq,
                     int bits, int qbits, int copies, int* __restrict__ out) {
  extern __shared__ int2 table[];
  __shared__ int distinct;
  int* counts = reinterpret_cast<int*>(table + (1 << bits));
  const unsigned mask = (1u << bits) - 1;
  for (int i = threadIdx.x; i < (1 << bits); i += THREADS) table[i] = make_int2(EMPTY, -1);
  for (int i = threadIdx.x; i < (copies << qbits); i += THREADS) counts[i] = 0;
  if (threadIdx.x == 0) distinct = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < nq; i += THREADS) {
    const int key = (int)q[i];
    if (key < 0) continue;  // outside the contract: it counts nothing
    for (unsigned h = home(key, bits);; h = (h + 1) & mask) {
      const int was = atomicCAS(&table[h].x, EMPTY, key);
      if (was == EMPTY) table[h].y = atomicAdd(&distinct, 1);
      if (was == EMPTY || was == key) break;
    }
  }
  __syncthreads();

  int* mine = counts + (threadIdx.x & 31 & (copies - 1));  // this lane's copy of row 0
  for (long long step = blockIdx.x; step < steps; step += gridDim.x) {
    const long long base = step * (THREADS * VECS) + threadIdx.x;
    int4 v[VECS];
#pragma unroll
    for (int k = 0; k < VECS; ++k)
      v[k] = base + k * THREADS < n4 ? __ldcs(s4 + base + k * THREADS)
                                     : make_int4(-1, -1, -1, -1);
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int t[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      unsigned h[4];
      int2 e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = home(t[j] < 0 ? 0 : t[j], bits);
        e[j] = table[h[j]];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = walk(table, t[j], h[j], e[j], bits);
        if (d >= 0) atomicAdd(mine + d * copies, 1);
      }
    }
  }
  if (blockIdx.x == 0 && 4 * n4 + threadIdx.x < n) {  // the last n - 4 n4 slots
    const int d = find(table, s[4 * n4 + threadIdx.x], bits);
    if (d >= 0) atomicAdd(mine + d * copies, 1);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nq; i += THREADS) {
    const int d = find(table, (int)q[i], bits);
    if (d < 0) continue;
    int c = 0;
    for (int r = 0; r < copies; ++r) c += counts[d * copies + r];
    if (c) atomicAdd(out + i, c);
  }
}

struct CountGeometry {
  int qbits;          // log2 of the queries rounded up to a power of two
  int bits;           // log2 of the table's entries: qbits + LOAD_BITS in [MIN_BITS, MAX_BITS]
  int copies;         // copies of each count: a power of two, at most COPIES, COUNT_BYTES in all
  int smem;           // bytes of a block's shared memory: entries and counts
  long long n4;       // whole 16-byte vectors of the stream
  long long steps;    // steps of the grid-stride loop, THREADS * VECS vectors each
  int sms;            // SMs of the current device
  int blocks_per_sm;  // min(BLOCKS_PER_SM, the kernel's occupancy at smem bytes)
  int grid;           // min(max(steps, 1), sms * blocks_per_sm)
};

// The launch of zbpe_count_queries on the current device:
// cudaErrorInvalidValue for arguments it does not take. The shared memory
// depends on qbits alone. The SM count and the kernel's occupancy at each
// qbits are asked once and kept; the kernel opts in once to the most dynamic
// shared memory any qbits takes (an attribute of the function, so never to a
// smaller one).
cudaError_t count_geometry(long long n, int nq, CountGeometry* g) {
  if (n < 0 || nq < 1 || nq > MAX_QUERIES) return cudaErrorInvalidValue;
  g->qbits = 0;
  while ((1 << g->qbits) < nq) ++g->qbits;
  g->bits = g->qbits + LOAD_BITS;
  g->bits = g->bits < MIN_BITS ? MIN_BITS : (g->bits > MAX_BITS ? MAX_BITS : g->bits);
  g->copies = COPIES;
  while (g->copies > 1 && (g->copies << g->qbits) * (int)sizeof(int) > COUNT_BYTES)
    g->copies /= 2;
  g->smem = (1 << g->bits) * (int)sizeof(int2) + (g->copies << g->qbits) * (int)sizeof(int);
  g->n4 = n / 4;
  g->steps = (g->n4 + THREADS * VECS - 1) / (THREADS * VECS);
  static int sms = 0;
  static bool opted = false;
  static int occupancy[MAX_BITS + 1];
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        count_queries_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (1 << MAX_BITS) * (int)sizeof(int2) + COUNT_BYTES);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  int& occ = occupancy[g->qbits];
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, count_queries_kernel, THREADS, g->smem);
    if (e != cudaSuccess) return e;
    if (occ < 1) occ = 1;
  }
  g->sms = sms;
  g->blocks_per_sm = occ < BLOCKS_PER_SM ? occ : BLOCKS_PER_SM;
  const long long resident = (long long)sms * g->blocks_per_sm;
  const long long want = g->steps > 1 ? g->steps : 1;
  g->grid = (int)(want < resident ? want : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out[i] = the number of j < n with pids[j] == queries[i], for nq int64
// queries (1 <= nq <= 8192), each taken as its low 32 bits. pids is int32
// and 16-byte aligned; its -1 slots match nothing. out is zeroed here.
int zbpe_count_queries(const void* pids, long long n, const long long* queries, int nq, int* out,
                       void* stream) {
  CountGeometry g;
  cudaError_t e = count_geometry(n, nq, &g);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(out, 0, (size_t)nq * sizeof(int), st);
  if (e != cudaSuccess || n == 0) return (int)e;
  count_queries_kernel<<<g.grid, THREADS, g.smem, st>>>(
      static_cast<const int4*>(pids), static_cast<const int*>(pids), g.n4, n, g.steps, queries,
      nq, g.bits, g.qbits, g.copies, out);
  return (int)cudaGetLastError();
}

// The geometry zbpe_count_queries launches for these arguments on the
// current device, without a launch: out = qbits, bits, copies, smem, n4,
// steps, sms, blocks_per_sm, grid.
int zbpe_count_plan(long long n, int nq, long long* out) {
  CountGeometry g;
  const cudaError_t e = count_geometry(n, nq, &g);
  if (e != cudaSuccess) return (int)e;
  out[0] = g.qbits, out[1] = g.bits, out[2] = g.copies, out[3] = g.smem, out[4] = g.n4;
  out[5] = g.steps, out[6] = g.sms, out[7] = g.blocks_per_sm, out[8] = g.grid;
  return 0;
}

}  // extern "C"
