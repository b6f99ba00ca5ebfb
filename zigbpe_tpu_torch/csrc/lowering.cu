// The lowering checks of the TPU build, hand-written for Hopper (sm_90a):
// each construct that the Mosaic compiler was asked to accept, as a kernel
// that must build with nvcc and equal its plain PyTorch twin.
//
// Replaces the Pallas TPU kernels of scripts/probe_mosaic_ops.py:
//   rows_to_column  try_kernel (pallas_call at :21) on the two reshapes
//                   (32,128) -> (4096,1) (:29-38): a copy into one column;
//   transpose       try_kernel on (32,128) -> (128,32) (:40-44);
//   iota_mod_kernel try_kernel on iota % 4 + x (:47-54), any modulus;
//   dot_tn_kernel   try_kernel on the bf16 product i^T . i of (256,128)
//                   (:53-63) and skinny (:77, the (4096,8)^T . (4096,128)
//                   product): a^T . b, bf16 in, f32 out;
//   onehot_kernel   onehot_dot (:97): hi^T . lo from a (4096,1) token
//                   column, hi = (t >> 7) == iota(8), lo = (t & 127) ==
//                   iota(128): the (8, 128) count of the tokens in each bin
//                   of [0, 1024), as f32.
// On the TPU a construct that does not lower raises and the script prints
// FAIL; here it fails the build, and a wrong one fails its twin check.
//
// What bounds them on an H100. rows_to_column, transpose and iota_mod_add
// move 8 bytes an element (one read, one write): 256 MiB at 2^25 int32,
// 80.1 us at 3.35 TB/s. onehot_dot reads 4 bytes a token (40.1 us at
// 2^25); dot_tn reads each bf16 input once, 285 MB at (2^20,8)^T .
// (2^20,128) (85.1 us) against 2.2 us of bf16 tensor-core work, so bytes
// bound it too. At the script's sizes (a few hundred KB at most) every
// one is bound by launch latency, a microsecond or two.
//
// What the design does about it.
// - transpose: one block of TILE_THREADS threads per TILE x TILE int32
//   tile (16 KB of shared memory), the tiles on a 1-D grid.x (up to
//   2^31 - 1 of them; grid.y stops at 65,535). Each thread loads 16-byte
//   vectors along input rows and stores 16-byte vectors along output rows.
//   The tile sits in shared memory in 16-byte chunks swizzled by XOR (chunk
//   k of tile row r at chunk k ^ ((r / 4) % 8)), so that neither the vector
//   writes into it (8 lanes cover 128 contiguous bytes) nor the column reads
//   out of it (a warp reads 4 tile columns x 8 row chunks, 32 banks) conflict
//   on banks. A side whose rows do not start on 16 bytes (cols % 4 or rows
//   % 4 not 0, or a pointer off 16 bytes, as a view with a storage offset
//   is) moves scalars, a warp on 32 neighbours; a ragged tile checks each
//   16-byte chunk (vector side) or element (scalar side).
// - rows_to_column: a flat copy, one 16-byte vector a thread over as many
//   blocks of COLUMN_THREADS as it takes. A scalar head takes both
//   pointers to 16 bytes when they are aligned alike (else every element
//   is a scalar, one a thread), and a scalar tail ends it. On the card this
//   one-shot grid keeps pace with cudaMemcpyAsync (what torch.clone runs),
//   where a grid of 8 blocks an SM striding over its share did not
//   (PERF.md).
// - iota_mod_add: a 2-D grid laid over (row, column unit): a unit is a
//   16-byte vector of 4 columns when cols % 4 == 0 and both pointers sit
//   on 16 bytes, else one column. A block is bx units of by rows (bx * by
//   <= IOTA_THREADS; a row narrower than the block takes several rows, so
//   a warp still reads neighbouring addresses). A thread keeps its unit and
//   takes IOTA_UNROLL rows, grid_y * by apart, all loads issued before
//   their stores (one row when that would leave fewer than IOTA_UNROLL
//   blocks an SM, so a small array spreads over the card); its columns'
//   c % m are computed once, with one division while its first loads are in
//   flight, so an element costs a load, an add and a store. The grid is
//   one-shot, as column_kernel's and copy.cu's are: a grid of one wave of
//   blocks on the SMs, each thread walking its rows, ran about 6% slower on
//   the card (PERF.md). Past grid.y's 65,535 row blocks a thread walks on.
//   rows and cols cross as 64-bit integers.
// - All of these read and write with the streaming cache hint
//   (ld/st.global.cs, evict first): each byte is touched once. Element
//   offsets are 64-bit.
// - onehot_dot: a count needs no products. The TPU formed it as bf16
//   one-hot products summed in f32, which stop counting at 2^24 a bin; the
//   first port kept that (one block of 8 warps walking n in mma.sync steps,
//   each waiting on four scalar loads). Now, as hist.cu does: a grid of at
//   most as many ONEHOT_THREADS blocks as fit on the SMs at once, each
//   taking a contiguous share of the tokens in chunks of ONEHOT_UNROLL
//   16-byte vectors a thread (neighbouring threads on neighbouring
//   addresses, streaming hint, all of a thread's loads issued before its
//   adds), and one shared-memory atomicAdd a token in [0, 1024) on the
//   block's private int32 histogram (4 KB). A block adds each nonzero bin
//   to a 64-bit workspace with one global atomicAdd; the last block to
//   finish (a done ticket, as merge.cu's last block folds its stats)
//   rounds each count to f32 once, as the twin's bincount().float() does,
//   and leaves the workspace and the ticket zeroed for the next call. So
//   the counts are exact at every n; a lone block writes its bins
//   directly. n crosses as a 64-bit integer.
// - dot_tn: D[p][q] = sum_k X[k][p] Y[k][q], both inputs K-major. The
//   output is cut into DOT_BP x DOT_BQ tiles and K into splits: enough
//   splits that the grid fills the card when the output has few tiles
//   (the skinny product has 2), each split at least DOT_MIN_SPLIT_STEPS
//   k16 steps. A block streams its K-slab of X and Y through a ring of
//   DOT_STAGES stages in shared memory with cp.async 16-byte copies
//   (coalesced rows, thread t on chunk t % 8 of every 32nd row: no
//   division in the loader, whose instructions the card measured; rows
//   padded by 16 bytes so that the 8 rows an ldmatrix reads fall on
//   distinct banks), builds the fragments with ldmatrix.trans, and runs
//   mma.sync.m16n8k16: each of the 8 warps takes one k16 step of a stage
//   for the whole tile, so 8 chains run at once and a warp's tile fragments
//   are independent accumulators. Bytes bound the product at every shape
//   the probes use (2.2 us of bf16 work against 85 us of reads at the
//   scaled skinny one), so wgmma's rate would buy nothing. The warps'
//   partial tiles sum in warp order through a padded tile in shared
//   memory, two neighbouring elements a thread; with one split the block
//   writes the tile, else it writes a partial to the workspace and the
//   tile's last block (a done ticket a tile) folds the partials in split
//   order, so the result is the same from run to run, and resets the
//   ticket. An output with fewer than 16 rows is computed as its
//   transpose, b^T . a, and written back transposed. K crosses as a 64-bit
//   integer.
// The wrappers keep one zeroed workspace per device for these two; each
// call leaves it zeroed, allocates nothing and stays capturable by a CUDA
// graph. Calls on one device must not overlap (one stream at a time).
// The entries compute their geometry here (transpose_geometry,
// column_geometry, iota_geometry, onehot_geometry, dot_geometry);
// zbpe_lowering_plan reports it without a launch, and
// ops/kernels/lowering.py states it again for the CPU tests
// (transpose_plan, column_plan, iota_plan, onehot_plan, dot_plan).
//
// Each entry runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;          // transpose: one TILE x TILE int32 tile a block
constexpr int TILE_THREADS = 256;
constexpr int VEC = 4;            // int32 in a 16-byte vector
constexpr int CHUNKS = TILE / VEC;                         // vectors in a tile row
constexpr int TILE_STEPS = TILE * CHUNKS / TILE_THREADS;   // vectors a thread moves, each way
constexpr int COLUMN_THREADS = 256;  // rows_to_column: one element or vector a thread
constexpr long long GRID_X_MAX = 2147483647;
constexpr long long GRID_Y_MAX = 65535;
constexpr int IOTA_THREADS = 256;  // iota_mod_add: a block of bx units x by rows
constexpr int IOTA_UNROLL = 4;     // rows a thread loads before it stores them
static_assert(TILE_STEPS * (TILE_THREADS / 32) == TILE / VEC * (CHUNKS / 8),
              "a warp's store step covers 4 tile columns x 8 chunks");

constexpr int ONEHOT_BINS = 1024;     // onehot_dot: 8 hi rows x 128 lo columns
constexpr int ONEHOT_THREADS = 1024;  // one bin a thread to clear and flush
constexpr int ONEHOT_UNROLL = 4;      // 16-byte vectors a thread a chunk
constexpr int ONEHOT_CHUNK = ONEHOT_THREADS * ONEHOT_UNROLL * VEC;  // tokens a chunk
constexpr long long ONEHOT_MAX_PER = 131071;  // chunks a block: fewer than 2^31 tokens
static_assert(ONEHOT_THREADS == ONEHOT_BINS, "a thread clears and flushes one bin");

constexpr int DOT_THREADS = 256;     // dot_tn: 8 warps, one k16 step of a stage each
constexpr int DOT_WARPS = DOT_THREADS / 32;
constexpr int DOT_BP = 64;           // a block's output tile: DOT_BP x DOT_BQ
constexpr int DOT_BQ = 32;
constexpr int DOT_STAGES = 5;        // the ring of stages in shared memory
constexpr int DOT_MIN_SPLIT_STEPS = 16;  // k16 steps a split takes at least (256 rows)
constexpr int DOT_TICKETS = 256;     // done tickets at the workspace's head
constexpr int DOT_STAGE_ROWS = 16 * DOT_WARPS;   // k rows a stage
constexpr int X_PITCH = DOT_BP * 2 + 16;  // bytes a stage row of X: 16 of padding, so
constexpr int Y_PITCH = DOT_BQ * 2 + 16;  // an ldmatrix's 8 rows fall on distinct banks
constexpr int DOT_STAGE_BYTES = DOT_STAGE_ROWS * (X_PITCH + Y_PITCH);
constexpr int DOT_SMEM = DOT_STAGES * DOT_STAGE_BYTES;  // dynamic shared memory
constexpr int RED_PITCH = DOT_BQ + 8;  // floats a row of a warp's partial tile: float2
                                       // stores of a fragment row then hit 32 banks
static_assert(DOT_BP <= 64 && DOT_BQ <= 64 && DOT_STAGE_ROWS % (DOT_THREADS / 8) == 0,
              "a tile row is at most 8 chunks; the loader's rows tile a stage");
static_assert(DOT_WARPS * DOT_BP * RED_PITCH * 4 <= DOT_SMEM,
              "the warps' partial tiles fit in the ring");

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// dst[0:n] = src[0:n], n = head + VEC * vecs + tail: head scalars, vecs
// 16-byte vectors from src + head (16-byte aligned, as is dst + head), tail
// scalars. Thread i of the grid copies unit i of each part.
__global__ void __launch_bounds__(COLUMN_THREADS)
column_kernel(const int* __restrict__ src, int* __restrict__ dst, long long head, long long vecs,
              long long tail) {
  const long long i = (long long)blockIdx.x * COLUMN_THREADS + threadIdx.x;
  if (i < head) __stcs(dst + i, __ldcs(src + i));
  if (i < vecs)
    __stcs(reinterpret_cast<int4*>(dst + head) + i,
           __ldcs(reinterpret_cast<const int4*>(src + head) + i));
  const long long t0 = head + vecs * VEC;
  if (i < tail) __stcs(dst + t0 + i, __ldcs(src + t0 + i));
}

// Where element (r, c) of a tile sits in its shared-memory row: 16-byte
// chunk c / 4 moves to chunk (c / 4) ^ ((r / 4) % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return (((c >> 2) ^ ((r >> 2) & 7)) << 2) | (c & 3);
}

// dst[c][r] = src[r][c] (rows x cols int32) on the tile of this block: tile
// row blockIdx.x / tiles_c, tile column blockIdx.x % tiles_c. LOAD_VEC: the
// rows of src start on 16 bytes; STORE_VEC: those of dst do.
template <bool LOAD_VEC, bool STORE_VEC>
__global__ void __launch_bounds__(TILE_THREADS)
transpose_kernel(const int* __restrict__ src, int* __restrict__ dst, long long rows,
                 long long cols, int tiles_c) {
  __shared__ __align__(16) int tile[TILE][TILE];
  const long long r0 = (long long)(blockIdx.x / tiles_c) * TILE;
  const long long c0 = (long long)(blockIdx.x % tiles_c) * TILE;
  const int t = threadIdx.x;
  if (LOAD_VEC) {  // step s: tile row i / CHUNKS, its chunk i % CHUNKS
    int4 v[TILE_STEPS];
#pragma unroll
    for (int s = 0; s < TILE_STEPS; ++s) {
      const int i = s * TILE_THREADS + t, r = i / CHUNKS, c = i % CHUNKS * VEC;
      if (r0 + r < rows && c0 + c < cols)
        v[s] = __ldcs(reinterpret_cast<const int4*>(src + (r0 + r) * cols + c0 + c));
    }
#pragma unroll
    for (int s = 0; s < TILE_STEPS; ++s) {
      const int i = s * TILE_THREADS + t, r = i / CHUNKS, c = i % CHUNKS * VEC;
      if (r0 + r < rows && c0 + c < cols) *reinterpret_cast<int4*>(&tile[r][swz(r, c)]) = v[s];
    }
  } else {  // a warp reads 32 neighbours of one tile row
    for (int i = t; i < TILE * TILE; i += TILE_THREADS) {
      const int r = i / TILE, c = i % TILE;
      if (r0 + r < rows && c0 + c < cols)
        tile[r][swz(r, c)] = __ldcs(src + (r0 + r) * cols + c0 + c);
    }
  }
  __syncthreads();
  if (STORE_VEC) {  // warp task: tile columns 4 (task / 2) + lane / 8, chunk 8 (task % 2) + lane % 8
    const int lane = t & 31;
#pragma unroll
    for (int s = 0; s < TILE_STEPS; ++s) {
      const int task = s * (TILE_THREADS / 32) + (t >> 5);
      const int c = (task >> 1) * VEC + (lane >> 3), r = ((task & 1) * 8 + (lane & 7)) * VEC;
      if (c0 + c < cols && r0 + r < rows) {
        const int4 o = make_int4(tile[r][swz(r, c)], tile[r + 1][swz(r + 1, c)],
                                 tile[r + 2][swz(r + 2, c)], tile[r + 3][swz(r + 3, c)]);
        __stcs(reinterpret_cast<int4*>(dst + (c0 + c) * rows + r0 + r), o);
      }
    }
  } else {  // a warp writes 32 neighbours of one output row
    for (int i = t; i < TILE * TILE; i += TILE_THREADS) {
      const int c = i / TILE, r = i % TILE;
      if (c0 + c < cols && r0 + r < rows)
        __stcs(dst + (c0 + c) * rows + r0 + r, tile[r][swz(r, c)]);
    }
  }
}

// dst[r][c] = src[r][c] + c % m, read as rows of `units` units (VEC: int4
// vectors of 4 columns, else int columns). Thread (x, y) of block (i, k)
// takes unit j = i * blockDim.x + x of rows k * blockDim.y + y + t * step,
// t = 0, 1, ..., step = gridDim.y * blockDim.y, IOTA_UNROLL rows at a time.
template <bool VEC>
__global__ void __launch_bounds__(IOTA_THREADS)
iota_mod_kernel(const int* __restrict__ src, int* __restrict__ dst, long long rows,
                long long units, int m) {
  using Unit = typename std::conditional<VEC, int4, int>::type;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= units) return;
  // the unit's columns c0, c0 + 1, ... modulo m: one division, then wraps,
  // computed while the first trip's loads are in flight
  const unsigned um = (unsigned)m;
  unsigned cm[VEC ? 4 : 1];
  bool known = false;
  const Unit* s = reinterpret_cast<const Unit*>(src) + j;
  Unit* d = reinterpret_cast<Unit*>(dst) + j;
  const long long stride = (long long)gridDim.y * blockDim.y * units;  // units between rows
  const long long end = rows * units;
  for (long long off = ((long long)blockIdx.y * blockDim.y + threadIdx.y) * units; off < end;
       off += IOTA_UNROLL * stride) {
    Unit v[IOTA_UNROLL];
#pragma unroll
    for (int u = 0; u < IOTA_UNROLL; ++u)
      if (off + u * stride < end) v[u] = __ldcs(s + off + u * stride);
    if (!known) {
      cm[0] = (unsigned)((VEC ? 4 * j : j) % m);
#pragma unroll
      for (int k = 1; k < (VEC ? 4 : 1); ++k) cm[k] = cm[k - 1] + 1 == um ? 0u : cm[k - 1] + 1;
      known = true;
    }
#pragma unroll
    for (int u = 0; u < IOTA_UNROLL; ++u)
      if (off + u * stride < end) {
        Unit o = v[u];
        if constexpr (VEC) {  // int32 wraps, as the twin's add does
          o.x = (int)((unsigned)o.x + cm[0]), o.y = (int)((unsigned)o.y + cm[1]);
          o.z = (int)((unsigned)o.z + cm[2]), o.w = (int)((unsigned)o.w + cm[3]);
        } else {
          o = (int)((unsigned)o + cm[0]);
        }
        __stcs(d + off + u * stride, o);
      }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A done ticket: *p += 1 with acquire and release at device scope, the
// sum before it returned. Taken by one thread after a barrier, it makes the
// block's writes visible to whichever block then sees the last ticket, and
// that block's reads after its next barrier see every block's writes (the
// split-K semaphore pattern).
__device__ __forceinline__ unsigned ticket_add(void* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 m to
// 8 m + 7 give the addresses of matrix m's rows.
__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                          const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

// o[0] = s.x and o[sq] = s.y, as one 8-byte store when they are neighbours.
__device__ __forceinline__ void store_pair(float* o, long long sq, float2 s) {
  if (sq == 1) {
    *reinterpret_cast<float2*>(o) = s;
  } else {
    o[0] = s.x;
    o[sq] = s.y;
  }
}

// D[p][q] = sum_k X[k][p] * Y[k][q] (bf16 in, f32 out), stored at
// out[p * sp + q * sq]; X is (K, P), Y is (K, Q), P % 16 == 0, Q % 8 == 0,
// K = 16 * steps. Block b computes tile b / splits (tile row t / tiles_q,
// tile column t % tiles_q) over split b % splits: k16 steps [per * split,
// per * split + per). Stage s of a split holds its k rows [128 s, 128 s +
// 128); warp w multiplies the stage's step w into its accumulators of the
// whole tile. part: the splits' partial tiles (DOT_BP * DOT_BQ floats a
// block, the tile's valid elements first); tickets: one a tile, zero on
// entry and on exit.
__global__ void __launch_bounds__(DOT_THREADS, 1)
dot_tn_kernel(const unsigned short* __restrict__ X, const unsigned short* __restrict__ Y,
              float* __restrict__ out, int P, int Q, long long sp, long long sq,
              long long steps, long long per, int splits, int tiles_q, float* __restrict__ part,
              int* __restrict__ tickets) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int p0 = tile / tiles_q * DOT_BP, q0 = tile % tiles_q * DOT_BQ;
  const int np = min(DOT_BP, P - p0), nq = min(DOT_BQ, Q - q0);  // np % 16 == nq % 8 == 0
  const long long s0 = per * split;
  const int nsteps = (int)min(per, steps - s0);
  const int nstages = (nsteps + DOT_WARPS - 1) / DOT_WARPS;
  const unsigned short* x = X + s0 * 16 * P + p0;  // the slab's first row, at the tile
  const unsigned short* y = Y + s0 * 16 * Q + q0;
  const int xc = np / 8, yc = nq / 8;  // 16-byte chunks of a tile row
  // the loader: thread t copies chunk t % 8 of rows t / 8 + LOAD_ROWS j
  constexpr int LOAD_ROWS = DOT_THREADS / 8;
  const int lc = threadIdx.x & 7, lr = threadIdx.x >> 3;

  auto load = [&](int st) {  // stage st into its slot of the ring, 16 bytes a copy
    unsigned char* xs = smem + st % DOT_STAGES * DOT_STAGE_BYTES;
    unsigned char* ys = xs + DOT_STAGE_ROWS * X_PITCH;
    const int rows = min(DOT_STAGE_ROWS, (nsteps - st * DOT_WARPS) * 16);
    const long long r0 = (long long)st * DOT_STAGE_ROWS + lr;
#pragma unroll
    for (int j = 0; j < DOT_STAGE_ROWS / LOAD_ROWS; ++j) {
      const int r = lr + LOAD_ROWS * j;
      if (r < rows && lc < xc)
        cp_async16(xs + r * X_PITCH + lc * 16, x + (r0 + LOAD_ROWS * j) * P + lc * 8);
      if (r < rows && lc < yc)
        cp_async16(ys + r * Y_PITCH + lc * 16, y + (r0 + LOAD_ROWS * j) * Q + lc * 8);
    }
  };

  constexpr int PF = DOT_BP / 16, QF = DOT_BQ / 8;  // fragments of a tile
  const int pf = np / 16, qf = nq / 8;              // ... that hold output
  float acc[PF][QF][4];
#pragma unroll
  for (int i = 0; i < PF; ++i)
#pragma unroll
    for (int j = 0; j < QF; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // the lane's ldmatrix row and column: A's matrices are (p 0-7, k 0-7),
  // (p 8-15, k 0-7), (p 0-7, k 8-15), (p 8-15, k 8-15); B's (k 0-7, q 0-7),
  // (k 8-15, q 0-7), then the same at q 8-15
  const int ar = (lane & 7) + (lane >> 4) * 8, ac = (lane >> 3 & 1) * 8;
  const int br = (lane & 7) + (lane >> 3 & 1) * 8, bc = (lane >> 4) * 8;

#pragma unroll
  for (int st = 0; st < DOT_STAGES - 1; ++st) {
    if (st < nstages) load(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<DOT_STAGES - 2>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1's slot
    if (st + DOT_STAGES - 1 < nstages) load(st + DOT_STAGES - 1);
    cp_async_commit();
    if (st * DOT_WARPS + warp < nsteps) {
      const unsigned char* xs = smem + st % DOT_STAGES * DOT_STAGE_BYTES + warp * 16 * X_PITCH;
      const unsigned char* ys = smem + st % DOT_STAGES * DOT_STAGE_BYTES +
                                DOT_STAGE_ROWS * X_PITCH + warp * 16 * Y_PITCH;
      unsigned a[PF][4], b[QF][2];
#pragma unroll
      for (int i = 0; i < PF; ++i)
        if (i < pf)
          ldsm_x4_t(a[i][0], a[i][1], a[i][2], a[i][3], xs + ar * X_PITCH + (i * 16 + ac) * 2);
#pragma unroll
      for (int j = 0; j < QF; j += 2) {
        if (j + 1 < qf)
          ldsm_x4_t(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1],
                    ys + br * Y_PITCH + (j * 8 + bc) * 2);
        else if (j < qf)
          ldsm_x2_t(b[j][0], b[j][1], ys + br * Y_PITCH + j * 8 * 2);
      }
#pragma unroll
      for (int i = 0; i < PF; ++i)
#pragma unroll
        for (int j = 0; j < QF; ++j)
          if (i < pf && j < qf)
            mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' partial tiles, summed in warp order
  float* red = reinterpret_cast<float*>(smem);  // [DOT_WARPS][DOT_BP][RED_PITCH]
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < PF; ++i)
#pragma unroll
    for (int j = 0; j < QF; ++j)
      if (i < pf && j < qf) {
        float* r = red + (warp * DOT_BP + i * 16 + g) * RED_PITCH + j * 8 + 2 * tig;
        *reinterpret_cast<float2*>(r) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(r + 8 * RED_PITCH) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
  __syncthreads();
  // pair e of the tile's valid np x nq: elements (p, q) and (p, q + 1), q =
  // 2 e % nq (nq is even); a partial holds the pairs in order
  const int pairs = np * nq / 2;
  float2* mine = reinterpret_cast<float2*>(part + (long long)blockIdx.x * (DOT_BP * DOT_BQ));
  for (int e = threadIdx.x; e < pairs; e += DOT_THREADS) {
    const int p = 2 * e / nq, q = 2 * e - p * nq;
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DOT_WARPS; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(red + (w * DOT_BP + p) * RED_PITCH + q);
      s.x += v.x;
      s.y += v.y;
    }
    if (splits == 1)
      store_pair(out + (p0 + p) * sp + (q0 + q) * sq, sq, s);
    else
      mine[e] = s;
  }
  if (splits == 1) return;

  // the tile's last block folds its splits' partials in split order
  __syncthreads();
  if (threadIdx.x == 0) last = ticket_add(tickets + tile) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  const float2* first =
      reinterpret_cast<const float2*>(part + (long long)tile * splits * (DOT_BP * DOT_BQ));
  for (int e = threadIdx.x; e < pairs; e += DOT_THREADS) {
    float2 s = make_float2(0.f, 0.f);
#pragma unroll 16
    for (int k = 0; k < splits; ++k) {
      const float2 v = __ldcg(first + (long long)k * (DOT_BP * DOT_BQ / 2) + e);
      s.x += v.x;
      s.y += v.y;
    }
    const int p = 2 * e / nq, q = 2 * e - p * nq;
    store_pair(out + (p0 + p) * sp + (q0 + q) * sq, sq, s);
  }
  if (threadIdx.x == 0) tickets[tile] = 0;
}

// out[h][l] = the tokens of t with t >> 7 == h (h < 8) and t & 127 == l,
// that is out[t] += 1 for t in [0, 1024): block b counts the 16-byte
// vectors [b * share, b * share + share) of the n4 vectors of t into its
// shared bins. ws: 1024 64-bit counts and the done ticket, zero on entry
// and on exit.
__global__ void __launch_bounds__(ONEHOT_THREADS)
onehot_kernel(const int4* __restrict__ t, float* __restrict__ out, long long n4, long long share,
              unsigned long long* __restrict__ ws) {
  __shared__ int bins[ONEHOT_BINS];
  __shared__ int last;
  bins[threadIdx.x] = 0;
  __syncthreads();
  const long long v0 = blockIdx.x * share, v1 = min(v0 + share, n4);
  constexpr int STEP = ONEHOT_THREADS * ONEHOT_UNROLL;
  for (long long base = v0 + threadIdx.x; base < v1; base += STEP) {
    int4 v[ONEHOT_UNROLL];
#pragma unroll
    for (int k = 0; k < ONEHOT_UNROLL; ++k)
      v[k] = base + k * ONEHOT_THREADS < v1 ? __ldcs(t + base + k * ONEHOT_THREADS)
                                             : make_int4(-1, -1, -1, -1);
#pragma unroll
    for (int k = 0; k < ONEHOT_UNROLL; ++k) {
      const int b[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((unsigned)b[q] < (unsigned)ONEHOT_BINS) atomicAdd(bins + b[q], 1);
    }
  }
  __syncthreads();
  const int c = bins[threadIdx.x];
  if (gridDim.x == 1) {  // a lone block: its counts are the result
    out[threadIdx.x] = (float)c;
    return;
  }
  if (c) atomicAdd(ws + threadIdx.x, (unsigned long long)c);
  __syncthreads();  // the block's adds before its ticket (the word's low half)
  if (threadIdx.x == 0) last = ticket_add(ws + ONEHOT_BINS) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  out[threadIdx.x] = __ull2float_rn(atomicExch(ws + threadIdx.x, 0ull));
  if (threadIdx.x == 0) ws[ONEHOT_BINS] = 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct TransposeGeometry {
  int tiles_c, grid;
  bool load_vec, store_vec;
};

// false when the shape is empty or has more tiles than grid.x holds.
bool transpose_geometry(const void* src, const void* dst, long long rows, long long cols,
                        TransposeGeometry* g) {
  if (rows <= 0 || cols <= 0) return false;
  const long long tiles_c = (cols + TILE - 1) / TILE, tiles = (rows + TILE - 1) / TILE * tiles_c;
  if (tiles > GRID_X_MAX) return false;
  *g = {(int)tiles_c, (int)tiles, aligned16(src) && cols % VEC == 0,
        aligned16(dst) && rows % VEC == 0};
  return true;
}

struct ColumnGeometry {
  long long head, vecs, tail;
  int grid;
};

// The split of n elements into head, 16-byte vectors and tail: a head that
// takes both pointers to 16 bytes when they are aligned alike, else all n
// in the head; a grid of one block per COLUMN_THREADS units of the longest
// part. false when n is not positive or the grid does not fit grid.x.
bool column_geometry(const void* src, const void* dst, long long n, ColumnGeometry* g) {
  if (n <= 0) return false;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src), d = reinterpret_cast<uintptr_t>(dst);
  g->head = ((s - d) & 15) ? n : ((16 - (s & 15)) & 15) / 4;
  if (g->head > n) g->head = n;
  g->vecs = (n - g->head) / VEC;
  g->tail = n - g->head - g->vecs * VEC;
  long long units = g->head > g->vecs ? g->head : g->vecs;
  if (g->tail > units) units = g->tail;
  const long long grid = (units + COLUMN_THREADS - 1) / COLUMN_THREADS;
  if (grid > GRID_X_MAX) return false;
  g->grid = (int)grid;
  return true;
}

// The SM count of the current device, asked once a device.
cudaError_t device_sms(int* sms) {
  static int known[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    e = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = known[dev];
  return cudaSuccess;
}

struct IotaGeometry {
  bool vec;             // 16-byte vectors: cols % VEC == 0 and both pointers on 16 bytes
  long long units;      // units a row: cols / VEC vectors, else cols columns
  int bx, by;           // a block: bx units of by rows
  int grid_x, grid_y;   // ceil(units / bx) blocks across a row, grid_y down the rows
  int sms;
};

// The launch of zbpe_iota_mod_add on the current device: bx = min(units,
// IOTA_THREADS), by = IOTA_THREADS / bx, and a row block for each
// IOTA_UNROLL by-row groups, or for each group when that leaves fewer than
// IOTA_UNROLL blocks an SM (a small array spreads over the card); at most
// GRID_Y_MAX, past which a thread walks on. cudaErrorInvalidValue when the
// shape is empty or a row's blocks do not fit grid.x.
cudaError_t iota_geometry(const void* src, const void* dst, long long rows, long long cols,
                          IotaGeometry* g) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  const cudaError_t e = device_sms(&g->sms);
  if (e != cudaSuccess) return e;
  g->vec = cols % VEC == 0 && aligned16(src) && aligned16(dst);
  g->units = g->vec ? cols / VEC : cols;
  g->bx = g->units < IOTA_THREADS ? (int)g->units : IOTA_THREADS;
  g->by = IOTA_THREADS / g->bx;
  const long long grid_x = (g->units + g->bx - 1) / g->bx;
  if (grid_x > GRID_X_MAX) return cudaErrorInvalidValue;
  const long long groups = (rows + g->by - 1) / g->by;
  const long long per = grid_x * groups < (long long)g->sms * IOTA_UNROLL ? 1 : IOTA_UNROLL;
  const long long grid_y = (groups + per - 1) / per;
  g->grid_x = (int)grid_x, g->grid_y = (int)(grid_y < GRID_Y_MAX ? grid_y : GRID_Y_MAX);
  return cudaSuccess;
}

struct OnehotGeometry {
  long long chunks;   // ONEHOT_CHUNK-token pieces of the tokens, the last ragged
  long long per;      // chunks a block: block b takes [b * per, b * per + per)
  int grid;           // ceil(chunks / per)
  int sms, blocks_per_sm;  // the card, and onehot_kernel's occupancy on it
};

// The launch of zbpe_onehot_dot on the current device: a grid of at most
// sms * blocks_per_sm blocks, each a contiguous share of whole chunks and
// fewer than 2^31 tokens. cudaErrorInvalidValue when n is not a positive
// multiple of 16 or t is not 16-byte aligned.
cudaError_t onehot_geometry(const void* t, long long n, OnehotGeometry* g) {
  if (n <= 0 || n % 16 || !aligned16(t)) return cudaErrorInvalidValue;
  cudaError_t e = device_sms(&g->sms);
  if (e != cudaSuccess) return e;
  static int occupancy[64];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (occupancy[dev] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[dev], onehot_kernel,
                                                      ONEHOT_THREADS, 0);
    if (e != cudaSuccess) return e;
    if (occupancy[dev] < 1) occupancy[dev] = 1;
  }
  g->blocks_per_sm = occupancy[dev];
  g->chunks = (n + ONEHOT_CHUNK - 1) / ONEHOT_CHUNK;
  const long long resident = (long long)g->sms * g->blocks_per_sm;
  const long long grid = g->chunks < resident ? g->chunks : resident;
  g->per = (g->chunks + grid - 1) / grid;
  if (g->per > ONEHOT_MAX_PER) g->per = ONEHOT_MAX_PER;
  const long long blocks = (g->chunks + g->per - 1) / g->per;
  if (blocks > GRID_X_MAX) return cudaErrorInvalidValue;
  g->grid = (int)blocks;
  return cudaSuccess;
}

struct DotGeometry {
  int tiles_p, tiles_q;  // DOT_BP x DOT_BQ tiles of the (P, Q) output
  long long steps;       // k16 steps, K / 16
  long long per;         // k16 steps a split
  int splits;            // splits of K a tile, ceil(steps / per)
  int grid;              // tiles * splits
  int sms;
  long long ws_words;    // workspace 32-bit words: DOT_TICKETS + grid tiles of partials, or 0
};

// The launch of zbpe_dot_tn on the current device: as many splits of K a
// tile as fill min(sms, DOT_TICKETS) blocks, each split at least
// DOT_MIN_SPLIT_STEPS steps. cudaErrorInvalidValue for a shape the kernel
// does not take or X, Y not 16-byte aligned.
cudaError_t dot_geometry(const void* X, const void* Y, long long K, long long P, long long Q,
                         DotGeometry* g) {
  if (K <= 0 || P <= 0 || Q <= 0 || K % 16 || P % 16 || Q % 8 || P > 2147483647 ||
      Q > 2147483647 || !aligned16(X) || !aligned16(Y))
    return cudaErrorInvalidValue;
  const cudaError_t e = device_sms(&g->sms);
  if (e != cudaSuccess) return e;
  const long long tiles_p = (P + DOT_BP - 1) / DOT_BP, tiles_q = (Q + DOT_BQ - 1) / DOT_BQ;
  const long long tiles = tiles_p * tiles_q;
  if (tiles > GRID_X_MAX) return cudaErrorInvalidValue;
  g->tiles_p = (int)tiles_p, g->tiles_q = (int)tiles_q;
  g->steps = K / 16;
  const long long fill = g->sms < DOT_TICKETS ? g->sms : DOT_TICKETS;
  long long splits = (fill + tiles - 1) / tiles;
  const long long most = g->steps / DOT_MIN_SPLIT_STEPS;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  g->per = (g->steps + splits - 1) / splits;
  g->splits = (int)((g->steps + g->per - 1) / g->per);
  g->grid = (int)(tiles * g->splits);
  g->ws_words = g->splits > 1 ? DOT_TICKETS + (long long)g->grid * DOT_BP * DOT_BQ : 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dst[n][1] = src, read flat: the (rows, cols) -> (rows * cols, 1) reshape.
int zbpe_rows_to_column(const int* src, int* dst, long long n, void* stream) {
  ColumnGeometry g;
  if (!column_geometry(src, dst, n, &g)) return (int)cudaErrorInvalidValue;
  column_kernel<<<g.grid, COLUMN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, dst, g.head, g.vecs, g.tail);
  return (int)cudaGetLastError();
}

// dst[cols][rows] = src[rows][cols]^T (int32).
int zbpe_transpose(const int* src, int* dst, long long rows, long long cols, void* stream) {
  TransposeGeometry g;
  if (!transpose_geometry(src, dst, rows, cols, &g)) return (int)cudaErrorInvalidValue;
  const auto kernel = g.load_vec ? (g.store_vec ? transpose_kernel<true, true>
                                                : transpose_kernel<true, false>)
                                 : (g.store_vec ? transpose_kernel<false, true>
                                                : transpose_kernel<false, false>);
  kernel<<<g.grid, TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(src, dst, rows, cols,
                                                                         g.tiles_c);
  return (int)cudaGetLastError();
}

// The geometry that zbpe_rows_to_column (kind 0: a = n; out = head,
// vecs, tail, grid), zbpe_transpose (kind 1: a = rows, b = cols; out =
// tiles_c, grid, load_vec, store_vec), zbpe_onehot_dot (kind 2: src = t,
// a = n; out = chunks, per, grid, sms, blocks_per_sm), zbpe_dot_tn (kind
// 3: src = X, dst = Y, a = K, b = P, c = Q; out = tiles_p, tiles_q, steps,
// per, splits, grid, sms, ws_words) or zbpe_iota_mod_add (kind 4: a = rows,
// b = cols; out = vec, units, bx, by, grid_x, grid_y, sms)
// launches for these pointers on the current device, without a launch.
int zbpe_lowering_plan(int kind, const void* src, const void* dst, long long a, long long b,
                       long long c, long long* out) {
  ColumnGeometry col;
  TransposeGeometry t;
  OnehotGeometry oh;
  DotGeometry d;
  IotaGeometry io;
  if (kind == 0 && column_geometry(src, dst, a, &col)) {
    out[0] = col.head, out[1] = col.vecs, out[2] = col.tail, out[3] = col.grid;
  } else if (kind == 1 && transpose_geometry(src, dst, a, b, &t)) {
    out[0] = t.tiles_c, out[1] = t.grid, out[2] = t.load_vec, out[3] = t.store_vec;
  } else if (kind == 2) {
    const cudaError_t e = onehot_geometry(src, a, &oh);
    if (e != cudaSuccess) return (int)e;
    out[0] = oh.chunks, out[1] = oh.per, out[2] = oh.grid, out[3] = oh.sms;
    out[4] = oh.blocks_per_sm;
  } else if (kind == 3) {
    const cudaError_t e = dot_geometry(src, dst, a, b, c, &d);
    if (e != cudaSuccess) return (int)e;
    out[0] = d.tiles_p, out[1] = d.tiles_q, out[2] = d.steps, out[3] = d.per;
    out[4] = d.splits, out[5] = d.grid, out[6] = d.sms, out[7] = d.ws_words;
  } else if (kind == 4) {
    const cudaError_t e = iota_geometry(src, dst, a, b, &io);
    if (e != cudaSuccess) return (int)e;
    out[0] = io.vec, out[1] = io.units, out[2] = io.bx, out[3] = io.by;
    out[4] = io.grid_x, out[5] = io.grid_y, out[6] = io.sms;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// dst[r][c] = c % m + src[r][c] (int32, rows x cols, rows and cols 64-bit).
int zbpe_iota_mod_add(const int* src, int* dst, long long rows, long long cols, int m,
                      void* stream) {
  if (rows <= 0 || cols <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  IotaGeometry g;
  const cudaError_t e = iota_geometry(src, dst, rows, cols, &g);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.grid_x, g.grid_y), block(g.bx, g.by);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.vec)
    iota_mod_kernel<true><<<grid, block, 0, st>>>(src, dst, rows, g.units, m);
  else
    iota_mod_kernel<false><<<grid, block, 0, st>>>(src, dst, rows, g.units, m);
  return (int)cudaGetLastError();
}

// out[P][Q] (f32, at out[p * sp + q * sq]) = X^T . Y, X (K, P) and Y (K, Q)
// bf16, 16-byte aligned; P % 16 == 0, Q % 8 == 0, K % 16 == 0. ws: the
// zeroed workspace of ws_words 32-bit words (dot_geometry's ws_words at
// least), left zeroed.
int zbpe_dot_tn(const void* X, const void* Y, float* out, long long K, long long P, long long Q,
                long long sp, long long sq, int* ws, long long ws_words, void* stream) {
  DotGeometry g;
  cudaError_t e = dot_geometry(X, Y, K, P, Q, &g);
  if (e != cudaSuccess) return (int)e;
  if (g.ws_words > ws_words) return (int)cudaErrorInvalidValue;
  static bool sized[64];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(dot_tn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DOT_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  dot_tn_kernel<<<g.grid, DOT_THREADS, DOT_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(X), static_cast<const unsigned short*>(Y), out, (int)P,
      (int)Q, sp, sq, g.steps, g.per, g.splits, g.tiles_q,
      reinterpret_cast<float*>(ws + DOT_TICKETS), ws);
  return (int)cudaGetLastError();
}

// out[8][128] (f32) = hi^T . lo of the n int32 tokens t (n % 16 == 0, t
// 16-byte aligned): out[h][l] counts the tokens h * 128 + l. ws: 1025
// zeroed 64-bit words, left zeroed.
int zbpe_onehot_dot(const int* t, float* out, long long n, unsigned long long* ws,
                    void* stream) {
  OnehotGeometry g;
  const cudaError_t e = onehot_geometry(t, n, &g);
  if (e != cudaSuccess) return (int)e;
  onehot_kernel<<<g.grid, ONEHOT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(t), out, n / VEC,
      g.per * (ONEHOT_THREADS * ONEHOT_UNROLL), ws);
  return (int)cudaGetLastError();
}

}  // extern "C"
