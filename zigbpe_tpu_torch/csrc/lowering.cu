// The lowering checks of the TPU build, hand-written for Hopper (sm_90a):
// each construct that the Mosaic compiler was asked to accept, as a kernel
// that must build with nvcc and equal its plain PyTorch twin.
//
// Replaces the Pallas TPU kernels of scripts/probe_mosaic_ops.py:
//   rows_to_column  try_kernel (pallas_call at :21) on the two reshapes
//                   (32,128) -> (4096,1) (:29-38): a copy into one column;
//   transpose       try_kernel on (32,128) -> (128,32) (:40-44);
//   iota_mod_kernel try_kernel on iota % 4 + x (:45-52), any modulus;
//   dot_tn_kernel   try_kernel on the bf16 product i^T . i of (256,128)
//                   (:53-63) and skinny (:77, the (4096,8)^T . (4096,128)
//                   product): a^T . b, bf16 in, f32 out, on mma.sync;
//   onehot_kernel   onehot_dot (:97): hi^T . lo from a (4096,1) token
//                   column, hi = (t >> 7) == iota(8), lo = (t & 127) ==
//                   iota(128), bf16 one-hots built in registers, f32 out.
// On the TPU a construct that does not lower raises and the script prints
// FAIL; here it fails the build, and a wrong one fails its twin check.
//
// What bounds them on an H100. rows_to_column and transpose move 8 bytes
// an element (one read, one write): 256 MiB at 2^25 int32, 80.1 us at
// 3.35 TB/s. At the script's (32, 128) they move 32 KB, and a call is
// bound by the host's launch path (PERF.md), not by the card. The others
// are bound by launch latency (a few microseconds): each moves at most a
// few hundred KB and does at most 2 * 128 * 128 * 4096 flops.
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
// - Both read and write with the streaming cache hint (ld/st.global.cs,
//   evict first): each byte is touched once. Element offsets are 64-bit.
// - The others are the plainest kernel per construct. The products give
//   each warp one 16 x 8 tile of the output and walk K in steps of 16 with
//   mma.sync.m16n8k16, loading each fragment's bf16 values straight from
//   device memory (the inputs are a^T-major, so no shared memory transpose
//   is needed). An output with fewer than 16 rows is computed as its
//   transpose, b^T . a, and written back transposed, as the histogram
//   kernel lays out its one-hots.
// The two copies' entries compute their geometry here (transpose_geometry,
// column_geometry); zbpe_lowering_plan reports it without a launch, and
// ops/kernels/lowering.py states it again for the CPU tests
// (transpose_plan, column_plan).
//
// Each entry runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // transpose: one TILE x TILE int32 tile a block
constexpr int TILE_THREADS = 256;
constexpr int VEC = 4;            // int32 in a 16-byte vector
constexpr int CHUNKS = TILE / VEC;                         // vectors in a tile row
constexpr int TILE_STEPS = TILE * CHUNKS / TILE_THREADS;   // vectors a thread moves, each way
constexpr int COLUMN_THREADS = 256;  // rows_to_column: one element or vector a thread
constexpr long long GRID_X_MAX = 2147483647;
static_assert(TILE_STEPS * (TILE_THREADS / 32) == TILE / VEC * (CHUNKS / 8),
              "a warp's store step covers 4 tile columns x 8 chunks");
constexpr unsigned ONE_LO = 0x3f80u, ONE_HI = 0x3f800000u;  // bf16 1.0 in a half

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

__global__ void iota_mod_kernel(const int* __restrict__ src, int* __restrict__ dst, int n,
                                int cols, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = (i % cols) % m + src[i];
}

__device__ __forceinline__ unsigned pair(const unsigned short* p, int stride) {
  return (unsigned)p[0] | ((unsigned)p[stride] << 16);
}

// D[p][q] = sum_k X[k][p] * Y[k][q] (bf16 in, f32 out), stored at
// out[p * sp + q * sq]; X is (K, P), Y is (K, Q), P % 16 == 0, Q % 8 == 0,
// K % 16 == 0. One warp per 16 x 8 tile of D.
__global__ void dot_tn_kernel(const unsigned short* __restrict__ X,
                              const unsigned short* __restrict__ Y, float* __restrict__ out,
                              int K, int P, int Q, int sp, int sq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int qt = Q / 8;
  if (tile >= P / 16 * qt) return;  // whole warps only
  const int p0 = tile / qt * 16 + g, q0 = tile % qt * 8 + g;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kb = 0; kb < K; kb += 16) {
    const int k = kb + 2 * tig;  // the lane's k indices: k, k + 1, k + 8, k + 9
    const unsigned short* x = X + (long long)k * P;
    const unsigned short* y = Y + (long long)k * Q;
    mma_bf16(d, pair(x + p0, P), pair(x + p0 + 8, P), pair(x + 8 * P + p0, P),
             pair(x + 8 * P + p0 + 8, P), pair(y + q0, Q), pair(y + 8 * Q + q0, Q));
  }
  const int p = tile / qt * 16 + g, q = tile % qt * 8 + 2 * tig;
  out[p * sp + q * sq] = d[0];
  out[p * sp + (q + 1) * sq] = d[1];
  out[(p + 8) * sp + q * sq] = d[2];
  out[(p + 8) * sp + (q + 1) * sq] = d[3];
}

__device__ __forceinline__ unsigned pack(bool lo, bool hi) {
  return (lo ? ONE_LO : 0u) | (hi ? ONE_HI : 0u);
}

// out[h][l] = the tokens t of t[0:n] with t >> 7 == h (h < 8) and t & 127
// == l, as the product lo^T . hi: warp w holds lo rows [16 w, 16 w + 16),
// the 8 hi values are the N tile. One block of 8 warps; n % 16 == 0.
__global__ void __launch_bounds__(256)
onehot_kernel(const int* __restrict__ t, float* __restrict__ out, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16 + g, row1 = row0 + 8;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kb = 0; kb < n; kb += 16) {
    const int* p = t + kb + 2 * tig;
    const int k0 = p[0], k1 = p[1], k2 = p[8], k3 = p[9];
    const int l0 = k0 & 127, l1 = k1 & 127, l2 = k2 & 127, l3 = k3 & 127;
    mma_bf16(d, pack(l0 == row0, l1 == row0), pack(l0 == row1, l1 == row1),
             pack(l2 == row0, l3 == row0), pack(l2 == row1, l3 == row1),
             pack((k0 >> 7) == g, (k1 >> 7) == g), pack((k2 >> 7) == g, (k3 >> 7) == g));
  }
  // D at lo row g (+ 8), hi columns 2 tig, +1; out is (8, 128), hi-major
  out[(2 * tig) * 128 + row0] = d[0];
  out[(2 * tig + 1) * 128 + row0] = d[1];
  out[(2 * tig) * 128 + row1] = d[2];
  out[(2 * tig + 1) * 128 + row1] = d[3];
}

unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

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

// The geometry that zbpe_rows_to_column (kind 0: a = n; out = head, vecs,
// tail, grid) or zbpe_transpose (kind 1: a = rows, b = cols; out =
// tiles_c, grid, load_vec, store_vec) launches for these pointers, without
// a launch.
int zbpe_lowering_plan(int kind, const void* src, const void* dst, long long a, long long b,
                       long long* out) {
  ColumnGeometry c;
  TransposeGeometry t;
  if (kind == 0 && column_geometry(src, dst, a, &c)) {
    out[0] = c.head, out[1] = c.vecs, out[2] = c.tail, out[3] = c.grid;
  } else if (kind == 1 && transpose_geometry(src, dst, a, b, &t)) {
    out[0] = t.tiles_c, out[1] = t.grid, out[2] = t.load_vec, out[3] = t.store_vec;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// dst[r][c] = c % m + src[r][c] (int32).
int zbpe_iota_mod_add(const int* src, int* dst, int rows, int cols, int m, void* stream) {
  if (rows <= 0 || cols <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int n = rows * cols;
  iota_mod_kernel<<<blocks(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(src, dst, n,
                                                                                cols, m);
  return (int)cudaGetLastError();
}

// out[P][Q] (f32, at out[p * sp + q * sq]) = X^T . Y, X (K, P) and Y (K, Q)
// bf16; P % 16 == 0, Q % 8 == 0, K % 16 == 0.
int zbpe_dot_tn(const void* X, const void* Y, float* out, int K, int P, int Q, int sp, int sq,
                void* stream) {
  if (K <= 0 || P <= 0 || Q <= 0 || K % 16 || P % 16 || Q % 8) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(P / 16) * (Q / 8);
  dot_tn_kernel<<<blocks(tiles, 4), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(X), static_cast<const unsigned short*>(Y), out, K, P,
      Q, sp, sq);
  return (int)cudaGetLastError();
}

// out[8][128] (f32) = hi^T . lo of the n int32 tokens t (n % 16 == 0).
int zbpe_onehot_dot(const int* t, float* out, int n, void* stream) {
  if (n <= 0 || n % 16) return (int)cudaErrorInvalidValue;
  onehot_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(t, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
