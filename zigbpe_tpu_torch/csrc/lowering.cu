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
// What bounds them on an H100: launch latency (a few microseconds); each
// moves at most a few hundred KB and does at most 2 * 128 * 128 * 4096
// flops. What the design does about it: the plainest kernel per construct.
// The products give each warp one 16 x 8 tile of the output and walk K in
// steps of 16 with mma.sync.m16n8k16, loading each fragment's bf16 values
// straight from device memory (the inputs are a^T-major, so no shared
// memory transpose is needed). An output with fewer than 16 rows is computed
// as its transpose, b^T . a, and written back transposed, as the histogram
// kernel lays out its one-hots.
//
// Each entry runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr unsigned ONE_LO = 0x3f80u, ONE_HI = 0x3f800000u;  // bf16 1.0 in a half

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void column_kernel(const int* __restrict__ src, int* __restrict__ dst, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

// dst[c][r] = src[r][c], through a padded 32 x 32 tile in shared memory.
__global__ void transpose_kernel(const int* __restrict__ src, int* __restrict__ dst, int rows,
                                 int cols) {
  __shared__ int tile[TILE][TILE + 1];
  const int c = blockIdx.x * TILE + threadIdx.x;
  for (int y = threadIdx.y; y < TILE; y += blockDim.y) {
    const int r = blockIdx.y * TILE + y;
    if (r < rows && c < cols) tile[y][threadIdx.x] = src[r * cols + c];
  }
  __syncthreads();
  const int r = blockIdx.y * TILE + threadIdx.x;
  for (int y = threadIdx.y; y < TILE; y += blockDim.y) {
    const int cc = blockIdx.x * TILE + y;
    if (cc < cols && r < rows) dst[cc * rows + r] = tile[threadIdx.x][y];
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

}  // namespace

extern "C" {

// dst[n][1] = src, read flat: the (rows, cols) -> (rows * cols, 1) reshape.
int zbpe_rows_to_column(const int* src, int* dst, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  column_kernel<<<blocks(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(src, dst, n);
  return (int)cudaGetLastError();
}

// dst[cols][rows] = src[rows][cols]^T (int32).
int zbpe_transpose(const int* src, int* dst, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks(cols, TILE), blocks(rows, TILE)), block(TILE, 8);
  transpose_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(src, dst, rows,
                                                                          cols);
  return (int)cudaGetLastError();
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
