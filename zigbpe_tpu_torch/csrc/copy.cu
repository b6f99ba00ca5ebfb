// Stream copies, hand-written for Hopper (sm_90a): the streaming floor
// under the merge pass.
//
// Replaces the Pallas TPU copy kernels of the measurement scripts:
//   copy_blocks  scripts/probe_floor.py copy_loop -> copy_kernel, and
//                scripts/probe_pipeline.py copy / one_copy: a blocked copy
//                of a (rows, 128) int32 or int16 array in (R, 128) blocks;
//   copy_carry   scripts/probe_pipeline.py copy_carry: the copy plus the
//                count of tokens >= 0, which the TPU carries in SMEM across
//                its sequential grid;
//   copy_peek    scripts/probe_pipeline.py copy_peek: copy_carry plus, for
//                every block i of R rows, its look-ahead token
//                x[min((i + 1) * R, rows - 8), 0] (the 8-row block index map
//                of probe_pipeline.py:103-107), all summed into one int32
//                that wraps. It models the merge kernel's read of the next
//                tile's head.
//
// What bounds them on an H100: bytes, one read and one write of the array
// (2^25 int32 tokens are 128 MiB each way, about 80 us at 3.35 TB/s; the
// 50 MB L2 cannot hold the array). What the design does about it: the
// array is one flat run of 16-byte vectors, copied by a one-shot grid in
// which each thread loads VPT vectors (neighbouring threads on neighbouring
// addresses) before it stores them, with the streaming cache hint
// (ld/st.global.cs, evict first): each byte is touched once. R shapes no
// tile: the TPU's blocks only define copy_peek's look-ahead terms, which
// the first rows / R threads of the grid load, one term a thread (at R = 8
// the last two terms read the same row, and two threads add it). The count
// is a warp reduction in each block and one atomic add per block into a
// word that the launch zeroes first; VPT vectors a thread keep the blocks,
// and so the adds into that word, to one per 32 KiB. The int32 sums wrap,
// as the TPU's carry does.
// The entries compute their geometry (copy_geometry); zbpe_copy_plan reports
// it without a launch, and ops/kernels/copy.py states it again (copy_plan)
// for the CPU tests.
//
// Each entry takes the element size (4 for int32, 2 for int16), runs on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int VPT = 8;  // 16-byte vectors a thread
constexpr long long GRID_X_MAX = 2147483647;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { COPY = 0, CARRY = 1, PEEK = 2 };

// Tokens >= 0 among the 16 bytes of v: 4 int32s or 8 int16s.
template <int ELEM>
__device__ __forceinline__ int count_nonneg(int4 v) {
  const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z, (unsigned)v.w};
  int c = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (ELEM == 4) c += 1 - (int)(w[k] >> 31);
    else c += 2 - (int)((w[k] >> 15) & 1u) - (int)(w[k] >> 31);
  }
  return c;
}

template <int ELEM>
__device__ __forceinline__ int load_elem(const void* x, long long i) {
  if (ELEM == 4) return static_cast<const int*>(x)[i];
  return static_cast<const short*>(x)[i];
}

// dst[0:n4] = src[0:n4] (16-byte vectors): block b copies vectors
// [b * THREADS * VPT, (b + 1) * THREADS * VPT), thread t those at t + u *
// THREADS. CARRY and PEEK add the block's count of tokens >= 0 to *acc;
// PEEK also adds look-ahead term g = b * THREADS + t for g < terms.
template <int MODE, int ELEM>
__global__ void __launch_bounds__(THREADS)
copy_kernel(const int4* __restrict__ src, int4* __restrict__ dst, long long n4, long long rows,
            int R, long long terms, unsigned* __restrict__ acc) {
  const long long base = (long long)blockIdx.x * (THREADS * VPT) + threadIdx.x;
  int4 v[VPT];
#pragma unroll
  for (int u = 0; u < VPT; ++u)
    if (base + u * THREADS < n4) v[u] = __ldcs(src + base + u * THREADS);
  int count = 0;
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
    if (base + u * THREADS < n4) {
      __stcs(dst + base + u * THREADS, v[u]);
      if (MODE != COPY) count += count_nonneg<ELEM>(v[u]);
    }
  }
  if (MODE == COPY) return;
  if (MODE == PEEK) {
    const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (g < terms) count += load_elem<ELEM>(src, min((g + 1) * R, rows - 8) * LANES);
  }

  __shared__ int s_warp[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(FULL, count, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += (unsigned)s_warp[w];
    atomicAdd(acc, total);
  }
}

struct CopyGeometry {
  long long n4;     // 16-byte vectors of the array
  int grid;         // blocks, each of THREADS * VPT vectors
  long long terms;  // copy_peek's look-ahead terms, rows / R (0 for the others)
};

// false for arguments the kernels do not take: rows not a positive
// multiple of R, elem not 4 or 2, for PEEK rows or R not a multiple of 8,
// or more blocks than grid.x holds.
bool copy_geometry(long long rows, int R, int elem, int mode, CopyGeometry* g) {
  if (rows <= 0 || R <= 0 || rows % R != 0 || (elem != 4 && elem != 2) ||
      (mode == PEEK && (rows % 8 != 0 || R % 8 != 0)))
    return false;
  g->n4 = rows * LANES * elem / 16;
  const long long grid = (g->n4 + THREADS * VPT - 1) / (THREADS * VPT);
  if (grid > GRID_X_MAX) return false;
  g->grid = (int)grid;
  g->terms = mode == PEEK ? rows / R : 0;
  return true;
}

template <int MODE>
int launch(const void* src, void* dst, long long rows, int R, int elem, int* acc,
           void* stream) {
  CopyGeometry g;
  if (!copy_geometry(rows, R, elem, MODE, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (MODE != COPY) {
    const cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  const int4* s = static_cast<const int4*>(src);
  int4* d = static_cast<int4*>(dst);
  unsigned* a = reinterpret_cast<unsigned*>(acc);
  if (elem == 4) copy_kernel<MODE, 4><<<g.grid, THREADS, 0, st>>>(s, d, g.n4, rows, R, g.terms, a);
  else copy_kernel<MODE, 2><<<g.grid, THREADS, 0, st>>>(s, d, g.n4, rows, R, g.terms, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dst[rows][128] = src[rows][128]. src and dst are 16-byte aligned device
// arrays of elem-byte integers (elem 4 or 2); rows is a multiple of R.
int zbpe_copy_blocks(const void* src, void* dst, long long rows, int R, int elem,
                     void* stream) {
  return launch<COPY>(src, dst, rows, R, elem, nullptr, stream);
}

// The copy, and *count = the number of src tokens >= 0 (int32, wrapping).
int zbpe_copy_carry(const void* src, void* dst, long long rows, int R, int elem,
                    int* count, void* stream) {
  return launch<CARRY>(src, dst, rows, R, elem, count, stream);
}

// The copy, and *sum = the count of tokens >= 0 plus, for each block i,
// src[min((i + 1) * R, rows - 8)][0] (int32, wrapping). rows and R are
// multiples of 8 (the look-ahead is an 8-row block).
int zbpe_copy_peek(const void* src, void* dst, long long rows, int R, int elem, int* sum,
                   void* stream) {
  return launch<PEEK>(src, dst, rows, R, elem, sum, stream);
}

// The geometry the entry of mode (0 copy_blocks, 1 copy_carry, 2 copy_peek)
// launches for these arguments, without a launch: out = n4, grid, terms.
int zbpe_copy_plan(long long rows, int R, int elem, int mode, long long* out) {
  CopyGeometry g;
  if (mode < COPY || mode > PEEK || !copy_geometry(rows, R, elem, mode, &g))
    return (int)cudaErrorInvalidValue;
  out[0] = g.n4, out[1] = g.grid, out[2] = g.terms;
  return 0;
}

}  // extern "C"
