// Blocked stream copies, hand-written for Hopper (sm_90a): the streaming
// floor under the merge pass.
//
// Replaces the Pallas TPU copy kernels of the measurement scripts:
//   copy_blocks  scripts/probe_floor.py copy_loop -> copy_kernel, and
//                scripts/probe_pipeline.py copy / one_copy: a blocked copy
//                of a (rows, 128) int32 or int16 array in (R, 128) blocks;
//   copy_carry   scripts/probe_pipeline.py copy_carry: the copy plus the
//                count of tokens >= 0, which the TPU carries in SMEM across
//                its sequential grid;
//   copy_peek    scripts/probe_pipeline.py copy_peek: copy_carry plus, for
//                every block i, its look-ahead token
//                x[min((i + 1) * R, rows - 8), 0] (the 8-row block index map
//                of probe_pipeline.py:103-107), all summed into one int32
//                that wraps. It models the merge kernel's read of the next
//                tile's head.
//
// What bounds them on an H100: bytes, one read and one write of the array
// (2^25 int32 tokens are 128 MiB each way, about 80 us at 3.35 TB/s; the
// 50 MB L2 cannot hold the array). What the design does about it: one CUDA
// block per (R, 128) tile, as the TPU grid has one step per block; every
// thread moves 16-byte vectors, neighbouring threads on neighbouring
// addresses, and starts UNROLL loads before their stores to keep bytes in
// flight. A block carries nothing to the next: the count is a warp
// reduction in each block and one atomic add per block into a word that the
// launch zeroes first. The int32 sums wrap, as the TPU's carry does.
//
// Each entry takes the element size (4 for int32, 2 for int16), runs on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;
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

template <int MODE, int ELEM>
__global__ void __launch_bounds__(THREADS)
copy_kernel(const int4* __restrict__ src, int4* __restrict__ dst, long long rows, int R,
            unsigned* __restrict__ acc) {
  constexpr int VEC_PER_ROW = LANES * ELEM / 16;
  const long long n4 = (long long)R * VEC_PER_ROW;
  const long long base = (long long)blockIdx.x * n4;
  int count = 0;
  for (long long k0 = threadIdx.x; k0 < n4; k0 += (long long)UNROLL * THREADS) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = k0 + (long long)u * THREADS;
      if (k < n4) v[u] = src[base + k];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = k0 + (long long)u * THREADS;
      if (k < n4) {
        dst[base + k] = v[u];
        if (MODE != COPY) count += count_nonneg<ELEM>(v[u]);
      }
    }
  }
  if (MODE == COPY) return;

  __shared__ int s_warp[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(FULL, count, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += (unsigned)s_warp[w];
    if (MODE == PEEK) {
      const long long row = min((long long)(blockIdx.x + 1) * R, rows - 8);
      total += (unsigned)load_elem<ELEM>(src, row * LANES);
    }
    atomicAdd(acc, total);
  }
}

template <int MODE>
int launch(const void* src, void* dst, long long rows, int R, int elem, int* acc,
           void* stream) {
  if (rows <= 0 || R <= 0 || rows % R != 0 || (elem != 4 && elem != 2) ||
      (MODE == PEEK && rows < 8) || rows / R > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (MODE != COPY) {
    const cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned G = (unsigned)(rows / R);
  const int4* s = static_cast<const int4*>(src);
  int4* d = static_cast<int4*>(dst);
  unsigned* a = reinterpret_cast<unsigned*>(acc);
  if (elem == 4) copy_kernel<MODE, 4><<<G, THREADS, 0, st>>>(s, d, rows, R, a);
  else copy_kernel<MODE, 2><<<G, THREADS, 0, st>>>(s, d, rows, R, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dst[rows][128] = src[rows][128], one block per R rows. src and dst are
// 16-byte aligned device arrays of elem-byte integers (elem 4 or 2); rows
// is a multiple of R.
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
// multiples of 8 (the look-ahead is an 8-row block); the wrapper checks.
int zbpe_copy_peek(const void* src, void* dst, long long rows, int R, int elem, int* sum,
                   void* stream) {
  return launch<PEEK>(src, dst, rows, R, elem, sum, stream);
}

}  // extern "C"
