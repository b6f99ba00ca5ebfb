// The merge kernel's op mix in int32 and in packed int16, hand-written for
// Hopper (sm_90a): does int16 pay on the card's integer ALUs?
//
// Replaces the Pallas TPU kernel scripts/probe_alu16.py opmix_kernel
// (pallas_call at :66, body :41-58). On each block of R rows of 128
// tokens, flattened, `reps` times:
//   nxt = the block shifted left by one slot, -1 at the block's last slot
//         (shift_left1: the fill is per block, never the next block's head);
//   acc = (acc == 101 && nxt == 32) ? 300 : acc;
//   acc = nxt < 0 ? acc : max(acc, nxt).
//
// What bounds it on an H100: bytes at reps = 0 (one read and one write:
// 2^25 int32 tokens are 268.4 MB, 80 us at 3.35 TB/s; int16 half that), the
// integer ALUs at reps = 16 (about 8 operations per token and rep). What the
// design does about it: one warp per window of 32 lanes x 32 bytes, each
// lane holding 8 int32 tokens or 16 int16 tokens packed two to a 32-bit
// register, loaded as two 16-byte vectors. A rep's shift is a register move
// inside the lane and one __shfl_down_sync across lanes; the lane at the
// window's end reads -1. Windows overlap by ceil(reps / tokens per lane)
// lanes: after `reps` reps a wrong value has spread at most `reps` slots
// back from the window's end, so those halo lanes compute but do not store
// (6.25% of int32 lanes and 3.1% of int16 lanes at reps = 16). Lanes past
// the block's end read -1, which is the Pallas fill and stays -1. No shared
// memory, no barrier.
//
// The int16 instantiation computes two tokens per instruction: the one-slot
// shift across a pair is __byte_perm; the two equality compares are one
// zero test of (acc ^ 101) | (nxt ^ 32) per half (a carry trick and a
// sign-replicating prmt: sm_90 has no 16x2 integer compare, and with two
// __vcmpeq2 the int16 op mix ran slower than the int32 one on an H100);
// nxt < 0 is a sign-replicating prmt; the maximum is __vmaxs2, one
// VIMNMX.S16x2; the selects are bit masks. 101, 32, 300 and -1 all fit in
// int16.
//
// The entry takes the element size (4 for int32, 2 for int16) and reps
// (0, 4 or 16), runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WORDS = 8;  // 32-bit registers of tokens per lane (32 bytes)

// One rep on 8 int32 tokens; nb is the next lane's first token.
__device__ __forceinline__ void rep32(int (&w)[WORDS], int nb) {
  int nxt[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS - 1; ++j) nxt[j] = w[j + 1];
  nxt[WORDS - 1] = nb;
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    int a = w[j];
    const int n = nxt[j];
    a = (a == 101 && n == 32) ? 300 : a;
    w[j] = n < 0 ? a : max(a, n);
  }
}

// 0xffff in each 16-bit half of x whose sign bit is set: prmt in its
// sign-replicating mode (__byte_perm ignores the mode bit of a selector).
__device__ __forceinline__ unsigned sign_mask16(unsigned x) {
  unsigned r;
  asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(r) : "r"(x));
  return r;
}

// 0xffff in each 16-bit half of x that is zero: adding 0x7fff to the low
// 15 bits carries into bit 15 exactly when they are not all zero, and never
// into the other half.
__device__ __forceinline__ unsigned zero_mask16(unsigned x) {
  return ~sign_mask16(((x & 0x7fff7fffu) + 0x7fff7fffu) | x);
}

// One rep on 16 int16 tokens, two to a word (token 2j in the low half of
// word j); nb is the next lane's first word.
__device__ __forceinline__ void rep16(unsigned (&w)[WORDS], unsigned nb) {
  constexpr unsigned K101 = 0x00650065u, K32 = 0x00200020u, K300 = 0x012c012cu;
  unsigned nxt[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS - 1; ++j) nxt[j] = __byte_perm(w[j], w[j + 1], 0x5432);
  nxt[WORDS - 1] = __byte_perm(w[WORDS - 1], nb, 0x5432);
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    unsigned a = w[j];
    const unsigned n = nxt[j];
    // both compares at once: a == 101 and n == 32 where (a^101) | (n^32) is 0
    const unsigned cand = zero_mask16((a ^ K101) | (n ^ K32));
    a = (a & ~cand) | (K300 & cand);
    const unsigned neg = sign_mask16(n);
    const unsigned mx = __vmaxs2(a, n);
    w[j] = (a & neg) | (mx & ~neg);
  }
}

template <int ELEM, int REPS>
__global__ void __launch_bounds__(THREADS)
opmix_kernel(const int4* __restrict__ src, int4* __restrict__ dst, long long block_elems,
             long long tiles_per_block, long long n_tiles) {
  constexpr int E = 32 / ELEM;                  // tokens per lane
  constexpr int HALO = (REPS + E - 1) / E;      // lanes that compute but do not store
  constexpr long long STEP = (32 - HALO) * E;   // tokens a window stores
  const int lane = threadIdx.x & 31;
  const long long wt = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (wt >= n_tiles) return;  // whole warps only
  const long long pb = wt / tiles_per_block;
  const long long block_end = (pb + 1) * block_elems;
  const long long p0 = pb * block_elems + (wt % tiles_per_block) * STEP + (long long)lane * E;
  const bool inside = p0 < block_end;  // block_elems is a multiple of E
  const long long v = p0 / E * 2;      // index of the lane's first int4
  int4 v0 = make_int4(-1, -1, -1, -1), v1 = v0;
  if (inside) {
    v0 = src[v];
    v1 = src[v + 1];
  }
  if (REPS > 0) {
    if (ELEM == 4) {
      int w[WORDS] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int r = 0; r < REPS; ++r) {
        int nb = __shfl_down_sync(FULL, w[0], 1);
        if (lane == 31) nb = -1;
        rep32(w, nb);
      }
      v0 = make_int4(w[0], w[1], w[2], w[3]);
      v1 = make_int4(w[4], w[5], w[6], w[7]);
    } else {
      unsigned w[WORDS] = {(unsigned)v0.x, (unsigned)v0.y, (unsigned)v0.z, (unsigned)v0.w,
                           (unsigned)v1.x, (unsigned)v1.y, (unsigned)v1.z, (unsigned)v1.w};
#pragma unroll
      for (int r = 0; r < REPS; ++r) {
        unsigned nb = __shfl_down_sync(FULL, w[0], 1);
        if (lane == 31) nb = FULL;
        rep16(w, nb);
      }
      v0 = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
      v1 = make_int4((int)w[4], (int)w[5], (int)w[6], (int)w[7]);
    }
  }
  if (inside && lane < 32 - HALO) {
    dst[v] = v0;
    dst[v + 1] = v1;
  }
}

template <int ELEM, int REPS>
int launch(const void* src, void* dst, long long rows, int R, cudaStream_t st) {
  constexpr int E = 32 / ELEM;
  constexpr long long STEP = (32 - (REPS + E - 1) / E) * E;
  const long long block_elems = (long long)R * 128;
  const long long tiles_per_block = (block_elems + STEP - 1) / STEP;
  const long long n_tiles = rows / R * tiles_per_block;
  const long long grid = (n_tiles + WARPS - 1) / WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  opmix_kernel<ELEM, REPS><<<(unsigned)grid, THREADS, 0, st>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), block_elems, tiles_per_block,
      n_tiles);
  return (int)cudaGetLastError();
}

template <int ELEM>
int dispatch(const void* src, void* dst, long long rows, int R, int reps, cudaStream_t st) {
  switch (reps) {
    case 0: return launch<ELEM, 0>(src, dst, rows, R, st);
    case 4: return launch<ELEM, 4>(src, dst, rows, R, st);
    case 16: return launch<ELEM, 16>(src, dst, rows, R, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dst[rows][128] = the op mix of src[rows][128] (elem-byte integers, elem 4
// or 2) over `reps` reps, in blocks of R rows. src and dst are 16-byte
// aligned device arrays; rows is a positive multiple of R.
int zbpe_opmix(const void* src, void* dst, long long rows, int R, int elem, int reps,
               void* stream) {
  if (rows <= 0 || R <= 0 || rows % R != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == 4) return dispatch<4>(src, dst, rows, R, reps, st);
  if (elem == 2) return dispatch<2>(src, dst, rows, R, reps, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
