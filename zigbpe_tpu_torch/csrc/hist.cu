// A blocked copy with two masked one-hot histograms on the tensor cores,
// hand-written for Hopper (sm_90a): what exact pair counts kept inside a
// pass would cost.
//
// Replaces the Pallas TPU kernel scripts/probe_hist.py kern (pallas_call at
// :88, body :41-83). Each block of R rows of 128 int32 tokens is copied.
// Its tokens, in subchunks of S rows, go into a histogram of 2 Vh x 128
// bins, Vh = ceil(V / 128): a token t in [0, Vh * 128) that is not a hit
// (t % d != 0, or d = 0) counts in bin t, a hit in bin Vh * 128 + t; any
// other token counts nowhere, as (t >> 7) == hi_iota never matches it. With
// `skip`, a subchunk without a hit adds nothing to either half (the Pallas
// pl.when(nh > 0)). The TPU forms hi^T . lo, bf16 one-hots summed in f32.
//
// What bounds it on an H100: bytes (one read and one write of the tokens,
// 0.0801 ms for 2^25 at 3.35 TB/s; a count needs no products). The one-hot
// design adds 2 * 128 * 2 Vh bf16 flops per token of every subchunk that
// runs: 0.0695, 0.1737 and 0.5906 ms at V = 512, 1280 and 4352 at
// 989 TFLOP/s, which is the design's cost and not the function's. What the
// design does about it: one 256-thread block per block of R rows. Each subchunk is copied
// with 16-byte vectors and its tokens, recoded as their bin (-1 for none),
// staged in shared memory; a block vote (__syncthreads_or) on its hits
// decides the skip. The product runs as mma.sync m16n8k16 bf16 with f32
// sums, laid out as lo^T . hi: the 128 lo values are M, one 16-row tile per
// warp, and the 2 Vh hi-and-half columns are N (8 at V = 512, no padding;
// 20 -> 24 at 1280, 68 -> 72 at 4352). The one-hot fragments are built in
// registers from the four tokens each lane needs (the A and B fragments of
// m16n8k16 take the same four k indices), never stored. The sums stay in
// registers over the whole block (at most R * 128 per bin, exact in f32)
// and leave as one int32 atomicAdd per nonzero bin and block into a
// histogram the wrapper zeroes, since blocks run in no order.
//
// The entry runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps: one per 16-row tile of the 128 lo values
constexpr int LANES = 128;
constexpr int MAX_NT = 9;     // N tiles of 8: 2 Vh <= 72, V <= 4608
constexpr unsigned ONE_LO = 0x3f80u, ONE_HI = 0x3f800000u;  // bf16 1.0 in a half

__device__ __forceinline__ unsigned pack(bool lo, bool hi) {
  return (lo ? ONE_LO : 0u) | (hi ? ONE_HI : 0u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const int4* __restrict__ src, int4* __restrict__ dst, int R, int S, int Vh,
            int dmod, int skip, int* __restrict__ hist) {
  extern __shared__ int4 smem4[];
  int* bins = reinterpret_cast<int*>(smem4);  // S * 128: each token's bin, -1 for none
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16 + g, row1 = row0 + 8;  // the lane's lo values
  const int span = Vh * LANES;
  const int sub4 = S * LANES / 4;  // int4 per subchunk
  const long long base4 = (long long)blockIdx.x * R * (LANES / 4);
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int s = 0; s < R / S; ++s) {
    const long long at = base4 + (long long)s * sub4;
    int hit = 0;
    for (int k = threadIdx.x; k < sub4; k += THREADS) {
      const int4 v = src[at + k];
      dst[at + k] = v;
      int t[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool h = dmod != 0 && t[q] % dmod == 0;
        hit |= h;
        t[q] = (t[q] >= 0 && t[q] < span) ? t[q] + (h ? span : 0) : -1;
      }
      smem4[k] = make_int4(t[0], t[1], t[2], t[3]);
    }
    const int any = __syncthreads_or(hit);  // also publishes the bins
    if (!skip || any) {
      for (int kb = 0; kb < S * LANES; kb += 16) {
        // the k indices of this lane in both fragments: 2 tig, +1, +8, +9
        const int* p = bins + kb + 2 * tig;
        const int k0 = p[0], k1 = p[1], k2 = p[8], k3 = p[9];
        // lo = t & 127, -1 for no bin; column = half * Vh + (t >> 7)
        const int l0 = (k0 & 127) | (k0 >> 31), l1 = (k1 & 127) | (k1 >> 31);
        const int l2 = (k2 & 127) | (k2 >> 31), l3 = (k3 & 127) | (k3 >> 31);
        const int n0 = k0 >> 7, n1 = k1 >> 7, n2 = k2 >> 7, n3 = k3 >> 7;
        const unsigned a0 = pack(l0 == row0, l1 == row0), a1 = pack(l0 == row1, l1 == row1);
        const unsigned a2 = pack(l2 == row0, l3 == row0), a3 = pack(l2 == row1, l3 == row1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = nt * 8 + g;
          mma_bf16(acc[nt], a0, a1, a2, a3, pack(n0 == n, n1 == n), pack(n2 == n, n3 == n));
        }
      }
    }
    __syncthreads();  // the next subchunk overwrites the bins
  }
  // D of m16n8k16: d0, d1 at row g, columns 2 tig, +1; d2, d3 at row g + 8
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nt * 8 + 2 * tig + (e & 1);
      const int c = (int)acc[nt][e];
      if (n < 2 * Vh && c != 0) atomicAdd(&hist[n * LANES + (e < 2 ? row0 : row1)], c);
    }
}

template <int NT>
int launch(const void* src, void* dst, long long rows, int R, int S, int Vh, int dmod,
           int skip, int* hist, cudaStream_t st) {
  hist_kernel<NT><<<(unsigned)(rows / R), THREADS, S * LANES * sizeof(int), st>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), R, S, Vh, dmod, skip, hist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dst[rows][128] = src[rows][128] (int32), and hist[2 Vh][128] += the two
// masked histograms of the tokens (see above) in blocks of R rows and
// subchunks of S rows, Vh = ceil(vocab / 128) <= 36, hits t % dmod == 0
// (dmod 0: none), hit-free subchunks skipped when skip != 0. src and dst
// are 16-byte aligned; rows is a multiple of R, R of S, S * 128 ints fit
// in 48 KB of shared memory; hist is zeroed by the caller.
int zbpe_hist(const void* src, void* dst, long long rows, int R, int S, int vocab, int dmod,
              int skip, int* hist, void* stream) {
  const int Vh = (vocab + LANES - 1) / LANES;
  if (rows <= 0 || R <= 0 || S <= 0 || rows % R != 0 || R % S != 0 || S > 96 ||
      rows / R > 0x7fffffffLL || vocab <= 0 || dmod < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((Vh + 3) / 4) {  // N tiles of 8 over 2 Vh columns
    case 1: return launch<1>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case 2: return launch<2>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case 3: return launch<3>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case 4: return launch<4>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case 5: return launch<5>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case 6: return launch<6>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case 7: return launch<7>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case 8: return launch<8>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    case MAX_NT: return launch<MAX_NT>(src, dst, rows, R, S, Vh, dmod, skip, hist, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
