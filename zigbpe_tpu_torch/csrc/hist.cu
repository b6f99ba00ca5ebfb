// A blocked copy with two masked histograms kept exact inside the pass,
// hand-written for Hopper (sm_90a): what exact pair counts kept inside a
// pass would cost.
//
// Replaces the Pallas TPU kernel scripts/probe_hist.py kern (pallas_call at
// :88, body :41-83). The (rows, 128) int32 tokens are copied. They go, in
// subchunks of S rows aligned from row 0, into a histogram of 2 Vh x 128
// bins, Vh = ceil(V / 128): a token t in [0, Vh * 128) that is not a hit
// (t % d != 0, or d = 0) counts in bin t, a hit in bin Vh * 128 + t; any
// other token counts nowhere. With `skip`, a subchunk without a hit adds
// nothing (the Pallas pl.when(nh > 0)). The TPU forms the counts as bf16
// one-hot products summed in f32; a count needs no products, so here each
// kept token is one integer add.
//
// What bounds it on an H100: bytes, one read and one write of the tokens
// (0.0801 ms for 2^25 at 3.35 TB/s; the histogram is at most 36,864 B).
// What the design does about it:
// - A persistent grid: as many 256-thread blocks as fit on the SMs at once
//   (the occupancy of the instantiation at its shared memory), each walking
//   steps of the stream in a grid-stride loop. A step is one S-row subchunk
//   with `skip`, else 32 rows (4 vectors a thread): without `skip` the
//   subchunks do not change what counts, so they shape nothing.
// - The copy: 16-byte vectors, neighbouring threads on neighbouring
//   addresses, all of a thread's vectors of a step loaded before any is
//   stored, with the streaming cache hint (ld/st.global.cs): each byte is
//   touched once.
// - The count: each thread recodes its vectors in registers as bins (-1 for
//   none); with `skip`, one block vote (__syncthreads_or) on the hits
//   decides the subchunk, and without it there is no barrier in the loop.
//   Each kept token is one atomicAdd on the block's private histogram in
//   shared memory (2 Vh x 128 int32, at most 36,864 B). The hit test is a
//   multiply and a compare (Lemire's divisibility test with c =
//   2^64 / d rounded up, computed by the C entry), not a division.
// - The flush: one global atomicAdd per nonzero bin and block into the
//   output, which the C entry zeroes on the caller's stream first.
// The entry computes its geometry (hist_geometry); zbpe_hist_plan reports
// it without a launch, and ops/kernels/hist.py states it again
// (hist_plan) for the CPU tests.
//
// The entry runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 128;
constexpr int ROW_VECS = LANES / 4;  // 16-byte vectors in a row of int32
constexpr int PER_SMALL = 4;   // vectors a thread a step: without skip, and with skip for S <= 32
constexpr int PER_WIDE = 12;   // with skip for 32 < S <= 96
constexpr int MAX_SUB_ROWS = 96;
constexpr int MAX_VH = 36;     // V <= 4608: 2 * 36 * 128 int32 bins, 36,864 B of shared memory

// t % d == 0 for every int32 t (|t| as unsigned), c = ~0 / d + 1 (d >= 1).
__device__ __forceinline__ bool divisible(int t, unsigned long long c) {
  const unsigned u = t < 0 ? 0u - (unsigned)t : (unsigned)t;
  return (unsigned long long)u * c <= c - 1;
}

// The copy of steps of span4 vectors and the histogram of their kept
// tokens; see the note above. bins: 2 * span int32 of dynamic shared memory.
template <int PER, bool SKIP>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const int4* __restrict__ src, int4* __restrict__ dst, long long n4, long long steps,
            int span4, int span, unsigned long long divc, int hits_on, int* __restrict__ hist) {
  extern __shared__ int bins[];
  for (int i = threadIdx.x; i < 2 * span; i += THREADS) bins[i] = 0;
  __syncthreads();
  for (long long step = blockIdx.x; step < steps; step += gridDim.x) {
    const long long base = step * span4 + threadIdx.x;
    const long long end = min(step * span4 + span4, n4);
    int4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      v[k] = base + k * THREADS < end ? __ldcs(src + base + k * THREADS)
                                      : make_int4(-1, -1, -1, -1);
    int hit = 0;
    int b[PER * 4];  // each token's bin, -1 for none
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const bool in = base + k * THREADS < end;
      if (in) __stcs(dst + base + k * THREADS, v[k]);
      const int t[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool h = in && hits_on && divisible(t[q], divc);
        hit |= h;
        b[4 * k + q] = (in && t[q] >= 0 && t[q] < span) ? t[q] + (h ? span : 0) : -1;
      }
    }
    if (SKIP && !__syncthreads_or(hit)) continue;
#pragma unroll
    for (int j = 0; j < PER * 4; ++j)
      if (b[j] >= 0) atomicAdd(bins + b[j], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * span; i += THREADS) {
    const int c = bins[i];
    if (c) atomicAdd(hist + i, c);
  }
}

struct HistGeometry {
  int vh;           // ceil(vocab / 128): rows of one half of the histogram
  int span4;        // vectors a step: an S-row subchunk with skip, else THREADS * PER_SMALL
  int per;          // vectors a thread holds in a step: the instantiation
  long long steps;  // steps of the grid-stride loop
  int smem;         // bytes of a block's histogram, 2 * vh * 128 int32
  int sms;          // SMs of the current device
  int blocks_per_sm;  // blocks of this instantiation resident on an SM at smem bytes
  int grid;         // min(steps, sms * blocks_per_sm)
};

using Kernel = void (*)(const int4*, int4*, long long, long long, int, int, unsigned long long,
                        int, int*);

Kernel kernel_of(int per, bool skip) {
  if (!skip) return hist_kernel<PER_SMALL, false>;
  return per == PER_SMALL ? hist_kernel<PER_SMALL, true> : hist_kernel<PER_WIDE, true>;
}

// The launch of zbpe_hist on the current device: cudaErrorInvalidValue
// for arguments it does not take. The SM count and each instantiation's
// occupancy at each Vh are asked once and kept.
cudaError_t hist_geometry(long long rows, int R, int S, int vocab, int skip, HistGeometry* g) {
  if (rows <= 0 || R <= 0 || S <= 0 || rows % R != 0 || R % S != 0 || S > MAX_SUB_ROWS ||
      vocab <= 0 || vocab > MAX_VH * LANES)
    return cudaErrorInvalidValue;
  g->vh = (vocab + LANES - 1) / LANES;
  g->span4 = skip ? S * ROW_VECS : THREADS * PER_SMALL;
  g->per = g->span4 <= THREADS * PER_SMALL ? PER_SMALL : PER_WIDE;
  g->steps = (rows * ROW_VECS + g->span4 - 1) / g->span4;
  g->smem = 2 * g->vh * LANES * (int)sizeof(int);
  static int sms = 0;
  static int occupancy[3][MAX_VH + 1];
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int& occ = occupancy[skip ? (g->per == PER_SMALL ? 1 : 2) : 0][g->vh];
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel_of(g->per, skip), THREADS, g->smem);
    if (e != cudaSuccess) return e;
    if (occ < 1) occ = 1;
  }
  g->sms = sms;
  g->blocks_per_sm = occ;
  const long long resident = (long long)sms * occ;
  g->grid = (int)(g->steps < resident ? g->steps : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dst[rows][128] = src[rows][128] (int32), and hist[2 Vh][128] = the two
// masked histograms of the tokens (see above) in subchunks of S rows, Vh =
// ceil(vocab / 128) <= 36, hits t % dmod == 0 (dmod 0: none), hit-free
// subchunks skipped when skip != 0. src and dst are 16-byte aligned; rows
// is a multiple of R and R of S, S <= 96. R tiles nothing: subchunks are
// aligned from row 0 whatever it is. hist is zeroed here.
int zbpe_hist(const void* src, void* dst, long long rows, int R, int S, int vocab, int dmod,
              int skip, int* hist, void* stream) {
  HistGeometry g;
  cudaError_t e = hist_geometry(rows, R, S, vocab, skip, &g);
  if (e != cudaSuccess) return (int)e;
  if (dmod < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(hist, 0, g.smem, st);  // the output has a block's histogram's size
  if (e != cudaSuccess) return (int)e;
  const unsigned long long divc = dmod ? ~0ull / (unsigned)dmod + 1 : 0;
  kernel_of(g.per, skip)<<<g.grid, THREADS, g.smem, st>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), rows * ROW_VECS, g.steps, g.span4,
      g.vh * LANES, divc, dmod != 0, hist);
  return (int)cudaGetLastError();
}

// The geometry zbpe_hist launches for these arguments on the current
// device, without a launch: out = vh, span4, per, steps, smem, sms,
// blocks_per_sm, grid, and the hit test's multiplier c (as its 64 bits).
int zbpe_hist_plan(long long rows, int R, int S, int vocab, int dmod, int skip,
                   long long* out) {
  HistGeometry g;
  const cudaError_t e = hist_geometry(rows, R, S, vocab, skip, &g);
  if (e != cudaSuccess) return (int)e;
  if (dmod < 0) return (int)cudaErrorInvalidValue;
  const unsigned long long divc = dmod ? ~0ull / (unsigned)dmod + 1 : 0;
  out[0] = g.vh, out[1] = g.span4, out[2] = g.per, out[3] = g.steps, out[4] = g.smem;
  out[5] = g.sms, out[6] = g.blocks_per_sm, out[7] = g.grid, out[8] = (long long)divc;
  return 0;
}

}  // extern "C"
