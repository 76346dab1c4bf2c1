// Fused 256-bit Hamming distance + top-2 reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orbslam2_tpu/ops/pallas_hamming.py
// (hamming_top2, body _kernel): for each row of A against the bank B,
// XOR -> popcount -> sum over the 8 words, invalid pairs read 256, and
// return the minimum, its first column, and the second minimum with the
// best COLUMN excluded -- bit-identical to
// best_and_second(masked_hamming_matrix(...)).
//
// What bounds it on an H100: at the tracking shape (A = B = 1024) the
// work is 8 M popcounts and 64 KB of input, a few microseconds of integer
// issue if spread over all SMs; neither bytes nor operations bound it.
// The design keeps it to one launch with no extra pass: no [A, B] matrix
// is written anywhere, the wrapper allocates only the three [A] outputs,
// and nothing synchronises.  What bounds this simple form is latency:
// each thread walks all B columns in series, and A = 1024 gives 16 blocks
// of 2 warps on 132 SMs (140 us of device time per launch at 1024x1024
// on an H100 80GB HBM3 at 700 W, against 1.4 ms for the plain PyTorch
// version).  Splitting the columns across the lanes of a warp is the
// next step.
//
// Design: one thread per A row, its 8 words in registers.  The bank is
// streamed through shared memory in chunks of CHUNK descriptors, so B has
// no cap (the TPU kernel kept the whole bank in VMEM, which capped B at
// ~4k).  Every thread of a block reads the same shared word at the same
// time (a broadcast, no bank conflicts).  Columns are visited in
// ascending order and only a strictly smaller distance replaces the best,
// so the first column wins a tie, as jnp.argmin does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // rows per block: 16 blocks at A = 1024
constexpr int kChunk = 512;    // bank descriptors staged per pass (16 KB)
constexpr int kMaxDist = 256;

__global__ void hamming_top2_kernel(const uint32_t* __restrict__ a,
                                    const uint8_t* __restrict__ av,
                                    const uint32_t* __restrict__ b,
                                    const uint8_t* __restrict__ bv,
                                    int A, int B,
                                    int32_t* __restrict__ best_out,
                                    int32_t* __restrict__ idx_out,
                                    int32_t* __restrict__ second_out) {
  __shared__ uint32_t sb[kChunk * 8];
  __shared__ uint8_t sv[kChunk];

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < A;
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = live ? a[row * 8 + k] : 0u;
  const bool row_ok = live && av[row] != 0;

  int best = kMaxDist + 1;   // above any distance: column 0 always lands
  int second = kMaxDist + 1;
  int best_idx = 0;

  for (int base = 0; base < B; base += kChunk) {
    const int n = min(kChunk, B - base);
    __syncthreads();   // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < n * 8; i += blockDim.x)
      sb[i] = b[base * 8 + i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) sv[i] = bv[base + i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      int d = kMaxDist;
      if (row_ok && sv[j]) {
        d = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) d += __popc(w[k] ^ sb[j * 8 + k]);
      }
      if (d < best) {
        second = best;
        best = d;
        best_idx = base + j;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (live) {
    // B = 1 leaves `second` at its initial value: clamp to MAX_DIST, the
    // value the excluded-column minimum reads in the reference
    best_out[row] = min(best, kMaxDist);
    idx_out[row] = best_idx;
    second_out[row] = min(second, kMaxDist);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int hamming_top2_launch(const void* a, const void* av,
                                   const void* b, const void* bv, int A,
                                   int B, void* best, void* idx, void* second,
                                   void* stream) {
  if (A > 0) {
    const int blocks = (A + kThreads - 1) / kThreads;
    hamming_top2_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint8_t*>(av),
        static_cast<const uint32_t*>(b), static_cast<const uint8_t*>(bv), A,
        B, static_cast<int32_t*>(best), static_cast<int32_t*>(idx),
        static_cast<int32_t*>(second));
  }
  return static_cast<int>(cudaGetLastError());
}
