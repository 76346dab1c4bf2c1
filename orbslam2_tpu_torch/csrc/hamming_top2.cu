// Fused 256-bit Hamming distance + top-2 reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orbslam2_tpu/ops/pallas_hamming.py
// (hamming_top2, body _kernel): for each row of A against the bank B,
// XOR -> popcount -> sum over the 8 words, invalid pairs read 256, and
// return the minimum, its first column, and the second minimum with the
// best COLUMN excluded -- bit-identical to
// best_and_second(masked_hamming_matrix(...)).
//
// What bounds it on an H100: operations.  A pair of valid descriptors
// costs 8 __popc, and the popcount pipe issues 16 per clock per SM
// (compute capability 9.0; 4 per clock on each of the SM's 4 schedulers,
// so one warp-wide __popc holds a scheduler's pipe for 8 clocks).
// 1024 x 1024 is 8.4 M __popc = 3972 clocks on 132 SMs, ~2.0 us at
// 1.98 GHz.  Its bytes (64 KB of descriptors) take ~0.02 us at 3.35 TB/s.
// Shared-memory reads come second: 32 bytes a pair, 8 clocks per
// warp-column at 128 B/clock against 16 for the popcounts.
//
// Design (G = 2 warps per A row; the lanes split the columns):
//   * A block is W = 16 warps and W / G = 8 A rows.  Each warp holds its
//     row's 8 words in every lane's registers (a broadcast load).  Within
//     a chunk of the bank, warp g of a row takes columns 32 g + l,
//     32 (g + G) + l, ... for lane l, so every lane visits its columns in
//     ascending order, and only a strictly smaller distance replaces its
//     best: a lane holds the first minimum of its columns and the second
//     minimum of the rest.  A __shfl_xor_sync butterfly merges the 32
//     lanes; the G warps of a row then merge through shared memory, in
//     warp order.
//   * Merge rule (exact): the winner has the smaller best, on a tie the
//     smaller index; second = min(winner.second, loser.best).  The loser's
//     best column differs from the winner's, so this is the minimum over
//     every column but the winner's.  A lane or warp that saw no column
//     holds best = second = 257 and loses to any real column; the final
//     clamp to 256 makes B = 1 and an all-invalid bank come out right.
//   * The bank is staged through shared memory in chunks of kChunk columns
//     (B has no cap), double-buffered: cp.async copies chunk c + 1 in
//     16-byte pieces while the warps work on chunk c.  The copy keeps B's
//     layout (thread i moves the i-th 16 bytes to the i-th 16 bytes): a
//     copy that scattered each column's two halves into two planes was
//     several times slower on the H100.  A lane reads its column as two
//     16-byte loads, the half (l >> 2) & 1 first, so the 8 lanes of each
//     shared-memory phase hit 32 distinct banks.  The validity bytes go
//     through registers and are stored before the chunk's barrier; the
//     row's own words are loaded while the first chunk is in flight.
//   * Occupancy: shared memory is 2 x (16 KB + 512 B) = 33 KB a block plus
//     12 B a warp, so an SM holds 6 blocks by shared memory and
//     2048 / (32 W) = 4 by threads.  At A = 1024 the grid is 128 blocks,
//     one wave on 132 SMs with 16 warps (4 per scheduler) on each: enough
//     independent popcounts in flight, where one warp per row (8 warps an
//     SM) left the pipe half idle.  W and G were picked by measurement:
//     orbslam2_tpu_torch/kernels/bench_hamming_top2.py builds the other
//     geometries with -DHT2_WARPS_PER_BLOCK / -DHT2_WARPS_PER_ROW.
//   * Every caller gives 1024 rows (a frame or keyframe) against one
//     keyframe's 1024 columns, so the rows alone fill the card and the
//     bank is not split across blocks.
//   * A row whose own flag is off writes (256, 0, 256) and reads nothing
//     of the bank: its warps skip the column loop.
//
// Where it stands (H100 80GB HBM3, 700 W; bench_hamming_top2.py): 5.3-5.6
// us per 1024 x 1024 launch against 140 us for one thread per row.  Of
// that, ~2 us is the floor of any launch (a 1 x 1 call), and the column
// loop runs at ~60% of the popcount peak (each further 1024 columns at
// A = 1024 adds ~3.6 us against 2.0 us of popcounts); the popcounts of
// pairs whose bank column is invalid are computed and then dropped.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#ifndef HT2_WARPS_PER_BLOCK
#define HT2_WARPS_PER_BLOCK 16
#endif
#ifndef HT2_WARPS_PER_ROW
#define HT2_WARPS_PER_ROW 2
#endif

namespace {

constexpr int kChunk = 512;            // bank columns a stage
constexpr int kMaxDist = 256;
constexpr int kEmpty = kMaxDist + 1;   // above any distance
constexpr int W = HT2_WARPS_PER_BLOCK;  // warps a block
constexpr int G = HT2_WARPS_PER_ROW;    // warps an A row
constexpr int kThreads = W * 32;
constexpr int kRows = W / G;            // A rows a block
constexpr int kMasks = (kChunk + kThreads - 1) / kThreads;
static_assert(W % G == 0 && kThreads <= 1024, "bad launch geometry");

struct Top2 {
  int best, idx, second;
};

__device__ __forceinline__ Top2 merge(const Top2& x, const Top2& y) {
  const bool x_wins = x.best < y.best || (x.best == y.best && x.idx < y.idx);
  const Top2& w = x_wins ? x : y;
  const Top2& l = x_wins ? y : x;
  return {w.best, w.idx, min(w.second, l.best)};
}

__device__ __forceinline__ int distance(const uint4& a0, const uint4& a1,
                                        const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

struct Stage {
  uint4 desc[2][2 * kChunk];   // two buffers of kChunk columns, as in B
  uint8_t valid[2][kChunk];
};

// Start copying chunk `c` (columns base .. base + n) into buffer c & 1 and
// read its validity bytes into `m` (stored once the chunk is waited on).
__device__ __forceinline__ void stage_chunk(Stage& s, const uint4* b,
                                            const uint8_t* bv, int base,
                                            int n, int buf, uint8_t* m) {
  for (int i = threadIdx.x; i < 2 * n; i += kThreads)
    __pipeline_memcpy_async(&s.desc[buf][i], &b[2 * base + i], 16);
  __pipeline_commit();
#pragma unroll
  for (int k = 0; k < kMasks; ++k) {
    const int i = threadIdx.x + k * kThreads;
    m[k] = i < n ? bv[base + i] : 0;
  }
}

// out: [3, A] (best, idx, second), clamped to 256.
__global__ void __launch_bounds__(kThreads)
    hamming_top2_kernel(const uint4* __restrict__ a,
                        const uint8_t* __restrict__ av,
                        const uint4* __restrict__ b,
                        const uint8_t* __restrict__ bv, int A, int B,
                        int32_t* __restrict__ out) {
  __shared__ Stage s;
  __shared__ Top2 s_warp[W];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp % G;
  const int row = blockIdx.x * kRows + warp / G;
  const int n_chunks = (B + kChunk - 1) / kChunk;

  uint8_t m[kMasks];
  stage_chunk(s, b, bv, 0, min(kChunk, B), 0, m);
  // The row's words, loaded while the first chunk is in flight.  Lane l
  // reads half h = (l >> 2) & 1 of a staged column first: the 8 lanes of a
  // 16-byte shared-memory phase then hit 32 distinct banks.  Its own words
  // are swapped to match.
  uint8_t row_ok = 0;
  uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
  if (row < A) {
    row_ok = av[row];
    lo = a[2 * row];
    hi = a[2 * row + 1];
  }
  const bool live = row_ok != 0;   // warp-uniform
  const int h = (lane >> 2) & 1;
  const uint4 first = h ? hi : lo;
  const uint4 second = h ? lo : hi;
  Top2 t = {kEmpty, INT_MAX, kEmpty};
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * kChunk;
    const int n = min(kChunk, B - base);
    const int buf = c & 1;
#pragma unroll
    for (int k = 0; k < kMasks; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kChunk) s.valid[buf][i] = m[k];
    }
    if (c + 1 < n_chunks) {
      // buffer buf ^ 1 was last read before the previous chunk's barrier
      stage_chunk(s, b, bv, base + kChunk, min(kChunk, B - base - kChunk),
                  buf ^ 1, m);
      __pipeline_wait_prior(1);   // this thread's copies of chunk c landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();              // everyone's copies of chunk c landed
    if (live) {
#pragma unroll 4
      for (int j = 32 * group + lane; j < n; j += 32 * G) {
        const bool ok = s.valid[buf][j] != 0;
        const int d = ok ? distance(first, second, s.desc[buf][2 * j + h],
                                    s.desc[buf][2 * j + 1 - h])
                         : kMaxDist;
        if (d < t.best) {
          t.second = t.best;
          t.best = d;
          t.idx = base + j;
        } else if (d < t.second) {
          t.second = d;
        }
      }
    }
    __syncthreads();              // buffer buf is free for chunk c + 2
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Top2 o = {__shfl_xor_sync(0xffffffffu, t.best, off),
                    __shfl_xor_sync(0xffffffffu, t.idx, off),
                    __shfl_xor_sync(0xffffffffu, t.second, off)};
    t = merge(t, o);
  }
  if (!live) t = {kMaxDist, 0, kMaxDist};
  int out_row = row;
  if constexpr (G > 1) {
    if (lane == 0) s_warp[warp] = t;
    __syncthreads();
    if (threadIdx.x >= kRows) return;
    out_row = blockIdx.x * kRows + threadIdx.x;
    t = s_warp[threadIdx.x * G];
#pragma unroll
    for (int g = 1; g < G; ++g) t = merge(t, s_warp[threadIdx.x * G + g]);
  } else if (lane != 0) {
    return;
  }
  if (out_row >= A) return;
  out[out_row] = min(t.best, kMaxDist);
  out[A + out_row] = t.idx;
  out[2 * A + out_row] = min(t.second, kMaxDist);
}

}  // namespace

// Plain C entry point (bound with ctypes).  a, b: 16-byte aligned [*, 8]
// uint32 words; av, bv: one byte per row; out: [3, A] int32 (best, idx,
// second).  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int hamming_top2_launch(const void* a, const void* av,
                                   const void* b, const void* bv, int A,
                                   int B, void* out, void* stream) {
  if (A <= 0) return static_cast<int>(cudaGetLastError());
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  hamming_top2_kernel<<<(A + kRows - 1) / kRows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint8_t*>(av),
      static_cast<const uint4*>(b), static_cast<const uint8_t*>(bv), A, B,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
