// K2: the corrector's per-row best-baseline verdicts, one thread per row.
//
// Replaces slam_process_tpu/ops/pallas_correct.py::correct_planes_pallas
// (_kernel, which runs ops/correct.py::baseline_plane_verdicts on a one-hot
// MXU selection of the table).  Inputs are the same: gid and clk int32 [F],
// and the residue-form baseline table packed f32 [G, W] with the column
// layout [0:B) r_hi8, [B:2B) r_lo8, [2B:3B) e, col 3B n (W >= 3B + 1), where
// r_b = clk_b mod cycle and e_b = (bs_b - clk_b // cycle) mod 64.  Per row:
// q_f = floor(clk / cycle), r_f = clk - q_f * cycle; over the first
// min(n, B) baselines of the row's group, diff = r_f - r_b, k_frac from two
// compares, resid = |diff - k_frac * cycle|, accept at resid <= tol, and the
// minimum of the packed score
//     ((resid * (B + 1) + col) << 10) | ((k_frac + 1) << 8) | e
// with sentinel 1 << 30.  Outputs has = best < 2^30,
// k_best = q_f + ((best >> 8) & 3) - 1, bs_best = best & 0xFF: the same bits
// as the TPU kernel, ties included (the column index makes the score
// unique).  A gid outside [0, G) selects no baseline, as a one-hot row of
// zeros does on the TPU.
//
// Bound on an H100: integer operations.  About F x n x 8 int32 operations
// (~124 M for a 160 k-row session with 93 baselines per group, ~3.8 us at
// the card's issue rate of 128 lanes per SM per clock, ~33 T op/s); memory
// is F x 17 bytes plus the table (~1 us).  Design: the loop runs only over the group's n live columns,
// not the padded B; rows of one group are contiguous in stream order, so a
// warp mostly reads the same table row (broadcast loads from L1/L2; the
// table is at most 256 x 769 f32, < 0.8 MB).  No one-hot matmul: the TPU
// used the MXU because its gathers serialize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kSentinel = 1 << 30;

__global__ void correct_verdicts_kernel(const int* __restrict__ gid,
                                        const int* __restrict__ clk, long long f,
                                        const float* __restrict__ packed, int g_rows,
                                        int width, int bmax, int cycle, int tol,
                                        uint8_t* __restrict__ has,
                                        int* __restrict__ k_best,
                                        int* __restrict__ bs_best) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= f) return;
  const int c = clk[i];
  int q = c / cycle;
  int r_f = c - q * cycle;
  if (r_f < 0) {  // floor division for negative clk
    r_f += cycle;
    q -= 1;
  }
  const int g = gid[i];
  int best = kSentinel;
  if (g >= 0 && g < g_rows) {
    const float* row = packed + static_cast<long long>(g) * width;
    const int n = min(static_cast<int>(row[3 * bmax]), bmax);
    const int half = cycle / 2;
    const int up = cycle - half;
    for (int col = 0; col < n; ++col) {
      const int r_b = (static_cast<int>(row[col]) << 8) | static_cast<int>(row[bmax + col]);
      const int e = static_cast<int>(row[2 * bmax + col]);
      const int diff = r_f - r_b;
      const int k_frac = static_cast<int>(diff >= up) - static_cast<int>(diff < -half);
      const int resid = abs(diff - k_frac * cycle);
      if (resid <= tol) {
        const int score = ((resid * (bmax + 1) + col) << 10) | ((k_frac + 1) << 8) | e;
        best = min(best, score);
      }
    }
  }
  has[i] = best < kSentinel;
  k_best[i] = q + ((best >> 8) & 3) - 1;
  bs_best[i] = best & 0xFF;
}

}  // namespace

// has [F] uint8, k_best / bs_best [F] int32.  Returns cudaGetLastError().
extern "C" int slam_correct_verdicts(const void* gid, const void* clk, long long f,
                                     const void* packed, int g_rows, int width, int bmax,
                                     int cycle, int tol, void* has, void* k_best,
                                     void* bs_best, void* stream) {
  const long long blocks = (f + kBlock - 1) / kBlock;
  correct_verdicts_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(clk), f,
      static_cast<const float*>(packed), g_rows, width, bmax, cycle, tol,
      static_cast<uint8_t*>(has), static_cast<int*>(k_best), static_cast<int*>(bs_best));
  return static_cast<int>(cudaGetLastError());
}
