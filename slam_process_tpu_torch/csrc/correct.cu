// K2: the corrector's per-row best-baseline verdicts.
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
// Bound on an H100: the function needs only the baselines whose residue
// lies within tol of the row's (the minimum is taken over them alone), a
// search for them in the group's sorted residues, and 17 B per row plus the
// table; chip_smoke.py counts them on each run's inputs (k2_work) and
// prints the bound.  At the full session's shape (~167 k rows, 58 groups of
// 93 baselines) the plain scan's 15 M (row, baseline) pairs are several
// times that work.  Design, one block of 256 rows:
//   1. Staging.  Rows of one group are contiguous in stream order, so a
//      block touches one or a few groups: those of its first and last rows,
//      up to four.  It stages them once as int32 in shared memory, each
//      column one 64-bit word (r_b, e), converted from the f32 limbs once
//      per (block, group, column), not per (row, column), in the same pass
//      that reads the counts.
//   2. Windowed search.  With 0 <= tol and 2 tol + 1 < cycle, a baseline is
//      accepted only if r_b lies within tol of r_f on the circle of length
//      cycle (for r_b, r_f in [0, cycle) the formula's resid is the circular
//      distance whenever either is <= tol).  So each staged group is
//      counting-sorted by residue into 512 buckets of the circle, each
//      column one 128-bit word (r_b, col, e), and a row scores only the
//      buckets its one or two arcs [r_f - tol, r_f + tol] (mod cycle) touch,
//      with the same packed score: the minimum and its column tie-break do
//      not change.  A group's residues cluster (CLK advances about one cycle
//      a frame), so a row still meets a sizeable share of its group's
//      baselines in the buckets its arcs touch.
//   Everything else reads the global table and scans every column, as the
//   first version of this kernel did: a block whose first and last groups
//   are out of order or out of range, a row whose group is past the four
//   staged, a group with more than 256 live baselines or a residue outside
//   [0, cycle), and a table where 2 tol + 1 >= cycle.  The corrector's own
//   table (ops/correct.py: gid nondecreasing and in range, residues
//   clk mod cycle) reaches the table only through a block of more than
//   four groups or a group of more than 256 baselines.
// So the main path does no per-(row, column) float -> int conversion.  No
// one-hot matmul: the TPU used the MXU because its gathers serialize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;       // rows per block, one per thread
constexpr int kGroups = 4;        // groups staged per block
constexpr int kCols = 256;        // most live baselines of a staged group
constexpr int kBuckets = 512;     // residue buckets of the circle
constexpr int kSentinel = 1 << 30;
static_assert(kCols == kBlock, "staging gives each thread one column");

__device__ __forceinline__ int score_of(int r_f, int r_b, int col, int e, int cycle, int tol,
                                        int bmax, int best) {
  const int half = cycle / 2;
  const int up = cycle - half;
  const int diff = r_f - r_b;
  const int k_frac = static_cast<int>(diff >= up) - static_cast<int>(diff < -half);
  const int resid = abs(diff - k_frac * cycle);
  if (resid <= tol) {
    best = min(best, ((resid * (bmax + 1) + col) << 10) | ((k_frac + 1) << 8) | e);
  }
  return best;
}

// floor(x / bw) for 0 <= x < kBuckets * bw, by a multiply and one step.
__device__ __forceinline__ int bucket_of(int x, int bw, float inv_bw) {
  int b = min(static_cast<int>(static_cast<float>(x) * inv_bw), kBuckets - 1);
  if (b * bw > x) {
    --b;
  } else if ((b + 1) * bw <= x) {
    ++b;
  }
  return b;
}

// Scores the bucketed candidates whose buckets cover residues [x0, x1];
// `start` holds each bucket's first slot and `n` the group's live count.
__device__ __forceinline__ int score_arc(const int4* cand, const int* start, int n, int bw,
                                         float inv_bw, int x0, int x1, int r_f, int cycle,
                                         int tol, int bmax, int best) {
  const int b1 = bucket_of(x1, bw, inv_bw);
#pragma unroll 4
  for (int k = start[bucket_of(x0, bw, inv_bw)], e = b1 + 1 < kBuckets ? start[b1 + 1] : n;
       k < e; ++k) {
    const int4 w = cand[k];
    best = score_of(r_f, w.x, w.y, w.z, cycle, tol, bmax, best);
  }
  return best;
}

__global__ void __launch_bounds__(kBlock) correct_verdicts_kernel(
    const int* __restrict__ gid, const int* __restrict__ clk, long long f,
    const float* __restrict__ packed, int g_rows, int width, int bmax, int cycle, int tol,
    uint8_t* __restrict__ has, int* __restrict__ k_best, int* __restrict__ bs_best) {
  __shared__ int2 s_tab[kGroups][kCols];      // (r_b, e) by column
  __shared__ int4 s_cand[kGroups][kCols];     // (r_b, col, e) by residue bucket
  __shared__ int s_pos[kGroups][kBuckets];    // bucket counts, then bucket starts
  __shared__ int s_n[kGroups];                // live columns, -1: not staged

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kBlock;
  const long long i = first + tid;
  const bool row = i < f;
  // The block's first and last rows' groups (the same address in every
  // thread), loaded beside the thread's own row.
  const int g_first = gid[first];
  const int g_last = gid[min(first + kBlock, f) - 1];
  const int c = row ? clk[i] : 0;
  const int g = row ? gid[i] : -1;

  // The groups to stage: [g_first, g_last], at most four, where the search
  // is windowed and the block's rows are in stream order (the corrector's
  // gid is nondecreasing and in range).  Otherwise none: every row reads
  // the global table.  Uniform branch.
  const bool windowed = tol >= 0 && 2LL * tol + 1 < cycle;
  const int g0 = g_first;
  const int n_staged = windowed && g_first >= 0 && g_last < g_rows && g_first <= g_last
                           ? min(g_last - g_first + 1, kGroups) : 0;
  const int bw = (cycle + kBuckets - 1) / kBuckets;   // bucket width
  const float inv_bw = 1.0f / static_cast<float>(bw);
  const int n_cols = min(bmax, kCols);

  // Stage: the columns and counts in one pass, one conversion per
  // (group, column), one column per thread; every thread keeps each
  // group's live count (-1: more than kCols, not staged).
  int n_live[kGroups];
#pragma unroll
  for (int s = 0; s < kGroups; ++s) {
    n_live[s] = -1;
    if (s < n_staged) {
      const float* tbl = packed + static_cast<long long>(g0 + s) * width;
      if (tid < n_cols) {
        s_tab[s][tid] = make_int2((static_cast<int>(tbl[tid]) << 8) |
                                      static_cast<int>(tbl[bmax + tid]),
                                  static_cast<int>(tbl[2 * bmax + tid]));
      }
      const int n = min(static_cast<int>(tbl[3 * bmax]), bmax);
      n_live[s] = n > kCols ? -1 : max(n, 0);
      if (tid == 0) s_n[s] = n_live[s];
    }
  }
  for (int k = tid; k < n_staged * kBuckets; k += kBlock) s_pos[k / kBuckets][k % kBuckets] = 0;
  __syncthreads();

  // Counting sort of each staged group's live columns by residue bucket,
  // one column per thread: the count's atomic returns the column's rank in
  // its bucket, so the scatter after the prefix sums needs no atomics.  A
  // live residue outside [0, cycle) unstages its group (every writer
  // stores -1; s_n is next read after a barrier): its rows read the table.
  int rank_in[kGroups];
#pragma unroll
  for (int s = 0; s < kGroups; ++s) {
    rank_in[s] = -1;
    if (s < n_staged && tid < n_live[s]) {
      const int r_b = s_tab[s][tid].x;
      if (r_b >= 0 && r_b < cycle) {
        rank_in[s] = atomicAdd(&s_pos[s][bucket_of(r_b, bw, inv_bw)], 1);
      } else {
        s_n[s] = -1;
      }
    }
  }
  __syncthreads();
  if (warp < n_staged) {
    // Exclusive scan of the group's bucket counts, 32 buckets a round
    // (lane l holds bucket 32 k + l: no bank conflicts).
    int carry = 0;
#pragma unroll
    for (int k = 0; k < kBuckets / 32; ++k) {
      int* slot = s_pos[warp] + k * 32 + lane;
      const int cnt = *slot;
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      *slot = carry + incl - cnt;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  // Scatter into bucket order.
#pragma unroll
  for (int s = 0; s < kGroups; ++s) {
    if (rank_in[s] >= 0 && s_n[s] >= 0) {
      const int2 w = s_tab[s][tid];
      s_cand[s][s_pos[s][bucket_of(w.x, bw, inv_bw)] + rank_in[s]] = make_int4(w.x, tid, w.y, 0);
    }
  }
  __syncthreads();
  if (!row) return;

  int q = c / cycle;
  int r_f = c - q * cycle;
  if (r_f < 0) {  // floor division for negative clk
    r_f += cycle;
    q -= 1;
  }
  int best = kSentinel;
  const int s = g - g0;
  if (s >= 0 && s < n_staged && s_n[s] >= 0) {
    // The arc [r_f - tol, r_f + tol] mod cycle as one or two intervals of
    // [0, cycle); each covers a run of whole buckets.
    const int n = s_n[s];
    const int x0 = r_f - tol, x1 = r_f + tol;
    best = score_arc(s_cand[s], s_pos[s], n, bw, inv_bw, max(x0, 0), min(x1, cycle - 1), r_f,
                     cycle, tol, bmax, best);
    if (x0 < 0) {
      best = score_arc(s_cand[s], s_pos[s], n, bw, inv_bw, x0 + cycle, cycle - 1, r_f, cycle,
                       tol, bmax, best);
    } else if (x1 >= cycle) {
      best = score_arc(s_cand[s], s_pos[s], n, bw, inv_bw, 0, x1 - cycle, r_f, cycle, tol, bmax,
                       best);
    }
  } else if (g >= 0 && g < g_rows) {
    // Not staged: the global table, converted per column.
    const float* tbl = packed + static_cast<long long>(g) * width;
    const int n = min(static_cast<int>(tbl[3 * bmax]), bmax);
    for (int col = 0; col < n; ++col) {
      const int r_b = (static_cast<int>(tbl[col]) << 8) | static_cast<int>(tbl[bmax + col]);
      best = score_of(r_f, r_b, col, static_cast<int>(tbl[2 * bmax + col]), cycle, tol, bmax,
                      best);
    }
  }
  has[i] = best < kSentinel;
  k_best[i] = q + ((best >> 8) & 3) - 1;
  bs_best[i] = best & 0xFF;
}

}  // namespace

// has [F] uint8, k_best / bs_best [F] int32; cycle > 0.  Returns
// cudaGetLastError().
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
