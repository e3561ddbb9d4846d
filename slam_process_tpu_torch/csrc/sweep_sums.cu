// K4: per-sweep intensity (sums, counts) [S, n_beams, n_beams] from row
// streams, in one cooperative launch whose blocks own the output cells.
//
// Replaces slam_process_tpu/ops/pallas_sweep_sums.py::sweep_sums_pallas
// (_kernel and _kernel_local, with _call_auto's full-width rerun on a
// spill).  Inputs are three int32 [F] streams: p = gid * n_beams + ue, or
// -1 for a dropped row; bs; val = the integer RSS (< 2^18 on the wire).  A
// row counts iff 0 <= p < S * n_beams and 0 <= bs < n_beams (the Pallas
// kernel's one-hots match nothing otherwise).  Each cell's sum is an exact
// int64 sum of its rows' val (shared-memory atomicAdd on unsigned long long:
// two's-complement wrap gives int64 addition bit for bit) and its count an
// unsigned count, each converted once to float32.  Integer atomics are exact
// and independent of their order, so the result is the same bits from run
// to run for any order of the rows, and equal to the plain version's int64
// index_add_.  The float32 values are exact while a cell's sum is below
// 2^24, the JAX kernel's own bound (pallas_sweep_sums.py:20-25); past it both
// packages round the exact integer once.  No float atomics.
//
// Bound on an H100: bytes.  p (4 B) of every row and bs, val (8 B) of the
// kept rows are read, 8 B per cell of float32 written: 3.76 MB and 1.12 us
// at the full session (155,035 rows, S = 58).  A scatter into a zeroed
// int64 / uint32 grid would need two fills and a conversion pass besides
// (~9.5 MB; the fills alone take 4.2 us at the full session,
// tools/diag_torch_k4_phases.py).  This form needs no scratch grid, no
// fill, no conversion pass and no global atomic on the data, in one
// launch:
//   1. tile summaries: the grid's blocks take tiles of kTile rows and
//      publish each tile's smallest and largest p in [0, S * n_beams) to a
//      scratch, each as one 64-bit word tagged with the call's epoch (so a
//      reader sees a whole word or an older one, and needs no fence), and
//      ask the L2 to fetch the tile's bs and val for the owners;
//   2. owners: block u owns cells [u kCells, (u + 1) kCells) of the output,
//      a range of p, with their int64 sums and uint32 counts in shared
//      memory; it reads every tile's summary (waiting for the ones not yet
//      published), takes only the tiles whose [min, max] meets its p range,
//      adds their rows in range with shared-memory integer atomics, and
//      writes each of its cells' float32 sum and count once, zeros included.
// No grid-wide barrier: an owner waits only until the summaries it reads
// carry the call's tag.  The epoch comes from a ticket word beside the
// summaries (K5's scheme, csrc/compact.cu): each block takes a ticket as it
// starts, the call's epoch in the high half, and the block that takes the
// last one starts the next epoch, so the scratch needs no reset and no host
// state.  The launch is cooperative (cudaLaunchCooperativeKernel, the grid
// no larger than the blocks the card holds at once), so no owner waits on a
// block that never starts.
// Every production caller feeds kept p in nondecreasing order with dropped
// rows as -1 between them, so an owner reads one to three tiles, loads their
// p, bs and val at once, and the rows are read about once.  An unsorted
// stream stays exact and only costs time: every tile then meets every owner,
// which loads a row's bs and val only when its p is in range (the CUDA form
// of the TPU kernel's spill rerun).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;     // threads per block
constexpr int kTile = 1024;       // rows per tile summary (two per thread)
constexpr int kCells = 1024;      // output cells a block owns at a time
constexpr int kUnroll = 4;        // tiles whose rows are loaded together
constexpr int kEager = 2 * kUnroll;   // up to this many tiles: bs and val loaded with p
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The tag of the call whose ticket was `old` (2 * epoch + 1: odd, so a
// zeroed summary word never carries it); the block that took the last
// index starts the next epoch with no tickets taken.
__device__ __forceinline__ unsigned call_tag(unsigned long long* ticket, unsigned long long old) {
  const unsigned epoch = static_cast<unsigned>(old >> 32);
  if (static_cast<unsigned>(old) == gridDim.x - 1) {
    atomicExch(ticket, static_cast<unsigned long long>(epoch + 1u) << 32);
  }
  return 2u * epoch + 1u;
}

__global__ void __launch_bounds__(kThreads, 2) sweep_sums_kernel(
    const int* __restrict__ p, const int* __restrict__ bs, const int* __restrict__ val,
    int f, long long width, int n_beams, long long n_cells, int n_tiles,
    unsigned long long* __restrict__ ticket, unsigned long long* __restrict__ summary,
    float* __restrict__ out_sums, float* __restrict__ out_counts) {
  __shared__ unsigned long long s_sum[kCells];
  __shared__ unsigned s_cnt[kCells];
  __shared__ int s_lo[kThreads / 32], s_hi[kThreads / 32];
  __shared__ int s_list[kThreads];
  __shared__ int s_n;
  __shared__ unsigned s_tag;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The ticket word holds the call's epoch in the high half and the blocks
  // started in the low half.  Its round trip overlaps the first tile's loads.
  unsigned long long old = 0;
  if (tid == 0) old = atomicAdd(ticket, 1ull);

  // 1. Each tile's smallest and largest p in [0, width), published.
  bool tagged = false;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int h = 0; h < kTile / kThreads; ++h) {
      const int i = t * kTile + h * kThreads + tid;
      if (i < f) {
        const int pi = p[i];
        if (pi >= 0 && pi < width) {
          lo = min(lo, pi);
          hi = max(hi, pi);
          prefetch_l2(bs + i);
          prefetch_l2(val + i);
        }
      }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    if (tid == 0 && !tagged) s_tag = call_tag(ticket, old);
    tagged = true;
    __syncthreads();
    if (warp == 0) {
      lo = __reduce_min_sync(kFull, lane < kThreads / 32 ? s_lo[lane] : INT_MAX);
      hi = __reduce_max_sync(kFull, lane < kThreads / 32 ? s_hi[lane] : INT_MIN);
      if (lane < 2) {
        const unsigned v = static_cast<unsigned>(lane == 0 ? lo : hi);
        store_volatile(summary + 2 * t + lane,
                       (static_cast<unsigned long long>(s_tag) << 32) | v);
      }
    }
    __syncthreads();
  }
  if (!tagged) {
    if (tid == 0) s_tag = call_tag(ticket, old);
    __syncthreads();
  }
  const unsigned tag = s_tag;

  // 2. Each block owns ranges of kCells output cells.
  const long long n_units = (n_cells + kCells - 1) / kCells;
  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const long long c0 = u * kCells;
    const int nc = static_cast<int>(n_cells - c0 < kCells ? n_cells - c0 : kCells);
    const int p_lo = static_cast<int>(c0 / n_beams);
    const int p_hi = static_cast<int>((c0 + nc - 1) / n_beams);
    for (int k = tid; k < kCells; k += kThreads) {
      s_sum[k] = 0ull;
      s_cnt[k] = 0u;
    }
    for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
      // The tiles of this stretch whose p range meets the block's, each
      // summary read once it carries the call's tag.
      if (tid == 0) s_n = 0;
      __syncthreads();
      const int t = t0 + tid;
      bool hit = false;
      if (t < n_tiles) {
        unsigned long long w_lo = load_volatile(summary + 2 * t);
        unsigned long long w_hi = load_volatile(summary + 2 * t + 1);
        while (static_cast<unsigned>(w_lo >> 32) != tag ||
               static_cast<unsigned>(w_hi >> 32) != tag) {
          __nanosleep(32);
          w_lo = load_volatile(summary + 2 * t);
          w_hi = load_volatile(summary + 2 * t + 1);
        }
        hit = static_cast<int>(static_cast<unsigned>(w_lo)) <= p_hi &&
              static_cast<int>(static_cast<unsigned>(w_hi)) >= p_lo;
      }
      const unsigned ballot = __ballot_sync(kFull, hit);
      int at = 0;
      if (lane == 0 && ballot) at = atomicAdd(&s_n, __popc(ballot));
      at = __shfl_sync(kFull, at, 0);
      if (hit) s_list[at + __popc(ballot & ((1u << lane) - 1u))] = t;
      __syncthreads();
      // Their rows in range, kUnroll tiles' rows loaded together: p, bs
      // and val at once while few tiles meet the block's range, else bs
      // and val only where p is in range.
      const int n_hit = s_n;
      const bool eager = n_hit <= kEager;
      for (int j = 0; j < n_hit; j += kUnroll) {
        constexpr int kRows = kUnroll * kTile / kThreads;
        int pv[kRows], bv[kRows], vv[kRows], iv[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int jt = j + q / (kTile / kThreads);
          iv[q] = jt < n_hit ? s_list[jt] * kTile + (q % (kTile / kThreads)) * kThreads + tid
                             : f;
          pv[q] = iv[q] < f ? p[iv[q]] : -1;
          if (eager && iv[q] < f) {
            bv[q] = bs[iv[q]];
            vv[q] = val[iv[q]];
          }
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (pv[q] < p_lo || pv[q] > p_hi) continue;
          if (!eager) {
            bv[q] = bs[iv[q]];
            vv[q] = val[iv[q]];
          }
          if (bv[q] < 0 || bv[q] >= n_beams) continue;
          const long long cell = static_cast<long long>(pv[q]) * n_beams + bv[q] - c0;
          if (cell < 0 || cell >= nc) continue;
          atomicAdd(s_sum + cell, static_cast<unsigned long long>(static_cast<long long>(vv[q])));
          atomicAdd(s_cnt + cell, 1u);
        }
      }
      __syncthreads();
    }
    for (int k = tid; k < nc; k += kThreads) {
      out_sums[c0 + k] = static_cast<float>(static_cast<long long>(s_sum[k]));
      out_counts[c0 + k] = static_cast<float>(s_cnt[k]);
    }
    __syncthreads();
  }
}

// Blocks of sweep_sums_kernel the card holds at once, per device.
int max_grid(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_sums_kernel, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      return 0;
    }
    cached[device] = per_sm * sms;
  }
  return cached[device];
}

}  // namespace

// p, bs, val: int32 [f], 1 <= f < 2^31 - 1024; n_sweeps >= 1, n_beams >= 1;
// scratch: 8 + 16 * ceil(f / 1024) bytes (the ticket word, then two summary
// words per tile), zero when first used (a call leaves it ready for the next
// on the same stream); out_sums and out_counts: float32 [n_sweeps *
// n_beams^2], no initial value needed.  One cooperative launch.  Returns the
// launch's error code.
extern "C" int slam_sweep_sums(const void* p, const void* bs, const void* val, long long f,
                               int n_sweeps, int n_beams, void* scratch, void* out_sums,
                               void* out_counts, void* stream) {
  if (f < 1 || f > INT_MAX - kTile || n_sweeps < 1 || n_beams < 1 ||
      static_cast<long long>(n_sweeps) * n_beams > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cap = max_grid(device);
  if (cap < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  long long width = static_cast<long long>(n_sweeps) * n_beams;
  long long n_cells = width * n_beams;
  int n_rows = static_cast<int>(f);
  int n_tiles = (n_rows + kTile - 1) / kTile;
  const long long n_units = (n_cells + kCells - 1) / kCells;
  const long long want = n_units > n_tiles ? n_units : n_tiles;
  const int grid = static_cast<int>(want < cap ? want : cap);
  unsigned long long* ticket = static_cast<unsigned long long*>(scratch);
  unsigned long long* summary = ticket + 1;
  const int* pp = static_cast<const int*>(p);
  const int* bp = static_cast<const int*>(bs);
  const int* vp = static_cast<const int*>(val);
  float* sp = static_cast<float*>(out_sums);
  float* cp = static_cast<float*>(out_counts);
  void* args[] = {&pp, &bp, &vp, &n_rows, &width, &n_beams, &n_cells, &n_tiles, &ticket,
                  &summary, &sp, &cp};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sweep_sums_kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
