// K5: stream-order compaction of masked rows.
//
// Replaces slam_process_tpu/ops/pallas_compact.py::compact_rows_pallas
// (_kernel): rows int32 [f, width] (row-major) and a mask [f]; the masked
// rows, in stream order, land at out[offset + rank] while offset + rank <
// capacity (rank = the number of masked rows before it), the rest are
// dropped, and with zero_tail the rows [offset + total, capacity) of out
// are zeroed.  The total masked count (not clamped) is written to *total.
// The streaming session uses it for the open-group carry (offset 0, zero
// tail) and for the emit-ring append (offset = the ring's device-side row
// count, no zeroing), and for the kept rows that its online paths segment.
//
// Bound on an H100: bytes.  Each row and mask byte is read once and each
// output row written once: at a 1 MiB window, 103,518 x (20 + 1) B in and
// 8,192 x 20 B out, ~2.34 MB, ~0.70 us at 3.35 TB/s.  The TPU kernel
// avoided scatters (ranks from a triangular-ones bf16 matmul, a [1024,
// 1024] one-hot in VMEM and 8-bit limbs written by one-hot^T matmul);
// on Hopper the function is a plain stream compaction.  Design, two
// launches: (1) one 1,024-thread block per 1,024 rows counts its masked
// rows with __syncthreads_count; (2) each block sums the counts of the
// blocks before it (and all of them, for the total and the tail), ranks
// its rows by a warp ballot and a scan of the 32 warp counts, and writes
// each masked row straight to its slot.  Ranks are exact int32; no float
// is involved.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;

__global__ void compact_count_kernel(const uint8_t* __restrict__ mask, long long f,
                                     int* __restrict__ block_counts) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const int m = i < f && mask[i] != 0;
  const int c = __syncthreads_count(m);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void compact_scatter_kernel(const int* __restrict__ rows,
                                       const uint8_t* __restrict__ mask, long long f, int width,
                                       const int* __restrict__ block_counts, int n_blocks,
                                       const int* __restrict__ offset_ptr, long long capacity,
                                       int zero_tail, int* __restrict__ out,
                                       int* __restrict__ total_out) {
  __shared__ long long red_pre[kWarps], red_tot[kWarps];
  __shared__ int warp_cnt[kWarps], warp_off[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Masked rows before this block, and in all blocks.
  long long pre = 0, tot = 0;
  for (int b = threadIdx.x; b < n_blocks; b += kBlock) {
    const int c = block_counts[b];
    tot += c;
    if (b < static_cast<int>(blockIdx.x)) pre += c;
  }
  for (int o = 16; o > 0; o >>= 1) {
    pre += __shfl_xor_sync(0xffffffffu, pre, o);
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
  }
  if (lane == 0) {
    red_pre[warp] = pre;
    red_tot[warp] = tot;
  }

  // In-block rank: the warp ballot, then the warps' exclusive scan.
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const int m = i < f && mask[i] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, m);
  const int rank_in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int v = warp_cnt[lane];
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    warp_off[lane] = incl - v;
    long long p = red_pre[lane], t = red_tot[lane];
    for (int o = 16; o > 0; o >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, o);
      t += __shfl_xor_sync(0xffffffffu, t, o);
    }
    if (lane == 0) {
      red_pre[0] = p;
      red_tot[0] = t;
    }
  }
  __syncthreads();
  const long long offset = offset_ptr ? *offset_ptr : 0;
  const long long base = offset + red_pre[0];
  const long long total = red_tot[0];

  if (m) {
    const long long dst = base + warp_off[warp] + rank_in_warp;
    if (dst < capacity) {
      const int* src = rows + i * width;
      int* d = out + dst * width;
      for (int c = 0; c < width; ++c) d[c] = src[c];
    }
  }
  if (zero_tail) {
    const long long first_empty = offset + total;
    for (long long g = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; g < capacity;
         g += static_cast<long long>(gridDim.x) * kBlock) {
      if (g >= first_empty) {
        for (int c = 0; c < width; ++c) out[g * width + c] = 0;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *total_out = static_cast<int>(total);
}

}  // namespace

// rows: int32 [f, width]; mask: bool [f]; block_counts: int32 scratch of
// max(1, ceil(f / 1024)) entries; offset: int32 scalar on the device or
// null (0); out: int32 [>= capacity, width]; total: int32 scalar.  Returns
// cudaGetLastError() after the launches.
extern "C" int slam_compact_rows(const void* rows, const void* mask, long long f, int width,
                                 void* block_counts, const void* offset, long long capacity,
                                 int zero_tail, void* out, void* total, void* stream) {
  if (f < 0 || width < 1 || capacity < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = f > 0 ? static_cast<int>((f + kBlock - 1) / kBlock) : 1;
  compact_count_kernel<<<n_blocks, kBlock, 0, s>>>(static_cast<const uint8_t*>(mask), f,
                                                   static_cast<int*>(block_counts));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  compact_scatter_kernel<<<n_blocks, kBlock, 0, s>>>(
      static_cast<const int*>(rows), static_cast<const uint8_t*>(mask), f, width,
      static_cast<const int*>(block_counts), n_blocks, static_cast<const int*>(offset),
      capacity, zero_tail, static_cast<int*>(out), static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}
