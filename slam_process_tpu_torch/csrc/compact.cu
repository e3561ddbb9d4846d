// K5: stream-order compaction of masked rows, into one or two destinations.
//
// Replaces slam_process_tpu/ops/pallas_compact.py::compact_rows_pallas
// (_kernel): rows int32 [f, width] (row-major) and a mask [f]; the masked
// rows, in stream order, land at out[offset + rank] while offset + rank <
// capacity (rank = the number of masked rows before it), the rest are
// dropped, and with zero_tail the rows [offset + total, capacity) of out
// are zeroed.  The total masked count (not clamped) is written to *total.
// Each destination has its own out, offset and capacity; both take the
// same ranks from one read of the mask and the rows.  The streaming session
// uses one destination for the open-group carry (offset 0, zero tail) and
// two for the window's kept rows: the emit-ring append (offset = the ring's
// device-side row count, no zeroing) and the compacted rows its online
// paths segment (a fresh buffer, zero tail).
//
// Bound on an H100: bytes.  Each mask byte is read once, the payload only
// of the masked rows, and each output slot written once: at the carry of a
// 1 MiB window, 103,518 mask bytes, 2,549 x 20 B in and 8,192 x 20 B out,
// ~0.32 MB, 0.095 us at 3.35 TB/s.  So the launch (~2 us for an empty
// kernel back to back) and the chain of dependent memory round trips inside
// it are the practical floor, and the design is one launch per call with as
// few round trips as it can.  The TPU kernel avoided scatters (ranks from a
// triangular-ones bf16 matmul, a one-hot in VMEM, 8-bit limbs written by
// one-hot^T matmul); on Hopper the function is a plain stream compaction in
// a single pass with decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016):
//   * each 1,024-thread block takes the next tile of 1,024 rows from an
//     atomic ticket, so a tile only ever waits on tiles handed out before
//     it, which are resident or done, whatever the scheduler does;
//   * it loads its mask bytes and its masked rows' payload, ranks its rows
//     by warp ballot and a scan of the 32 warp counts, publishes its count
//     as one 64-bit (tag, flag, count) word, reads its predecessors' words
//     128 at a time (four per lane of warp 0) back to the nearest inclusive
//     prefix, and publishes its own inclusive prefix;
//   * it writes each masked row to offset + rank of every destination;
//   * the last tile writes the total; a few more blocks, handed out after
//     every tile, wait for it and zero the tails.
// The scratch needs no reset launch and no host state: the ticket word
// holds the call's epoch beside the next tile, and the block that takes the
// last index starts the next epoch at tile 0; every status word carries its
// call's tag, 2 * epoch + 1, so words of earlier calls (and zeroed ones)
// never read as published.  A word could be mistaken only if its tile went
// unused by exactly a multiple of 2^31 calls on one stream.  The wrapper
// keeps one scratch per device and stream.  No fence is needed: a status
// word carries all it publishes in one 64-bit store, and the rows are read
// by later launches only.  Ranks are exact unsigned integers; no float is
// involved.
//
// The stream axis (slam_compact_rows_streams): S independent compactions of
// one shape in one launch, rows [S, f, width] and mask [S, f]; stream s
// writes at out_k + s stride_k from offset_k[s] up to the same capacity,
// and its total to total[s].  Each stream has its own decoupled look-back
// chain: the grid is S segments of (tiles + tail blocks), handed out in
// ticket order, and block g works on tile g mod (tiles + tail) of stream g
// div (tiles + tail), publishing into the stream's own segment of status
// words.  A block waits only on tiles of its own stream with lower tickets,
// so the progress argument above holds per stream; the epoch tag is the
// call's, so every segment is ready for the next launch with no reset.  The
// single-stream entry is the case S = 1 (strides unused, offsets read while
// the ticket is taken, as before).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr int kLook = 4;          // predecessors each lane of warp 0 reads per look-back round
constexpr int kMaxDests = 2;
constexpr int kPrefetch = 8;      // row widths whose payload is loaded before the look-back
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr unsigned long long kInclusive = 0x80000000ull;

struct Dest {
  int* out;
  const int* offset;   // int32 device scalar per stream, or null for 0
  long long capacity;
  long long stride;    // int32 elements from one stream's out to the next's
  int zero_tail;
};

struct Dests {
  Dest d[kMaxDests];
  int n;
};

// A status word: the call's tag in the high half (2 * epoch + 1: odd, so a
// zeroed word is never ready), the inclusive flag in bit 31 and the count
// in bits 0-30.  One 64-bit store publishes all of it at once, so no fence
// is needed: a reader sees the whole word or an older one.
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned tag, bool inclusive,
                                             unsigned count) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(tag) << 32) | (inclusive ? kInclusive : 0ull) | count;
}

// Warp 0 of tile `tile` > 0: the masked rows in all earlier tiles.  Each
// round reads the 128 nearest unread predecessors (lane l, word q: tile base
// - l - 32 q), waits until they are published, and sums the counts up to
// the nearest inclusive prefix among them.
__device__ unsigned look_back(const unsigned long long* status, int tile, int lane, unsigned tag) {
  unsigned excl = 0;
  for (int base = tile - 1;; base -= 32 * kLook) {
    unsigned long long w[kLook];
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      const int j = base - lane - 32 * q;
      w[q] = j >= 0 ? load_status(status + j)
                    : (static_cast<unsigned long long>(tag) << 32) | kInclusive;
    }
    bool waiting = true;
    while (waiting) {
      waiting = false;
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        if (static_cast<unsigned>(w[q] >> 32) != tag) {
          w[q] = load_status(status + base - lane - 32 * q);
          waiting = true;
        }
      }
      waiting = __any_sync(kFull, waiting);
    }
    unsigned near = kNone;      // the nearest inclusive prefix's distance
#pragma unroll
    for (int q = kLook - 1; q >= 0; --q) {
      if (w[q] & kInclusive) near = static_cast<unsigned>(lane + 32 * q);
    }
    near = __reduce_min_sync(kFull, near);
    unsigned v = 0;
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      if (static_cast<unsigned>(lane + 32 * q) <= near) v += static_cast<unsigned>(w[q]) & 0x7fffffffu;
    }
    excl += __reduce_add_sync(kFull, v);
    if (near != kNone) return excl;
  }
}

__global__ void __launch_bounds__(kBlock) compact_kernel(
    const int* __restrict__ rows, const uint8_t* __restrict__ mask, long long f, int width,
    int n_streams, int n_tiles, int per_stream, int n_grid, Dests dests,
    unsigned long long* __restrict__ ticket, unsigned long long* __restrict__ status,
    int* __restrict__ total_out) {
  __shared__ int s_tile, s_stream;
  __shared__ unsigned s_tag, s_excl, s_total;
  __shared__ long long s_off[kMaxDests];
  __shared__ int warp_cnt[kWarps], warp_off[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // The ticket word: the call's epoch in the high half, the next tile in
  // the low half.  The block that takes the last index starts the next
  // epoch at tile 0.
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(ticket, 1ull);
    const unsigned epoch = static_cast<unsigned>(old >> 32);
    if (static_cast<unsigned>(old) == static_cast<unsigned>(n_grid - 1)) {
      atomicExch(ticket, static_cast<unsigned long long>(epoch + 1u) << 32);
    }
    const unsigned g = static_cast<unsigned>(old);
    s_stream = static_cast<int>(g / static_cast<unsigned>(per_stream));
    s_tile = static_cast<int>(g % static_cast<unsigned>(per_stream));
    s_tag = 2u * epoch + 1u;
  }
  if (n_streams == 1) {
    if (threadIdx.x == 32) s_off[0] = dests.d[0].offset ? *dests.d[0].offset : 0;
    if (threadIdx.x == 64) s_off[1] = dests.d[1].offset ? *dests.d[1].offset : 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const unsigned tag = s_tag;
  const long long st = s_stream;
  if (n_streams > 1) {
    if (threadIdx.x == 32) s_off[0] = dests.d[0].offset ? dests.d[0].offset[st] : 0;
    if (threadIdx.x == 64) s_off[1] = dests.d[1].offset ? dests.d[1].offset[st] : 0;
    __syncthreads();
  }
  // This block's stream: its rows, mask, status segment, total and outputs.
  rows += st * f * width;
  mask += st * f;
  status += st * n_tiles;
  total_out += st;
  int* outs[kMaxDests];
#pragma unroll
  for (int k = 0; k < kMaxDests; ++k) outs[k] = dests.d[k].out + st * dests.d[k].stride;

  if (tile < n_tiles) {
    const long long i = static_cast<long long>(tile) * kBlock + threadIdx.x;
    const int m = i < f && mask[i] != 0;
    // A masked row's payload is loaded now, while the look-back runs.
    const int* src = rows + i * width;
    int payload[kPrefetch];
#pragma unroll
    for (int c = 0; c < kPrefetch; ++c) payload[c] = m && c < width ? src[c] : 0;
    const unsigned ballot = __ballot_sync(kFull, m);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int v = warp_cnt[lane];
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += n;
      }
      warp_off[lane] = incl - v;
      const unsigned count = static_cast<unsigned>(__shfl_sync(kFull, incl, 31));
      unsigned excl = 0;
      if (tile > 0) {
        if (lane == 0) store_status(status + tile, tag, false, count);
        excl = look_back(status, tile, lane, tag);
      }
      if (lane == 0) {
        store_status(status + tile, tag, true, excl + count);
        s_excl = excl;
        if (tile == n_tiles - 1) *total_out = static_cast<int>(excl + count);
      }
    }
    __syncthreads();
    if (m) {
      const long long rank = static_cast<long long>(s_excl) + warp_off[warp] +
                             __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
      for (int k = 0; k < kMaxDests; ++k) {
        const long long dst = s_off[k] + rank;
        if (k < dests.n && dst < dests.d[k].capacity) {
          int* o = outs[k] + dst * width;
#pragma unroll
          for (int c = 0; c < kPrefetch; ++c) {
            if (c < width) o[c] = payload[c];
          }
          for (int c = kPrefetch; c < width; ++c) o[c] = src[c];
        }
      }
    }
  } else {
    // A tail block: wait for the last tile's inclusive prefix, the total,
    // then zero its share of each zero-tailed destination's tail, which the
    // tail blocks split evenly.
    if (threadIdx.x == 0) {
      unsigned long long w;
      do {
        w = load_status(status + n_tiles - 1);
      } while (static_cast<unsigned>(w >> 32) != tag || !(w & kInclusive));
      s_total = static_cast<unsigned>(w) & 0x7fffffffu;
    }
    __syncthreads();
    const long long b = tile - n_tiles;
    const long long n_tail = per_stream - n_tiles;
#pragma unroll
    for (int k = 0; k < kMaxDests; ++k) {
      if (k >= dests.n || !dests.d[k].zero_tail) continue;
      const long long hi = dests.d[k].capacity * width;
      const long long lo = min(hi, (s_off[k] + s_total) * width);
      const long long chunk = (hi - lo + n_tail - 1) / n_tail;
      const long long e1 = min(hi, lo + (b + 1) * chunk);
      int* o = outs[k];
      for (long long e = lo + b * chunk + threadIdx.x; e < e1; e += kBlock) o[e] = 0;
    }
  }
}

int launch(const void* rows, const void* mask, long long n_streams, long long f, int width,
           void* scratch, int n_dest, void* out0, const void* offset0, long long capacity0,
           long long stride0, int zero_tail0, void* out1, const void* offset1,
           long long capacity1, long long stride1, int zero_tail1, int n_tail, void* total,
           void* stream) {
  if (f < 0 || f > 0x7fffffffLL || width < 1 || n_dest < 1 || n_dest > kMaxDests ||
      capacity0 < 0 || capacity1 < 0 || n_tail < 0 || n_streams < 1 ||
      (n_tail == 0 && (zero_tail0 || (n_dest > 1 && zero_tail1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dests dests;
  dests.n = n_dest;
  dests.d[0] = Dest{static_cast<int*>(out0), static_cast<const int*>(offset0), capacity0,
                    stride0, zero_tail0};
  dests.d[1] = Dest{static_cast<int*>(out1), static_cast<const int*>(offset1), capacity1,
                    stride1, n_dest > 1 ? zero_tail1 : 0};
  const int n_tiles = f > 0 ? static_cast<int>((f + kBlock - 1) / kBlock) : 1;
  const long long per_stream = n_tiles + n_tail;
  if (per_stream * n_streams > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n_grid = static_cast<int>(per_stream * n_streams);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  compact_kernel<<<n_grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const uint8_t*>(mask), f, width,
      static_cast<int>(n_streams), n_tiles, static_cast<int>(per_stream), n_grid, dests, words,
      words + 1, static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: int32 [f, width]; mask: bool [f]; scratch: 8 + 8 * n_tiles bytes,
// zero when first used (a call leaves it ready for the next on the same
// stream), n_tiles = max(1, ceil(f / 1024)); n_dest destinations (1 or
// 2), each an out int32 [>= capacity, width], an int32 offset scalar on the
// device or null (0), a capacity and a zero_tail flag; n_tail: the tail
// blocks (>= 1 when a destination has zero_tail); total: int32 scalar.  f <
// 2^31.  One launch.  Returns cudaGetLastError() after it.
extern "C" int slam_compact_rows(const void* rows, const void* mask, long long f, int width,
                                 void* scratch, int n_dest, void* out0, const void* offset0,
                                 long long capacity0, int zero_tail0, void* out1,
                                 const void* offset1, long long capacity1, int zero_tail1,
                                 int n_tail, void* total, void* stream) {
  return launch(rows, mask, 1, f, width, scratch, n_dest, out0, offset0, capacity0, 0,
                zero_tail0, out1, offset1, capacity1, 0, zero_tail1, n_tail, total, stream);
}

// The stream axis: rows int32 [S, f, width], mask bool [S, f]; destination k
// is S outs of stride_k int32 elements (each [>= capacity_k, width]), offsets
// int32 [S] on the device or null, one capacity and zero_tail flag; n_tail
// tail blocks per stream; total int32 [S]; scratch 8 + 8 S n_tiles bytes
// under the single-stream contract.  S (tiles + tail) < 2^31.  One launch.
// Returns cudaGetLastError() after it.
extern "C" int slam_compact_rows_streams(const void* rows, const void* mask, long long n_streams,
                                         long long f, int width, void* scratch, int n_dest,
                                         void* out0, const void* offset0, long long capacity0,
                                         long long stride0, int zero_tail0, void* out1,
                                         const void* offset1, long long capacity1,
                                         long long stride1, int zero_tail1, int n_tail,
                                         void* total, void* stream) {
  return launch(rows, mask, n_streams, f, width, scratch, n_dest, out0, offset0, capacity0,
                stride0, zero_tail0, out1, offset1, capacity1, stride1, zero_tail1, n_tail,
                total, stream);
}
