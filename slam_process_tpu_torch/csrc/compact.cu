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
// and its total to total[s].  S = 1 is the single stream's schedule above
// (the single entry; offsets read while the ticket is taken).  For S > 1
// the tile-a-block schedule made each stream a look-back chain of f / 1,024
// tiles and the round many waves of blocks (19 streams of 103,518 rows:
// ~2,000 blocks, one resident a SM at 64 registers a thread, ~16 waves),
// 20x its bytes bound (~6.1 MB moved, ~1.8 us at 3.35 TB/s): the schedule,
// not the bytes, bounded it.  So the stream axis has a schedule of its own
// (compact_chunks_kernel): a block takes a chunk of consecutive tiles of
// one stream, sized so that the S streams' chunks fit one resident wave
// (at most kMaxChunk tiles); it reads the chunk's mask bytes 8 tiles at a
// time, ranks every row by warp ballots and a scan of each tile's 32 warp
// counts (one warp a tile, in parallel), keeps a running count over the
// tiles, publishes one look-back word for the whole chunk, and writes its
// masked rows 4 tiles at a time (their payloads loaded together).  Each
// stream's chain is then a few chunks long.  The tail blocks are handed out
// after every chunk of every stream, so they hold no slot a chunk needs;
// each waits for its stream's last chunk (zeroing the tails in that last
// chunk instead, with no tail blocks, measured 11 % slower at 19 streams on
// an H100: one block's serial stores end the launch).  The status
// words, the ticket's epoch and the tags are the single stream's: every
// stream's segment is ready for the next launch with no reset, and the
// same launch is safe to capture in a CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr int kLook = 4;          // predecessors each lane of warp 0 reads per look-back round
constexpr int kMaxDests = 2;
constexpr int kPrefetch = 8;      // row widths whose payload is loaded before the look-back
constexpr int kMaxChunk = 64;     // tiles a block of the stream axis takes at most
constexpr int kMaskGroup = 8;     // tiles whose mask bytes a thread loads together
constexpr int kRowGroup = 4;      // tiles whose masked rows' payloads a thread loads together
constexpr int kRowPrefetch = 5;   // row widths loaded together in a row group
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

// A tail block's share of each zero-tailed destination's tail [offset +
// total, capacity): the tail blocks b = 0 .. n_tail - 1 split it evenly.
__device__ __forceinline__ void zero_tails(const Dests& dests, int* const* outs,
                                           const long long* off, unsigned total, int width,
                                           long long b, long long n_tail) {
#pragma unroll
  for (int k = 0; k < kMaxDests; ++k) {
    if (k >= dests.n || !dests.d[k].zero_tail) continue;
    const long long hi = dests.d[k].capacity * width;
    const long long lo = min(hi, (off[k] + total) * width);
    const long long chunk = (hi - lo + n_tail - 1) / n_tail;
    const long long e1 = min(hi, lo + (b + 1) * chunk);
    int* o = outs[k];
    for (long long e = lo + b * chunk + threadIdx.x; e < e1; e += kBlock) o[e] = 0;
  }
}

// The ticket word: the call's epoch in the high half, the next index in the
// low half.  The block that takes the last index starts the next epoch at 0.
// Returns the index; ``tag`` = 2 * epoch + 1.
__device__ __forceinline__ unsigned take_ticket(unsigned long long* ticket, int n_grid,
                                                unsigned& tag) {
  const unsigned long long old = atomicAdd(ticket, 1ull);
  const unsigned epoch = static_cast<unsigned>(old >> 32);
  if (static_cast<unsigned>(old) == static_cast<unsigned>(n_grid - 1)) {
    atomicExch(ticket, static_cast<unsigned long long>(epoch + 1u) << 32);
  }
  tag = 2u * epoch + 1u;
  return static_cast<unsigned>(old);
}

// A tail block's wait: the inclusive prefix of status word ``last``, the
// stream's total.
__device__ __forceinline__ unsigned wait_total(const unsigned long long* status, unsigned tag) {
  unsigned long long w;
  do {
    w = load_status(status);
  } while (static_cast<unsigned>(w >> 32) != tag || !(w & kInclusive));
  return static_cast<unsigned>(w) & 0x7fffffffu;
}

// The single stream (S = 1): a tile of 1,024 rows a block, then the tail
// blocks, in ticket order.
__global__ void __launch_bounds__(kBlock) compact_kernel(
    const int* __restrict__ rows, const uint8_t* __restrict__ mask, long long f, int width,
    int n_tiles, int n_grid, Dests dests, unsigned long long* __restrict__ ticket,
    unsigned long long* __restrict__ status, int* __restrict__ total_out) {
  __shared__ int s_tile;
  __shared__ unsigned s_tag, s_excl, s_total;
  __shared__ long long s_off[kMaxDests];
  __shared__ int warp_cnt[kWarps], warp_off[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) s_tile = static_cast<int>(take_ticket(ticket, n_grid, s_tag));
  if (threadIdx.x == 32) s_off[0] = dests.d[0].offset ? *dests.d[0].offset : 0;
  if (threadIdx.x == 64) s_off[1] = dests.d[1].offset ? *dests.d[1].offset : 0;
  __syncthreads();
  const int tile = s_tile;
  const unsigned tag = s_tag;
  int* outs[kMaxDests];
#pragma unroll
  for (int k = 0; k < kMaxDests; ++k) outs[k] = dests.d[k].out;

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
    // then zero its share of the tails.
    if (threadIdx.x == 0) s_total = wait_total(status + n_tiles - 1, tag);
    __syncthreads();
    zero_tails(dests, outs, s_off, s_total, width, tile - n_tiles, n_grid - n_tiles);
  }
}

// The stream axis (S > 1): ticket g < S n_chunks is chunk g mod n_chunks of
// stream g div n_chunks (tiles [chunk c, chunk (c + 1)) of that stream),
// then S n_tail tail blocks, n_tail a stream.
__global__ void __launch_bounds__(kBlock) compact_chunks_kernel(
    const int* __restrict__ rows, const uint8_t* __restrict__ mask, long long f, int width,
    int n_tiles, int chunk, int n_chunks, int n_streams, int n_tail, int n_grid, Dests dests,
    unsigned long long* __restrict__ ticket, unsigned long long* __restrict__ status,
    int* __restrict__ total_out) {
  __shared__ int s_unit, s_stream;
  __shared__ unsigned s_tag, s_excl, s_total;
  __shared__ long long s_off[kMaxDests];
  __shared__ unsigned s_ballot[kMaxChunk][kWarps];   // tile j, warp w: its rows' mask bits
  __shared__ int s_woff[kMaxChunk][kWarps];          // masked rows of tile j before warp w
  __shared__ int s_cnt[kMaxChunk];                   // masked rows of tile j
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    const unsigned g = take_ticket(ticket, n_grid, s_tag);
    const unsigned n_units = static_cast<unsigned>(n_streams) * n_chunks;
    const bool tail = g >= n_units;
    const unsigned per = tail ? static_cast<unsigned>(n_tail) : static_cast<unsigned>(n_chunks);
    const unsigned u = tail ? g - n_units : g;
    s_stream = static_cast<int>(u / per);
    // A tail block's unit is -1 - its index among its stream's tails.
    s_unit = tail ? -1 - static_cast<int>(u % per) : static_cast<int>(u % per);
  }
  __syncthreads();
  const int unit = s_unit;
  const unsigned tag = s_tag;
  const long long st = s_stream;
  if (threadIdx.x == 32) s_off[0] = dests.d[0].offset ? dests.d[0].offset[st] : 0;
  if (threadIdx.x == 64) s_off[1] = dests.d[1].offset ? dests.d[1].offset[st] : 0;
  // This block's stream: its rows, mask, status segment, total and outputs.
  rows += st * f * width;
  mask += st * f;
  status += st * n_tiles;
  total_out += st;
  int* outs[kMaxDests];
#pragma unroll
  for (int k = 0; k < kMaxDests; ++k) outs[k] = dests.d[k].out + st * dests.d[k].stride;

  if (unit < 0) {
    if (threadIdx.x == 0) s_total = wait_total(status + n_chunks - 1, tag);
    __syncthreads();
    zero_tails(dests, outs, s_off, s_total, width, -1 - unit, n_tail);
    return;
  }
  const int t0 = unit * chunk;
  const int nt = min(chunk, n_tiles - t0);
  const long long row0 = static_cast<long long>(t0) * kBlock + threadIdx.x;
  // The chunk's mask bytes, kMaskGroup tiles at a time (the loads of a group
  // in flight together), ranked by warp ballots.
  for (int j0 = 0; j0 < nt; j0 += kMaskGroup) {
    bool m[kMaskGroup];
#pragma unroll
    for (int j = 0; j < kMaskGroup; ++j) {
      const long long i = row0 + static_cast<long long>(j0 + j) * kBlock;
      m[j] = j0 + j < nt && i < f && mask[i] != 0;
    }
#pragma unroll
    for (int j = 0; j < kMaskGroup; ++j) {
      const unsigned ballot = __ballot_sync(kFull, m[j]);
      if (lane == 0 && j0 + j < nt) s_ballot[j0 + j][warp] = ballot;
    }
  }
  __syncthreads();
  // Warp w scans the 32 warp counts of tiles w, w + 32, ...
  for (int j = warp; j < nt; j += kWarps) {
    const int v = __popc(s_ballot[j][lane]);
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += n;
    }
    s_woff[j][lane] = incl - v;
    if (lane == 31) s_cnt[j] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned count = 0;
    for (int j = lane; j < nt; j += 32) count += static_cast<unsigned>(s_cnt[j]);
    count = __reduce_add_sync(kFull, count);
    unsigned excl = 0;
    if (unit > 0) {
      if (lane == 0) store_status(status + unit, tag, false, count);
      excl = look_back(status, unit, lane, tag);
    }
    if (lane == 0) {
      store_status(status + unit, tag, true, excl + count);
      s_excl = excl;
      if (unit == n_chunks - 1) *total_out = static_cast<int>(excl + count);
    }
  }
  __syncthreads();
  // The masked rows, kRowGroup tiles at a time: their payloads loaded
  // together, then written to offset + rank of every destination.
  long long base = s_excl;
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < nt; j0 += kRowGroup) {
    int payload[kRowGroup][kRowPrefetch];
    bool m[kRowGroup];
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) {
      m[j] = j0 + j < nt && ((s_ballot[j0 + j][warp] >> lane) & 1u);
      const int* src = rows + (row0 + static_cast<long long>(j0 + j) * kBlock) * width;
#pragma unroll
      for (int c = 0; c < kRowPrefetch; ++c) payload[j][c] = m[j] && c < width ? src[c] : 0;
    }
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) {
      if (j0 + j >= nt) break;
      if (m[j]) {
        const long long i = row0 + static_cast<long long>(j0 + j) * kBlock;
        const unsigned ballot = s_ballot[j0 + j][warp];
        const long long rank = base + s_woff[j0 + j][warp] + __popc(ballot & below);
        const int* src = rows + i * width;
#pragma unroll
        for (int k = 0; k < kMaxDests; ++k) {
          const long long dst = s_off[k] + rank;
          if (k < dests.n && dst < dests.d[k].capacity) {
            int* o = outs[k] + dst * width;
#pragma unroll
            for (int c = 0; c < kRowPrefetch; ++c) {
              if (c < width) o[c] = payload[j][c];
            }
            for (int c = kRowPrefetch; c < width; ++c) o[c] = src[c];
          }
        }
      }
      base += s_cnt[j0 + j];
    }
  }
}

// The S = 1 schedule, or the stream axis's chunks.  Resident blocks of
// compact_chunks_kernel on the card (once a process; a host query, so a
// graph capture may call it).
int resident_blocks() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_chunks_kernel, kBlock, 0);
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n;
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
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_streams == 1) {
    const int n_grid = n_tiles + n_tail;
    compact_kernel<<<n_grid, kBlock, 0, st>>>(
        static_cast<const int*>(rows), static_cast<const uint8_t*>(mask), f, width, n_tiles,
        n_grid, dests, words, words + 1, static_cast<int*>(total));
    return static_cast<int>(cudaGetLastError());
  }
  // Chunks of equal tiles, as many a stream as one resident wave holds.
  const long long per_stream = resident_blocks() / n_streams;
  long long chunk = per_stream > 0 ? (n_tiles + per_stream - 1) / per_stream : n_tiles;
  chunk = chunk < 1 ? 1 : (chunk > kMaxChunk ? kMaxChunk : chunk);
  const long long n_chunks = (n_tiles + chunk - 1) / chunk;
  if ((n_chunks + n_tail) * n_streams > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_grid = static_cast<int>((n_chunks + n_tail) * n_streams);
  compact_chunks_kernel<<<n_grid, kBlock, 0, st>>>(
      static_cast<const int*>(rows), static_cast<const uint8_t*>(mask), f, width, n_tiles,
      static_cast<int>(chunk), static_cast<int>(n_chunks), static_cast<int>(n_streams), n_tail,
      n_grid, dests, words, words + 1, static_cast<int*>(total));
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
