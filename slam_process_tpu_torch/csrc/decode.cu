// K1: frame decode to the masked-row layout, one thread per output row and
// one launch per call.
//
// Replaces slam_process_tpu/ops/pallas_decode.py::decode_frames_pallas
// (_decode_kernel) and computes what the production XLA form
// ops/decode.py::decode_rows_jax computes.  Position p is a frame start iff
// b[p] is a flag byte (0xCC / 0x33), the ten following bytes carry the tag
// classes (UE 00, BS 11, CLK x5 01, RSS x3 10) and the whole 11-byte window
// lies below `limit` (= min(n, n_valid)).  By the >= 11-byte spacing theorem
// the row [11 r, 11 r + 11) holds at most one start: rows[r] is its
// (FLAG, UE, BS, RSS, CLK) or zeros, valid[r] says whether there is one, and
// count is the number of starts.  (Were the flags set so that two starts
// shared a row, the row would hold their fields' int32 sum, as the plain
// version's masked row sum does.)
//
// Bound on an H100: bytes.  N bytes are read once and R = ceil(N / 11) rows
// of 20 B, R valid bytes and the count are written: N + 21 R + 4 bytes, 5.34
// MB and 1.59 us at the full session's 1,835,008 padded bytes, 0.057 us at
// a 64 KiB stream window.  The operations the function needs (a flag test at every byte, the
// tag tests where a flag byte sits, the assembly at the starts) stay under
// that.  So a call's floor is the launch and one round trip to device memory
// each way, and the design is one launch per call with nothing else around
// it:
//   * a block of kRows threads owns kRows consecutive rows; it stages their
//     byte span [11 r0, 11 r0 + 11 kRows + 10) in shared memory with 16-byte
//     loads (single bytes where b is not 16-byte aligned), zeros past n;
//   * thread r reads its row's 21 bytes (its 11 positions and the 10 after)
//     as six 32-bit words, finds the flag bytes four at a time (__vcmpeq4),
//     and for each flag position cuts the 11-byte window out of those words
//     in registers: three masked compares test the tag classes, shifts and
//     masks assemble the row;
//   * every row is written, zeros where no frame starts, so the wrapper's
//     outputs come from torch.empty: the block's rows go out through shared
//     memory as 16-byte stores, valid as contiguous bytes;
//   * the count: each block adds (1 << 32) + its count to one 64-bit word
//     of a per-(device, stream) scratch; the block whose add finds every
//     other block done writes the total and sets the word back to 0, so the
//     scratch needs no reset launch and no host state.  The atomic goes out
//     before the block's row stores and is read after them.  One atomic per
//     kRows rows: 652 at the full session.
// A block per 256 bytes (an empty kernel on that grid takes 6.1 us at the
// full session) and three fills before the launch (5.8 us at a 64 KiB
// window) cost more than the whole kernel does now
// (tools/diag_torch_k1_phases.py).
// The TPU form's [R, 128] lane layout and block-diagonal MXU row reduction
// were TPU workarounds and are not carried over.
//
// The stream axis (slam_decode_rows_streams): S byte streams of one width n
// side by side, [S, n], each with its own limit, decode in one launch whose
// grid's y dimension is the stream.  Stream s reads bytes [s n, s n + n),
// writes rows [s R, s R + R), its valid bytes and count[s], and keeps its
// own ticket word, so its blocks meet only each other.  The single-stream
// entry is the case S = 1.  A batch of sessions and a round of S live
// streams decode in one launch instead of S.  A block whose rows lie
// wholly past its stream's limit (none of its windows can end by the
// limit) neither stages nor tests its bytes: it writes its zero rows and
// its count, 0.  In the 19 streams' first 1 MiB round 41 % of the blocks
// are such (each stream is shorter than its window).  One schedule serves
// every size: on an H100, persistent blocks (a ring of tiles staged with
// cp.async a block or a warp, or a strided walk with a register prefetch)
// saved the ~6 us of launching 7,087 blocks but lost more in their loads
// and tests, and were slower than a block per tile at the batch's
// 19 x 786,432 bytes (tools/torch_kernel_ab.py; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;                     // rows (and threads) per block
constexpr int kFrame = 11;
constexpr int kVecs = kFrame * kRows / 16 + 1;   // staged 16-byte words: the span and the halo
static_assert(kFrame * kRows % 16 == 0, "a block's byte span must start 16-byte aligned");

// One bit per byte of x that equals a flag, byte k at bit k (the multiply
// gathers the four byte flags into bits 21-24 with no carries).
__device__ __forceinline__ unsigned flags4(unsigned x, unsigned ft4, unsigned ff4) {
  const unsigned m = (__vcmpeq4(x, ft4) | __vcmpeq4(x, ff4)) & 0x01010101u;
  return ((m * 0x00204081u) >> 21) & 0xFu;
}

__global__ void __launch_bounds__(kRows) decode_rows_kernel(
    const uint8_t* __restrict__ b, long long n, long long limit,
    const long long* __restrict__ limits, int flag_true, int flag_false, long long n_rows,
    int* __restrict__ rows, uint8_t* __restrict__ valid, int* __restrict__ count,
    unsigned long long* __restrict__ ticket) {
  __shared__ uint4 s_vec[kVecs];
  __shared__ __align__(16) int s_rows[kRows * 5];
  __shared__ int s_warp[kRows / 32];
  const int tid = threadIdx.x;
  // This block's stream: its bytes, rows, count and ticket word.
  const long long st = blockIdx.y;
  b += st * n;
  rows += st * n_rows * 5;
  valid += st * n_rows;
  count += st;
  ticket += st;
  if (limits != nullptr) limit = limits[st] < n ? limits[st] : n;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long base = r0 * kFrame;
  // No window of the block's rows can end by the limit: nothing to stage or test.
  const bool skip = limit - r0 * kFrame - kFrame < 0;

  // Stage the block's bytes.
  const bool aligned = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  for (int i = tid; i < (skip ? 0 : kVecs); i += kRows) {
    const long long g = base + 16LL * i;
    uint4 v;
    if (aligned && g + 16 <= n) {
      v = *reinterpret_cast<const uint4*>(b + g);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      for (int k = 0; k < 16; ++k) {
        if (g + k < n) w[k >> 2] |= static_cast<unsigned>(b[g + k]) << (8 * (k & 3));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    s_vec[i] = v;
  }
  __syncthreads();

  // This thread's row: its 21 bytes as words a[0..5] (a[5]: byte 20 only).
  const long long r = r0 + tid;
  unsigned f[5] = {0u, 0u, 0u, 0u, 0u};
  int found = 0;
  if (!skip) {
    const int off = kFrame * tid;
    const unsigned* s_words = reinterpret_cast<const unsigned*>(s_vec);
    const int k0 = off >> 2;
    const unsigned sh = 8u * (off & 3);
    unsigned a[6];
#pragma unroll
    for (int i = 0; i < 5; ++i) a[i] = __funnelshift_r(s_words[k0 + i], s_words[k0 + i + 1], sh);
    a[5] = s_words[k0 + 5] >> sh;
    const unsigned ft4 = static_cast<unsigned>(flag_true) * 0x01010101u;
    const unsigned ff4 = static_cast<unsigned>(flag_false) * 0x01010101u;
    unsigned cand = flags4(a[0], ft4, ff4) | (flags4(a[1], ft4, ff4) << 4) |
                    (flags4(a[2], ft4, ff4) << 8);
    // Position 11 r + q starts a frame only if its window ends at or below limit.
    const long long room = limit - r * kFrame - kFrame;    // the largest q allowed
    cand &= room < 0 ? 0u : (room >= kFrame - 1 ? 0x7FFu : (2u << room) - 1u);

    while (cand) {
      const int q = __ffs(cand) - 1;
      cand &= cand - 1;
      // Bytes q..q+11 of the row as x0, x1, x2 (x2's top byte unused).
      const int k = q >> 2;
      const unsigned s = 8u * (q & 3);
      const unsigned y0 = k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
      const unsigned y1 = k == 0 ? a[1] : (k == 1 ? a[2] : a[3]);
      const unsigned y2 = k == 0 ? a[2] : (k == 1 ? a[3] : a[4]);
      const unsigned y3 = k == 0 ? a[3] : (k == 1 ? a[4] : a[5]);
      const unsigned x0 = __funnelshift_r(y0, y1, s);
      const unsigned x1 = __funnelshift_r(y1, y2, s);
      const unsigned x2 = __funnelshift_r(y2, y3, s);
      // Tag classes (top two bits): UE 00, BS 11, CLK 01 x5, RSS 10 x3.
      if ((x0 & 0xC0C0C000u) != 0x40C00000u || (x1 & 0xC0C0C0C0u) != 0x40404040u ||
          (x2 & 0x00C0C0C0u) != 0x00808080u) {
        continue;
      }
      f[0] += (x0 & 0xFFu) == static_cast<unsigned>(flag_true);
      f[1] += (x0 >> 8) & 0x3Fu;
      f[2] += (x0 >> 16) & 0x3Fu;
      f[3] += (x2 & 0x3Fu) | ((x2 >> 2) & 0xFC0u) | ((x2 >> 4) & 0x3F000u);
      f[4] += ((x0 >> 24) & 0x3Fu) | ((x1 & 0x3Fu) << 6) | ((x1 << 4) & 0x3F000u) |
              ((x1 << 2) & 0xFC0000u) | (x1 & 0x3F000000u);
      ++found;
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) s_rows[5 * tid + c] = static_cast<int>(f[c]);
  if (r < n_rows) valid[r] = found > 0;

  // The block's count, then the call's.
  int warp_sum = __reduce_add_sync(0xffffffffu, found);
  if ((tid & 31) == 0) s_warp[tid >> 5] = warp_sum;
  __syncthreads();
  // The ticket's atomic goes out before the row stores and its answer is
  // read after them, so its round trip overlaps the stores.
  unsigned block_count = 0;
  unsigned long long old = 0;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < kRows / 32; ++w) block_count += static_cast<unsigned>(s_warp[w]);
    old = atomicAdd(ticket, (1ull << 32) + block_count);
  }

  // The block's rows, 16 bytes a store where the block is whole.
  const long long nr = n_rows - r0 < kRows ? n_rows - r0 : kRows;
  if (nr == kRows && (reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
    uint4* dst = reinterpret_cast<uint4*>(rows + r0 * 5);
    const uint4* src = reinterpret_cast<const uint4*>(s_rows);
    for (int i = tid; i < kRows * 5 / 4; i += kRows) dst[i] = src[i];
  } else {
    for (long long i = tid; i < nr * 5; i += kRows) rows[r0 * 5 + i] = s_rows[i];
  }
  if (tid == 0 && static_cast<unsigned>(old >> 32) == gridDim.x - 1) {
    *count = static_cast<int>(static_cast<unsigned>(old) + block_count);
    atomicExch(ticket, 0ull);
  }
}

void launch(const void* b, long long n_streams, long long n, long long limit,
            const void* limits, int flag_true, int flag_false, void* rows, void* valid,
            void* count, void* ticket, void* stream) {
  const long long n_rows = (n + kFrame - 1) / kFrame;
  const long long blocks = n_rows > 0 ? (n_rows + kRows - 1) / kRows : 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_streams));
  decode_rows_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), n, limit < n ? limit : n,
      static_cast<const long long*>(limits), flag_true, flag_false, n_rows,
      static_cast<int*>(rows), static_cast<uint8_t*>(valid), static_cast<int*>(count),
      static_cast<unsigned long long*>(ticket));
}

bool bad_flags(int flag_true, int flag_false) {
  return flag_true < 0 || flag_true > 0xFF || flag_false < 0 || flag_false > 0xFF;
}

}  // namespace

// b: uint8 [n]; flags: byte values; rows int32 [R, 5] (16-byte aligned), valid uint8 [R] and
// count int32 [1] need no initial value, R = ceil(n / 11); ticket: an 8-byte
// scratch word, zero when first used (a call leaves it zero for the next on
// the same stream).  One launch, also for n = 0.  Returns cudaGetLastError()
// after it.
extern "C" int slam_decode_rows(const void* b, long long n, long long limit, int flag_true,
                                int flag_false, void* rows, void* valid, void* count,
                                void* ticket, void* stream) {
  if (n < 0 || (reinterpret_cast<uintptr_t>(rows) & 15) != 0 || bad_flags(flag_true, flag_false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch(b, 1, n, limit, nullptr, flag_true, flag_false, rows, valid, count, ticket, stream);
  return static_cast<int>(cudaGetLastError());
}

// The stream axis: b uint8 [S, n]; limits int64 [S] on the device, or null for
// n each; rows int32 [S, R, 5], valid uint8 [S, R], count int32 [S]; tickets:
// S 8-byte scratch words under the single-stream contract.  1 <= S <= 65,535.
// One launch.  Returns cudaGetLastError() after it.
extern "C" int slam_decode_rows_streams(const void* b, long long n_streams, long long n,
                                        const void* limits, int flag_true, int flag_false,
                                        void* rows, void* valid, void* count, void* tickets,
                                        void* stream) {
  if (n < 0 || n_streams < 1 || n_streams > 65535 || bad_flags(flag_true, flag_false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch(b, n_streams, n, n, limits, flag_true, flag_false, rows, valid, count, tickets, stream);
  return static_cast<int>(cudaGetLastError());
}
