// K1: frame decode to the masked-row layout, one thread per byte position.
//
// Replaces slam_process_tpu/ops/pallas_decode.py::decode_frames_pallas
// (_decode_kernel) and computes what the production XLA form
// ops/decode.py::decode_rows_jax computes.  Position p is a frame start iff
// b[p] is a flag byte (0xCC / 0x33), the ten following bytes carry the tag
// classes (UE 00, BS 11, CLK x5 01, RSS x3 10) and the whole 11-byte window
// lies below `limit` (= min(n, n_valid)).  By the >= 11-byte spacing theorem
// no two starts share a row p / 11, so each start writes its row
// (FLAG, UE, BS, RSS, CLK) and valid[p / 11] = 1 with no conflicts; the
// caller zeroes the outputs.
//
// Bound on an H100: bytes.  N bytes are read once and ~R * 21 bytes are
// written (R = ceil(N / 11)), about 1.8 MB in and 3.5 MB out for a 160 k
// frame session, ~1.6 us at 3.35 TB/s.  The work decode needs is a flag
// test at every byte, the tag-class tests only where a flag byte sits and
// the assembly only at frame starts, ~15 M integer operations (~0.5 us);
// the kernel runs all eleven tests everywhere, branch-free.  Design: each block stages its 256 bytes plus the
// 10-byte halo in shared memory with coalesced loads, so every byte is read
// from device memory about once; the frame count is one __syncthreads_count
// per block and one integer atomicAdd.  The TPU form's [R, 128] lane layout
// and block-diagonal MXU row reduction were TPU workarounds and are not
// carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kFrame = 11;

__global__ void decode_rows_kernel(const uint8_t* __restrict__ b, long long n,
                                   long long limit, int flag_true, int flag_false,
                                   int* __restrict__ rows, uint8_t* __restrict__ valid,
                                   int* __restrict__ count) {
  __shared__ uint8_t tile[kBlock + kFrame - 1];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  for (int i = threadIdx.x; i < kBlock + kFrame - 1; i += kBlock) {
    const long long q = base + i;
    tile[i] = q < n ? b[q] : 0;
  }
  __syncthreads();

  const long long p = base + threadIdx.x;
  int ok = 0;
  if (p + kFrame <= limit) {
    const uint8_t* w = tile + threadIdx.x;
    ok = (w[0] == flag_true) | (w[0] == flag_false);
    ok &= (w[1] >> 6) == 0;    // UE
    ok &= (w[2] >> 6) == 3;    // BS
    ok &= (w[3] >> 6) == 1;    // CLK limbs
    ok &= (w[4] >> 6) == 1;
    ok &= (w[5] >> 6) == 1;
    ok &= (w[6] >> 6) == 1;
    ok &= (w[7] >> 6) == 1;
    ok &= (w[8] >> 6) == 2;    // RSS limbs
    ok &= (w[9] >> 6) == 2;
    ok &= (w[10] >> 6) == 2;
    if (ok) {
      const int clk = (w[3] & 0x3F) | ((w[4] & 0x3F) << 6) | ((w[5] & 0x3F) << 12) |
                      ((w[6] & 0x3F) << 18) | ((w[7] & 0x3F) << 24);
      const int rss = (w[8] & 0x3F) | ((w[9] & 0x3F) << 6) | ((w[10] & 0x3F) << 12);
      const long long r = p / kFrame;
      int* row = rows + r * 5;
      row[0] = w[0] == flag_true;
      row[1] = w[1] & 0x3F;
      row[2] = w[2] & 0x3F;
      row[3] = rss;
      row[4] = clk;
      valid[r] = 1;
    }
  }
  const int block_count = __syncthreads_count(ok);
  if (threadIdx.x == 0 && block_count > 0) atomicAdd(count, block_count);
}

}  // namespace

// rows [R, 5] int32, valid [R] uint8 and count [1] int32 must be zeroed by
// the caller; R = ceil(n / 11).  Returns cudaGetLastError() after the launch.
extern "C" int slam_decode_rows(const void* b, long long n, long long limit,
                                int flag_true, int flag_false, void* rows, void* valid,
                                void* count, void* stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  decode_rows_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), n, limit, flag_true, flag_false,
      static_cast<int*>(rows), static_cast<uint8_t*>(valid), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
