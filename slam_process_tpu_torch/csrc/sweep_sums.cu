// K4: per-sweep intensity (sums, counts) [S, n_beams, n_beams] from row
// streams, one thread per row, by integer atomics.
//
// Replaces slam_process_tpu/ops/pallas_sweep_sums.py::sweep_sums_pallas
// (_kernel and _kernel_local, with _call_auto's full-width rerun on a
// spill).  Inputs are three int32 [F] streams: p = gid * n_beams + ue, or
// -1 for a dropped row; bs; val = the integer RSS (< 2^18 on the wire).  A
// row counts iff 0 <= p < S * n_beams and 0 <= bs < n_beams (the Pallas
// kernel's one-hots match nothing otherwise).  Each kept row adds val to an
// int64 cell sum (atomicAdd on unsigned long long: two's-complement wrap
// gives int64 addition bit for bit) and 1 to an unsigned cell count; a
// second kernel converts both to float32.  Integer atomics are exact and
// independent of their order, so the result is the same from run to run
// and equal to the plain version's int64 index_add_.  The float32 values
// are exact while a cell's sum is below 2^24, the JAX kernel's own bound
// (pallas_sweep_sums.py:20-25); both packages lose exactness past it.
//
// Bound on an H100: bytes.  12 B per row read, the S * n^2 * 12 B scratch
// zeroed and updated, S * n^2 * 8 B of float32 written; the two atomics per
// kept row resolve in L2.  The TPU form built a (sweep x UE) one-hot in
// VMEM and contracted it on the MXU against the BS one-hot times RSS in
// 8-bit bf16 limbs, because scatters serialize there; on Hopper the scatter
// is the natural form and there is no width limit (the TPU's 4224-column
// VMEM bound does not apply).  Every production caller feeds a stream
// sorted by p, so each block's rows span few sweeps: a shared-memory window
// per block over those sweeps, flushed once to global memory, is the later
// fast design; this kernel is the simple form.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void sweep_sums_scatter(const int* __restrict__ p, const int* __restrict__ bs,
                                   const int* __restrict__ val, long long f, long long width,
                                   int n_beams, unsigned long long* __restrict__ sums,
                                   unsigned int* __restrict__ counts) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= f) return;
  const int pi = p[i];
  const int b = bs[i];
  if (pi < 0 || pi >= width || b < 0 || b >= n_beams) return;
  const long long cell = static_cast<long long>(pi) * n_beams + b;
  atomicAdd(sums + cell, static_cast<unsigned long long>(static_cast<long long>(val[i])));
  atomicAdd(counts + cell, 1u);
}

__global__ void sweep_sums_to_f32(const unsigned long long* __restrict__ sums,
                                  const unsigned int* __restrict__ counts, long long n,
                                  float* __restrict__ out_sums, float* __restrict__ out_counts) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  out_sums[i] = static_cast<float>(static_cast<long long>(sums[i]));
  out_counts[i] = static_cast<float>(counts[i]);
}

}  // namespace

// p, bs, val: int32 [f]; sums (int64) and counts (int32) scratch of
// n_sweeps * n_beams^2 cells must be zeroed by the caller; out_sums and
// out_counts are float32 of the same cell count.  Returns
// cudaGetLastError() after the launches.
extern "C" int slam_sweep_sums(const void* p, const void* bs, const void* val, long long f,
                               int n_sweeps, int n_beams, void* sums, void* counts,
                               void* out_sums, void* out_counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long width = static_cast<long long>(n_sweeps) * n_beams;
  const long long cells = width * n_beams;
  if (f > 0) {
    sweep_sums_scatter<<<static_cast<unsigned>((f + kBlock - 1) / kBlock), kBlock, 0, s>>>(
        static_cast<const int*>(p), static_cast<const int*>(bs), static_cast<const int*>(val),
        f, width, n_beams, static_cast<unsigned long long*>(sums),
        static_cast<unsigned int*>(counts));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (cells > 0) {
    sweep_sums_to_f32<<<static_cast<unsigned>((cells + kBlock - 1) / kBlock), kBlock, 0, s>>>(
        static_cast<const unsigned long long*>(sums), static_cast<const unsigned int*>(counts),
        cells, static_cast<float*>(out_sums), static_cast<float*>(out_counts));
  }
  return static_cast<int>(cudaGetLastError());
}
