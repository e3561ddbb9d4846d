// K6: the streaming tracker block, greedy global-nearest-neighbour
// association over the s1 sweep lanes one streaming window closed.
//
// Replaces slam_process_tpu/ops/pallas_tracker.py::track_block_pallas
// (_kernel).  Per lane i (in order): the carry's T tracks against the
// lane's K paths; K assignment rounds, each taking the smallest masked
// cost (pa - a)^2 + (pd - d)^2 over (created & unassigned track, valid &
// unused path), the lowest flat index t * K + k on a tie, accepted iff
// cost <= gate2; then leftover valid paths open tracks in path order while
// count < T.  Lanes at or past min(m_eff, s1) run with every path invalid,
// a carry no-op.  The output is the four [s1, T] column blocks (positions
// after the lane's update, matched power, observed) and the new carry.
// Contract: equal bit for bit to models/tracking.track_sweep_step_np lane
// by lane, and to the plain version ops/tracker.py::track_block_plain.
//
// Exactness: nvcc contracts a * a + b * b into an FMA by default, which
// rounds once where numpy rounds twice and flips near-ties of the gate
// and of the argmin; the cost is written with __fsub_rn / __fmul_rn /
// __fadd_rn in the oracle's order.  The argmin reduces on the pair (cost,
// flat index) packed into one 64-bit key: a non-negative float's bits are
// monotone as an unsigned integer, and the flat index in the low half
// makes the lowest index win a tie.  A NaN cost takes the smallest key, as
// np.argmin returns the first NaN, and then fails the gate.
//
// Bound on an H100: bytes, ~13 B per (lane, path) read and ~13 B per
// (lane, track) written, about 11.5 KB at s1 = 65, K = 3, T = 8: a few ns.
// In practice the launch and the lanes' serial dependence through the
// carry are the floor.  Design: the TPU kernel ran a sequential grid over
// the lanes with the carry in VMEM / SMEM scratch; here one block walks
// the lanes in a loop with the carry in shared memory.  One thread holds
// one (track, path) pair (T * K <= 320, at most ten warps); each round is
// a warp-shuffle min of the keys, then a min over the warps' results by
// thread 0, which applies the assignment.  The cost matrix is static
// within a lane: a matched track is masked out in the round that moves it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 16;
constexpr int kMaxK = 20;
constexpr int kMaxWarps = (kMaxT * kMaxK + 31) / 32;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__global__ void track_block_kernel(const float* __restrict__ aoa, const float* __restrict__ aod,
                                   const float* __restrict__ pw, const uint8_t* __restrict__ val,
                                   const int* __restrict__ m_eff,
                                   const float* __restrict__ pos_in,
                                   const uint8_t* __restrict__ created_in,
                                   const int* __restrict__ count_in, int s1, int k_n, int t_n,
                                   float gate2, float* __restrict__ c_aoa,
                                   float* __restrict__ c_aod, float* __restrict__ c_pow,
                                   uint8_t* __restrict__ c_obs, float* __restrict__ pos_out,
                                   uint8_t* __restrict__ created_out, int* __restrict__ count_out) {
  __shared__ float pa[kMaxT], pd[kMaxT], opow[kMaxT];
  __shared__ int created[kMaxT], assigned[kMaxT], obs[kMaxT];
  __shared__ float qa[kMaxK], qd[kMaxK], qp[kMaxK];
  __shared__ int qv[kMaxK], used[kMaxK];
  __shared__ unsigned long long warp_best[kMaxWarps];
  __shared__ int count, stop;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int pairs = t_n * k_n;
  const int t = tid / k_n;
  const int k = tid % k_n;
  const int live = max(0, min(*m_eff, s1));

  if (tid < t_n) {
    pa[tid] = pos_in[2 * tid];
    pd[tid] = pos_in[2 * tid + 1];
    created[tid] = created_in[tid] != 0;
  }
  if (tid == 0) count = *count_in;

  for (int i = 0; i < s1; ++i) {
    if (tid < k_n) {
      const long long q = static_cast<long long>(i) * k_n + tid;
      qa[tid] = aoa[q];
      qd[tid] = aod[q];
      qp[tid] = pw[q];
      qv[tid] = i < live && val[q] != 0;
      used[tid] = 0;
    }
    if (tid < t_n) {
      assigned[tid] = 0;
      obs[tid] = 0;
      opow[tid] = 0.0f;
    }
    __syncthreads();

    float cost = 0.0f;
    if (tid < pairs) {
      const float da = __fsub_rn(pa[t], qa[k]);
      const float dd = __fsub_rn(pd[t], qd[k]);
      cost = __fadd_rn(__fmul_rn(da, da), __fmul_rn(dd, dd));
    }
    const unsigned cost_key = isnan(cost) ? 0u : __float_as_uint(cost) + 1u;
    for (int round = 0; round < k_n; ++round) {
      unsigned long long key = kNone;
      if (tid < pairs && created[t] && !assigned[t] && qv[k] && !used[k]) {
        key = (static_cast<unsigned long long>(cost_key) << 32) | static_cast<unsigned>(tid);
      }
      key = warp_min(key);
      if (lane == 0) warp_best[warp] = key;
      __syncthreads();
      if (tid == 0) {
        unsigned long long best = warp_best[0];
        for (int w = 1; w < n_warps; ++w) best = warp_best[w] < best ? warp_best[w] : best;
        stop = 1;
        const unsigned hi = static_cast<unsigned>(best >> 32);
        if (best != kNone && hi != 0u && __uint_as_float(hi - 1u) <= gate2) {
          const int flat = static_cast<int>(best & 0xffffffffull);
          const int bt = flat / k_n;
          const int bk = flat % k_n;
          assigned[bt] = 1;
          used[bk] = 1;
          pa[bt] = qa[bk];
          pd[bt] = qd[bk];
          obs[bt] = 1;
          opow[bt] = qp[bk];
          stop = 0;
        }
      }
      __syncthreads();
      if (stop) break;
    }

    if (tid == 0) {
      int c = count;
      for (int kk = 0; kk < k_n; ++kk) {
        if (qv[kk] && !used[kk] && c < t_n) {
          pa[c] = qa[kk];
          pd[c] = qd[kk];
          created[c] = 1;
          obs[c] = 1;
          opow[c] = qp[kk];
          ++c;
        }
      }
      count = c;
    }
    __syncthreads();
    if (tid < t_n) {
      const long long o = static_cast<long long>(i) * t_n + tid;
      c_aoa[o] = pa[tid];
      c_aod[o] = pd[tid];
      c_pow[o] = opow[tid];
      c_obs[o] = static_cast<uint8_t>(obs[tid]);
    }
    __syncthreads();
  }

  if (tid < t_n) {
    pos_out[2 * tid] = pa[tid];
    pos_out[2 * tid + 1] = pd[tid];
    created_out[tid] = static_cast<uint8_t>(created[tid]);
  }
  if (tid == 0) *count_out = count;
}

}  // namespace

// aoa, aod, pw: float32 [s1, k_n]; val: bool [s1, k_n]; m_eff, count_in:
// int32 scalars on the device; pos_in: float32 [t_n, 2]; created_in: bool
// [t_n]; outputs c_* [s1, t_n], pos_out, created_out, count_out.  1 <= t_n
// <= 16, 1 <= k_n <= 20.  Returns cudaGetLastError() after the launch.
extern "C" int slam_track_block(const void* aoa, const void* aod, const void* pw,
                                const void* val, const void* m_eff, const void* pos_in,
                                const void* created_in, const void* count_in, int s1, int k_n,
                                int t_n, float gate2, void* c_aoa, void* c_aod, void* c_pow,
                                void* c_obs, void* pos_out, void* created_out, void* count_out,
                                void* stream) {
  if (t_n < 1 || t_n > kMaxT || k_n < 1 || k_n > kMaxK || s1 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = ((t_n * k_n + 31) / 32) * 32;
  track_block_kernel<<<1, threads, 0, s>>>(
      static_cast<const float*>(aoa), static_cast<const float*>(aod),
      static_cast<const float*>(pw), static_cast<const uint8_t*>(val),
      static_cast<const int*>(m_eff), static_cast<const float*>(pos_in),
      static_cast<const uint8_t*>(created_in), static_cast<const int*>(count_in), s1, k_n, t_n,
      gate2, static_cast<float*>(c_aoa), static_cast<float*>(c_aod), static_cast<float*>(c_pow),
      static_cast<uint8_t*>(c_obs), static_cast<float*>(pos_out),
      static_cast<uint8_t*>(created_out), static_cast<int*>(count_out));
  return static_cast<int>(cudaGetLastError());
}
