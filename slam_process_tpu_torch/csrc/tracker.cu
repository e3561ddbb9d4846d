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
// __fadd_rn in the oracle's order.  The argmin takes the smallest cost key
// and then the smallest flat index among the pairs that hold it: a
// non-negative float's bits are monotone as an unsigned integer, so the
// key is bits + 1, and a NaN cost takes key 0, the smallest, as np.argmin
// returns the first NaN, and then fails the gate.  gate2 = f32(gate)^2 is
// rounded by the wrapper as the oracle rounds it.
//
// Bound on an H100: not bytes (~13 B per live (lane, path) read and per
// (lane, track) written, about 8 KB at s1 = 65, 33 live, K = 3, T = 8: a
// few ns) and not operations, but the lanes' serial dependence through the
// carry: the live lanes of the slowest stream times the latency of one
// lane, plus the launch.  So the design keeps on the chain only what
// depends on the carry.  One warp carries the whole chain, for every legal
// shape (T <= 16, K <= 20): thread l holds the (track, path) pairs l, l +
// 32, ... (at most ten), each with its own copy of its track's position
// and the lane's path, and thread t < T holds track t (position, matched
// power, observed).  The assigned / used / created / valid sets are 32-bit
// masks that every thread keeps alike.  Per lane:
//   * costs: each pair's cost from registers alone (no shuffle, no load);
//   * rounds: a thread-local min over its pairs and two warp reductions
//     (__reduce_min_sync: the cost key, then (t << 5 | k) among the threads
//     that hold it, which orders as the flat index t * K + k does), so every
//     thread knows the winner (t, k) and notes it in its own state; a pair
//     past the gate is keyed out when its cost is taken, so no round tests
//     the gate;
//   * when track t moves to path k (a round's winner, or a leftover path
//     opening track count + r: the r-th free path, the oracle's order),
//     each pair of track t loads its new position and thread t loads the
//     path (one 16-byte shared load) right then, so the loads land under
//     the rounds that follow; then the columns go out.
// The cost matrix is static within a lane (a matched track is masked out in
// the round that moves it), so each lane costs its pairs once, and a
// track's new position is needed only by the next lane.  The carry-free
// work is off the chain: the other warps of the block stage the live
// lanes a tile ahead (two buffers; a __syncthreads separates one tile's
// chain from the next tile's staging) as one float4 (aoa, aod, power) per
// (lane, path) and the lane's valid paths as one mask word, and the chain
// loads lane i + 1's mask and its pairs' paths into registers while lane
// i's rounds run.  s1 may be any length.  The chain stops at the last live
// lane; once the carry is final, the whole block writes the dead lanes
// [live, s1) in one parallel pass.
//
// The stream axis (slam_track_block_streams): S independent blocks of s1
// lanes, [S, s1, K] inputs, m_eff [S], carries [S, T, 2] / [S, T] / [S], and
// [S, s1, T] columns, in one launch of S blocks: block s runs stream s's
// chain on its own warp with its own staging, as above.  The streams share
// nothing, so their chains run side by side on S SMs.  The single-stream
// entry is the case S = 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 16;
constexpr int kMaxK = 20;
constexpr int kThreads = 256;     // warp 0: the chain; warps 1-7 stage the next tile
constexpr int kSlots = 1024;      // (lane, path) slots in one staging buffer
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

struct Staged {
  float4 q[2][kSlots];            // (aoa, aod, power, 0) per (lane, path)
  unsigned m[2][kSlots];          // per lane: bit k set iff path k is valid
};

// The position of the r-th (from 0) set bit of m, which has more than r:
// a binary search by population counts (__fns takes ~260 cycles on an
// H100, tools/warp_op_latency.py).
__device__ __forceinline__ int nth_set_bit(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// Lanes [l0, l0 + n_lanes) of the block's stream into buffer `buf`.
__device__ __forceinline__ void stage(Staged& s, int buf, const float* __restrict__ aoa,
                                      const float* __restrict__ aod,
                                      const float* __restrict__ pw,
                                      const uint8_t* __restrict__ val, long long l0,
                                      int n_lanes, int k_n, int tid, int n_threads) {
  const long long q0 = l0 * k_n;
  for (int j = tid; j < n_lanes * k_n; j += n_threads) {
    s.q[buf][j] = make_float4(__ldg(aoa + q0 + j), __ldg(aod + q0 + j), __ldg(pw + q0 + j), 0.0f);
  }
  for (int l = tid; l < n_lanes; l += n_threads) {
    unsigned m = 0;
    for (int k = 0; k < k_n; ++k) m |= (__ldg(val + q0 + l * k_n + k) != 0 ? 1u : 0u) << k;
    s.m[buf][l] = m;
  }
}

// P: (track, path) pairs per thread, ceil(T * K / 32).
template <int P>
__global__ void __launch_bounds__(kThreads) track_block_kernel(
    const float* __restrict__ aoa, const float* __restrict__ aod, const float* __restrict__ pw,
    const uint8_t* __restrict__ val, const int* __restrict__ m_eff,
    const float* __restrict__ pos_in, const uint8_t* __restrict__ created_in,
    const int* __restrict__ count_in, int s1, int k_n, int t_n, float gate2,
    float* __restrict__ c_aoa, float* __restrict__ c_aod, float* __restrict__ c_pow,
    uint8_t* __restrict__ c_obs, float* __restrict__ pos_out, uint8_t* __restrict__ created_out,
    int* __restrict__ count_out) {
  __shared__ Staged st;
  __shared__ float fin_a[kMaxT], fin_d[kMaxT];

  // This block's stream: its lanes, carry and columns.
  const long long sn = blockIdx.x;
  const long long lane_elems = static_cast<long long>(s1) * k_n;
  const long long col_elems = static_cast<long long>(s1) * t_n;
  aoa += sn * lane_elems;
  aod += sn * lane_elems;
  pw += sn * lane_elems;
  val += sn * lane_elems;
  m_eff += sn;
  pos_in += sn * 2 * t_n;
  created_in += sn * t_n;
  count_in += sn;
  c_aoa += sn * col_elems;
  c_aod += sn * col_elems;
  c_pow += sn * col_elems;
  c_obs += sn * col_elems;
  pos_out += sn * 2 * t_n;
  created_out += sn * t_n;
  count_out += sn;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int live = max(0, min(*m_eff, s1));
  const int tile_lanes = kSlots / k_n;
  const int n_tiles = (live + tile_lanes - 1) / tile_lanes;

  // The chain's state (warp 0): track `lane`, and this thread's pairs with
  // their tracks' positions.
  float my_a = 0.0f, my_d = 0.0f;
  unsigned created = 0;
  int count = 0;
  int pt[P], pk[P];
  unsigned tk[P];
  float pa[P], pd[P];
  if (warp == 0) {
    if (lane < t_n) {
      my_a = pos_in[2 * lane];
      my_d = pos_in[2 * lane + 1];
    }
    created = __ballot_sync(kFull, lane < t_n && created_in[lane] != 0);
    count = *count_in;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int f = lane + 32 * j;
      pt[j] = f < t_n * k_n ? f / k_n : -1;
      pk[j] = f < t_n * k_n ? f - (f / k_n) * k_n : 0;
      tk[j] = pt[j] < 0 ? kNone : (static_cast<unsigned>(pt[j]) << 5) | pk[j];
      pa[j] = pt[j] < 0 ? 0.0f : pos_in[2 * pt[j]];
      pd[j] = pt[j] < 0 ? 0.0f : pos_in[2 * pt[j] + 1];
    }
  }

  if (n_tiles > 0) stage(st, 0, aoa, aod, pw, val, 0, min(live, tile_lanes), k_n, tid, kThreads);
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    const int i0 = tile * tile_lanes;
    const int i1 = min(live, i0 + tile_lanes);
    if (warp == 0) {
      const float4* q = st.q[buf];
      // Lane i0's valid mask and this thread's pairs' paths.
      unsigned vm = st.m[buf][0];
      float qa[P], qd[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(q + pk[j]);
        qa[j] = v.x;
        qd[j] = v.y;
      }
      for (int i = i0; i < i1; ++i) {
        const int li = i - i0;
        const float4* ql = q + li * k_n;
        unsigned key[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float da = __fsub_rn(pa[j], qa[j]);
          const float dd = __fsub_rn(pd[j], qd[j]);
          const float cost = __fadd_rn(__fmul_rn(da, da), __fmul_rn(dd, dd));
          // A pair past the gate can never be taken, and it is the smallest
          // free pair only when every free pair is past the gate: it takes
          // kNone, so a round that finds kNone ends the lane's rounds.
          key[j] = pt[j] < 0 ? kNone
                             : (isnan(cost) ? 0u
                                            : (cost <= gate2 ? __float_as_uint(cost) + 1u : kNone));
        }
        // Lane i + 1's mask and paths, loaded while this lane's rounds run.
        const bool more = i + 1 < i1;
        const unsigned vm_next = more ? st.m[buf][li + 1] : 0u;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (more) {
            const float2 v = *reinterpret_cast<const float2*>(ql + k_n + pk[j]);
            qa[j] = v.x;
            qd[j] = v.y;
          }
        }

        unsigned free_k = vm;        // valid & unused
        unsigned free_t = created;   // & unassigned
        float my_p = 0.0f;           // track `lane`'s matched power this lane
        bool my_o = false;           // and whether it was observed
        while (free_t != 0u && free_k != 0u) {
          unsigned best = kNone, best_tk = kNone;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            if (pt[j] >= 0 && ((free_t >> pt[j]) & 1u) && ((free_k >> pk[j]) & 1u) &&
                key[j] < best) {
              best = key[j];
              best_tk = tk[j];
            }
          }
          const unsigned g = __reduce_min_sync(kFull, best);
          if (g - 1u >= kNone - 1u) break;   // kNone: none passes the gate; 0: a NaN cost first
          const unsigned w = __reduce_min_sync(kFull, best == g ? best_tk : kNone);
          const int bt = static_cast<int>(w >> 5);
          const int bk = static_cast<int>(w & 31u);
          // Track bt moves to path bk: its pairs and its owner load the path
          // now, and the loads land under the rounds that follow.
#pragma unroll
          for (int j = 0; j < P; ++j) {
            if (pt[j] == bt) {
              const float2 v = *reinterpret_cast<const float2*>(ql + bk);
              pa[j] = v.x;
              pd[j] = v.y;
            }
          }
          if (lane == bt) {
            const float4 v = ql[bk];
            my_a = v.x;
            my_d = v.y;
            my_p = v.z;
            my_o = true;
          }
          free_t &= ~(1u << bt);
          free_k &= ~(1u << bk);
        }

        // Leftover valid paths open tracks count, count + 1, ... in path
        // order: track count + r takes the r-th free path.
        const int n_new = count >= 0 ? min(__popc(free_k), max(t_n - count, 0)) : 0;
        if (n_new > 0) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const int r = pt[j] - count;
            if (r >= 0 && r < n_new) {
              const float2 v = *reinterpret_cast<const float2*>(ql + nth_set_bit(free_k, r));
              pa[j] = v.x;
              pd[j] = v.y;
            }
          }
          const int r = lane - count;
          if (r >= 0 && r < n_new) {
            const float4 v = ql[nth_set_bit(free_k, r)];
            my_a = v.x;
            my_d = v.y;
            my_p = v.z;
            my_o = true;
          }
          created |= ((1u << n_new) - 1u) << count;
          count += n_new;
        }

        if (lane < t_n) {
          const long long o = static_cast<long long>(i) * t_n + lane;
          c_aoa[o] = my_a;
          c_aod[o] = my_d;
          c_pow[o] = my_p;
          c_obs[o] = my_o ? 1 : 0;
        }
        vm = vm_next;
      }
    } else if (tile + 1 < n_tiles) {
      const int j1 = min(live, i1 + tile_lanes);
      stage(st, buf ^ 1, aoa, aod, pw, val, i1, j1 - i1, k_n, tid - 32, kThreads - 32);
    }
    __syncthreads();
  }

  if (warp == 0) {
    if (lane < t_n) {
      fin_a[lane] = my_a;
      fin_d[lane] = my_d;
      pos_out[2 * lane] = my_a;
      pos_out[2 * lane + 1] = my_d;
      created_out[lane] = static_cast<uint8_t>((created >> lane) & 1u);
    }
    if (lane == 0) *count_out = count;
  }
  __syncthreads();

  // Dead lanes: the final carry's positions, no power, not observed.
  const long long o0 = static_cast<long long>(live) * t_n;
  const long long n_dead = static_cast<long long>(s1 - live) * t_n;
  for (long long e = tid; e < n_dead; e += kThreads) {
    const int t = static_cast<int>(e % t_n);
    c_aoa[o0 + e] = fin_a[t];
    c_aod[o0 + e] = fin_d[t];
    c_pow[o0 + e] = 0.0f;
    c_obs[o0 + e] = 0;
  }
}

template <int P>
void launch(cudaStream_t s, int n_streams, const float* aoa, const float* aod, const float* pw,
            const uint8_t* val, const int* m_eff, const float* pos_in,
            const uint8_t* created_in, const int* count_in, int s1, int k_n, int t_n,
            float gate2, float* c_aoa, float* c_aod, float* c_pow, uint8_t* c_obs,
            float* pos_out, uint8_t* created_out, int* count_out) {
  track_block_kernel<P><<<n_streams, kThreads, 0, s>>>(aoa, aod, pw, val, m_eff, pos_in, created_in,
                                               count_in, s1, k_n, t_n, gate2, c_aoa, c_aod,
                                               c_pow, c_obs, pos_out, created_out, count_out);
}

using Launch = void (*)(cudaStream_t, int, const float*, const float*, const float*,
                       const uint8_t*, const int*, const float*, const uint8_t*, const int*, int,
                       int, int, float, float*, float*, float*, uint8_t*, float*, uint8_t*,
                       int*);

int run(int n_streams, const void* aoa, const void* aod, const void* pw, const void* val,
        const void* m_eff, const void* pos_in, const void* created_in, const void* count_in,
        int s1, int k_n, int t_n, float gate2, void* c_aoa, void* c_aod, void* c_pow,
        void* c_obs, void* pos_out, void* created_out, void* count_out, void* stream) {
  if (t_n < 1 || t_n > kMaxT || k_n < 1 || k_n > kMaxK || s1 < 0 || n_streams < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const Launch by_pairs[] = {launch<1>, launch<2>, launch<3>, launch<4>, launch<5>,
                                    launch<6>, launch<7>, launch<8>, launch<9>, launch<10>};
  by_pairs[(t_n * k_n + 31) / 32 - 1](
      static_cast<cudaStream_t>(stream), n_streams, static_cast<const float*>(aoa),
      static_cast<const float*>(aod), static_cast<const float*>(pw),
      static_cast<const uint8_t*>(val), static_cast<const int*>(m_eff),
      static_cast<const float*>(pos_in), static_cast<const uint8_t*>(created_in),
      static_cast<const int*>(count_in), s1, k_n, t_n, gate2, static_cast<float*>(c_aoa),
      static_cast<float*>(c_aod), static_cast<float*>(c_pow), static_cast<uint8_t*>(c_obs),
      static_cast<float*>(pos_out), static_cast<uint8_t*>(created_out),
      static_cast<int*>(count_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// aoa, aod, pw: float32 [s1, k_n]; val: bool [s1, k_n]; m_eff, count_in:
// int32 scalars on the device; pos_in: float32 [t_n, 2]; created_in: bool
// [t_n]; outputs c_* [s1, t_n], pos_out, created_out, count_out.  1 <= t_n
// <= 16, 1 <= k_n <= 20.  One launch of one block.  Returns
// cudaGetLastError() after the launch.
extern "C" int slam_track_block(const void* aoa, const void* aod, const void* pw,
                                const void* val, const void* m_eff, const void* pos_in,
                                const void* created_in, const void* count_in, int s1, int k_n,
                                int t_n, float gate2, void* c_aoa, void* c_aod, void* c_pow,
                                void* c_obs, void* pos_out, void* created_out, void* count_out,
                                void* stream) {
  return run(1, aoa, aod, pw, val, m_eff, pos_in, created_in, count_in, s1, k_n, t_n, gate2,
             c_aoa, c_aod, c_pow, c_obs, pos_out, created_out, count_out, stream);
}

// The stream axis: every input and output above with a leading S axis
// (m_eff, count_in and count_out int32 [S]).  One launch of S blocks.
extern "C" int slam_track_block_streams(int n_streams, const void* aoa, const void* aod,
                                        const void* pw, const void* val, const void* m_eff,
                                        const void* pos_in, const void* created_in,
                                        const void* count_in, int s1, int k_n, int t_n,
                                        float gate2, void* c_aoa, void* c_aod, void* c_pow,
                                        void* c_obs, void* pos_out, void* created_out,
                                        void* count_out, void* stream) {
  return run(n_streams, aoa, aod, pw, val, m_eff, pos_in, created_in, count_in, s1, k_n, t_n,
             gate2, c_aoa, c_aod, c_pow, c_obs, pos_out, created_out, count_out, stream);
}
