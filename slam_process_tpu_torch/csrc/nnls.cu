// K7: batched Lawson-Hanson non-negative least squares on Gram systems.
//
// Replaces no Pallas kernel: it is the port of the JAX package's
// on-device NNLS loops, the two nested bounded lax.while_loops of
// slam_process_tpu/ops/nnls.py::nnls_gram (inner :168, outer :179), which
// end on a device-side condition inside the jitted estimator.  Eager
// PyTorch has no such loop: the plain version (ops/nnls.py::
// nnls_gram_plain) runs the lanes in lockstep and asks the host once a
// loop step whether every lane is done, so a CUDA graph cannot hold it.
// Here each lane runs its own loops on the device, to the same stopping
// conditions; a lane that is done in the lockstep version takes no
// updates there, so looping per lane gives the same results.
//
// Per lane s: G [K, K], b [K], a warm start x0 [K] / P0 [K] (or zeros),
// max_outer.  Outer step: w = b - G x (summed in column order), j = the
// argmax of w off the passive set (lowest index on ties, NaN the
// largest, as torch.argmax), stop unless w_j > 1e-10 + 3e-7 max|b| and
// some atom is not passive; else the inner loop from P | {j}: solve the
// passive subproblem (rows / columns off P replaced by identity), and
// while a passive coefficient is <= 1e-10 step back to the boundary,
// alpha = min over those of x / max(x - z, 0) (NaN propagating, as
// torch.amin and clamp_min: a 0/0 ratio makes every x NaN and empties P,
// and the next solve gives zeros), dropping the coefficients <= 1e-10; at
// most 16 steps; then x = max(x, 0) with NaN kept.  Solvers: "auto" (0)
// the adjugate at K = 3, Gauss-Jordan without pivoting at K > 3 (a pivot
// of |piv| <= 1e-30 zeroes its row), the float64 LU otherwise; "lu" (1)
// the float64 LU with partial pivoting at every K != 3, rounded once to
// float32.
//
// Contract: bit-equal to the plain version on the card for "auto" at K >=
// 3; for "lu" and K < 3 equal passive sets and x within rtol 1e-6 (the
// plain version's LU is the library's, whose last float64 bits may
// differ).  The plain version is eager PyTorch, one rounding an
// operation, so every product, sum and difference here is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in its order: nvcc would
// otherwise contract a * b + c into one FMA.  Reciprocals are 1 / x
// (torch's ``1.0 / t`` is reciprocal() * 1.0), constants float32
// literals, comparisons in float32.  fmaxf / fminf drop NaN, so the
// clamps and the min test for NaN first, as PyTorch's kernels do.
//
// Bound on an H100: neither bytes (G, b, x0, P0 read once and x, P
// written once: ~60 B a lane at K = 3, ~1.8 KB at K = 20) nor operations
// (a few hundred to a few thousand flops a lane) but the chain of
// dependent steps in each lane: up to max_outer outer steps, each a
// reduction and up to 16 solves of K dependent pivots.  The call takes
// its slowest lane's chain, so the design shortens the chain.
//
// K <= 3 (the per-sweep estimator's K = 3 adjugate, and K <= 2): one warp
// a lane, one lane a block.  Thread r owns row r of G and of the [K, K+1]
// solve tile, and its own x, P, b and w, so each reduction (argmax, min,
// all, any) is a warp shuffle or vote, no __syncthreads.  G stays in shared
// memory for the lane's whole solve (rows 33 floats apart, so thread r's
// column sweep hits 32 distinct banks).  There the kernel is launch-bound
// (~3.8 us a call at the streams' 9 and 65 lanes on an H100), so this path
// keeps its one-warp design.
//
// K > 3 (the session estimator's K = 20 refits, Gauss-Jordan and LU): one
// lane a block of ceil(K (K+1) / 32) warps (14 at K = 20; at most 1,024
// threads, so at K = 32 a thread owns two elements).  One warp a lane made
// every pivot serial in one thread (its row's K + 1 updates one after
// another, the row's K tile entries rebuilt from G before each solve, the
// LU's row update and pivot search in one thread), with no other warp to
// hide a shared-memory or float64 latency.  Here each thread owns one (r,
// c) of the tile: a pivot is one rounded update a thread, read from one of
// two tile buffers in shared memory and written to the other, then one
// __syncthreads; the first pivot reads the masked tile straight from G and
// b, so building the tile costs no step of its own.  The Lawson-Hanson
// bookkeeping (w = b - G x summed in column order by one thread a row,
// argmax, the step back, the passive set) runs in every warp alike, on the
// same data in the same order, so every warp holds the lane's x, P and z
// in its lane r with no broadcast, and every warp takes the same branches
// to the same barriers.  A solve's first pivot writes the buffer that does
// not hold the previous solve's result, so a warp still reading that
// result is never overwritten (the pivot's barrier orders the rest).  The
// LU keeps "the first largest |pivot|" (a 64-bit key through three warp
// reductions), runs the swapped rows' updates in parallel, and keeps the
// back substitution's K steps in every warp, each row's update by its own
// lane (reciprocal pivots taken once).  The chain of a solve is K pivots
// of a few shared-memory loads, one update and one barrier, where it was K
// pivots of K + 1 serial updates.  K <= 32 (the callers have K <= 20); the
// wrapper refuses more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kStride = kMaxK + 1;
constexpr int kMaxInner = 16;
constexpr int kWideThreads = 1024;      // the element path's largest block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTol = 1e-10f;
constexpr float kTolRel = 3e-7f;
constexpr float kTiny = 1e-30f;

// The one-warp path's shared memory (K <= 3).
struct Tiles {
  float g[kMaxK * kStride];             // G, row r at r * kStride
  union {
    float aug[kMaxK * kStride];         // the adjugate's tile [K, K+1]
    double lu[kMaxK * kStride];         // LU tile [K, K+1]
  };
};

// The element path's shared memory (K > 3): G, b and two [K, K+1] tiles
// (row r at r (K + 1)), float32 for Gauss-Jordan, float64 for the LU.
struct WideTiles {
  float g[kMaxK * kStride];
  float b[kMaxK];
  union {
    float aug[2][kMaxK * (kMaxK + 1)];
    double lu[2][kMaxK * (kMaxK + 1)];
  };
};

// The tile elements a thread of the element path owns: e = threadIdx.x and
// e + blockDim.x, at (r, c) = (e / (K+1), e % (K+1)) while e < K (K+1).
struct Elems {
  int n;
  int e[2], r[2], c[2];
};

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

__device__ __forceinline__ float clamp_min0(float v) {
  return is_nan(v) ? v : fmaxf(v, 0.f);   // torch's clamp_min: NaN kept
}

// torch.amax / amin on the card: a NaN wins.
__device__ __forceinline__ float warp_max_nan(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    v = (is_nan(v) || v > u) ? v : u;
  }
  return v;
}

__device__ __forceinline__ float warp_min_nan(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    v = (is_nan(v) || v < u) ? v : u;
  }
  return v;
}

// torch.argmax: the largest value, a NaN above every number, the lowest
// index among equals (and among NaNs).
__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    const int iu = __shfl_xor_sync(kFull, idx, o);
    bool take;
    if (is_nan(u)) {
      take = !is_nan(v) || iu < idx;
    } else if (is_nan(v)) {
      take = false;
    } else {
      take = (u == v) ? iu < idx : u > v;
    }
    if (take) {
      v = u;
      idx = iu;
    }
  }
}

// The passive subproblem's tile: Gp = G * (P_r P_c) + diag(1 - P), bp = b
// * P, as the plain version forms them (its zeros are +0 off P).
__device__ __forceinline__ float gp_at(const float* g, int r, int c, unsigned pmask) {
  const float pr = ((pmask >> r) & 1u) ? 1.f : 0.f;
  const float pc = ((pmask >> c) & 1u) ? 1.f : 0.f;
  return __fadd_rn(__fmul_rn(g[r * kStride + c], pr * pc), r == c ? 1.f - pr : 0.f);
}

// The closed-form adjugate at K = 3, in the plain version's order.
__device__ float solve_adjugate(Tiles& t, int r, unsigned pmask, float br) {
  if (r < 3) {
    for (int c = 0; c < 3; ++c) t.aug[r * kStride + c] = gp_at(t.g, r, c, pmask);
    t.aug[r * kStride + 3] = __fmul_rn(br, ((pmask >> r) & 1u) ? 1.f : 0.f);
  }
  __syncwarp();
  float z = 0.f;
  if (r < 3) {
    const float* a = t.aug;
    const float a11 = a[0], a12 = a[1], a13 = a[2], b0 = a[3];
    const float a21 = a[kStride], a22 = a[kStride + 1], a23 = a[kStride + 2],
                b1 = a[kStride + 3];
    const float a31 = a[2 * kStride], a32 = a[2 * kStride + 1], a33 = a[2 * kStride + 2],
                b2 = a[2 * kStride + 3];
    const float c11 = __fsub_rn(__fmul_rn(a22, a33), __fmul_rn(a23, a32));
    const float c12 = __fsub_rn(__fmul_rn(a13, a32), __fmul_rn(a12, a33));
    const float c13 = __fsub_rn(__fmul_rn(a12, a23), __fmul_rn(a13, a22));
    const float c21 = __fsub_rn(__fmul_rn(a23, a31), __fmul_rn(a21, a33));
    const float c22 = __fsub_rn(__fmul_rn(a11, a33), __fmul_rn(a13, a31));
    const float c23 = __fsub_rn(__fmul_rn(a13, a21), __fmul_rn(a11, a23));
    const float c31 = __fsub_rn(__fmul_rn(a21, a32), __fmul_rn(a22, a31));
    const float c32 = __fsub_rn(__fmul_rn(a12, a31), __fmul_rn(a11, a32));
    const float c33 = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a21));
    const float det = __fadd_rn(__fadd_rn(__fmul_rn(a11, c11), __fmul_rn(a12, c21)),
                                __fmul_rn(a13, c31));
    const float inv_det = fabsf(det) > kTiny ? __fdiv_rn(1.f, det) : 0.f;
    float x1, x2, x3;
    if (r == 0) {
      x1 = c11; x2 = c12; x3 = c13;
    } else if (r == 1) {
      x1 = c21; x2 = c22; x3 = c23;
    } else {
      x1 = c31; x2 = c32; x3 = c33;
    }
    z = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(x1, b0), __fmul_rn(x2, b1)), __fmul_rn(x3, b2)),
                  inv_det);
  }
  __syncwarp();
  return z;
}

// float64 LU with partial pivoting (the first largest |pivot|),
// then back substitution, rounded once to float32.
__device__ float solve_lu(Tiles& t, int k, int r, unsigned pmask, float br) {
  const bool on = r < k;
  if (on) {
    for (int c = 0; c < k; ++c) t.lu[r * kStride + c] = static_cast<double>(gp_at(t.g, r, c, pmask));
    t.lu[r * kStride + k] =
        static_cast<double>(__fmul_rn(br, ((pmask >> r) & 1u) ? 1.f : 0.f));
  }
  __syncwarp();
  for (int i = 0; i < k; ++i) {
    // Pivot search over rows i..K-1: a double's |value| as a float key is
    // not exact, so compare the doubles through two shuffles of 32 bits.
    double best = (on && r >= i) ? fabs(t.lu[r * kStride + i]) : -1.0;
    int at = r;
    for (int o = 16; o > 0; o >>= 1) {
      const double u = __shfl_xor_sync(kFull, best, o);
      const int iu = __shfl_xor_sync(kFull, at, o);
      if (u > best || (u == best && iu < at)) {
        best = u;
        at = iu;
      }
    }
    if (at != i) {
      for (int c = r; c <= k; c += 32) {
        const double tmp = t.lu[i * kStride + c];
        t.lu[i * kStride + c] = t.lu[at * kStride + c];
        t.lu[at * kStride + c] = tmp;
      }
    }
    __syncwarp();
    if (on && r > i) {
      double* a = t.lu + r * kStride;
      const double* p = t.lu + i * kStride;
      const double l = a[i] / p[i];
      for (int c = i + 1; c <= k; ++c) a[c] -= l * p[c];
    }
    __syncwarp();
  }
  double zr = 0.0;
  for (int i = k - 1; i >= 0; --i) {
    const double xi = t.lu[i * kStride + k] / t.lu[i * kStride + i];
    if (r == i) zr = xi;
    if (r < i) t.lu[r * kStride + k] -= t.lu[r * kStride + i] * xi;
    __syncwarp();
  }
  return on ? static_cast<float>(zr) : 0.f;
}

// K <= 3: the adjugate at K = 3 under either solver, else the LU.
__device__ __forceinline__ float solve(Tiles& t, int k, int r, unsigned pmask, float br) {
  return k == 3 ? solve_adjugate(t, r, pmask, br) : solve_lu(t, k, r, pmask, br);
}

// -- the element path (K > 3) --------------------------------------------------

// The masked tile's (r, c) as the plain version builds it: Gp, or bp at c = K.
__device__ __forceinline__ float tile_at(const WideTiles& t, int k, int r, int c,
                                         unsigned pmask) {
  return c < k ? gp_at(t.g, r, c, pmask)
               : __fmul_rn(t.b[r], ((pmask >> r) & 1u) ? 1.f : 0.f);
}

// Gauss-Jordan pivot i on the float32 tile: every owned element updated from
// the tile before the pivot (``a``; the first pivot reads the masked tile
// from G and b) into ``o``.  Row i becomes the scaled pivot row; every other
// element a - col * row, each product and difference rounded, as the plain
// version's elementwise ops.
template <bool kFirst>
__device__ __forceinline__ void gj_pivot(const WideTiles& t, const float* a, float* o, int k,
                                         int i, const Elems& el, unsigned pmask) {
  const int s = k + 1;
  auto at = [&](int r, int c) { return kFirst ? tile_at(t, k, r, c, pmask) : a[r * s + c]; };
  const float piv = at(i, i);
  const float inv = fabsf(piv) > kTiny ? __fdiv_rn(1.f, piv) : 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (el.e[j] >= el.n) continue;
    const int r = el.r[j], c = el.c[j];
    const float row = __fmul_rn(at(i, c), inv);
    o[el.e[j]] = r == i ? row : __fsub_rn(at(r, c), __fmul_rn(at(r, i), row));
  }
}

// One Gauss-Jordan solve: K pivots, a barrier after each.  ``fin`` names the
// buffer holding the previous solve's result (read by slower warps while the
// first pivot writes the other one) and returns this solve's.
__device__ float solve_gj_wide(WideTiles& t, int k, const Elems& el, unsigned pmask, int lane,
                               int& fin) {
  int cur = fin ^ 1;
  gj_pivot<true>(t, nullptr, t.aug[cur], k, 0, el, pmask);
  __syncthreads();
  for (int i = 1; i < k; ++i) {
    gj_pivot<false>(t, t.aug[cur], t.aug[cur ^ 1], k, i, el, pmask);
    __syncthreads();
    cur ^= 1;
  }
  fin = cur;
  return lane < k ? t.aug[cur][lane * (k + 1) + k] : 0.f;
}

// LU column i on the float64 tile: the pivot row ``piv`` = the first row of
// the largest |a[r][i]|, r >= i (found in every warp), swapped with row i;
// the rows below subtract l = a[r][i] / a[piv][i] times the pivot row from
// their columns past i.  Each owned element is written once into ``o``.
template <bool kFirst>
__device__ __forceinline__ void lu_column(const WideTiles& t, const double* a, double* o, int k,
                                          int i, const Elems& el, unsigned pmask, int lane) {
  const int s = k + 1;
  auto at = [&](int r, int c) {
    return kFirst ? static_cast<double>(tile_at(t, k, r, c, pmask)) : a[r * s + c];
  };
  // |value| as a 64-bit key (order-preserving for non-negative doubles),
  // one above 0 for a candidate row; the highest key, then the lowest lane.
  const unsigned long long key =
      (lane < k && lane >= i)
          ? static_cast<unsigned long long>(__double_as_longlong(fabs(at(lane, i)))) + 1ull
          : 0ull;
  const unsigned hi = __reduce_max_sync(kFull, static_cast<unsigned>(key >> 32));
  const unsigned lo =
      __reduce_max_sync(kFull, static_cast<unsigned>(key >> 32) == hi ? static_cast<unsigned>(key) : 0u);
  const int piv = static_cast<int>(__reduce_min_sync(
      kFull, key == ((static_cast<unsigned long long>(hi) << 32) | lo) ? static_cast<unsigned>(lane)
                                                                        : 32u));
  const double pp = at(piv, i);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (el.e[j] >= el.n) continue;
    const int r = el.r[j], c = el.c[j];
    const int src = r == i ? piv : (r == piv ? i : r);
    double v = at(src, c);
    if (r > i && c > i) {
      const double l = at(src, i) / pp;
      v -= l * at(piv, c);
    }
    o[el.e[j]] = v;
  }
}

// One LU solve: K columns, a barrier after each, then the back substitution
// in every warp (lane r holds row r's right-hand side), rounded once.
__device__ float solve_lu_wide(WideTiles& t, int k, const Elems& el, unsigned pmask, int lane,
                               int& fin) {
  int cur = fin ^ 1;
  lu_column<true>(t, nullptr, t.lu[cur], k, 0, el, pmask, lane);
  __syncthreads();
  for (int i = 1; i < k; ++i) {
    lu_column<false>(t, t.lu[cur], t.lu[cur ^ 1], k, i, el, pmask, lane);
    __syncthreads();
    cur ^= 1;
  }
  fin = cur;
  const double* u = t.lu[cur];
  const int s = k + 1;
  const bool on = lane < k;
  double rhs = on ? u[lane * s + k] : 0.0;
  const double rinv = on ? 1.0 / u[lane * s + lane] : 0.0;
  double zr = 0.0;
  for (int i = k - 1; i >= 0; --i) {
    const double xi = __shfl_sync(kFull, rhs * rinv, i);
    if (lane == i) zr = xi;
    if (lane < i) rhs -= u[lane * s + i] * xi;
  }
  return on ? static_cast<float>(zr) : 0.f;
}

// One lane's Lawson-Hanson loops.  kWide: the element path, run alike in
// every warp of the block; else one warp.
template <bool kWide, typename T>
__device__ __forceinline__ void run_lane(T& t, const float* __restrict__ G,
                                         const float* __restrict__ b,
                                         const float* __restrict__ x0,
                                         const uint8_t* __restrict__ p0, int k, int max_outer,
                                         int solver, float* __restrict__ x_out,
                                         uint8_t* __restrict__ p_out) {
  const int r = threadIdx.x & 31;
  const long long s = blockIdx.x;
  const bool on = r < k;
  const float* gs = G + s * k * k;
  for (int i = threadIdx.x; i < k * k; i += blockDim.x) t.g[(i / k) * kStride + i % k] = __ldg(gs + i);
  const float br = on ? __ldg(b + s * k + r) : 0.f;
  Elems el{};
  int fin = 0;
  if constexpr (kWide) {
    if (static_cast<int>(threadIdx.x) < k) t.b[threadIdx.x] = br;
    el.n = k * (k + 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      el.e[j] = threadIdx.x + j * blockDim.x;
      el.r[j] = el.e[j] / (k + 1);
      el.c[j] = el.e[j] - el.r[j] * (k + 1);
    }
    __syncthreads();
  } else {
    __syncwarp();
  }
  float x = (on && x0 != nullptr) ? __ldg(x0 + s * k + r) : 0.f;
  bool p = on && p0 != nullptr && __ldg(p0 + s * k + r) != 0;
  const float w_tol = __fadd_rn(kTol, __fmul_rn(kTolRel, warp_max_nan(on ? fabsf(br) : 0.f)));
  const int grow = on ? r : 0;

  for (int it = 0; it < max_outer; ++it) {
    // w = b - G x, G x summed in column order from column 0's product.
    float acc = 0.f;
    for (int c = 0; c < k; ++c) {
      const float term = __fmul_rn(t.g[grow * kStride + c], __shfl_sync(kFull, x, c));
      acc = c == 0 ? term : __fadd_rn(acc, term);
    }
    float wj = (on && !p) ? __fsub_rn(br, acc) : -INFINITY;
    int j = r;
    warp_argmax(wj, j);
    const bool all_p = __all_sync(kFull, p || !on);
    if (!(wj > w_tol) || all_p) break;                 // this lane is done

    // Inner loop from P | {j}.
    float xc = x;
    bool pc = p || r == j;
    for (int in = 0; in < kMaxInner; ++in) {
      const unsigned pmask = __ballot_sync(kFull, on && pc);
      float z;
      if constexpr (kWide) {
        z = solver == 0 ? solve_gj_wide(t, k, el, pmask, r, fin)
                        : solve_lu_wide(t, k, el, pmask, r, fin);
      } else {
        z = solve(t, k, r, pmask, br);
      }
      const bool neg = on && pc && z <= kTol;
      if (!__any_sync(kFull, neg)) {
        xc = z;
        break;
      }
      const float ratio = neg ? __fdiv_rn(xc, clamp_min0(__fsub_rn(xc, z))) : INFINITY;
      const float alpha = warp_min_nan(ratio);
      xc = __fadd_rn(xc, __fmul_rn(alpha, __fsub_rn(z, xc)));
      pc = pc && xc > kTol;
    }
    x = clamp_min0(xc);
    p = pc;
  }
  if (on && threadIdx.x < 32) {
    x_out[s * k + r] = x;
    p_out[s * k + r] = p ? 1 : 0;
  }
}

__global__ void __launch_bounds__(32) nnls_kernel(
    const float* __restrict__ G, const float* __restrict__ b, const float* __restrict__ x0,
    const uint8_t* __restrict__ p0, int k, int max_outer, int solver, float* __restrict__ x_out,
    uint8_t* __restrict__ p_out) {
  __shared__ Tiles t;
  run_lane<false>(t, G, b, x0, p0, k, max_outer, solver, x_out, p_out);
}

__global__ void __launch_bounds__(kWideThreads) nnls_wide_kernel(
    const float* __restrict__ G, const float* __restrict__ b, const float* __restrict__ x0,
    const uint8_t* __restrict__ p0, int k, int max_outer, int solver, float* __restrict__ x_out,
    uint8_t* __restrict__ p_out) {
  __shared__ WideTiles t;
  run_lane<true>(t, G, b, x0, p0, k, max_outer, solver, x_out, p_out);
}

}  // namespace

// G: float32 [S, K, K]; b, x0: float32 [S, K]; p0: bool [S, K] (x0 and p0
// may be null: zeros); x_out float32 [S, K], p_out bool [S, K].  1 <= K <=
// 32, S >= 1, solver 0 ("auto") or 1 ("lu").  One launch of S blocks: one
// warp at K <= 3, else ceil(K (K+1) / 32) warps (at most 32).  Returns
// cudaGetLastError() after the launch.
extern "C" int slam_nnls_gram(const void* G, const void* b, const void* x0, const void* p0,
                              int n_lanes, int k, int max_outer, int solver, void* x_out,
                              void* p_out, void* stream) {
  if (n_lanes < 1 || k < 1 || k > kMaxK || max_outer < 0 || (solver != 0 && solver != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(G);
  const float* bb = static_cast<const float*>(b);
  const float* xx = static_cast<const float*>(x0);
  const uint8_t* pp = static_cast<const uint8_t*>(p0);
  if (k > 3) {
    const int warps = (k * (k + 1) + 31) / 32;
    const int threads = warps * 32 < kWideThreads ? warps * 32 : kWideThreads;
    nnls_wide_kernel<<<n_lanes, threads, 0, st>>>(g, bb, xx, pp, k, max_outer, solver,
                                                  static_cast<float*>(x_out),
                                                  static_cast<uint8_t*>(p_out));
  } else {
    nnls_kernel<<<n_lanes, 32, 0, st>>>(g, bb, xx, pp, k, max_outer, solver,
                                        static_cast<float*>(x_out),
                                        static_cast<uint8_t*>(p_out));
  }
  return static_cast<int>(cudaGetLastError());
}
