// K3: fused raster of [S, H, W] intensity tiles: NaN-aware normalised
// Gaussian blur with replicate padding, then the shifted-log (or linear)
// norm over the tile's finite range, then the colormap LUT.
//
// Replaces slam_process_tpu/ops/pallas_raster.py::pallas_rasterize_batch
// (_raster_kernel).  Per tile: pad_v / pad_m = the tile's finite values
// (NaN -> 0) and its finiteness mask, edge-replicated by `ph`, `pw`;
// num = sum_k w_k pad_v, den = sum_k w_k pad_m over the kh x kw taps in
// row-major order; blurred = den > 1e-12 ? num / max(den, 1e-30) : NaN;
// mn / mx = NaN-skipping min / max of blurred over the tile;
// log norm: t = (log(max(b - mn + 1e-6, 1e-30)) - L) / max(H - L, 1e-30),
//           L = log(1e-6), or log(max(vmin - mn + 1e-6, 1e-30)) given vmin,
//           H = log(max(mx - mn + 1e-6, 1e-30)), or log(vmax - mn + 1e-6)
//           given vmax (NaN when vmax lies below the tile's minimum, and
//           then every cell's t is NaN, as in the JAX package);
// linear:   t = (b - lo) / max(hi - lo, 1e-30), lo = vmin or mn, hi = vmax
//           or mx; t clipped to [0, 1];
// rgba = lut[clip(int(t * n_lut), 0, n_lut - 1)] where t is a number, else
// 0 and t NaN.  Explicit bounds change only the norm's lo and hi: the log
// form's shift keeps the tile's own minimum.
// The multiply-adds use __fmul_rn / __fadd_rn (no FMA contraction) in the
// same row-major order as the plain PyTorch version, so `blurred` is
// bit-equal to it.  f32 throughout; no tensor cores, so no TF32.
//
// Bound on an H100: at 64 x 64 a tile moves ~120 KB (16 KB in, 96 KB of
// outputs, the 4 KB LUT) and does ~0.9 M flops, well under a microsecond
// either way.  What costs is latency: one block on one SM walking every
// pixel's 49-tap chain leaves 131 SMs idle.  Design: one thread-block
// cluster of 8 blocks per tile (S tiles -> S clusters).  Rank r owns a band
// of ceil(h / 8) rows and stages only that band plus its kh - 1 halo rows of
// values and mask in shared memory.  Each thread blurs a pair of vertically
// adjacent pixels, so every staged value loaded for a padded row serves
// both pixels' chains; the taps are broadcast from shared memory.  Each
// block reduces its min / max with warp shuffles and pushes the pair into
// every rank's shared memory (distributed shared memory stores); one
// cluster barrier then publishes all eight pairs, so the tile's range needs
// no global scratch, atomics, second launch or host state (the launch stays
// capturable in a CUDA graph), and no block reads another's memory after
// the barrier, so any may exit.  The first phase of the cluster barrier,
// arrived at on entry and waited on before the pushes, guarantees every
// block has started.  Then each block normalises and colour-maps its own
// band, the LUT staged in shared memory beside the tile.  A band is empty
// when h < 8; its block still joins both barrier phases.  For 7 taps
// (sigma 1, every caller's) the width is a template parameter, so the tap
// loops unroll; other widths read it at run time.  The shared-memory opt-in
// is set once per (process, device) by slam_raster_init, not on every
// launch.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kRanks = 8;      // blocks per tile: the portable cluster size

// One padded row of taps into a pixel's sums; KW > 0 fixes kw at compile
// time so the loop unrolls and its loads issue together.
template <int KW>
__device__ __forceinline__ void blur_row(const float* rv, const float* rm, const float* tap,
                                         int kw, float& num, float& den) {
  const int n = KW > 0 ? KW : kw;
#pragma unroll
  for (int dx = 0; dx < n; ++dx) {
    num = __fadd_rn(num, __fmul_rn(tap[dx], rv[dx]));
    den = __fadd_rn(den, __fmul_rn(tap[dx], rm[dx]));
  }
}

template <int KW>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kBlock)
    raster_kernel(const float* __restrict__ mats, int h, int w, const float* __restrict__ lut,
                  int n_lut, const float* __restrict__ taps, int kh, int kw, int use_log,
                  int has_vmin, float vmin, int has_vmax, float vmax,
                  float* __restrict__ rgba, float* __restrict__ norm_t,
                  float* __restrict__ blurred) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[2 * kWarps];
  __shared__ float s_all[2 * kRanks];    // every rank's (min, max), pushed by the ranks

  // Arrive on the cluster barrier now and wait on it before the first
  // remote store: every block of the cluster has then started.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ph = kh / 2, pw = kw / 2;
  const int band = (h + kRanks - 1) / kRanks;
  const int r0 = min(rank * band, h);
  const int rows = min(r0 + band, h) - r0;     // 0 for an empty band
  const int wp = w + kw - 1;
  const int pad = (band + kh - 1) * wp;
  float4* s_lut = reinterpret_cast<float4*>(smem);
  float* pad_v = smem + 4 * n_lut;
  float* pad_m = pad_v + pad;
  float* s_taps = pad_m + pad;
  float* s_b = s_taps + kh * kw;               // [band, w] blurred

  const long long tile = static_cast<long long>(blockIdx.x / kRanks) * h * w;
  const float* mat = mats + tile;
  const int prn = rows > 0 ? rows + kh - 1 : 0;
  // Stage the band: four loads in flight per thread before their stores.
  for (int i0 = threadIdx.x; i0 < prn * wp; i0 += 4 * kBlock) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * kBlock;
      const int y = min(max(r0 + i / wp - ph, 0), h - 1);
      const int x = min(max(i % wp - pw, 0), w - 1);
      v[j] = i < prn * wp ? mat[y * w + x] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * kBlock;
      if (i < prn * wp) {
        const bool fin = isfinite(v[j]);
        pad_v[i] = fin ? v[j] : 0.0f;
        pad_m[i] = fin ? 1.0f : 0.0f;
      }
    }
  }
  for (int i = threadIdx.x; i < n_lut; i += kBlock)
    s_lut[i] = reinterpret_cast<const float4*>(lut)[i];
  for (int i = threadIdx.x; i < kh * kw; i += kBlock) s_taps[i] = taps[i];
  __syncthreads();

  // Blur: pixels (ya, x) and (ya + 1, x) of the band per unit; padded row
  // ya + pr is tap row pr of the first and tap row pr - 1 of the second.
  float lo = INFINITY, hi = -INFINITY;
  const int units = w * ((rows + 1) / 2);
  for (int u = threadIdx.x; u < units; u += kBlock) {
    const int x = u % w, ya = 2 * (u / w);
    const bool two = ya + 1 < rows;
    float na = 0.0f, da = 0.0f, nb = 0.0f, db = 0.0f;
    blur_row<KW>(pad_v + ya * wp + x, pad_m + ya * wp + x, s_taps, kw, na, da);
    for (int pr = 1; pr < kh; ++pr) {
      const float* rv = pad_v + (ya + pr) * wp + x;
      const float* rm = pad_m + (ya + pr) * wp + x;
      const float* ta = s_taps + pr * kw;
      const float* tb = ta - kw;
#pragma unroll
      for (int dx = 0; dx < (KW > 0 ? KW : kw); ++dx) {
        const float v = rv[dx], m = rm[dx];
        na = __fadd_rn(na, __fmul_rn(ta[dx], v));
        da = __fadd_rn(da, __fmul_rn(ta[dx], m));
        nb = __fadd_rn(nb, __fmul_rn(tb[dx], v));
        db = __fadd_rn(db, __fmul_rn(tb[dx], m));
      }
    }
    const float ba = da > 1e-12f ? __fdiv_rn(na, fmaxf(da, 1e-30f)) : NAN;
    s_b[ya * w + x] = ba;
    blurred[tile + static_cast<long long>(r0 + ya) * w + x] = ba;
    if (!isnan(ba)) {
      lo = fminf(lo, ba);
      hi = fmaxf(hi, ba);
    }
    if (two) {
      blur_row<KW>(pad_v + (ya + kh) * wp + x, pad_m + (ya + kh) * wp + x,
               s_taps + (kh - 1) * kw, kw, nb, db);
      const float bb = db > 1e-12f ? __fdiv_rn(nb, fmaxf(db, 1e-30f)) : NAN;
      s_b[(ya + 1) * w + x] = bb;
      blurred[tile + static_cast<long long>(r0 + ya + 1) * w + x] = bb;
      if (!isnan(bb)) {
        lo = fminf(lo, bb);
        hi = fmaxf(hi, bb);
      }
    }
  }

  // The block's min / max, then the tile's through distributed shared memory.
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_red[warp] = lo;
    s_red[kWarps + warp] = hi;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < kRanks) {
    // Thread r pushes the block's pair into rank r's s_all.
    float mn = s_red[0], mx = s_red[kWarps];
    for (int k = 1; k < kWarps; ++k) {
      mn = fminf(mn, s_red[k]);
      mx = fmaxf(mx, s_red[kWarps + k]);
    }
    float* remote = cluster.map_shared_rank(s_all, threadIdx.x);
    remote[2 * rank] = mn;
    remote[2 * rank + 1] = mx;
  }
  cluster.sync();   // every pair has landed; no block touches another's memory after
  float mn = s_all[0], mx = s_all[1];
  for (int k = 1; k < kRanks; ++k) {
    mn = fminf(mn, s_all[2 * k]);
    mx = fmaxf(mx, s_all[2 * k + 1]);
  }

  const float log_lo = logf(1e-6f);
  const float lo_log =
      has_vmin ? logf(fmaxf(__fadd_rn(__fsub_rn(vmin, mn), 1e-6f), 1e-30f)) : log_lo;
  const float hi_log = has_vmax ? logf(__fadd_rn(__fsub_rn(vmax, mn), 1e-6f))
                                : logf(fmaxf(__fadd_rn(__fsub_rn(mx, mn), 1e-6f), 1e-30f));
  const float log_span = __fsub_rn(hi_log, lo_log);
  const float log_den = isnan(log_span) ? log_span : fmaxf(log_span, 1e-30f);
  const float lin_lo = has_vmin ? vmin : mn;
  const float lin_den = fmaxf(__fsub_rn(has_vmax ? vmax : mx, lin_lo), 1e-30f);
  float4* out4 = reinterpret_cast<float4*>(rgba + 4 * tile) + static_cast<long long>(r0) * w;
  float* out_t = norm_t + tile + static_cast<long long>(r0) * w;
  for (int p = threadIdx.x; p < rows * w; p += kBlock) {
    const float b = s_b[p];
    float t = NAN;
    if (!isnan(b)) {   // fmaxf would turn a NaN b into a number
      if (use_log) {
        const float shifted = __fadd_rn(__fsub_rn(b, mn), 1e-6f);
        t = __fdiv_rn(__fsub_rn(logf(fmaxf(shifted, 1e-30f)), lo_log), log_den);
      } else {
        t = __fdiv_rn(__fsub_rn(b, lin_lo), lin_den);
      }
    }
    if (isnan(t)) {   // b is NaN, or vmax lies below the tile's minimum
      out_t[p] = NAN;
      out4[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    out_t[p] = t;
    const int idx = min(max(static_cast<int>(__fmul_rn(t, static_cast<float>(n_lut))), 0),
                        n_lut - 1);
    out4[p] = s_lut[idx];
  }
}

// The kernel that reads kw at run time, and the one for 7 taps (sigma 1,
// every caller's blur).
const void* const kKernels[] = {reinterpret_cast<const void*>(raster_kernel<0>),
                                reinterpret_cast<const void*>(raster_kernel<7>)};

// Dynamic shared memory one block needs for an h x w tile with kh x kw taps.
long long smem_bytes(int h, int w, int n_lut, int kh, int kw) {
  const long long band = (h + kRanks - 1) / kRanks;
  const long long pad = (band + kh - 1) * static_cast<long long>(w + kw - 1);
  return static_cast<long long>(sizeof(float)) * (4LL * n_lut + 2 * pad + kh * kw + band * w);
}

}  // namespace

// Once per (process, device), on the current device: lets the kernel opt
// into all the shared memory a block may use.  Returns the CUDA error.
extern "C" int slam_raster_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const void* kernel : kKernels) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - static_cast<int>(attr.sharedSizeBytes));
  }
  return static_cast<int>(err);
}

// mats [S, h, w] f32, lut [n_lut, 4] f32, taps [kh, kw] f32 (kh, kw odd);
// the norm's explicit bounds vmin / vmax where has_vmin / has_vmax; rgba [S, h, w, 4], norm_t and blurred [S, h, w] f32, lut and rgba 16-byte
// aligned; slam_raster_init has run on this device.  One cluster of 8
// blocks per tile.  Returns the launch's CUDA error: a band whose shared
// memory exceeds what one block can opt into (227 KB on an H100) fails with
// cudaErrorInvalidValue.
extern "C" int slam_raster(const void* mats, int s, int h, int w, const void* lut,
                           int n_lut, const void* taps, int kh, int kw, int use_log,
                           int has_vmin, float vmin, int has_vmax, float vmax, void* rgba,
                           void* norm_t, void* blurred, void* stream) {
  const long long smem = smem_bytes(h, w, n_lut, kh, kw);
  if (smem > INT_MAX || static_cast<long long>(s) * kRanks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slot = kw == 7 ? 1 : 0;   // kKernels index
  void* args[] = {&mats, &h, &w, &lut, &n_lut, &taps, &kh, &kw, &use_log, &has_vmin, &vmin,
                  &has_vmax, &vmax, &rgba, &norm_t, &blurred};
  return static_cast<int>(cudaLaunchKernel(kKernels[slot], dim3(s * kRanks), dim3(kBlock), args,
                                           static_cast<size_t>(smem),
                                           static_cast<cudaStream_t>(stream)));
}
