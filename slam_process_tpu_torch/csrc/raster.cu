// K3: fused raster of [S, H, W] intensity tiles, one thread block per tile:
// NaN-aware normalised Gaussian blur with replicate padding, then the
// shifted-log (or linear) norm over the tile's finite range, then the
// colormap LUT.
//
// Replaces slam_process_tpu/ops/pallas_raster.py::pallas_rasterize_batch
// (_raster_kernel).  Per tile: pad_v / pad_m = the tile's finite values
// (NaN -> 0) and its finiteness mask, edge-replicated by `ph`, `pw`;
// num = sum_k w_k pad_v, den = sum_k w_k pad_m over the kh x kw taps in
// row-major order; blurred = den > 1e-12 ? num / max(den, 1e-30) : NaN;
// mn / mx = NaN-skipping min / max of blurred over the tile;
// log norm: t = (log(max(b - mn + 1e-6, 1e-30)) - log(1e-6)) /
//               max(log(max(mx - mn + 1e-6, 1e-30)) - log(1e-6), 1e-30),
// linear:   t = (b - mn) / max(mx - mn, 1e-30); t clipped to [0, 1];
// rgba = lut[clip(int(t * n_lut), 0, n_lut - 1)] for finite b, else 0.
// The multiply-adds use __fmul_rn / __fadd_rn (no FMA contraction), so the
// blur is bit-identical to the plain PyTorch version, which sums in the same
// order.  f32 throughout; no tensor cores, so no TF32.
//
// Bound on an H100: at 64 x 64 a tile moves ~120 KB (16 KB in, 96 KB of
// outputs, the 4 KB LUT) and does ~0.4 M flops, well under a microsecond
// either way, so one launch is bound by launch latency.  Design: one block
// of 1,024 threads per tile holds the padded tile, its mask, the taps and
// the LUT in shared memory (43 KB at 64 x 64), so each thread's chain of
// dependent multiply-adds covers 4 pixels, not 16 as with 256 threads; the
// colormap is a direct indexed read of the LUT, not the TPU's one-hot LUT
// matmul.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // 4 pixels a thread at 64 x 64
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock) raster_kernel(const float* __restrict__ mats, int h, int w,
                              const float* __restrict__ lut, int n_lut,
                              const float* __restrict__ taps, int kh, int kw, int use_log,
                              float* __restrict__ rgba, float* __restrict__ norm_t,
                              float* __restrict__ blurred) {
  extern __shared__ float smem[];
  const int ph = kh / 2, pw = kw / 2;
  const int hp = h + kh - 1, wp = w + kw - 1;
  float* pad_v = smem;
  float* pad_m = pad_v + hp * wp;
  float* s_lut = pad_m + hp * wp;
  float* s_taps = s_lut + 4 * n_lut;
  float* s_red = s_taps + kh * kw;  // [2 * kWarps]

  const long long tile = static_cast<long long>(blockIdx.x) * h * w;
  const float* mat = mats + tile;
  for (int i = threadIdx.x; i < hp * wp; i += kBlock) {
    const int y = min(max(i / wp - ph, 0), h - 1);
    const int x = min(max(i % wp - pw, 0), w - 1);
    const float v = mat[y * w + x];
    const bool fin = isfinite(v);
    pad_v[i] = fin ? v : 0.0f;
    pad_m[i] = fin ? 1.0f : 0.0f;
  }
  for (int i = threadIdx.x; i < 4 * n_lut; i += kBlock) s_lut[i] = lut[i];
  for (int i = threadIdx.x; i < kh * kw; i += kBlock) s_taps[i] = taps[i];
  __syncthreads();

  // Blur; each thread keeps the NaN-skipping min / max of its own pixels.
  float lo = INFINITY, hi = -INFINITY;
  for (int p = threadIdx.x; p < h * w; p += kBlock) {
    const int y = p / w, x = p % w;
    float num = 0.0f, den = 0.0f;
    for (int dy = 0; dy < kh; ++dy) {
      const float* rv = pad_v + (y + dy) * wp + x;
      const float* rm = pad_m + (y + dy) * wp + x;
      for (int dx = 0; dx < kw; ++dx) {
        const float wgt = s_taps[dy * kw + dx];
        num = __fadd_rn(num, __fmul_rn(wgt, rv[dx]));
        den = __fadd_rn(den, __fmul_rn(wgt, rm[dx]));
      }
    }
    const float b = den > 1e-12f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : NAN;
    blurred[tile + p] = b;
    if (!isnan(b)) {
      lo = fminf(lo, b);
      hi = fmaxf(hi, b);
    }
  }

  // Block-wide min / max: warp shuffles, then one value per warp.
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
  float mn = s_red[0], mx = s_red[kWarps];
  for (int k = 1; k < kWarps; ++k) {
    mn = fminf(mn, s_red[k]);
    mx = fmaxf(mx, s_red[kWarps + k]);
  }

  const float log_lo = logf(1e-6f);
  const float log_den = fmaxf(logf(fmaxf(__fadd_rn(__fsub_rn(mx, mn), 1e-6f), 1e-30f)) - log_lo,
                              1e-30f);
  const float lin_den = fmaxf(__fsub_rn(mx, mn), 1e-30f);
  float4* out4 = reinterpret_cast<float4*>(rgba + 4 * tile);
  // Each thread reads back only the blurred values it wrote itself.
  for (int p = threadIdx.x; p < h * w; p += kBlock) {
    const float b = blurred[tile + p];
    if (isnan(b)) {
      norm_t[tile + p] = NAN;
      out4[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    float t;
    if (use_log) {
      const float shifted = __fadd_rn(__fsub_rn(b, mn), 1e-6f);
      t = __fdiv_rn(__fsub_rn(logf(fmaxf(shifted, 1e-30f)), log_lo), log_den);
    } else {
      t = __fdiv_rn(__fsub_rn(b, mn), lin_den);
    }
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    norm_t[tile + p] = t;
    const int idx = min(max(static_cast<int>(__fmul_rn(t, static_cast<float>(n_lut))), 0),
                        n_lut - 1);
    out4[p] = make_float4(s_lut[4 * idx], s_lut[4 * idx + 1], s_lut[4 * idx + 2],
                          s_lut[4 * idx + 3]);
  }
}

// Shared memory one block needs for an h x w tile with kh x kw taps.
long long smem_bytes(int h, int w, int n_lut, int kh, int kw) {
  const long long pad = static_cast<long long>(h + kh - 1) * (w + kw - 1);
  return static_cast<long long>(sizeof(float)) * (2 * pad + 4LL * n_lut + kh * kw + 2 * kWarps);
}

}  // namespace

// mats [S, h, w] f32, lut [n_lut, 4] f32, taps [kh, kw] f32 (kh, kw odd);
// rgba [S, h, w, 4], norm_t and blurred [S, h, w] f32, 16-byte aligned.
// Returns the first CUDA error of the attribute call or the launch: a tile
// whose shared memory exceeds what one block can opt into (227 KB on an
// H100) fails the attribute call with cudaErrorInvalidValue.
extern "C" int slam_raster(const void* mats, int s, int h, int w, const void* lut,
                           int n_lut, const void* taps, int kh, int kw, int use_log,
                           void* rgba, void* norm_t, void* blurred, void* stream) {
  const long long smem = smem_bytes(h, w, n_lut, kh, kw);
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_kernel<<<s, kBlock, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mats), h, w, static_cast<const float*>(lut), n_lut,
      static_cast<const float*>(taps), kh, kw, use_log, static_cast<float*>(rgba),
      static_cast<float*>(norm_t), static_cast<float*>(blurred));
  return static_cast<int>(cudaGetLastError());
}
