// Fused plane-sweep warp + variance cost volume for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_variance_volume_pallas
// (mvs_tpu/ops/warp_pallas.py, kernel body _kernel): for every output
// (b, d, y, x) it projects the reference pixel at its depth hypothesis into
// each source view, samples the source features bilinearly with zero fill,
// and accumulates sum(f) and sum(f^2) over ref + V views in f32 registers, so
// no per-view warped volume ever reaches device memory. The variance
// sum(f^2)/N - (sum(f)/N)^2 is written once, in the input dtype.
//
// Unlike the TPU kernel (banded hat-function matmuls with a coverage
// contract), sampling here is exact: four corner gathers of a C-vector per
// view, which is what the GPU's caches are built for.
//
// What bounds it on the card: bytes. The volume it writes (B*D*H*W*C
// elements) is the largest tensor of each cascade stage. Per output element
// the least f32 work is ~10 flops per source view (a bilinear blend from four
// precomputed corner weights, and two sums), ~40 for four views, plus ~14 per
// (pixel, depth, view) for the depth multiply-add, divide and weights (the
// rotation is per pixel and view): ~14-20 flops per byte of a bf16 volume
// with its features and hypotheses, under the H100's f32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 (chip_smoke.py computes both least times).
// The design keeps the one unavoidable write and reads the (small,
// cache-resident) feature maps through L1/L2: one thread owns one output
// pixel and a chunk of kChunk channels, so neighbouring threads write
// neighbouring addresses and the corner gathers of a warp hit a few cache
// lines.
//
// C interface (loaded with ctypes, see mvs_tpu_torch/ops/warp_variance.py):
// every pointer is a device pointer to contiguous memory,
//   ref  (B, H, W, C)      T
//   src  (B, V, H, W, C)   T
//   geom (B, V, 12)        f32: rows of R (9 values) then t (3) of src @ ref^-1
//   hyp  (B, D, H, W)      f32 per-pixel depth hypotheses
//   out  (B, D, H, W, C)   T
// with T = float (dtype 0) or __nv_bfloat16 (dtype 1). Launches on `stream`
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;     // channels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, bool ok, int nc,
                                           float* v) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) v[k] = (ok && k < nc) ? to_f32(p[k]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_variance_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                     const float* __restrict__ geom,
                     const float* __restrict__ hyp, T* __restrict__ out,
                     int V, int D, int H, int W, int C, int64_t total) {
  const int nchunk = (C + kChunk - 1) / kChunk;
  const int64_t hw = (int64_t)H * W;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int chunk = (int)(t % nchunk);
    int64_t bd = t / nchunk;  // flat (b, d, y, x), reduced to (b, d) below
    const int x = (int)(bd % W);
    bd /= W;
    const int y = (int)(bd % H);
    bd /= H;
    const int b = (int)(bd / D);
    const int c0 = chunk * kChunk;
    const int nc = min(kChunk, C - c0);
    const int64_t yx = (int64_t)y * W + x;
    const float dep = hyp[bd * hw + yx];
    const float px = (float)x;
    const float py = (float)y;

    float sf[kChunk], sq[kChunk], v00[kChunk], v01[kChunk], v10[kChunk],
        v11[kChunk];
    load_chunk(ref + ((int64_t)b * hw + yx) * C + c0, true, nc, sf);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) sq[k] = sf[k] * sf[k];

    for (int v = 0; v < V; ++v) {
      const float* g = geom + ((int64_t)b * V + v) * 12;
      // Same order as plane_sweep_coords: rotate the pixel, then multiply-add
      // depth and translation, then divide. The _rn intrinsics keep nvcc from
      // contracting these into fused multiply-adds, so every step rounds once
      // as the elementwise PyTorch version does and the coordinates agree to
      // the bit.
      const float rx = __fadd_rn(__fadd_rn(__fmul_rn(g[0], px),
                                           __fmul_rn(g[1], py)), g[2]);
      const float ry = __fadd_rn(__fadd_rn(__fmul_rn(g[3], px),
                                           __fmul_rn(g[4], py)), g[5]);
      const float rz = __fadd_rn(__fadd_rn(__fmul_rn(g[6], px),
                                           __fmul_rn(g[7], py)), g[8]);
      const float qx = __fadd_rn(__fmul_rn(rx, dep), g[9]);
      const float qy = __fadd_rn(__fmul_rn(ry, dep), g[10]);
      const float qz = __fadd_rn(__fmul_rn(rz, dep), g[11]);
      float xs, ys;
      if (qz > 1e-3f) {
        xs = __fdiv_rn(qx, qz);
        ys = __fdiv_rn(qy, qz);
      } else {  // behind the source camera: far outside, every corner drops
        xs = -2.f * (float)W;
        ys = -2.f * (float)H;
      }
      const float x0f = floorf(xs);
      const float y0f = floorf(ys);
      const float wx = xs - x0f;
      const float wy = ys - y0f;
      // Corner validity in float space, so huge coordinates cannot overflow
      // an int before they are rejected.
      const bool okx0 = x0f >= 0.f && x0f <= (float)(W - 1);
      const bool okx1 = x0f >= -1.f && x0f <= (float)(W - 2);
      const bool oky0 = y0f >= 0.f && y0f <= (float)(H - 1);
      const bool oky1 = y0f >= -1.f && y0f <= (float)(H - 2);
      const int xi = (okx0 || okx1) ? (int)x0f : 0;
      const int yi = (oky0 || oky1) ? (int)y0f : 0;
      const T* sv = src + ((int64_t)b * V + v) * hw * C + c0;
      const int64_t r0 = (int64_t)yi * W;
      const int64_t r1 = (int64_t)(yi + 1) * W;
      load_chunk(sv + (r0 + xi) * C, oky0 && okx0, nc, v00);
      load_chunk(sv + (r0 + xi + 1) * C, oky0 && okx1, nc, v01);
      load_chunk(sv + (r1 + xi) * C, oky1 && okx0, nc, v10);
      load_chunk(sv + (r1 + xi + 1) * C, oky1 && okx1, nc, v11);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float top = v00[k] * (1.f - wx) + v01[k] * wx;
        const float bot = v10[k] * (1.f - wx) + v11[k] * wx;
        const float f = top * (1.f - wy) + bot * wy;
        sf[k] += f;
        sq[k] += f * f;
      }
    }

    const float n = (float)(V + 1);
    T* op = out + (bd * hw + yx) * C + c0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < nc) {
        const float mean = sf[k] / n;
        op[k] = from_f32<T>(sq[k] / n - mean * mean);
      }
    }
  }
}

template <typename T>
int launch(const void* ref, const void* src, const void* geom,
           const void* hyp, void* out, int B, int V, int D, int H, int W,
           int C, cudaStream_t stream) {
  const int64_t total =
      (int64_t)B * D * H * W * ((C + kChunk - 1) / kChunk);
  if (total == 0) return cudaSuccess;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65536 ? want : 65536);
  warp_variance_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(geom), static_cast<const float*>(hyp),
      static_cast<T*>(out), V, D, H, W, C, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mvs_warp_variance(const void* ref, const void* src,
                                 const void* geom, const void* hyp, void* out,
                                 int B, int V, int D, int H, int W, int C,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ref, src, geom, hyp, out, B, V, D, H, W, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ref, src, geom, hyp, out, B, V, D, H, W, C,
                                 s);
  return (int)cudaErrorInvalidValue;
}
