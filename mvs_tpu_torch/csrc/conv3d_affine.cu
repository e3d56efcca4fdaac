// Direct 3x3x3 stride-1 SAME convolution over NDHWC volumes with a fused
// per-channel affine (the eval-mode BatchNorm fold, or a bias) and optional
// ReLU, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conv3d_lane_folded
// (mvs_tpu/ops/conv3d_pallas.py, kernel body _conv_kernel; entry
// conv3d_folded). The TPU kernel folds W into the 128-lane dimension so that
// 8-64 channel convs fill the MXU; that fold is a TPU layout device and is not
// carried over: this kernel reads the plain (B, D, H, W, C) layout.
//
// Computes y[b,z,y,x,o] = act(scale[o] * sum_{tap,i} x[..neighbour.., i] *
// w[tap, i, o] + shift[o]) with f32 accumulation; x and y are f32 or bf16.
//
// What bounds it on the card: at the cost-regularization widths the conv is
// close to the H100's bf16 ridge (the full-resolution 8- and 16-channel blocks
// sit below it, the 32/64-channel blocks above it), so the tensor cores and
// device memory both matter. This first form does neither optimally: it runs
// on the CUDA cores (f32 FMA, 67 TFLOP/s peak) and relies on L1/L2 for the
// 27-fold reuse of each input voxel. One thread computes one output voxel for
// a block of kCob output channels; the block's (27, Cin, kCob) weight slice
// sits in shared memory and is read as broadcasts, and the input is read once
// per tap from cache. Implicit GEMM on tensor cores (mma/wgmma over halo tiles
// staged by TMA) is the planned replacement.
//
// C interface (loaded with ctypes, see mvs_tpu_torch/ops/conv3d.py); every
// pointer is a device pointer to contiguous memory,
//   x      (B, D, H, W, Cin)   T
//   w      (27, Cin, Cout)     f32, taps ordered (dz, dy, dx) row-major
//   scale  (Cout,)             f32
//   shift  (Cout,)             f32
//   y      (B, D, H, W, Cout)  T
// with T = float (dtype 0) or __nv_bfloat16 (dtype 1). Launches on `stream`
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // grid-stride beyond this: weights load once

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

template <typename T, int kCob>
__global__ void __launch_bounds__(kThreads)
conv3d_affine_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, T* __restrict__ y,
                     int D, int H, int W, int Cin, int Cout, int relu,
                     int64_t nvox) {
  extern __shared__ float sw[];  // (27, Cin, kCob) slice of this block
  const int co0 = blockIdx.y * kCob;
  const int ncol = min(kCob, Cout - co0);
  const int nw = 27 * Cin * kCob;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int co = i % kCob;
    const int row = i / kCob;  // tap * Cin + ci
    sw[i] = co < ncol ? w[(int64_t)row * Cout + co0 + co] : 0.f;
  }
  float sc[kCob], sh[kCob];
#pragma unroll
  for (int co = 0; co < kCob; ++co) {
    sc[co] = co < ncol ? scale[co0 + co] : 0.f;
    sh[co] = co < ncol ? shift[co0 + co] : 0.f;
  }
  __syncthreads();

  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvox;
       v += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = v;
    const int xx = (int)(r % W);
    r /= W;
    const int yy = (int)(r % H);
    r /= H;
    const int zz = (int)(r % D);
    const int64_t b = r / D;

    float acc[kCob];
#pragma unroll
    for (int co = 0; co < kCob; ++co) acc[co] = 0.f;

    for (int dz = 0; dz < 3; ++dz) {
      const int z = zz + dz - 1;
      if (z < 0 || z >= D) continue;
      for (int dy = 0; dy < 3; ++dy) {
        const int yv = yy + dy - 1;
        if (yv < 0 || yv >= H) continue;
        for (int dx = 0; dx < 3; ++dx) {
          const int xv = xx + dx - 1;
          if (xv < 0 || xv >= W) continue;
          const T* xp = x + (((b * D + z) * H + yv) * (int64_t)W + xv) * Cin;
          const float* wp = sw + ((dz * 3 + dy) * 3 + dx) * Cin * kCob;
          for (int ci = 0; ci < Cin; ++ci) {
            const float xvl = to_f32(xp[ci]);
#pragma unroll
            for (int co = 0; co < kCob; ++co)
              acc[co] = fmaf(xvl, wp[ci * kCob + co], acc[co]);
          }
        }
      }
    }

    T* yp = y + v * Cout + co0;
#pragma unroll
    for (int co = 0; co < kCob; ++co) {
      if (co < ncol) {
        float o = acc[co] * sc[co] + sh[co];
        if (relu) o = fmaxf(o, 0.f);
        yp[co] = from_f32<T>(o);
      }
    }
  }
}

template <typename T, int kCob>
int launch_cob(const void* x, const void* w, const void* scale,
               const void* shift, void* y, int B, int D, int H, int W,
               int Cin, int Cout, int relu, cudaStream_t stream) {
  const int64_t nvox = (int64_t)B * D * H * W;
  if (nvox == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * 27 * (size_t)Cin * kCob;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_affine_kernel<T, kCob>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (nvox + kThreads - 1) / kThreads;
  dim3 grid((unsigned)(want < kMaxBlocks ? want : kMaxBlocks),
            (unsigned)((Cout + kCob - 1) / kCob));
  conv3d_affine_kernel<T, kCob><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(y), D, H, W, Cin, Cout, relu, nvox);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* shift,
           void* y, int B, int D, int H, int W, int Cin, int Cout, int relu,
           cudaStream_t stream) {
  // The score conv has one output channel: a block of 8 would idle 7/8 of
  // its FMAs.
  if (Cout == 1)
    return launch_cob<T, 1>(x, w, scale, shift, y, B, D, H, W, Cin, Cout,
                            relu, stream);
  return launch_cob<T, 8>(x, w, scale, shift, y, B, D, H, W, Cin, Cout, relu,
                          stream);
}

}  // namespace

extern "C" int mvs_conv3d_affine(const void* x, const void* w,
                                 const void* scale, const void* shift,
                                 void* y, int B, int D, int H, int W, int Cin,
                                 int Cout, int relu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, scale, shift, y, B, D, H, W, Cin, Cout, relu,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, shift, y, B, D, H, W, Cin, Cout,
                                 relu, s);
  return (int)cudaErrorInvalidValue;
}
