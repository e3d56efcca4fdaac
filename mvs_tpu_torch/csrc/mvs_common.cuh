// Helpers shared by the port's CUDA sources: f32 <-> storage-type
// conversions, the plane-sweep sampling steps that the warp-variance and
// group-correlation kernels share (so that both round the projected
// coordinates as plane_sweep_coords does and sample the same corners), and
// the sm_80+ primitives the tensor-core conv is built from (16-byte cp.async
// with zero fill, ldmatrix, bf16 mma.sync), and the host-side launch checks
// and variant dispatch that the two backward kernels share.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mvs {

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

// Two f32 values rounded to bf16 and packed, `lo` at the lower address.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- Plane-sweep sampling, channels-last features --------------------------

__device__ __forceinline__ void vec_load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void vec_load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Channels c0 .. c0+7 of one feature row (the first nc of them when !kVec),
// zero where `ok` is false. kVec: one 16-byte load (two for f32), which
// needs C % 8 == 0 and 16-byte-aligned rows.
template <bool kVec, typename T>
__device__ __forceinline__ void load8(const T* p, bool ok, int nc, float* v) {
  if constexpr (kVec) {
    if (ok) {
      vec_load8(p, v);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (ok && k < nc) ? to_f32(p[k]) : 0.f;
}

// Row i of R @ [px, py, 1], g = the view's (R rows, t) geometry. Same order
// as plane_sweep_coords (x term + y term, then the constant column): the _rn
// intrinsics keep nvcc from contracting these into fused multiply-adds, so
// every step rounds once as the elementwise PyTorch version does.
__device__ __forceinline__ float rotate_row(const float* g, int i, int px,
                                            int py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(g[3 * i], (float)px),
                             __fmul_rn(g[3 * i + 1], (float)py)),
                   g[3 * i + 2]);
}

// The sample record of a rotated pixel (rot: its 3 rotate_row values,
// `stride` floats apart) at depth `dep` in the view with geometry g: (corner
// offset in elements, wx, wy, corner validity bits). Multiply-add depth and
// translation, then divide, as plane_sweep_coords does; a point with z <=
// 1e-3 (behind the source camera) goes to (-2W, -2H). Validity is tested in
// float space, so a coordinate pushed behind the camera or far off the
// image never reaches an int conversion.
__device__ __forceinline__ int4 sample_record(const float* rot, int stride,
                                              const float* g, float dep,
                                              int W, int H, int C) {
  const float qx = __fadd_rn(__fmul_rn(rot[0], dep), g[9]);
  const float qy = __fadd_rn(__fmul_rn(rot[stride], dep), g[10]);
  const float qz = __fadd_rn(__fmul_rn(rot[2 * stride], dep), g[11]);
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
  const bool okx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool okx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool oky0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool oky1 = y0f >= -1.f && y0f <= (float)(H - 2);
  const int xi = (okx0 || okx1) ? (int)x0f : 0;
  const int yi = (oky0 || oky1) ? (int)y0f : 0;
  const int mask = (oky0 && okx0) | (oky0 && okx1) << 1 |
                   (oky1 && okx0) << 2 | (oky1 && okx1) << 3;
  return make_int4((yi * W + xi) * C, __float_as_int(xs - x0f),
                   __float_as_int(ys - y0f), mask);
}

// The four corner weights of a record, in bit order (00, 01, 10, 11).
__device__ __forceinline__ void corner_weights(int4 r, float* w) {
  const float wx = __int_as_float(r.y), wy = __int_as_float(r.z);
  w[0] = (1.f - wx) * (1.f - wy);
  w[1] = wx * (1.f - wy);
  w[2] = (1.f - wx) * wy;
  w[3] = wx * wy;
}

// f = the bilinear sample of channels c0 .. c0+7 at record r; sv points at
// the view's features plus c0, rowc = W * C. A corner off the image is not
// loaded: it reads as zero.
template <bool kVec, typename T>
__device__ __forceinline__ void blend(const T* sv, int4 r, int nc, int C,
                                      int rowc, float* f) {
  float w[4];
  corner_weights(r, w);
  sv += r.x;
  float v00[8], v01[8], v10[8], v11[8];
  load8<kVec>(sv, r.w & 1, nc, v00);
  load8<kVec>(sv + C, r.w & 2, nc, v01);
  load8<kVec>(sv + rowc, r.w & 4, nc, v10);
  load8<kVec>(sv + rowc + C, r.w & 8, nc, v11);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    f[k] = v00[k] * w[0] + v01[k] * w[1] + v10[k] * w[2] + v11[k] * w[3];
}

// ---- Gradients of a sample -------------------------------------------------

// (dx/ddep, dy/ddep) of the source coordinates of a rotated pixel (rot, as
// sample_record reads it) at depth `dep`: the quotient rule of
// plane_sweep_coords' divisions, (r_x - x r_z) / q_z and (r_y - y r_z) / q_z,
// with q and the coordinates rounded as sample_record rounds them. A point
// with q_z <= 1e-3 gets (0, 0): plane_sweep_coords' `where` gives it no
// gradient.
__device__ __forceinline__ float2 depth_jacobian(const float* rot, int stride,
                                                 const float* g, float dep) {
  const float rz = rot[2 * stride];
  const float qx = __fadd_rn(__fmul_rn(rot[0], dep), g[9]);
  const float qy = __fadd_rn(__fmul_rn(rot[stride], dep), g[10]);
  const float qz = __fadd_rn(__fmul_rn(rz, dep), g[11]);
  if (!(qz > 1e-3f)) return make_float2(0.f, 0.f);
  const float xs = __fdiv_rn(qx, qz), ys = __fdiv_rn(qy, qz);
  return make_float2(__fdiv_rn(rot[0] - xs * rz, qz),
                     __fdiv_rn(rot[stride] - ys * rz, qz));
}

// blend's f, and the sample's derivatives along x and y with the corners
// held: fx = (1 - wy)(v01 - v00) + wy (v11 - v10), fy = (1 - wx)(v10 - v00)
// + wx (v11 - v01), each corner off the image read as zero. JAX
// differentiates x - floor(x) with slope 1 everywhere, so at an integer x
// these are the right-hand differences (and -v00 at x = W - 1).
template <bool kVec, typename T>
__device__ __forceinline__ void blend_diff(const T* sv, int4 r, int nc, int C,
                                           int rowc, float* f, float* fx,
                                           float* fy) {
  float w[4];
  corner_weights(r, w);
  const float wx = __int_as_float(r.y), wy = __int_as_float(r.z);
  sv += r.x;
  float v00[8], v01[8], v10[8], v11[8];
  load8<kVec>(sv, r.w & 1, nc, v00);
  load8<kVec>(sv + C, r.w & 2, nc, v01);
  load8<kVec>(sv + rowc, r.w & 4, nc, v10);
  load8<kVec>(sv + rowc + C, r.w & 8, nc, v11);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    f[k] = v00[k] * w[0] + v01[k] * w[1] + v10[k] * w[2] + v11[k] * w[3];
    fx[k] = (1.f - wy) * (v01[k] - v00[k]) + wy * (v11[k] - v10[k]);
    fy[k] = (1.f - wx) * (v10[k] - v00[k]) + wx * (v11[k] - v01[k]);
  }
}

// dst[k] += w * dv[k] for the first nc channels, as f32 atomics: two
// 16-byte vector atomics on the 16-byte path (sm_90), else scalar ones.
template <bool kVec>
__device__ __forceinline__ void scatter8(float* dst, float w, int nc,
                                         const float* dv) {
  if constexpr (kVec) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(w * dv[0], w * dv[1], w * dv[2], w * dv[3]));
    atomicAdd(reinterpret_cast<float4*>(dst) + 1,
              make_float4(w * dv[4], w * dv[5], w * dv[6], w * dv[7]));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < nc) atomicAdd(dst + k, w * dv[k]);
  }
}

// Scatter a sample's cotangent dv to the valid corners of record r (dst
// points at the view's f32 gradient plus c0), each corner's share weighted
// as the forward blended it.
template <bool kVec>
__device__ __forceinline__ void scatter_corners(float* dst, int4 r, int nc,
                                                int C, int rowc,
                                                const float* dv) {
  float w[4];
  corner_weights(r, w);
  dst += r.x;
  if (r.w & 1) scatter8<kVec>(dst, w[0], nc, dv);
  if (r.w & 2) scatter8<kVec>(dst + C, w[1], nc, dv);
  if (r.w & 4) scatter8<kVec>(dst + rowc, w[2], nc, dv);
  if (r.w & 8) scatter8<kVec>(dst + rowc + C, w[3], nc, dv);
}

// ---- sm_80+ primitives of the tensor-core conv ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 reads nothing and writes 16
// zero bytes (the zero padding of a halo).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- Host-side launch helpers ----------------------------------------------

// Whether every corner offset into an (H, W, C) feature map, hw = H * W,
// fits the kernels' int32 element offsets.
inline bool offsets_fit(int64_t hw, int W, int C) {
  return (hw + W + 1) * C <= INT32_MAX;
}

// Let `kernel` take `smem` bytes of dynamic shared memory: refuses more than
// an sm_90 block can have (227 KB), opts in above the default 48 KB.
template <typename Kernel>
int reserve_smem(Kernel* kernel, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
struct TypeTag {
  using type = T;
};
template <bool B>
using Flag = std::integral_constant<bool, B>;

// A backward kernel's variant chosen at run time: returns
// launch(TypeTag<T>{}, Flag<kVec>{}, Flag<kDepth>{}) with T = float (dtype 0)
// or __nv_bfloat16 (dtype 1), kVec = vec (the 16-byte path, which needs
// C % 8 == 0) and kDepth = depth (the hypotheses' gradient).
template <typename Launch>
int dispatch_grad(int dtype, bool vec, bool depth, int C, Launch launch) {
  if (vec && C % 8 != 0) return (int)cudaErrorInvalidValue;
  auto flags = [&](auto type) -> int {
    if (depth)
      return vec ? launch(type, Flag<true>{}, Flag<true>{})
                 : launch(type, Flag<false>{}, Flag<true>{});
    return vec ? launch(type, Flag<true>{}, Flag<false>{})
               : launch(type, Flag<false>{}, Flag<false>{});
  };
  if (dtype == 0) return flags(TypeTag<float>{});
  if (dtype == 1) return flags(TypeTag<__nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace mvs
