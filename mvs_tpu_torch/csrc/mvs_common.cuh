// Helpers shared by the port's CUDA sources: f32 <-> storage-type
// conversions, the plane-sweep sampling steps that the warp-variance and
// group-correlation kernels share (so that both round the projected
// coordinates as plane_sweep_coords does and sample the same corners), and
// the sm_80+ primitives the tensor-core conv is built from (16-byte cp.async
// with zero fill, ldmatrix, bf16 and TF32 mma.sync, the TF32 rounding of
// its 3xTF32 split), the dsrc window that the two
// backward kernels add their source gradients into, and the host-side
// launch checks and variant dispatch that they share.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
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

// Lane l of a warp rotates pixel (px, py), the l-th of the warp's 32, into
// each view: rot[v * 96 + i * 32 + l] = row i of R_v @ [px, py, 1], kept in
// shared memory across depths (sgeom: the views' (V, 12) geometry);
// sample_record reads it back with a stride of 32.
__device__ __forceinline__ void rotate_pixel(const float* sgeom, float* rot,
                                             int V, int px, int py,
                                             int lane) {
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rot[v * 96 + i * 32 + lane] = rotate_row(sgeom + v * 12, i, px, py);
  }
}

// The source coordinates (x, y) of a rotated pixel (rot: its 3 rotate_row
// values, `stride` floats apart) at depth `dep` in the view with geometry g:
// multiply-add depth and translation, then divide, as plane_sweep_coords
// does; a point with z <= 1e-3 (behind the source camera) goes to (-2W, -2H).
__device__ __forceinline__ float2 project(const float* rot, int stride,
                                          const float* g, float dep, int W,
                                          int H) {
  const float qx = __fadd_rn(__fmul_rn(rot[0], dep), g[9]);
  const float qy = __fadd_rn(__fmul_rn(rot[stride], dep), g[10]);
  const float qz = __fadd_rn(__fmul_rn(rot[2 * stride], dep), g[11]);
  if (qz > 1e-3f) return make_float2(__fdiv_rn(qx, qz), __fdiv_rn(qy, qz));
  // behind the source camera: far outside, every corner drops
  return make_float2(-2.f * (float)W, -2.f * (float)H);
}

// The sample record of a rotated pixel at depth `dep` (project's arguments):
// (corner offset in elements, wx, wy, corner validity bits). Validity is
// tested in float space, so a coordinate pushed behind the camera or far off
// the image never reaches an int conversion.
__device__ __forceinline__ int4 sample_record(const float* rot, int stride,
                                              const float* g, float dep,
                                              int W, int H, int C) {
  const float2 s = project(rot, stride, g, dep, W, H);
  const float x0f = floorf(s.x);
  const float y0f = floorf(s.y);
  const bool okx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool okx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool oky0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool oky1 = y0f >= -1.f && y0f <= (float)(H - 2);
  const int xi = (okx0 || okx1) ? (int)x0f : 0;
  const int yi = (oky0 || oky1) ? (int)y0f : 0;
  const int mask = (oky0 && okx0) | (oky0 && okx1) << 1 |
                   (oky1 && okx0) << 2 | (oky1 && okx1) << 3;
  return make_int4((yi * W + xi) * C, __float_as_int(s.x - x0f),
                   __float_as_int(s.y - y0f), mask);
}

// The 2x2 cell of source coordinates s: (x0, y0, wx, wy), x0 = floor(x)
// where one of the cell's columns lies on the image and -2 where none does
// (likewise y0), so that a corner is on the image exactly where
// sample_record sets its validity bit (cell_mask).
__device__ __forceinline__ int4 sample_cell(float2 s, int W, int H) {
  const float x0f = floorf(s.x), y0f = floorf(s.y);
  const int xi = x0f >= -1.f && x0f <= (float)(W - 1) ? (int)x0f : -2;
  const int yi = y0f >= -1.f && y0f <= (float)(H - 1) ? (int)y0f : -2;
  return make_int4(xi, yi, __float_as_int(s.x - x0f),
                   __float_as_int(s.y - y0f));
}

// sample_record's corner validity bits of a cell.
__device__ __forceinline__ int cell_mask(int4 c, int W, int H) {
  const bool okx0 = (unsigned)c.x < (unsigned)W;
  const bool okx1 = (unsigned)(c.x + 1) < (unsigned)W;
  const bool oky0 = (unsigned)c.y < (unsigned)H;
  const bool oky1 = (unsigned)(c.y + 1) < (unsigned)H;
  return (oky0 && okx0) | (oky0 && okx1) << 1 | (oky1 && okx0) << 2 |
         (oky1 && okx1) << 3;
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

// x (f32 bits) rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest,
// ties away from zero), with the 13 low bits cleared so that the rest, x
// minus this, is exact in f32: half a TF32 unit added to the magnitude's
// bits, then truncated (finite x).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// c += a (16x8, row-major) * b (8x8, column-major), TF32 in, f32 sums.
__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- The dsrc window of the backward kernels --------------------------------
//
// A backward block owns a 16 x 8 tile of reference pixels, one per thread;
// warp w owns the 8 x 4 patch at ((w & 1) * 8, (w >> 1) * 4) and works on
// its own: it walks the channels in slices of 8 and, per slice, the depths
// in chunks. Per chunk each source view gets a box of source cells in the
// warp's part of shared memory (its window), planned from the samples at
// the chunk's first and last depth: where the hypotheses are monotone in
// depth (every sweep of the models), those bound every sample in between.
// The samples' dsrc cotangents are added there, and the window is added to
// the f32 dsrc buffer once per chunk by the TMA unit (cp.reduce.async.bulk),
// one reduction per source pixel's slice (per row of a box when C = 8). A
// sample whose cell is not in its view's window (a sweep that is not
// monotone, a footprint larger than the window) takes the spill branch:
// scatter_corners' global atomics. Off-image corners are dropped either way.
//
// The adds are plain read-modify-writes of 16 bytes, not atomics (a float
// atomic on shared memory is a compare-and-swap loop on sm_90): only the
// warp touches its window, a __syncwarp orders one corner's writes before
// the next corner's reads, and lanes whose cells coincide take turns
// (a claim table of 32 entries, hashed by the cell). Layout: one slot of 8
// f32 per source cell (the slice's channels), the views' boxes one after
// another, each box's row stride bw a multiple of 4 slots; a lane writes
// the half of its slot that bit 2 of the cell's x selects first, so that
// the 8 lanes of a patch row, whose cells are 8 consecutive columns where
// the warp's pixels map near one to one, hit distinct banks.

constexpr int kWinThreads = 128;  // a 16 x 8 tile, one pixel per thread
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kWinTileW = 16, kWinTileH = 8;
constexpr int kInWin = 16;  // record bit 4: the sample's cell is in the window
// Shared memory per block: 4 blocks (16 warps) per SM, each with 1 KB that
// the SM reserves, fill its 228 KB.
constexpr int kGradBlocksPerSm = 4;
constexpr size_t kGradSmemBytes = 56 * 1024;

// Thread t's pixel offset in its block's tile.
__device__ __forceinline__ int2 tile_offset(int t) {
  const int warp = t >> 5, lane = t & 31;
  return make_int2((warp & 1) * 8 + (lane & 7), (warp >> 1) * 4 + (lane >> 3));
}

// A backward block's shared memory, carved in this order (each part a
// multiple of 16 bytes): windows [4 warps][slots][8] f32; records [V][128]
// int4; with kDepth, depth jacobians [V][128] float2; boxes [4 warps][V][2]
// int4 (box[2v] = (x, y, w, h) in source cells, box[2v + 1] = (row stride
// bw, first slot, 0, 0), w = 0 for none); claims [4 warps][32] int;
// rotated pixels [V][3][128] f32; geometry [V][12] f32. Thread t owns
// column t of the records, jacobians and rotated pixels.
struct GradSmem {
  float* win;  // this warp's window
  int4* rec;
  float2* jac;
  int4* box;   // this warp's boxes
  int* claim;  // this warp's claims
  float* rot;
  float* geom;
};

inline size_t grad_smem_fixed(int V, bool depth) {
  return (size_t)V * (kWinThreads * (16 + (depth ? 8 : 0) + 12) +
                      kWinWarps * 2 * 16 + 12 * 4) +
         kWinWarps * 32 * 4;
}

// slots: each warp's window, in slots (a multiple of 4).
__device__ __forceinline__ GradSmem carve_grad_smem(void* base, int V,
                                                    int slots, bool depth) {
  const int warp = threadIdx.x >> 5;
  char* p = static_cast<char*>(base);
  GradSmem s;
  s.win = reinterpret_cast<float*>(p) + warp * slots * 8;
  p += (size_t)kWinWarps * slots * 32;
  s.rec = reinterpret_cast<int4*>(p);
  p += (size_t)V * kWinThreads * 16;
  s.jac = reinterpret_cast<float2*>(p);
  if (depth) p += (size_t)V * kWinThreads * 8;
  s.box = reinterpret_cast<int4*>(p) + warp * V * 2;
  p += (size_t)kWinWarps * V * 2 * 16;
  s.claim = reinterpret_cast<int*>(p) + warp * 32;
  p += kWinWarps * 32 * 4;
  s.rot = reinterpret_cast<float*>(p);
  s.geom = s.rot + V * 3 * kWinThreads;
  return s;
}

// Load the batch's (V, 12) geometry and rotate the thread's pixel (px, py)
// into each view, kept for every slice and depth.
__device__ __forceinline__ void grad_setup(const GradSmem& s,
                                           const float* geom, int V, int px,
                                           int py) {
  for (int i = threadIdx.x; i < V * 12; i += kWinThreads) s.geom[i] = geom[i];
  __syncthreads();
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s.rot[(v * 3 + i) * kWinThreads + threadIdx.x] =
          rotate_row(s.geom + v * 12, i, px, py);
  }
}

__device__ __forceinline__ float2 grad_project(const GradSmem& s, int v,
                                               float dep, int W, int H) {
  return project(s.rot + v * 3 * kWinThreads + threadIdx.x, kWinThreads,
                 s.geom + v * 12, dep, W, H);
}

__device__ __forceinline__ float2 grad_jacobian(const GradSmem& s, int v,
                                                float dep) {
  return depth_jacobian(s.rot + v * 3 * kWinThreads + threadIdx.x,
                        kWinThreads, s.geom + v * 12, dep);
}

// The thread's sample record in view v at depth dep (sample_record's; no
// valid corner when the pixel is off the image, !ok), with the cell's box
// coordinates in bits 5-17 and 18-30 and kInWin where the whole 2x2 cell
// lies in view v's window.
__device__ __forceinline__ int4 grad_record(const GradSmem& s, int v,
                                            float dep, bool ok, int W, int H,
                                            int C) {
  const int4 c = sample_cell(grad_project(s, v, dep, W, H), W, H);
  int mask = ok ? cell_mask(c, W, H) : 0;
  const int4 box = s.box[2 * v];
  const int dx = c.x - box.x, dy = c.y - box.y;
  if (mask && dx >= 0 && dx < box.z - 1 && dy >= 0 && dy < box.w - 1)
    mask |= kInWin | dx << 5 | dy << 18;
  return make_int4(mask ? (c.y * W + c.x) * C : 0, c.z, c.w, mask);
}

// slot[0..7] += w * dv[0..7] as two 16-byte read-modify-writes, the half
// `hi` first.
__device__ __forceinline__ void slot_add(float* slot, float w,
                                         const float* dv, bool hi) {
  float4* p = reinterpret_cast<float4*>(slot);
  const float4 lo4 = make_float4(w * dv[0], w * dv[1], w * dv[2], w * dv[3]);
  const float4 hi4 = make_float4(w * dv[4], w * dv[5], w * dv[6], w * dv[7]);
  const float4 a = hi ? hi4 : lo4, b = hi ? lo4 : hi4;
  float4 u = p[hi], t = p[!hi];
  u.x += a.x, u.y += a.y, u.z += a.z, u.w += a.w;
  t.x += b.x, t.y += b.y, t.z += b.z, t.w += b.w;
  p[hi] = u;
  p[!hi] = t;
}

// Add a sample's cotangent dv (the slice's channels; zero past the first
// nc) to the valid corners of record r in view v, each corner's share
// weighted as the forward blended it: into the warp's window, or (the
// spill branch) with global atomics at dst, the view's f32 dsrc plus the
// slice's first channel. Every lane of the warp calls it.
template <bool kVec>
__device__ __forceinline__ void scatter_sample(const GradSmem& s, int v,
                                               float* dst, int4 r, int nc,
                                               int C, int rowc,
                                               const float* dv) {
  bool pending = r.w & kInWin;
  if (!pending && (r.w & 15)) scatter_corners<kVec>(dst, r, nc, C, rowc, dv);
  if (!__any_sync(0xffffffffu, pending)) return;
  const int lane = threadIdx.x & 31;
  const int4 b = s.box[2 * v + 1];
  const int dx = (r.w >> 5) & 0x1fff, dy = (r.w >> 18) & 0x1fff;
  const int hash = (dx & 7) | (dy & 3) << 3;
  float w[4];
  corner_weights(r, w);
  float* s00 = s.win + (b.y + dy * b.x + dx) * 8;
  do {  // lanes whose cells share a hash take turns
    if (pending) s.claim[hash] = lane;
    __syncwarp();
    const bool go = pending && s.claim[hash] == lane;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (go && (r.w & (1 << i)))
        slot_add(s00 + ((i & 1) + (i >> 1) * b.x) * 8, w[i], dv,
                 (dx + (i & 1)) & 4);
      __syncwarp();  // this corner's writes before the next one's reads
    }
    pending = pending && !go;
  } while (__any_sync(0xffffffffu, pending));
}

// Plan the warp's chunk of depths that starts at d0 (hyp: the thread's
// pixel's hypothesis at depth 0, hw apart; ok: the pixel is on the image):
// try `want` depths and halve until the views' boxes over the chunk's
// first and last depth fit the warp's `slots`. At one depth that does not
// fit, the views keep their boxes in order while they fit; the rest get
// none. Writes the boxes, zeroes the slots they use (returned in *used) and
// returns the chunk's length. Every lane of the warp calls it.
__device__ int window_plan(const GradSmem& s, const float* hyp, int hw,
                           bool ok, int d0, int want, int V, int W, int H,
                           int slots, int* used) {
  const int lane = threadIdx.x & 31;
  int L = want, n;
  __syncwarp();  // the last chunk's window and boxes are free
  for (;;) {
    int need = 0;
    n = 0;
    for (int v = 0; v < V; ++v) {
      int x0 = INT_MAX, x1 = INT_MIN, y0 = INT_MAX, y1 = INT_MIN;
      if (ok) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dep = __ldg(hyp + (int64_t)(e ? d0 + L - 1 : d0) * hw);
          const int4 c = sample_cell(grad_project(s, v, dep, W, H), W, H);
          if (c.x != -2 && c.y != -2) {  // a corner on the image
            x0 = min(x0, c.x);
            x1 = max(x1, c.x);
            y0 = min(y0, c.y);
            y1 = max(y1, c.y);
          }
        }
      }
      x0 = __reduce_min_sync(0xffffffffu, x0);
      x1 = __reduce_max_sync(0xffffffffu, x1);
      y0 = __reduce_min_sync(0xffffffffu, y0);
      y1 = __reduce_max_sync(0xffffffffu, y1);
      int4 box = make_int4(0, 0, 0, 0), row = make_int4(0, 0, 0, 0);
      if (x0 <= x1) {
        const int w = x1 - x0 + 2, h = y1 - y0 + 2, bw = (w + 3) & ~3;
        need += bw * h;
        if (n + bw * h <= slots) {
          box = make_int4(x0, y0, w, h);
          row = make_int4(bw, n, 0, 0);
          n += bw * h;
        }
      }
      if (lane == 0) {
        s.box[2 * v] = box;
        s.box[2 * v + 1] = row;
      }
    }
    if (need <= slots || L == 1) break;
    L = (L + 1) >> 1;
  }
  float4* w4 = reinterpret_cast<float4*>(s.win);
  for (int i = lane; i < n * 2; i += 32) w4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  *used = n;
  return L;
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src,
                                                int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(__cvta_generic_to_global(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// Add the warp's window to dsrc (dst: the batch's f32 dsrc plus the
// slice's first channel, vstride elements per view): make the writes
// visible to the TMA unit and reduce each on-image source pixel's nc
// channels (a row of a box at once when C = 8) into dst. Returns once the
// TMA has read the window. Every lane of the warp calls it.
__device__ void window_flush(const GradSmem& s, int used, int V, float* dst,
                             int vstride, int W, int H, int C, int nc) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  for (int i = threadIdx.x & 31; i < used; i += 32) {
    int v = 0;  // slot i's view: the last box that starts at or before it
    for (int u = 1; u < V; ++u) {
      const int4 row = s.box[2 * u + 1];
      if (row.x && row.y <= i) v = u;
    }
    const int4 box = s.box[2 * v], row = s.box[2 * v + 1];
    const int y = (i - row.y) / row.x, x = i - row.y - y * row.x;
    const int gx = box.x + x, gy = box.y + y;
    if (x >= box.z || gx < 0 || gx >= W || gy < 0 || gy >= H) continue;
    int bytes = nc * 4;
    if (C == 8) {  // the row's on-image slots are one run
      if (gx != max(box.x, 0)) continue;
      bytes = (min(box.x + box.z, W) - gx) * 32;
    }
    bulk_reduce_add(dst + (int64_t)v * vstride + (gy * W + gx) * C,
                    s.win + i * 8, bytes);
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's bulk reductions have reached global memory.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// A backward kernel's launch: the grid of 16 x 8 tiles (`split` blocks per
// tile along y) per batch, the dynamic shared memory (kGradSmemBytes) and
// each warp's window slots in it. No
// window (every sample spills) when C % 4 != 0 or dsrc is not 16-byte
// aligned: the TMA's reductions move 16-byte-aligned runs of 16-byte
// multiples.
template <typename Kernel>
int grad_launch_config(Kernel* kernel, int B, int V, int H, int W, int C,
                       bool depth, const void* dsrc, int split, dim3* grid,
                       size_t* smem, int* slots) {
  const size_t fixed = grad_smem_fixed(V, depth);
  const bool window = C % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(dsrc) % 16 == 0 &&
                      fixed < kGradSmemBytes;
  *slots = window ? (int)((kGradSmemBytes - fixed) / (kWinWarps * 32)) & ~3
                  : 0;
  *smem = fixed + (size_t)kWinWarps * *slots * 32;
  const int err = reserve_smem(kernel, *smem);
  if (err != cudaSuccess) return err;
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  const int64_t tx = (W + kWinTileW - 1) / kWinTileW;
  const int64_t ty = (H + kWinTileH - 1) / kWinTileH * split;
  if (tx > INT32_MAX || ty > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)tx, (unsigned)ty, (unsigned)B);
  return cudaSuccess;
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
