// Fused plane-sweep warp + group-wise correlation cost volume for Hopper
// (sm_90a): AACVP-MVSNet's cost.
//
// The counterpart of the JAX package's fused group-correlation mode
// (mvs_tpu/ops/hat_warp.py, fused_variance_volume_banded with
// mode="group_correlation", the TPU path of AACVP's refine levels) and of
// group_correlation_cost_volume with the exact gather sampler
// (mvs_tpu/ops/cost_volume.py). It has no pallas_call of its own. For every
// output (b, d, pixel, g) it computes
//
//   (1/V) sum_v (1/Cg) sum_{c in group g} bilinear_v(c) * ref(c),
//
// Cg = C / G channels per group, over the V source views (the reference
// view is not a term). Each (pixel, depth) is projected into each source
// view with the coordinate steps of mvs_common.cuh (rotate_row,
// sample_record), which round as plane_sweep_coords does, so it samples
// the same corners with the same weights as the warp-variance kernel; a
// point with z <= 1e-3 is sent off the image, and a corner off the image
// reads as zero. Sums are f32; features and the output are f32 or bf16. No
// per-view warped volume reaches device memory: the output is (B, D, H, W,
// G), G = 4 values per (pixel, depth) where the variance volume has C = 16.
//
// What bounds it on the card: with C = 16, G = 4 and 4 source views the
// output is 4 values per (pixel, depth) but the arithmetic is ~600 f32
// operations (per view the projection and 16 channels of 4-corner blends),
// so f32 operations and bytes are close (chip_smoke.py computes both least
// times for each call).
//
// Design of the 16-byte variant (C % 8 == 0; group_correlation_lane_kernel):
// the warp-variance kernel's lane layout. A block owns a 16 x 8 pixel tile
// and a group of depths, each warp an 8 x 4 patch. Once per depth group
// lane l rotates pixel l of its patch into each view (kept in shared
// memory); once per (pixel, depth, view) it writes one 16-byte sample record
// (corner offset, wx, wy, validity bits) to shared memory. Then the warp
// walks (pixel, 16-byte chunk) pairs, consecutive lanes on consecutive
// chunks of one pixel (C / chunk rounded up to a power of two lanes a pixel,
// 4 f32 or 8 bf16 channels a chunk), so a 64-byte f32 pixel is read by 4
// lanes in one instruction, 2 full sectors per corner, where a thread per
// pixel touched 32 sectors per instruction and used half of each. Per
// chunk a lane sums each channel's bilinear samples over the views,
// multiplies by ref and adds the products of a group. Where a chunk holds
// whole groups (Cg divides the chunk: f32 at C = 16, G = 4, one group a
// chunk; bf16 at Cg = 4, two), the lane writes each of them; where a group
// spans chunks (C = 24, G = 2), each group's sum is reduced over the
// pixel's lanes by __shfl_xor and one of them writes it. Stores stream
// (__stcs), a chunk's groups in one store. Blocks split the depths until
// the card has 8 blocks per SM, and the kernel asks for a shared-memory
// carveout that leaves most of L1 to the gathers (kSharedCarveout).
// The variant with masked scalar loads (C % 8 != 0, and C above 32 chunks,
// which no model has) keeps the first design, group_correlation_kernel: one thread per pixel
// walks a group of depths and all C channels in chunks of 8. Measured on
// one H100 80GB HBM3 at 700 W, an f32 AACVP map's five launches (phase 8a's
// inputs) took 5.26 ms with the first design (level 0: 3.79) and take 1.91
// ms with this one (level 0: 1.35), against a 0.36 ms byte bound; bf16
// 1.80-1.95 and 1.63 ms. Unrolling the view loop, as the warp kernel does, made
// f32 slower (level 0: 1.75 against 1.62 without the carveout).
//
// The backward (group_correlation_grad_kernel) has no TPU counterpart: the
// JAX package trains AACVP through autodiff of the gather path. It recomputes
// the forward's samples and gives dref, dsrc and, with a template flag chosen
// when the hypotheses require a gradient, ddepth. It is built as the warp
// backward is: a 16 x 8 tile per block, a thread per pixel over every depth,
// slices of 8 channels (one block each without kDepth), and dsrc through
// the dsrc window of mvs_common.cuh with the spill branch's float4 atomics
// for samples outside it. Each sample's cotangent q ref needs no blend, so
// the corners are read once, for dref and ddepth. The first version,
// a thread per pixel with float4 atomics for every sample, took 12.0 ms per
// AACVP train step in f32; the window version takes 3.97 ms, measured on
// one H100 80GB HBM3 at 700 W, against a 0.37 ms bound.
//
// C interface (loaded with ctypes, see mvs_tpu_torch/ops/group_correlation.py):
// every pointer is a device pointer to contiguous memory,
//   ref  (B, H, W, C)      T
//   src  (B, V, H, W, C)   T
//   geom (B, V, 12)        f32: rows of R (9 values) then t (3) of src @ ref^-1
//   hyp  (B, D, H, W)      f32 per-pixel depth hypotheses
//   out  (B, D, H, W, G)   T
// with T = float (dtype 0) or __nv_bfloat16 (dtype 1) and C % G == 0; vec = 1
// selects the 16-byte loads (C % 8 == 0, 16-byte-aligned pointers; the
// forward's lane kernel also needs C <= 32 chunks: 128 f32 or 256 bf16
// channels, and refuses more). The backward entry also takes
//   grad   (B, D, H, W, G)  T    dL/dout
//   dref   (B, H, W, C)     T    written
//   dsrc   (B, V, H, W, C)  f32  zero-filled by the caller, accumulated
//   ddepth (B, D, H, W)     f32  written, or null for no depth gradient
// Each launches on `stream` and returns cudaGetLastError().

#include "mvs_common.cuh"

namespace {

using mvs::blend;
using mvs::blend_diff;
using mvs::corner_weights;
using mvs::from_f32;
using mvs::load8;
using mvs::sample_record;

constexpr int kThreads = 128;       // one pixel per thread
constexpr int kMinBlocksPerSm = 8;  // split depths until this many blocks

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_correlation_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                         const float* __restrict__ geom,
                         const float* __restrict__ hyp, T* __restrict__ out,
                         int V, int D, int H, int W, int C, int G,
                         int dgroup) {
  // [V][kThreads] sample records, [V][3][kThreads] rotated pixels (thread t
  // owns column t of each), then the batch's (V, 12) geometry.
  extern __shared__ int4 smem[];
  const int tid = threadIdx.x;
  int4* rec = smem;
  float* rot = reinterpret_cast<float*>(smem + V * kThreads);
  float* sgeom = rot + 3 * V * kThreads;

  const int b = blockIdx.z;
  const int d0 = blockIdx.y * dgroup;
  const int d1 = min(D, d0 + dgroup);
  const int hw = H * W;
  for (int i = tid; i < V * 12; i += kThreads)
    sgeom[i] = geom[(int64_t)b * V * 12 + i];
  __syncthreads();

  const int p = blockIdx.x * kThreads + tid;
  if (p >= hw) return;  // no barrier follows
  const int px = p % W, py = p / W;
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rot[(v * 3 + i) * kThreads + tid] =
          mvs::rotate_row(sgeom + v * 12, i, px, py);
  }

  const int vstride = hw * C;  // < 2^31, checked at launch
  const int rowc = W * C;
  const T* refp = ref + (int64_t)b * vstride + p * C;
  const T* srcb = src + (int64_t)b * V * vstride;
  const int cg = C / G;
  const float scale = 1.f / (float)(cg * V);

  for (int d = d0; d < d1; ++d) {
    const int64_t at = ((int64_t)b * D + d) * hw + p;
    const float dep = __ldg(hyp + at);
    for (int v = 0; v < V; ++v)
      rec[v * kThreads + tid] =
          sample_record(rot + v * 3 * kThreads + tid, kThreads,
                        sgeom + v * 12, dep, W, H, C);
    T* o = out + at * G;
    float gsum = 0.f;
    int g = 0, group_end = cg;
    for (int c0 = 0; c0 < C; c0 += 8) {
      const int nc = min(8, C - c0);
      float r[8], acc[8];
      load8<false>(refp + c0, true, nc, r);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.f;
      for (int v = 0; v < V; ++v) {
        float f[8];
        blend<false>(srcb + (int64_t)v * vstride + c0,
                     rec[v * kThreads + tid], nc, C, rowc, f);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] += f[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < nc) {
          gsum += r[k] * acc[k];
          if (c0 + k + 1 == group_end) {  // the group's last channel
            o[g] = from_f32<T>(gsum * scale);
            ++g;
            group_end += cg;
            gsum = 0.f;
          }
        }
      }
    }
  }
}

// ---- The 16-byte variant: the warp kernel's lane layout ----

constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 16, kTileH = 8;  // block tile: 2 x 2 warps of 8 x 4
// Shared memory's share of the SM's 228 KB, in percent: 100 KB, 6 blocks of
// 14.5 KB at V = 4, and the rest of the 256 KB is L1 for the gathers, which
// a block's depths mostly share. By default 15 such blocks fill 218 KB and
// leave L1 about 30 KB: f32 level 0 of an AACVP map took 1.62 ms so and
// 1.35 with this carveout, on an H100 80GB HBM3 at 700 W.
constexpr int kSharedCarveout = 44;

// The 16-byte chunk of channels c0 .. c0 + kChunk - 1 at p (4 f32 or 8
// bf16), zero where `ok` is false.
__device__ __forceinline__ void load_chunk(const float* p, bool ok,
                                           float* v) {
  const float4 a = ok ? __ldg(reinterpret_cast<const float4*>(p))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, bool ok,
                                           float* v) {
  load8<true>(p, ok, 8, v);
}

// Streaming stores (evict first) of one and of two consecutive outputs.
__device__ __forceinline__ void store_one(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16(v)));
}
__device__ __forceinline__ void store_two(float* p, float a, float b) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a, b));
}
__device__ __forceinline__ void store_two(__nv_bfloat16* p, float a,
                                          float b) {
  __stcs(reinterpret_cast<unsigned*>(p), mvs::pack_bf16x2(a, b));
}

// Each warp owns an 8 x 4 patch of its block's 16 x 8 tile. Per depth, lane
// l writes the V sample records of the patch's pixel l; then the warp walks
// (pixel, 16-byte chunk) pairs, `lanes` (nch = C / kChunk rounded up to a
// power of two) lanes per pixel, 32 / lanes pixels per pass: lane l takes
// chunk l % lanes (none past nch) of pass pixel l / lanes. kWhole: a chunk
// holds whole groups (Cg divides kChunk), and the lane writes each of them;
// else each group's sum is reduced over the pixel's lanes by __shfl_xor
// and written by one of them.
template <typename T, bool kWhole>
__global__ void __launch_bounds__(kThreads)
group_correlation_lane_kernel(const T* __restrict__ ref,
                              const T* __restrict__ src,
                              const float* __restrict__ geom,
                              const float* __restrict__ hyp,
                              T* __restrict__ out, int V, int D, int H, int W,
                              int C, int G, int lanes, int dgroup,
                              int ngroups) {
  constexpr int kChunk = 16 / sizeof(T);  // channels per 16-byte chunk
  // Per warp: [V][32] sample records, [V][3][32] rotated pixels; then the
  // batch's (V, 12) geometry.
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int4* rec = smem + warp * V * 32;
  float* rot = reinterpret_cast<float*>(smem + kWarps * V * 32) +
               warp * V * 96;
  float* sgeom = reinterpret_cast<float*>(smem + kWarps * V * 32) +
                 kWarps * V * 96;

  const int b = blockIdx.z;
  const int d0 = (blockIdx.y % ngroups) * dgroup;
  const int d1 = min(D, d0 + dgroup);
  const int hw = H * W;
  const int wx0 = blockIdx.x * kTileW + (warp & 1) * 8;
  const int wy0 = (blockIdx.y / ngroups) * kTileH + (warp >> 1) * 4;

  for (int i = threadIdx.x; i < V * 12; i += kThreads)
    sgeom[i] = geom[(int64_t)b * V * 12 + i];
  __syncthreads();

  // Lane l computes the coordinates of pixel l of the patch.
  const int px = wx0 + (lane & 7), py = wy0 + (lane >> 3);
  const bool pix_ok = px < W && py < H;
  mvs::rotate_pixel(sgeom, rot, V, px, py, lane);

  const int chunk = lane & (lanes - 1), lane_pl = lane / lanes;
  const int c0 = chunk * kChunk;
  const bool chunk_ok = c0 < C;
  const int cg = C / G;
  const int lg = __ffs(cg) - 1;  // log2(Cg) when it divides kChunk
  const float scale = 1.f / (float)(cg * V);
  const int vstride = hw * C;  // < 2^31, checked at launch
  const int rowc = W * C;
  const T* refb = ref + (int64_t)b * vstride + c0;
  const T* srcb = src + (int64_t)b * V * vstride + c0;

  for (int d = d0; d < d1; ++d) {
    const int64_t plane = ((int64_t)b * D + d) * hw;
    if (pix_ok) {
      const float dep = __ldcs(hyp + plane + py * W + px);
      for (int v = 0; v < V; ++v)
        rec[v * 32 + lane] = sample_record(rot + v * 96 + lane, 32,
                                           sgeom + v * 12, dep, W, H, C);
    }
    __syncwarp();

    for (int pass = 0; pass < lanes; ++pass) {
      const int pl = pass * (32 / lanes) + lane_pl;
      const int x = wx0 + (pl & 7), y = wy0 + (pl >> 3);
      const bool on = x < W && y < H;
      const int p = y * W + x;
      // prod[k] = ref[c] * sum_v sample_v[c], c = c0 + k; zero off the
      // image and past C.
      float prod[kChunk];
      const bool ok = on && chunk_ok;
      load_chunk(refb + p * C, ok, prod);
      if (ok) {
        float acc[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
        for (int v = 0; v < V; ++v) {
          const int4 r = rec[v * 32 + pl];
          float w[4];
          corner_weights(r, w);
          // A corner off the image is not loaded: it reads as zero.
          const T* sv = srcb + (int64_t)v * vstride + r.x;
          float v00[kChunk], v01[kChunk], v10[kChunk], v11[kChunk];
          load_chunk(sv, r.w & 1, v00);
          load_chunk(sv + C, r.w & 2, v01);
          load_chunk(sv + rowc, r.w & 4, v10);
          load_chunk(sv + rowc + C, r.w & 8, v11);
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            acc[k] += v00[k] * w[0] + v01[k] * w[1] + v10[k] * w[2] +
                      v11[k] * w[3];
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) prod[k] *= acc[k];
      }
      T* o = out + (plane + p) * G;
      if constexpr (kWhole) {
        // Cg is a power of two that divides kChunk: a group closes at
        // every Cg-th channel k, its sum in gsum[k]; the chunk's groups are
        // consecutive outputs from c0 / Cg on.
        float gsum[kChunk], s = 0.f;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          s += prod[k];
          gsum[k] = s * scale;
          if (((k + 1) & (cg - 1)) == 0) s = 0.f;
        }
        T* og = o + (c0 >> lg);
        if (ok) {
          if (cg == kChunk) {
            store_one(og, gsum[kChunk - 1]);
          } else if (2 * cg == kChunk) {
            store_two(og, gsum[kChunk / 2 - 1], gsum[kChunk - 1]);
          } else {
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
              if (((k + 1) & (cg - 1)) == 0)
                store_one(og + (k >> lg), gsum[k]);
          }
        }
      } else {
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if ((c0 + k) / cg == g) s += prod[k];
          for (int m = 1; m < lanes; m <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, m);
          if (on && chunk == g % lanes) store_one(o + g, s * scale);
        }
      }
    }
    __syncwarp();  // records are rewritten for the next depth
  }
}

// The backward: given grad = dL/dout (B, D, H, W, G), with s_v[c] the
// bilinear sample of view v and q[c] = grad[g(c)] / (V Cg) the cotangent of
// the product s_v[c] ref[c]:
//   dref[c]  = sum_d q[c] sum_v s_v[c];
//   dsrc     : q[c] ref[c] added to the valid corners of each view's
//              sample, weighted as the forward blended them (the window of
//              mvs_common.cuh, or the spill branch's atomics);
//   ddepth   = sum_v sum_c q[c] ref[c] (ds_v/dx dx/ddep + ds_v/dy dy/ddep),
//              with kDepth (a template flag), as the warp backward takes it.
// A block owns a 16 x 8 tile, a thread one pixel across every slice of 8
// channels and every depth, so each pixel's dref (registers) and each
// (pixel, depth)'s ddepth have one owner.
template <typename T, bool kVec, bool kDepth>
__global__ void __launch_bounds__(mvs::kWinThreads, mvs::kGradBlocksPerSm)
group_correlation_grad_kernel(const T* __restrict__ ref,
                              const T* __restrict__ src,
                              const float* __restrict__ geom,
                              const float* __restrict__ hyp,
                              const T* __restrict__ grad, T* __restrict__ dref,
                              float* __restrict__ dsrc,
                              float* __restrict__ ddep, int V, int D, int H,
                              int W, int C, int G, int slots) {
  extern __shared__ int4 smem[];
  const mvs::GradSmem sm = mvs::carve_grad_smem(smem, V, slots, kDepth);
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int hw = H * W;
  // Without kDepth each slice of 8 channels is a block of its own; with
  // it a block walks every slice, so ddepth has one writer.
  const int split = kDepth ? 1 : (C + 7) >> 3;
  const int c_begin = blockIdx.y % split * 8;
  const int c_end = kDepth ? C : c_begin + 8;
  const int2 off = mvs::tile_offset(tid);
  const int px = blockIdx.x * mvs::kWinTileW + off.x;
  const int py = blockIdx.y / split * mvs::kWinTileH + off.y;
  const bool ok = px < W && py < H;
  const int pix = py * W + px;
  mvs::grad_setup(sm, geom + (int64_t)b * V * 12, V, px, py);

  const int vstride = hw * C;  // < 2^31, checked at launch
  const int rowc = W * C;
  const T* refp = ref + (int64_t)b * vstride + pix * C;
  const T* srcb = src + (int64_t)b * V * vstride;
  float* dsrcb = dsrc + (int64_t)b * V * vstride;
  const float* hypp = hyp + (int64_t)b * D * hw + pix;
  const int cg = C / G;
  const float scale = 1.f / (float)(cg * V);
  int4* rec = sm.rec + tid;
  float2* jac = sm.jac + tid;

  for (int c0 = c_begin; c0 < c_end; c0 += 8) {
    const int nc = min(8, C - c0);
    float r[8], dr[8];
    int grp[8];  // each channel's group
    load8<kVec>(refp + c0, ok, nc, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      dr[k] = 0.f;
      grp[k] = (c0 + min(k, nc - 1)) / cg;
    }
    for (int d0 = 0, want = D; d0 < D;) {
      int used;
      const int L = mvs::window_plan(sm, hypp, hw, ok, d0, min(want, D - d0),
                                     V, W, H, slots, &used);
      // Every lane walks the chunk (the window's adds take the whole
      // warp); a lane whose pixel is off the image has no valid sample.
      for (int d = d0; d < d0 + L; ++d) {
        const int64_t at = ((int64_t)b * D + d) * hw + pix;
        const float dep = ok ? __ldg(hyp + at) : 1.f;
        for (int v = 0; v < V; ++v) {
          rec[v * mvs::kWinThreads] =
              mvs::grad_record(sm, v, dep, ok, W, H, C);
          if constexpr (kDepth)
            jac[v * mvs::kWinThreads] = mvs::grad_jacobian(sm, v, dep);
        }
        const T* go = grad + at * G;
        float q[8], qr[8], sum[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          q[k] = ok && k < nc ? mvs::to_f32(go[grp[k]]) * scale : 0.f;
          qr[k] = q[k] * r[k];
          sum[k] = 0.f;
        }
        float dd = 0.f;
        for (int v = 0; v < V; ++v) {
          const int4 rv = rec[v * mvs::kWinThreads];
          const T* sv = srcb + (int64_t)v * vstride + c0;
          float f[8];
          if constexpr (kDepth) {
            float fx[8], fy[8];
            blend_diff<kVec>(sv, rv, nc, C, rowc, f, fx, fy);
            const float2 j = jac[v * mvs::kWinThreads];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              dd += qr[k] * (fx[k] * j.x + fy[k] * j.y);
          } else {
            blend<kVec>(sv, rv, nc, C, rowc, f);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) sum[k] += f[k];
          mvs::scatter_sample<kVec>(sm, v, dsrcb + (int64_t)v * vstride + c0,
                                    rv, nc, C, rowc, qr);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) dr[k] += q[k] * sum[k];
        // One writer per (pixel, depth): this thread, slice by slice.
        if (kDepth && ok) ddep[at] = c0 == 0 ? dd : ddep[at] + dd;
      }
      mvs::window_flush(sm, used, V, dsrcb + c0, vstride, W, H, C, nc);
      d0 += L;
      want = 2 * L;
    }
    // dref, rounded once to T.
    if (ok) {
      T* o = dref + (int64_t)b * vstride + pix * C + c0;
      for (int k = 0; k < nc; ++k) o[k] = from_f32<T>(dr[k]);
    }
  }
  mvs::bulk_wait_all();
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// All depths in one block unless that leaves too few blocks to fill the
// card: each split rotates the pixels once more.
static int depth_group(int64_t blocks, int D) {
  int dgroup = D;
  while (dgroup > 1 &&
         blocks * ((D + dgroup - 1) / dgroup) < kMinBlocksPerSm * sm_count())
    dgroup = (dgroup + 1) / 2;
  return dgroup;
}

// The thread-per-pixel kernel: the scalar variant.
template <typename T>
int launch_pixel(const void* ref, const void* src, const void* geom,
                 const void* hyp, void* out, int B, int V, int D, int H,
                 int W, int C, int G, cudaStream_t stream) {
  const int64_t hw = (int64_t)H * W;
  const size_t smem = (size_t)V * (kThreads * 16 + 3 * kThreads * 4 + 48);
  const int err = mvs::reserve_smem(group_correlation_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (hw + kThreads - 1) / kThreads;
  const int dgroup = depth_group(tiles * B, D);
  const int64_t groups = (D + dgroup - 1) / dgroup;
  if (tiles > INT32_MAX || groups > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, (unsigned)groups, (unsigned)B);
  group_correlation_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(geom), static_cast<const float*>(hyp),
      static_cast<T*>(out), V, D, H, W, C, G, dgroup);
  return (int)cudaGetLastError();
}

template <typename T, bool kWhole>
int launch_lanes(const void* ref, const void* src, const void* geom,
                 const void* hyp, void* out, int B, int V, int D, int H,
                 int W, int C, int G, int lanes, cudaStream_t stream) {
  auto* kernel = group_correlation_lane_kernel<T, kWhole>;
  const size_t smem = (size_t)V * (kWarps * 32 * 16 + kWarps * 96 * 4 + 48);
  const int err = mvs::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  static bool carved = false;  // once per instantiation
  if (!carved) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        kSharedCarveout);
    if (e != cudaSuccess) return (int)e;
    carved = true;
  }
  const int64_t tx = (W + kTileW - 1) / kTileW, ty = (H + kTileH - 1) / kTileH;
  const int dgroup = depth_group(tx * ty * B, D);
  const int64_t groups = (D + dgroup - 1) / dgroup;
  if (tx > INT32_MAX || ty * groups > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tx, (unsigned)(ty * groups), (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(geom), static_cast<const float*>(hyp),
      static_cast<T*>(out), V, D, H, W, C, G, lanes, dgroup, (int)groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* ref, const void* src, const void* geom,
             const void* hyp, void* out, int B, int V, int D, int H, int W,
             int C, int G, int vec, cudaStream_t stream) {
  const int64_t hw = (int64_t)H * W;
  if (B == 0 || D == 0 || hw == 0) return cudaSuccess;
  if (V <= 0 || C <= 0 || G <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  if (!mvs::offsets_fit(hw, W, C)) return (int)cudaErrorInvalidValue;
  if (!vec)
    return launch_pixel<T>(ref, src, geom, hyp, out, B, V, D, H, W, C, G,
                           stream);
  constexpr int kChunk = 16 / sizeof(T);
  const int nch = C / kChunk, cg = C / G;
  int lanes = 1;
  while (lanes < nch) lanes <<= 1;
  if (lanes > 32) return (int)cudaErrorInvalidValue;  // C > 32 chunks
  if (kChunk % cg == 0)
    return launch_lanes<T, true>(ref, src, geom, hyp, out, B, V, D, H, W, C,
                                 G, lanes, stream);
  return launch_lanes<T, false>(ref, src, geom, hyp, out, B, V, D, H, W, C,
                                G, lanes, stream);
}

template <typename T, bool kVec, bool kDepth>
int launch_grad(const void* ref, const void* src, const void* geom,
                const void* hyp, const void* grad, void* dref, void* dsrc,
                void* ddep, int B, int V, int D, int H, int W, int C, int G,
                cudaStream_t stream) {
  const int64_t hw = (int64_t)H * W;
  if (B == 0 || hw == 0) return cudaSuccess;
  if (V <= 0 || C <= 0 || G <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  if (!mvs::offsets_fit(hw, W, C)) return (int)cudaErrorInvalidValue;
  auto* kernel = group_correlation_grad_kernel<T, kVec, kDepth>;
  dim3 grid;
  size_t smem;
  int slots;
  const int err = mvs::grad_launch_config(kernel, B, V, H, W, C, kDepth, dsrc,
                                          kDepth ? 1 : (C + 7) / 8, &grid,
                                          &smem, &slots);
  if (err != cudaSuccess) return err;
  kernel<<<grid, mvs::kWinThreads, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(geom), static_cast<const float*>(hyp),
      static_cast<const T*>(grad), static_cast<T*>(dref),
      static_cast<float*>(dsrc), static_cast<float*>(ddep), V, D, H, W, C, G,
      slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mvs_group_correlation(const void* ref, const void* src,
                                     const void* geom, const void* hyp,
                                     void* out, int B, int V, int D, int H,
                                     int W, int C, int G, int dtype, int vec,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_t<float>(ref, src, geom, hyp, out, B, V, D, H, W, C, G, vec,
                           s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(ref, src, geom, hyp, out, B, V, D, H, W, C,
                                   G, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mvs_group_correlation_grad(const void* ref, const void* src,
                                          const void* geom, const void* hyp,
                                          const void* grad, void* dref,
                                          void* dsrc, void* ddepth, int B,
                                          int V, int D, int H, int W, int C,
                                          int G, int dtype, int vec,
                                          void* stream) {
  return mvs::dispatch_grad(
      dtype, vec, ddepth != nullptr, C, [&](auto type, auto kvec, auto kdep) {
        return launch_grad<typename decltype(type)::type, decltype(kvec)::value,
                           decltype(kdep)::value>(
            ref, src, geom, hyp, grad, dref, dsrc, ddepth, B, V, D, H, W, C, G,
            static_cast<cudaStream_t>(stream));
      });
}
