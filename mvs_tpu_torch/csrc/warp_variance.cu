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
//
// Design: the work per output element is cut to what the arithmetic needs
// and the one unavoidable write runs at full width. The grid is (16x8 pixel
// tile, depth group x tile row, batch) with 32-bit pixel indices and no
// division per output. Each warp owns an 8x4 patch of 32 pixels:
//   * once per depth group, lane l rotates pixel l into each view (R @ [x,
//     y, 1]) and keeps the result in shared memory across the group's depths
//     (it does not depend on depth);
//   * once per (pixel, depth, view), lane l finishes the projection (depth
//     multiply-add, the two IEEE divides), floors the coordinates, and writes
//     a 16-byte record (corner offset, wx, wy, corner-validity bits) to
//     shared memory;
//   * then the warp walks the patch's 8-channel chunks with consecutive lanes
//     on consecutive 16-byte chunks: each lane reads its pixel's record,
//     gathers each valid corner as one 16-byte load (8 bf16; two for f32),
//     blends with the four corner weights, and writes its chunk of the
//     variance as one 16-byte streaming store (evict-first, so the volume
//     does not push the feature maps out of L2).
// The coordinates are computed with __fmul_rn/__fadd_rn/__fdiv_rn in the
// order of plane_sweep_coords, so nvcc cannot contract them and they agree
// with the plain PyTorch version to the bit; corner validity is tested in
// float space, so a coordinate pushed behind the camera or far off the image
// never reaches an int conversion. The vector loads need C % 8 == 0 and
// 16-byte-aligned rows; other C (the ragged case) run the same kernel with
// masked scalar loads and stores (kVec = false), chosen by the wrapper.
//
// What is left is instruction issue, not memory: on an H100 80GB HBM3 at
// 700 W (chip_smoke.py) the three bf16 stages of a 1152x864 map (D =
// 48/32/8, C = 32/16/8) take 0.427 / 0.627 / 0.379 ms against byte bounds of
// 0.067 / 0.098 / 0.071 ms (a thread per chunk that recomputed its
// coordinates took 1.641 / 2.515 / 1.258 ms), and the same kernel with every
// gather sent to one cached address is no faster. Per channel and view it
// issues four bf16 unpacks, four multiply-adds of the blend and two of the
// sums, in f32 on the CUDA cores.
//
// The backward kernel (warp_variance_grad_kernel) has no TPU counterpart:
// the JAX package trains through XLA's gather path under jax.checkpoint,
// which recomputes the warp in the backward pass. It does the same: given
// G = dL/dvar it recomputes each (pixel, depth)'s V source samples with the
// forward's coordinate rounding and their mean m over N = V + 1 views, and
// with g = 2 G / N
//   * dref[p, c] = sum_d g (ref - m), summed in the pixel's thread;
//   * dsrc[v, corner, c] += w_corner g (f_v - m), f_v the blended sample,
//     valid corners only (the forward's zero fill);
//   * with kDepth (a template flag, chosen by the wrapper when the
//     hypotheses require a gradient), ddepth[p, d] = sum_v sum_c g (f_v - m)
//     (df_v/dx dx/ddep + df_v/dy dy/ddep): the sample's corner differences
//     (mvs::blend_diff, JAX's right-hand differences at an integer
//     coordinate) times the quotient rule of the projection
//     (mvs::depth_jacobian), one f32 store per (pixel, depth).
// A block owns a 16 x 8 tile, a thread one pixel across every depth. The
// channels go in slices of 8: without kDepth each slice is a block of its
// own (a 160x128 batch-4 stage still fills the card), with it the block
// walks every slice and adds each slice's share of ddepth to the last, so
// ddepth has one writer. dsrc goes through the dsrc window of
// mvs_common.cuh: each warp plans chunks of depths whose samples fit a box
// of source cells per view in its part of 56 KB of shared memory, adds the
// samples' shares there with plain 16-byte read-modify-writes, and hands
// the window to the TMA unit's bulk reduce-add once per chunk; a sample
// outside its window (a sweep that is not monotone in depth, a footprint
// larger than the window) takes the spill branch, float4 atomics to dsrc.
// What bounded the first version was those float4 atomics for
// every sample: 70-90 G/s at every launch shape, 18.7 ms per CasMVSNet
// train step. With the window, measured on one H100 80GB HBM3 at 700 W,
// a step takes 6.56 ms on make_plane_scene's default rig and 6.93
// ms on a DTU-like rig (sweeps of 9-18 px at stage 1), against a 0.48 ms
// bound; the rest is the recomputed gathers (the corners of each sample
// are read twice, the second time mostly from L2), the records (recomputed
// per slice) and the window's adds (a quarter of the time).
//
// The partial-moment variant (kPartial, both kernels) serves a cost volume
// whose source views are split over processes (mvs_tpu_torch.parallel): the
// variance is not additive over views, so each process writes the f32 sums
// sum(f) and sum(f^2) over its own source views, the reference view a term
// on one process only (with_ref), and one all-reduce of the sums precedes
// the variance. Its backward takes g1 = dL/dsum(f) and g2 = dL/dsum(f^2),
// f32: each term f has cotangent g1 + 2 f g2, so no mean over the views is
// needed and each sample is blended once; dref = sum_d (g1 + 2 ref g2) when
// the reference is a term; dsrc goes through the same window.
//
// A row window (Hs, y0) serves a volume whose rows are split over processes
// (mvs_tpu_torch.parallel.sharding): the reference, the hypotheses and the
// output hold rows y0 .. y0 + H - 1 of source views of Hs rows. Pixel
// (x, y) of the window is rotated as pixel (x, y0 + y) of the whole image,
// so a window computes the whole volume's rows bit for bit; Hs = H, y0 = 0
// is the whole volume. (Folding y0 into the geometry's constant column
// would round the rotation differently.)
//
// C interface (loaded with ctypes, see mvs_tpu_torch/ops/warp_variance.py):
// every pointer is a device pointer to contiguous memory,
//   ref  (B, H, W, C)      T
//   src  (B, V, Hs, W, C)  T
//   geom (B, V, 12)        f32: rows of R (9 values) then t (3) of src @ ref^-1
//   hyp  (B, D, H, W)      f32 per-pixel depth hypotheses
//   out  (B, D, H, W, C)   T
// with T = float (dtype 0) or __nv_bfloat16 (dtype 1); vec = 1 selects the
// 16-byte path (C % 8 == 0, 16-byte-aligned pointers). The backward entry
// also takes
//   grad (B, D, H, W, C)   T    dL/dvar
//   dref (B, H, W, C)      T    written
//   dsrc (B, V, Hs, W, C)  f32  zero-filled by the caller, accumulated
//   ddepth (B, D, H, W)    f32  written, or null for no depth gradient
// The partial entries write (mvs_warp_partials) or read
// (mvs_warp_partials_grad, as g1 and g2)
//   sum_f, sum_sq (B, D, H, W, C)  f32
// in place of out and grad, add the reference view where with_ref != 0, and
// take dref null when it is 0.
// Each launches on `stream` and returns cudaGetLastError().

#include "mvs_common.cuh"

namespace {

using mvs::blend;
using mvs::blend_diff;
using mvs::corner_weights;
using mvs::from_f32;
using mvs::load8;
using mvs::sample_record;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;  // one pixel per thread per tile
constexpr int kMinBlocksPerSm = 8;     // split depths until this many blocks
constexpr int kTileW = 16, kTileH = 8;  // block tile: 2 x 2 warps of 8 x 4

// Stores stream past L2 (evict first), which keeps the features resident.
__device__ __forceinline__ void vec_store8(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void vec_store8(__nv_bfloat16* p, const float* v) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(mvs::pack_bf16x2(v[0], v[1]), mvs::pack_bf16x2(v[2], v[3]),
                    mvs::pack_bf16x2(v[4], v[5]),
                    mvs::pack_bf16x2(v[6], v[7])));
}

template <bool kVec, typename T>
__device__ __forceinline__ void store8(T* p, int nc, const float* v) {
  if constexpr (kVec) {
    vec_store8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < nc) p[k] = from_f32<T>(v[k]);
  }
}

// kPartial: write the f32 sums sum(f) to `out` and sum(f^2) to `out_sq`
// instead of the variance, the reference view a term only when with_ref.
template <typename T, bool kVec, bool kPartial>
__global__ void __launch_bounds__(kThreads)
warp_variance_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                     const float* __restrict__ geom,
                     const float* __restrict__ hyp,
                     std::conditional_t<kPartial, float, T>* __restrict__ out,
                     float* __restrict__ out_sq, int V, int D, int H, int W,
                     int C, int Hs, int y0, int dgroup, int ngroups,
                     int with_ref) {
  // Per warp: [V][32] sample records (corner offset, wx, wy, corner
  // validity bits), [V][3][32] rotated pixels; then the batch's (V, 12)
  // geometry.
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int4* rec = smem + warp * V * 32;
  float* rot = reinterpret_cast<float*>(smem + kWarps * V * 32) +
               warp * V * 96;
  float* sgeom = reinterpret_cast<float*>(smem + kWarps * V * 32) +
                 kWarps * V * 96;

  const int b = blockIdx.z;
  const int grp = blockIdx.y % ngroups;
  const int d0 = grp * dgroup;
  const int d1 = min(D, d0 + dgroup);
  const int hw = H * W;
  // The warp's pixels: an 8 x 4 (W x H) patch of the block's 16 x 8 tile.
  const int wx0 = blockIdx.x * kTileW + (warp & 1) * 8;
  const int wy0 = (blockIdx.y / ngroups) * kTileH + (warp >> 1) * 4;

  for (int i = threadIdx.x; i < V * 12; i += kThreads)
    sgeom[i] = geom[(int64_t)b * V * 12 + i];
  __syncthreads();

  // Lane l computes the coordinates of pixel l of the patch.
  const int px = wx0 + (lane & 7), py = wy0 + (lane >> 3);
  const bool pix_ok = px < W && py < H;
  const int pix = py * W + px;
  mvs::rotate_pixel(sgeom, rot, V, px, py + y0, lane);

  // Pass k of the chunk walk gives lane l chunk (32k + l) % nch of pixel
  // (32k + l) / nch: consecutive lanes on consecutive 16-byte chunks.
  const int nch = (C + 7) >> 3;
  const bool even = 32 % nch == 0;  // then a lane keeps its chunk
  const int lane_pl = lane / nch, lane_c0 = (lane - lane_pl * nch) * 8;
  const int vstride = hw * C;  // < 2^31, checked at launch
  const int svstride = Hs * W * C;
  const int rowc = W * C;
  const T* refb = ref + (int64_t)b * vstride;
  const T* srcb = src + (int64_t)b * V * svstride;
  // variance = sq / n - (sf / n)^2, each quotient as a product with the
  // rounded 1/n (within an ulp of the division, at a fraction of its cost).
  const float rn = __frcp_rn((float)(V + 1));

  for (int d = d0; d < d1; ++d) {
    const int64_t plane = ((int64_t)b * D + d) * hw;
    if (pix_ok) {
      const float dep = __ldcs(hyp + plane + pix);
      for (int v = 0; v < V; ++v)
        rec[v * 32 + lane] = sample_record(rot + v * 96 + lane, 32,
                                           sgeom + v * 12, dep, W, Hs, C);
    }
    __syncwarp();

    for (int pass = 0; pass < nch; ++pass) {
      int pl = pass * (32 / nch) + lane_pl, c0 = lane_c0;
      if (!even) {
        pl = (pass * 32 + lane) / nch;
        c0 = (pass * 32 + lane - pl * nch) * 8;
      }
      const int x = wx0 + (pl & 7), y = wy0 + (pl >> 3);
      if (x >= W || y >= H) continue;
      const int p = y * W + x;
      const int nc = min(8, C - c0);
      float sf[8], sq[8];
      load8<kVec>(refb + p * C + c0, !kPartial || with_ref, nc, sf);
#pragma unroll
      for (int k = 0; k < 8; ++k) sq[k] = sf[k] * sf[k];
#pragma unroll 4
      for (int v = 0; v < V; ++v) {
        const int4 r = rec[v * 32 + pl];
        float w[4];
        corner_weights(r, w);
        // A corner off the image is not loaded: it reads as zero.
        const T* sv = srcb + (int64_t)v * svstride + c0 + r.x;
        float v00[8], v01[8], v10[8], v11[8];
        load8<kVec>(sv, r.w & 1, nc, v00);
        load8<kVec>(sv + C, r.w & 2, nc, v01);
        load8<kVec>(sv + rowc, r.w & 4, nc, v10);
        load8<kVec>(sv + rowc + C, r.w & 8, nc, v11);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float f =
              v00[k] * w[0] + v01[k] * w[1] + v10[k] * w[2] + v11[k] * w[3];
          sf[k] += f;
          sq[k] += f * f;
        }
      }
      const int64_t at = plane * C + p * C + c0;
      if constexpr (kPartial) {
        store8<kVec>(out + at, nc, sf);
        store8<kVec>(out_sq + at, nc, sq);
      } else {
        float o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float mean = sf[k] * rn;
          o[k] = sq[k] * rn - mean * mean;
        }
        store8<kVec>(out + at, nc, o);
      }
    }
    __syncwarp();  // records are rewritten for the next depth
  }
}

// kPartial: the gradient of the partial sums, given gsum = dL/dsum(f) and
// gsq = dL/dsum(f^2) (f32) in place of `grad`; dref only when with_ref.
template <typename T, bool kVec, bool kDepth, bool kPartial>
__global__ void __launch_bounds__(mvs::kWinThreads, mvs::kGradBlocksPerSm)
warp_variance_grad_kernel(const T* __restrict__ ref,
                          const T* __restrict__ src,
                          const float* __restrict__ geom,
                          const float* __restrict__ hyp,
                          const T* __restrict__ grad,
                          const float* __restrict__ gsum,
                          const float* __restrict__ gsq, T* __restrict__ dref,
                          float* __restrict__ dsrc, float* __restrict__ ddep,
                          int V, int D, int H, int W, int C, int Hs, int y0,
                          int slots, int with_ref) {
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
  mvs::grad_setup(sm, geom + (int64_t)b * V * 12, V, px, py + y0);

  const int vstride = hw * C;  // < 2^31, checked at launch
  const int svstride = Hs * W * C;
  const int rowc = W * C;
  const T* refp = ref + (int64_t)b * vstride + pix * C;
  const T* srcb = src + (int64_t)b * V * svstride;
  float* dsrcb = dsrc + (int64_t)b * V * svstride;
  const float* hypp = hyp + (int64_t)b * D * hw + pix;
  const float rn = __frcp_rn((float)(V + 1));
  const float g2 = 2.f * rn;  // dvar/df_i = (2 / N) (f_i - m)
  int4* rec = sm.rec + tid;
  float2* jac = sm.jac + tid;
  const bool has_ref = ok && (!kPartial || with_ref);

  for (int c0 = c_begin; c0 < c_end; c0 += 8) {
    const int nc = min(8, C - c0);
    float r[8], dr[8];
    load8<kVec>(refp + c0, has_ref, nc, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) dr[k] = 0.f;
    for (int d0 = 0, want = D; d0 < D;) {
      int used;
      const int L = mvs::window_plan(sm, hypp, hw, ok, d0, min(want, D - d0),
                                     V, W, Hs, slots, &used);
      // Every lane walks the chunk (the window's adds take the whole
      // warp); a lane whose pixel is off the image has no valid sample.
      for (int d = d0; d < d0 + L; ++d) {
        const int64_t at = ((int64_t)b * D + d) * hw + pix;
        const float dep = ok ? __ldg(hyp + at) : 1.f;
        for (int v = 0; v < V; ++v) {
          rec[v * mvs::kWinThreads] =
              mvs::grad_record(sm, v, dep, ok, W, Hs, C);
          if constexpr (kDepth)
            jac[v * mvs::kWinThreads] = mvs::grad_jacobian(sm, v, dep);
        }
        if constexpr (kPartial) {
          // Each term f of the sums has cotangent gsum + 2 f gsq: the
          // reference's (when a term) goes to dref, each sample's to its
          // corners and, with kDepth, along its coordinates.
          float g[8], q[8];
          load8<kVec>(gsum + at * C + c0, ok, nc, g);
          load8<kVec>(gsq + at * C + c0, ok, nc, q);
#pragma unroll
          for (int k = 0; k < 8; ++k) dr[k] += g[k] + 2.f * r[k] * q[k];
          float dd = 0.f;
          for (int v = 0; v < V; ++v) {
            const int4 rv = rec[v * mvs::kWinThreads];
            const T* sv = srcb + (int64_t)v * svstride + c0;
            float f[8];
            if constexpr (kDepth) {
              float fx[8], fy[8];
              blend_diff<kVec>(sv, rv, nc, C, rowc, f, fx, fy);
              const float2 j = jac[v * mvs::kWinThreads];
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                f[k] = g[k] + 2.f * f[k] * q[k];
                dd += f[k] * (fx[k] * j.x + fy[k] * j.y);
              }
            } else {
              blend<kVec>(sv, rv, nc, C, rowc, f);
#pragma unroll
              for (int k = 0; k < 8; ++k) f[k] = g[k] + 2.f * f[k] * q[k];
            }
            mvs::scatter_sample<kVec>(sm, v,
                                      dsrcb + (int64_t)v * svstride + c0, rv,
                                      nc, C, rowc, f);
          }
          if (kDepth && ok) ddep[at] = c0 == 0 ? dd : ddep[at] + dd;
          continue;
        }
        float g[8], m[8];
        load8<kVec>(grad + at * C + c0, ok, nc, g);
#pragma unroll
        for (int k = 0; k < 8; ++k) m[k] = r[k];
        for (int v = 0; v < V; ++v) {
          float f[8];
          blend<kVec>(srcb + (int64_t)v * svstride + c0,
                      rec[v * mvs::kWinThreads], nc, C, rowc, f);
#pragma unroll
          for (int k = 0; k < 8; ++k) m[k] += f[k];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          m[k] *= rn;
          g[k] *= g2;
          dr[k] += g[k] * (r[k] - m[k]);
        }
        // Each view's sample again (its corners are in L1 from the pass
        // above); its cotangent g (f - m) goes to the valid corners and,
        // with kDepth, along the sample's coordinates.
        float dd = 0.f;
        for (int v = 0; v < V; ++v) {
          const int4 rv = rec[v * mvs::kWinThreads];
          const T* sv = srcb + (int64_t)v * svstride + c0;
          float f[8];
          if constexpr (kDepth) {
            float fx[8], fy[8];
            blend_diff<kVec>(sv, rv, nc, C, rowc, f, fx, fy);
            const float2 j = jac[v * mvs::kWinThreads];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              f[k] = g[k] * (f[k] - m[k]);
              dd += f[k] * (fx[k] * j.x + fy[k] * j.y);
            }
          } else {
            blend<kVec>(sv, rv, nc, C, rowc, f);
#pragma unroll
            for (int k = 0; k < 8; ++k) f[k] = g[k] * (f[k] - m[k]);
          }
          mvs::scatter_sample<kVec>(sm, v, dsrcb + (int64_t)v * svstride + c0,
                                    rv, nc, C, rowc, f);
        }
        // One writer per (pixel, depth): this thread, slice by slice.
        if (kDepth && ok) ddep[at] = c0 == 0 ? dd : ddep[at] + dd;
      }
      mvs::window_flush(sm, used, V, dsrcb + c0, svstride, W, Hs, C, nc);
      d0 += L;
      want = 2 * L;
    }
    // dref, rounded once to T.
    if (has_ref)
      store8<kVec>(dref + (int64_t)b * vstride + pix * C + c0, nc, dr);
  }
  mvs::bulk_wait_all();
}

template <typename T, bool kVec, bool kPartial>
int launch(const void* ref, const void* src, const void* geom,
           const void* hyp, void* out, void* out_sq, int B, int V, int D,
           int H, int W, int C, int Hs, int y0, int with_ref,
           cudaStream_t stream) {
  const int64_t hw = (int64_t)H * W;
  if (B == 0 || V == 0 || D == 0 || hw == 0 || C == 0) return cudaSuccess;
  if (y0 < 0 || y0 + H > Hs || !mvs::offsets_fit((int64_t)Hs * W, W, C))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)V * (kWarps * 32 * 16 + kWarps * 96 * 4 + 48);
  auto* kernel = warp_variance_kernel<T, kVec, kPartial>;
  const int err = mvs::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t tx = (W + kTileW - 1) / kTileW, ty = (H + kTileH - 1) / kTileH;
  // All depths in one block unless that leaves too few blocks to fill the
  // card: each split recomputes the rotation once more.
  int dgroup = D;
  while (dgroup > 1 &&
         tx * ty * B * ((D + dgroup - 1) / dgroup) < kMinBlocksPerSm * sms)
    dgroup = (dgroup + 1) / 2;
  const int64_t groups = (D + dgroup - 1) / dgroup;
  if (tx > INT32_MAX || ty * groups > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tx, (unsigned)(ty * groups), (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(geom), static_cast<const float*>(hyp),
      static_cast<std::conditional_t<kPartial, float, T>*>(out),
      static_cast<float*>(out_sq), V, D, H, W, C, Hs, y0, dgroup, (int)groups,
      with_ref);
  return (int)cudaGetLastError();
}

template <typename T, bool kPartial>
int launch_t(const void* ref, const void* src, const void* geom,
             const void* hyp, void* out, void* out_sq, int B, int V, int D,
             int H, int W, int C, int Hs, int y0, int with_ref, int vec,
             cudaStream_t stream) {
  if (vec)
    return launch<T, true, kPartial>(ref, src, geom, hyp, out, out_sq, B, V,
                                     D, H, W, C, Hs, y0, with_ref, stream);
  return launch<T, false, kPartial>(ref, src, geom, hyp, out, out_sq, B, V, D,
                                    H, W, C, Hs, y0, with_ref, stream);
}

template <bool kPartial>
int launch_dtype(const void* ref, const void* src, const void* geom,
                 const void* hyp, void* out, void* out_sq, int B, int V,
                 int D, int H, int W, int C, int Hs, int y0, int with_ref,
                 int dtype, int vec, cudaStream_t stream) {
  if (vec && C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_t<float, kPartial>(ref, src, geom, hyp, out, out_sq, B, V,
                                     D, H, W, C, Hs, y0, with_ref, vec,
                                     stream);
  if (dtype == 1)
    return launch_t<__nv_bfloat16, kPartial>(ref, src, geom, hyp, out, out_sq,
                                             B, V, D, H, W, C, Hs, y0,
                                             with_ref, vec, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kVec, bool kDepth, bool kPartial>
int launch_grad(const void* ref, const void* src, const void* geom,
                const void* hyp, const void* grad, const void* g1,
                const void* g2, void* dref, void* dsrc, void* ddep, int B,
                int V, int D, int H, int W, int C, int Hs, int y0,
                int with_ref, cudaStream_t stream) {
  const int64_t hw = (int64_t)H * W;
  if (B == 0 || V == 0 || D == 0 || hw == 0 || C == 0) return cudaSuccess;
  if (y0 < 0 || y0 + H > Hs || !mvs::offsets_fit((int64_t)Hs * W, W, C))
    return (int)cudaErrorInvalidValue;
  auto* kernel = warp_variance_grad_kernel<T, kVec, kDepth, kPartial>;
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
      static_cast<const T*>(grad), static_cast<const float*>(g1),
      static_cast<const float*>(g2), static_cast<T*>(dref),
      static_cast<float*>(dsrc), static_cast<float*>(ddep), V, D, H, W, C, Hs,
      y0, slots, with_ref);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mvs_warp_variance(const void* ref, const void* src,
                                 const void* geom, const void* hyp, void* out,
                                 int B, int V, int D, int H, int W, int C,
                                 int Hs, int y0, int dtype, int vec,
                                 void* stream) {
  return launch_dtype<false>(ref, src, geom, hyp, out, nullptr, B, V, D, H, W,
                             C, Hs, y0, 1, dtype, vec,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int mvs_warp_partials(const void* ref, const void* src,
                                 const void* geom, const void* hyp,
                                 void* sum_f, void* sum_sq, int B, int V,
                                 int D, int H, int W, int C, int Hs, int y0,
                                 int with_ref, int dtype, int vec,
                                 void* stream) {
  return launch_dtype<true>(ref, src, geom, hyp, sum_f, sum_sq, B, V, D, H, W,
                            C, Hs, y0, with_ref, dtype, vec,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int mvs_warp_variance_grad(const void* ref, const void* src,
                                      const void* geom, const void* hyp,
                                      const void* grad, void* dref,
                                      void* dsrc, void* ddepth, int B, int V,
                                      int D, int H, int W, int C, int Hs,
                                      int y0, int dtype, int vec,
                                      void* stream) {
  return mvs::dispatch_grad(
      dtype, vec, ddepth != nullptr, C, [&](auto type, auto kvec, auto kdep) {
        return launch_grad<typename decltype(type)::type, decltype(kvec)::value,
                           decltype(kdep)::value, false>(
            ref, src, geom, hyp, grad, nullptr, nullptr, dref, dsrc, ddepth, B,
            V, D, H, W, C, Hs, y0, 1, static_cast<cudaStream_t>(stream));
      });
}

extern "C" int mvs_warp_partials_grad(const void* ref, const void* src,
                                      const void* geom, const void* hyp,
                                      const void* g1, const void* g2,
                                      void* dref, void* dsrc, void* ddepth,
                                      int B, int V, int D, int H, int W,
                                      int C, int Hs, int y0, int with_ref,
                                      int dtype, int vec, void* stream) {
  return mvs::dispatch_grad(
      dtype, vec, ddepth != nullptr, C, [&](auto type, auto kvec, auto kdep) {
        return launch_grad<typename decltype(type)::type, decltype(kvec)::value,
                           decltype(kdep)::value, true>(
            ref, src, geom, hyp, nullptr, g1, g2, dref, dsrc, ddepth, B, V, D,
            H, W, C, Hs, y0, with_ref, static_cast<cudaStream_t>(stream));
      });
}
