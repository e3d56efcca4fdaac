// 3x3x3 stride-1 SAME convolution over NDHWC volumes with a fused
// per-channel affine (the eval-mode BatchNorm fold, or a bias) and optional
// ReLU, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conv3d_lane_folded
// (mvs_tpu/ops/conv3d_pallas.py, kernel body _conv_kernel; entry
// conv3d_folded). The TPU kernel folds W into the 128-lane dimension so that
// 8-64 channel convs fill the MXU; that fold is a TPU layout device and is not
// carried over: both kernels here read the plain (B, D, H, W, C) layout.
//
// Computes y[b,z,y,x,o] = act(scale[o] * sum_{tap,i} x[..neighbour.., i] *
// w[tap*Cin + i, o] + shift[o]) with f32 sums, the affine and ReLU on the f32
// sum, and one rounding to the output type.
//
// What bounds it on the card: in bf16, bytes. At the cost-regularization
// widths the GEMM view (M = voxels, N = Cout, K = 27*Cin) does 108-173 flop
// per byte of input and output at (8,8)-(32,8), under the H100's bf16 ridge
// of ~295, and the wider blocks run at 1/2-1/8 resolution, where the work is
// small. So the aim is to read each input plane from device memory about
// once and keep the tensor cores fed from shared memory. In f32 the same
// convs are bound by operations on the CUDA cores (67 TFLOP/s: AACVP's (4,
// 16) and (16, 16) blocks do 4.2x more work than their bytes take), which is
// why the f32 path moves to the tensor cores too.
//
// conv3d_mma_kernel: an implicit GEMM on the tensor cores with mma.sync.
// mma.sync rather than wgmma: the N of these layers is 8-32, far below
// wgmma's 64-row M by a useful N. A CTA owns an 8x16 (H x W) output tile and
// a run of up to 8 z planes, and marches along z with a ring of four
// (8+2)x(16+2)xCin halo planes in shared memory, filled by 16-byte cp.async
// with zero fill at the volume's border (the SAME padding costs nothing).
// Plane z+2 is copied while plane z's 27 taps run on the tensor cores, and
// each input plane is read once per CTA instead of three times. The 16-byte
// chunks of a halo pixel are XOR-swizzled by the pixel index so that
// ldmatrix, which gathers one 16-byte row per (output voxel, tap, chunk)
// straight from the halo, is free of bank conflicts at every Cin. K runs
// tap-major, channel-minor; a k step is two chunks, and where it spans two
// taps (one chunk a pixel) the 28th (padding) tap reads a zero row. Each CTA
// stages an N slice of 8-32 columns of the weights, packed once per weight
// tensor (mvs_tpu_torch/ops/conv3d.py), sized so that K x N stays within 56
// KB (Cout is split over blockIdx.z for the wide blocks). Each of the 4
// warps computes 2 tile rows (two m16 tiles) by the CTA's N slice. The
// epilogue applies the affine and ReLU in f32 and rounds once to the output
// type; the 1-channel score conv (N padded to 8) stores channel 0 only. Two
// element types:
//   * bf16 (Cin in {8, 16, 32, 64}, Cout a multiple of 8 or 1): m16n8k16,
//     bf16 in, f32 sums; a chunk is 8 channels, B is read by ldmatrix.trans
//     from (Kpad, Npad) bf16 (pack_conv3d_taps); a voxel's 8 channels are
//     gathered in one lane by quad shuffles and stored as one 16-byte store.
//   * f32 (Cin in {4, 8, 16, 32}, Cout a multiple of 8 or 1), "3xTF32":
//     m16n8k8 on TF32, a chunk is 4 channels. ldmatrix of an 8x8 b16 matrix
//     gives 8 rows of four 32-bit values, which is the TF32 A fragment as it
//     is. One TF32 product keeps 11 bits of each factor: on AACVP's shapes
//     it misses the f32 result by 3e-4 of the largest output, over the 1e-4
//     that the f32 path is held to. So each value is split, x = x_big +
//     x_small and w = w_big + w_small, each part rounded to TF32 (ties away,
//     as cvt.rna), and the sum takes x_small w_big + x_big w_small + x_big
//     w_big on the tensor cores in f32; what is dropped (x_small w_small, the
//     parts' roundings) is below 2^-21 of the product. The weights come split
//     and in B-fragment order, (Npad / 8, Kpad / 8, 32 lanes, 4) f32
//     (pack_conv3d_tf32x3): one 16-byte shared load gives a lane both parts
//     of its fragment. x is split in registers after ldmatrix (a few integer
//     and one float op per value, beside three MMAs per A fragment and n8
//     tile): the halo ring then stays one f32 plane per z (11.5 KB at Cin =
//     16), so two CTAs fit an SM. The epilogue stores a lane's two channels
//     of a column as one 8-byte store; a quad's four fill one 32-byte sector.
//     Cin = 64 does not fit this ring (4 x 46 KB of f32 halo beside 110 KB
//     for one n8 tile of split weights): see conv3d_tf32x3_cin64_kernel.
//     Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py phase 8a),
//     AACVP's 10 f32 launches of a bf16 map take 6.08 ms, against 45.8 ms
//     on the direct kernel, 36.5 ms for cuDNN's f32 conv (TF32 off) and a
//     bound of 2.21 ms (launch by launch the larger of the three TF32
//     products at the tensor-core rate and the bytes; the same f32 work on
//     the CUDA cores would need 5.28). Its largest launch, (16, 16) at
//     8 x 1184 x 1600, takes 3.35 ms; without the split of x (wrong
//     results, for timing) 2.76, as one TF32 product 2.05.
//
// conv3d_tf32x3_cin64_kernel: the f32 convs at Cin = 64 (Cout a multiple of
// 8: the U-Nets' (64, 64) blocks and 64->32 transposed block, Point-MVSNet's
// 64->8 and 64->64), with the 3xTF32 arithmetic, fragments, 8x16 tile, halo
// swizzle and split-weight layout above. Those are bound by operations
// (Point-MVSNet's 64->8 does 27 * 64 * 8 * 2 flop per 288 bytes of x and y),
// and at Cin = 64 the K of an n8 tile (27 taps x 64 channels, 216 k steps)
// is 110,592 bytes split: one n8 tile of weights and a halo ring cannot
// both be resident over a CTA's run as the Cin <= 32 kernel keeps them. So
// the loop over z is turned around: input-stationary. Step i loads input
// plane z0 - 1 + i once and multiplies it by all three tap planes dz of the
// weights, into the accumulators of the three output planes it feeds (z0 +
// i - dz); output plane z0 + i - 2 is then complete, stored, and the
// accumulators shift by one plane. A plane is read into shared memory once
// per CTA, the ring holds 2 planes (one in use, one in flight) instead of
// 4, and each A fragment is split once for 9 MMAs (3 dz x 3 products)
// instead of 3. Planes outside the volume are neither loaded nor
// multiplied; an output plane outside the CTA's z run takes no MMA.
//   Shared memory per CTA: 2 halo planes of (8+2) x (16+2) pixels x 256 B
//   (92,160 B), the split weights of the CTA's n8 tile (110,592 B, loaded
//   once by cp.async with the first plane) and 4,096 B for partial sums:
//   206,848 of 232,448 B, one CTA an SM. 8 warps (256 threads): warps 0-3
//   and 4-7 take the same 2 tile rows each (two m16 tiles) over the low
//   and the high 32 channels of every tap, two warps a scheduler; the
//   upper half adds its sums into the lower's through shared memory before
//   the epilogue. Registers: 134 a thread, no stack or local bytes
//   (cuobjdump -res-usage of the sm_90a build): 48
//   accumulators (3 planes x 2 m16 x 4, the big products and the two small
//   ones apart), two A fragments in flight (ldmatrix of step c + 1 starts
//   before step c's split), three B fragments. A warp runs its
//   instructions in order, so each k step runs its 18 MMAs in three passes
//   over the (dz, m16) pairs: the two MMAs into one accumulator are 12
//   apart.
//   Cout > 8: one CTA per n8 slice; the slices of a tile are neighbours in
//   blockIdx.x, so they run together and all but the first find its halo
//   planes in L2. At CVP level 0's (64, 64), 4 x 592 x 800 (D = 4: one z
//   run a CTA, 3,700 tiles x 8 slices), x is 485 MB; device memory gives
//   it about once, times the halo's 180 / 128 pixels (~0.68 GB), while
//   shared memory takes 8 x 4 planes of 46,080 B a tile (5.5 GB) and the
//   weights once a CTA (3.3 GB) from L2: a reckoning from the launch
//   shape, not measured (no ncu on the card's machine).
//   Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py 11a and 8a;
//   chip_ab.py for the direct kernel): Point-MVSNet's 64->8 at 96 x 120 x
//   160 1.04 ms (direct 14.12-14.16, cuDNN f32 with TF32 off 7.28-7.31,
//   3xTF32 bound 0.31), CVP level 0's (64, 64) at 4 x 592 x 800 6.99 ms
//   (direct 98.8-99.3, cuDNN 10.74-11.03, bound 2.54): 30% and 36% of the
//   TF32 rate.
//
// conv3d_direct_kernel (what the tensor-core kernels do not take: f32 with
// Cin outside {4, 8, 16, 32, 64}, or at Cin = 64 with Cout not a multiple of
// 8, bf16 with Cin not a multiple of 8): the direct form on the CUDA cores.
// One thread computes one voxel for a block of kCob output channels from a
// (27, Cin, kCob) f32 weight slice in shared memory.
//
// C interface (loaded with ctypes, see mvs_tpu_torch/ops/conv3d.py); every
// pointer is a device pointer to contiguous memory,
//   x      (B, D, H, W, Cin)   T
//   w      (Kpad, ldw)         T, rows tap*Cin + i with tap = (dz*3+dy)*3+dx,
//                              zero past 27*Cin rows and Cout columns; for
//                              the 3xTF32 entries the split fragments above
//   scale  (Cout,)             f32
//   shift  (Cout,)             f32
//   y      (B, D, H, W, Cout)  T
// with T = float (dtype 0) or __nv_bfloat16 (dtype 1) for the direct entry,
// bf16 for mvs_conv3d_mma and f32 for mvs_conv3d_tf32x3 and
// mvs_conv3d_tf32x3_cin64 (Cin = 64 only); ldw is the padded Cout. Each
// entry launches on `stream` and returns cudaGetLastError() (an argument it
// does not take: cudaErrorInvalidValue, before any launch).

#include "mvs_common.cuh"

namespace {

using mvs::from_f32;
using mvs::to_f32;

// --------------------------------------------------------------------------
// Direct kernel.

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // grid-stride beyond this: weights load once

template <typename T, int kCob>
__global__ void __launch_bounds__(kThreads)
conv3d_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, T* __restrict__ y,
                     int D, int H, int W, int Cin, int Cout, int ldw,
                     int relu, int64_t nvox) {
  extern __shared__ float sw[];  // (27, Cin, kCob) slice of this block
  const int co0 = blockIdx.y * kCob;
  const int ncol = min(kCob, Cout - co0);
  const int nw = 27 * Cin * kCob;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int co = i % kCob;
    const int row = i / kCob;  // tap * Cin + ci
    sw[i] = co < ncol ? to_f32(w[(int64_t)row * ldw + co0 + co]) : 0.f;
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
int launch_direct_cob(const void* x, const void* w, const void* scale,
                      const void* shift, void* y, int B, int D, int H, int W,
                      int Cin, int Cout, int ldw, int relu,
                      cudaStream_t stream) {
  const int64_t nvox = (int64_t)B * D * H * W;
  if (nvox == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * 27 * (size_t)Cin * kCob;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_direct_kernel<T, kCob>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (nvox + kThreads - 1) / kThreads;
  dim3 grid((unsigned)(want < kMaxBlocks ? want : kMaxBlocks),
            (unsigned)((Cout + kCob - 1) / kCob));
  conv3d_direct_kernel<T, kCob><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(y), D, H, W, Cin, Cout, ldw, relu, nvox);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_direct(const void* x, const void* w, const void* scale,
                  const void* shift, void* y, int B, int D, int H, int W,
                  int Cin, int Cout, int ldw, int relu, cudaStream_t stream) {
  // The score conv has one output channel: a block of 8 would idle 7/8 of
  // its FMAs.
  if (Cout == 1)
    return launch_direct_cob<T, 1>(x, w, scale, shift, y, B, D, H, W, Cin,
                                   Cout, ldw, relu, stream);
  return launch_direct_cob<T, 8>(x, w, scale, shift, y, B, D, H, W, Cin,
                                 Cout, ldw, relu, stream);
}

// --------------------------------------------------------------------------
// Tensor-core implicit GEMM: bf16 on m16n8k16, f32 as 3xTF32 on m16n8k8.

constexpr int kTH = 8;                    // output tile rows (H)
constexpr int kTW = 16;                   // output tile columns (W): one m16
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPix = (kTH + 2) * kHaloW;
constexpr int kMmaThreads = 128;          // 4 warps x 2 tile rows
constexpr int kRing = 4;                  // halo planes: 3 in use, 1 in flight
constexpr int kMaxZRun = 8;               // z planes per CTA at most
constexpr int kWeightBytes = 56 * 1024;   // K x N-slice budget in shared

// What the element type changes. A k step is two 16-byte chunks of a halo
// pixel: 16 bf16 channels for m16n8k16, 8 f32 channels for m16n8k8 (TF32).
// B takes, per (n8 tile, k step), 16 k rows of 8 bf16 (read by
// ldmatrix.trans) or, for f32, 32 lanes' fragments (b0, b1) of the big and
// the small weights (one 16-byte load per lane).
template <typename T>
struct Gemm {
  static constexpr int kChunkCh = 16 / sizeof(T);  // channels per chunk
  static constexpr int kStepBytes = sizeof(T) == 2 ? 256 : 512;
};

// A halo pixel of kChunks 16-byte chunks.
template <int kChunks>
struct Halo {
  static constexpr int kPixBytes = kChunks * 16;
  static constexpr int kPlaneBytes =
      (kHaloPix * kPixBytes + 127) / 128 * 128;
  // Chunk o of pixel p sits at o ^ ((p >> kShift) & (kChunks - 1)): 8
  // consecutive pixels at one chunk then fall in 8 distinct 16-byte bank
  // groups (the rows of one ldmatrix phase).
  static constexpr int kShift =
      kChunks == 1 ? 3 : kChunks == 2 ? 2 : kChunks == 4 ? 1 : 0;
  static __device__ __forceinline__ int offset(int p, int o) {
    return p * kPixBytes + ((o ^ ((p >> kShift) & (kChunks - 1))) << 4);
  }
};

template <typename T, int kCin>
__host__ __device__ constexpr int k_steps() {
  return (27 * (kCin / Gemm<T>::kChunkCh) + 1) / 2;
}

// B bytes of one n8 tile over every k step.
template <typename T, int kCin>
__host__ __device__ constexpr int tile_bytes() {
  return k_steps<T, kCin>() * Gemm<T>::kStepBytes;
}

template <typename T, int kCin, int kNs>
__host__ __device__ constexpr int mma_smem_bytes() {
  return kRing * Halo<kCin / Gemm<T>::kChunkCh>::kPlaneBytes +
         (kNs / 8) * tile_bytes<T, kCin>() + 16;
}

// Shared-memory address of the 16-byte A row this lane hands to ldmatrix at
// k-chunk q (tap q / kChunks, chunk q % kChunks), for output column `col` of
// tile row r. q is a compile-time constant once the k loop is unrolled.
template <int kChunks>
__device__ __forceinline__ uint32_t a_row(const uint32_t* plane,
                                          uint32_t zero, int q, int r,
                                          int col) {
  const int tap = q / kChunks;
  if (tap >= 27) return zero;
  const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
  const int p = (r + dy) * kHaloW + col + dx;
  return plane[dz] + Halo<kChunks>::offset(p, q % kChunks);
}

// Halo plane z of batch b (rows h0 - 1 .. h0 + kTH, columns w0 - 1 .. w0 +
// kTW) into dst as kChunks 16-byte chunks a pixel by cp.async, zero outside
// the volume (z outside [0, D) included). Keep it a function taking x by
// value: the same loop inlined in a lambda that captures x by reference
// computes the addresses in more instructions, and CVP level 0's nine bf16
// convs take 10.1 ms on one H100 at 700 W against 8.7 (chip_ab.py
// ab_bf16_convs), with the same MMA, ldmatrix and cp.async counts.
template <typename T, int kChunks, int kThreads = kMmaThreads>
__device__ __forceinline__ void load_halo(unsigned char* dst, const T* x,
                                          int b, int z, int D, int H, int W,
                                          int h0, int w0, int tid) {
  constexpr int kCh = kChunks * 16 / (int)sizeof(T);  // channels a pixel
  const bool zok = z >= 0 && z < D;
  const int64_t zrow = ((int64_t)b * D + (zok ? z : 0)) * H;
  for (int i = tid; i < kHaloPix * kChunks; i += kThreads) {
    const int p = i / kChunks, o = i % kChunks;
    const int hr = p / kHaloW, hc = p - hr * kHaloW;
    const int ih = h0 - 1 + hr, iw = w0 - 1 + hc;
    const bool ok = zok && ih >= 0 && ih < H && iw >= 0 && iw < W;
    const T* src = ok ? x + ((zrow + ih) * W + iw) * kCh + o * (16 / sizeof(T))
                      : x;
    mvs::cp_async16(mvs::smem_u32(dst + Halo<kChunks>::offset(p, o)), src,
                    ok ? 16 : 0);
  }
}

template <typename T, int kCin, int kNs>
__global__ void __launch_bounds__(kMmaThreads)
conv3d_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ y, int D,
                  int H, int W, int Cout, int ldw, int relu, int zrun,
                  int nzrun, int nns) {
  constexpr bool kTf32 = std::is_same<T, float>::value;
  constexpr int kChunks = kCin / Gemm<T>::kChunkCh;
  using L = Halo<kChunks>;
  constexpr int kSteps = k_steps<T, kCin>();
  constexpr int kTile = tile_bytes<T, kCin>();
  constexpr int kKpad = kSteps * 16;  // bf16 k rows
  constexpr int kNt = kNs / 8;        // n8 tiles of this CTA's N slice

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* wsm = smem + kRing * L::kPlaneBytes;  // [kNt][kTile]
  unsigned char* zero = wsm + kNt * kTile;              // one zero A row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = blockIdx.x * kTW, h0 = blockIdx.y * kTH;
  const int ns = blockIdx.z % nns;
  const int zi = (blockIdx.z / nns) % nzrun;
  const int b = blockIdx.z / (nns * nzrun);
  const int co0 = ns * kNs;
  const int z0 = zi * zrun;
  const int nz = min(zrun, D - z0);

  if constexpr (kTf32) {
    // Packed in fragment order (pack_conv3d_tf32x3): the slice is one run.
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(w) + (size_t)(co0 / 8) * kTile;
    for (int i = tid; i < kNt * kTile / 16; i += kMmaThreads)
      mvs::cp_async16(mvs::smem_u32(wsm + i * 16), src + i * 16, 16);
  } else {
    // n8 tile by n8 tile: 16-byte rows, so that ldmatrix.trans reads 8
    // consecutive k rows without bank conflicts.
    for (int i = tid; i < kKpad * kNt; i += kMmaThreads) {
      const int nt = i % kNt, k = i / kNt;
      mvs::cp_async16(mvs::smem_u32(wsm + (nt * kKpad + k) * 16),
                      w + (int64_t)k * ldw + co0 + nt * 8, 16);
    }
  }
  if (tid == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0, 0, 0, 0);

  // Input plane z0 - 1 + iz into ring slot iz % kRing, zero outside.
  auto load_plane = [&](int iz) {
    load_halo<T, kChunks>(ring + (iz % kRing) * L::kPlaneBytes, x, b,
                          z0 - 1 + iz, D, H, W, h0, w0, tid);
  };
  load_plane(0);
  mvs::cp_async_commit();  // with the weights
  load_plane(1);
  mvs::cp_async_commit();
  load_plane(2);
  mvs::cp_async_commit();

  // ldmatrix.x4 of A: lanes 0-15 address rows (output columns) 0-15 at the
  // step's first k-chunk, lanes 16-31 the same rows at its second. For f32
  // each 8x8 b16 matrix is 8 rows of four 32-bit values: the m16n8k8 TF32
  // A fragment (a0-a3) as it is.
  const int acol = lane & 15, ahalf = lane >> 4;
  // ldmatrix.trans of bf16 B: lanes 0-15 address k rows 0-15 of n8 tile
  // nt, lanes 16-31 those of tile nt + 1 (x4 only).
  const int brow = lane & 15, bnt = kNt > 1 ? lane >> 4 : 0;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row, column pair

  float sc[kNt][2], sh[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = co0 + nt * 8 + t4 * 2 + e;
      sc[nt][e] = c < Cout ? scale[c] : 0.f;
      sh[nt][e] = c < Cout ? shift[c] : 0.f;
    }

  const uint32_t ring0 = mvs::smem_u32(ring);
  const uint32_t wbase = mvs::smem_u32(wsm);
  const uint32_t zaddr = mvs::smem_u32(zero);

  for (int j = 0; j < nz; ++j) {
    if (j + 3 <= nz + 1) load_plane(j + 3);
    mvs::cp_async_commit();
    mvs::cp_async_wait<1>();  // planes j .. j+2 have landed
    __syncthreads();

    uint32_t plane[3];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
      plane[dz] = ring0 + ((j + dz) % kRing) * L::kPlaneBytes;

    float acc[2][kNt][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp * 2 + mt;
        const uint32_t lo = a_row<kChunks>(plane, zaddr, 2 * s, r, acol);
        const uint32_t hi = a_row<kChunks>(plane, zaddr, 2 * s + 1, r, acol);
        mvs::ldsm_x4(ahalf ? hi : lo, a[mt]);
      }
      if constexpr (kTf32) {
        // x = big + small, both TF32 (the weights come split); the sum
        // takes small*big, big*small, then big*big. small*small and the
        // parts' own rounding are below 2^-21 of the product.
        uint32_t as[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t big = mvs::tf32_rna(a[mt][i]);
            as[mt][i] = mvs::tf32_rna(__float_as_uint(
                __uint_as_float(a[mt][i]) - __uint_as_float(big)));
            a[mt][i] = big;
          }
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const uint4 bw = *reinterpret_cast<const uint4*>(
              wsm + nt * kTile + (s * 32 + lane) * 16);
          const uint32_t wb[2] = {bw.x, bw.y}, ws[2] = {bw.z, bw.w};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mvs::mma_tf32_1688(acc[mt][nt], as[mt], wb);
            mvs::mma_tf32_1688(acc[mt][nt], a[mt], ws);
            mvs::mma_tf32_1688(acc[mt][nt], a[mt], wb);
          }
        }
      } else {
        const uint32_t brow_addr =
            wbase + (bnt * kKpad + s * 16 + brow) * 16;
        if constexpr (kNt == 1) {
          uint32_t bf[2];
          mvs::ldsm_x2_trans(brow_addr, bf);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mvs::mma_bf16_16816(acc[mt][0], a[mt], bf);
        } else {
#pragma unroll
          for (int nt = 0; nt < kNt; nt += 2) {
            uint32_t bf[4];
            mvs::ldsm_x4_trans(brow_addr + nt * kKpad * 16, bf);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mvs::mma_bf16_16816(acc[mt][nt], a[mt], bf);
              mvs::mma_bf16_16816(acc[mt][nt + 1], a[mt], bf + 2);
            }
          }
        }
      }
    }

    // Epilogue: lane (g, t4) holds channels 2*t4, 2*t4+1 of columns g and
    // g + 8 of each n8 tile.
    const int oz = z0 + j;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int oh = h0 + warp * 2 + mt;
      const int64_t row = ((int64_t)b * D + oz) * H + oh;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = __fadd_rn(__fmul_rn(acc[mt][nt][e], sc[nt][e & 1]),
                           sh[nt][e & 1]);
          if (relu) v[e] = fmaxf(v[e], 0.f);
        }
        if (Cout == 1) {  // the score conv: channel 0 of columns g, g + 8
          if (t4 == 0 && oh < H) {
            if (w0 + g < W) y[row * W + w0 + g] = from_f32<T>(v[0]);
            if (w0 + g + 8 < W) y[row * W + w0 + g + 8] = from_f32<T>(v[2]);
          }
          continue;
        }
        if constexpr (kTf32) {
          // One 8-byte store per column: a quad's four fill one 32-byte
          // sector.
          float* yp = y + row * W * Cout + co0 + nt * 8 + 2 * t4;
          if (oh < H && w0 + g < W)
            *reinterpret_cast<float2*>(yp + (int64_t)(w0 + g) * Cout) =
                make_float2(v[0], v[1]);
          if (oh < H && w0 + g + 8 < W)
            *reinterpret_cast<float2*>(yp + (int64_t)(w0 + g + 8) * Cout) =
                make_float2(v[2], v[3]);
        } else {
          // Gather the quad's 8 channels of column g in lane t4 = 0 and of
          // column g + 8 in lane t4 = 1, then one 16-byte store each.
          const uint32_t lo = mvs::pack_bf16x2(v[0], v[1]);
          const uint32_t hi = mvs::pack_bf16x2(v[2], v[3]);
          const int quad = lane & ~3;
          uint32_t q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t l = __shfl_sync(0xffffffffu, lo, quad + i);
            const uint32_t h = __shfl_sync(0xffffffffu, hi, quad + i);
            q[i] = t4 == 0 ? l : h;
          }
          const int ow = w0 + g + (t4 == 1 ? 8 : 0);
          if (t4 < 2 && oh < H && ow < W)
            *reinterpret_cast<uint4*>(y + (row * W + ow) * Cout + co0 +
                                      nt * 8) =
                make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    }
    __syncthreads();  // slot j % kRing is refilled next iteration
  }
}

// The card's SM count, read once.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// z planes a CTA marches over: up to kMaxZRun, halved while `tiles` CTAs
// a z run give fewer than `min_ctas` in all.
int z_run(int D, int64_t tiles, int64_t min_ctas) {
  int zrun = D < kMaxZRun ? D : kMaxZRun;
  while (zrun > 1 && tiles * ((D + zrun - 1) / zrun) < min_ctas)
    zrun = (zrun + 1) / 2;
  return zrun;
}

template <typename T, int kCin, int kNs>
int launch_mma_ns(const void* x, const void* w, const void* scale,
                  const void* shift, void* y, int B, int D, int H, int W,
                  int Cout, int ldw, int relu, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<T, kCin, kNs>();
  static_assert(smem <= 227 * 1024, "shared memory");
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3d_mma_kernel<T, kCin, kNs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int nns = ldw / kNs;
  const int64_t tiles =
      (int64_t)((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH) * nns * B;
  // Under 2 CTAs an SM, shorter runs.
  const int zrun = z_run(D, tiles, 2 * (int64_t)sm_count());
  const int nzrun = (D + zrun - 1) / zrun;
  const int64_t gz = (int64_t)B * nzrun * nns;
  if (gz > 65535 || (H + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, (unsigned)gz);
  conv3d_mma_kernel<T, kCin, kNs><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(y), D, H, W, Cout, ldw, relu, zrun, nzrun, nns);
  return (int)cudaGetLastError();
}

// The widest N slice (32, 16 or 8 columns) that divides the padded Cout and
// keeps K x N within kWeightBytes.
template <typename T, int kCin>
int launch_mma(const void* x, const void* w, const void* scale,
               const void* shift, void* y, int B, int D, int H, int W,
               int Cout, int ldw, int relu, cudaStream_t stream) {
  constexpr int kTile = tile_bytes<T, kCin>();
  if constexpr (kTile * 4 <= kWeightBytes) {
    if (ldw % 32 == 0)
      return launch_mma_ns<T, kCin, 32>(x, w, scale, shift, y, B, D, H, W,
                                        Cout, ldw, relu, stream);
  }
  if constexpr (kTile * 2 <= kWeightBytes) {
    if (ldw % 16 == 0)
      return launch_mma_ns<T, kCin, 16>(x, w, scale, shift, y, B, D, H, W,
                                        Cout, ldw, relu, stream);
  }
  return launch_mma_ns<T, kCin, 8>(x, w, scale, shift, y, B, D, H, W, Cout,
                                   ldw, relu, stream);
}

// The tensor-core entries' shared checks and their switch over Cin.
template <typename T, int... kCins>
int dispatch_mma(const void* x, const void* w, const void* scale,
                 const void* shift, void* y, int B, int D, int H, int W,
                 int Cin, int Cout, int ldw, int relu, void* stream) {
  if ((B * (int64_t)D * H * W) == 0) return cudaSuccess;
  if (ldw % 8 != 0 || (Cout != 1 && Cout % 8 != 0) || Cout > ldw)
    return (int)cudaErrorInvalidValue;
  int status = (int)cudaErrorInvalidValue;  // a Cin it does not take
  (void)((Cin == kCins &&
          (status = launch_mma<T, kCins>(x, w, scale, shift, y, B, D, H, W,
                                         Cout, ldw, relu,
                                         static_cast<cudaStream_t>(stream)),
           true)) ||
         ...);
  return status;
}

// --------------------------------------------------------------------------
// 3xTF32 at Cin = 64: the same tile, fragments and split, input-stationary
// over z (see the header).

using HaloC64 = Halo<16>;                     // 64 f32 channels a pixel
constexpr int kC64Ring = 2;                   // halo planes: in use, in flight
constexpr int kC64Steps = 27 * 8;             // k8 steps; a tap is 8 of them
constexpr int kC64Tile = kC64Steps * 512;     // split B of one n8 tile
constexpr int kC64Threads = 256;  // 2 channel halves x 4 warps x 2 rows
constexpr int kC64Red = 4 * 2 * 32 * 16;      // one half's partial sums
constexpr int kC64Smem = kC64Ring * HaloC64::kPlaneBytes + kC64Tile + kC64Red;

__global__ void __launch_bounds__(kC64Threads, 1)
conv3d_tf32x3_cin64_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           float* __restrict__ y, int D, int H, int W,
                           int Cout, int relu, int zrun, int nzrun, int nns) {
  using L = HaloC64;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* wsm = smem + kC64Ring * L::kPlaneBytes;  // one n8 tile
  float4* red = reinterpret_cast<float4*>(wsm + kC64Tile);

  const int tid = threadIdx.x, lane = tid & 31;
  // Warp (half, wr): tile rows 2 wr, 2 wr + 1 over channels 32 half ..
  // 32 half + 31 of every tap (k steps 4 half .. 4 half + 3 of the tap's 8).
  const int half = tid >> 7, wr = (tid >> 5) & 3;
  // The n8 slices of a tile are neighbours in the grid, so they run at the
  // same time and all but the first read its halo planes from L2.
  const int ns = blockIdx.x % nns;
  const int w0 = (blockIdx.x / nns) * kTW, h0 = blockIdx.y * kTH;
  const int zi = blockIdx.z % nzrun, b = blockIdx.z / nzrun;
  const int z0 = zi * zrun, nz = min(zrun, D - z0);
  const int co0 = ns * 8;

  {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(w) + (size_t)ns * kC64Tile;
    for (int i = tid; i < kC64Tile / 16; i += kC64Threads)
      mvs::cp_async16(mvs::smem_u32(wsm + i * 16), src + i * 16, 16);
  }
  // Step i (0 .. nz + 1) takes input plane z0 - 1 + i from ring slot
  // i % kC64Ring; a plane outside the volume is zero: not loaded, not
  // multiplied.
  auto in_volume = [&](int i) {
    return z0 - 1 + i >= 0 && z0 - 1 + i < D;
  };
  auto load_plane = [&](int i) {
    load_halo<float, 16, kC64Threads>(ring + (i % kC64Ring) * L::kPlaneBytes,
                                      x, b, z0 - 1 + i, D, H, W, h0, w0, tid);
  };
  if (in_volume(0)) load_plane(0);
  mvs::cp_async_commit();  // with the weights

  // ldmatrix.x4 of A as in conv3d_mma_kernel: lanes 0-15 address output
  // columns 0-15 at a step's first chunk, lanes 16-31 at its second.
  const int acol = lane & 15, ahalf = lane >> 4;
  const int g = lane >> 2, t4 = lane & 3;
  float sc[2], sh[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = co0 + t4 * 2 + e;
    sc[e] = c < Cout ? scale[c] : 0.f;
    sh[e] = c < Cout ? shift[c] : 0.f;
  }
  const uint32_t ring0 = mvs::smem_u32(ring);
  const unsigned char* wl = wsm + lane * 16;

  // acc[k][mt]: output plane z0 + i - k of tile row wr * 2 + mt during step
  // i, which it takes through tap plane dz = k. The big products go to acc,
  // the two small ones to acs: three chains of MMAs, not one.
  float acc[3][2][4], acs[3][2][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][mt][e] = acs[k][mt][e] = 0.f;

  for (int i = 0; i < nz + 2; ++i) {
    if (i + 1 < nz + 2 && in_volume(i + 1)) load_plane(i + 1);
    mvs::cp_async_commit();
    mvs::cp_async_wait<1>();  // plane i (and the weights) have landed
    __syncthreads();

    if (in_volume(i)) {
      // Output planes of the run that this plane feeds: k in [klo, khi].
      const int klo = max(0, i - nz + 1), khi = min(2, i);
      const uint32_t plane = ring0 + (i % kC64Ring) * L::kPlaneBytes;
      for (int t = 0; t < 9; ++t) {  // (dy, dx) = (t / 3, t % 3)
        const int dy = t / 3, dx = t - dy * 3;
        uint32_t arow[2];
        int asw[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int p = (wr * 2 + mt + dy) * kHaloW + acol + dx;
          arow[mt] = plane + p * L::kPixBytes;
          asw[mt] = ahalf ^ (p & 15);  // Halo<16>::offset's swizzle
        }
        // k step (dz * 9 + t) * 8 + c of the packed weights, c = 4 half +
        // cc.
        const unsigned char* bt = wl + (t * 8 + 4 * half) * 512;
        uint32_t a[2][2][4];  // [cc & 1][mt]: the next step's is in flight
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mvs::ldsm_x4(arow[mt] + (((8 * half) ^ asw[mt]) << 4), a[0][mt]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          uint32_t(&ab)[2][4] = a[cc & 1];
          if (cc + 1 < 4) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mvs::ldsm_x4(
                  arow[mt] + (((8 * half + 2 * (cc + 1)) ^ asw[mt]) << 4),
                  a[(cc + 1) & 1][mt]);
          }
          uint4 bw[3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (k >= klo && k <= khi)
              bw[k] = *reinterpret_cast<const uint4*>(bt +
                                                      (k * 72 + cc) * 512);
          uint32_t as[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t big = mvs::tf32_rna(ab[mt][j]);
              as[mt][j] = mvs::tf32_rna(__float_as_uint(
                  __uint_as_float(ab[mt][j]) - __uint_as_float(big)));
              ab[mt][j] = big;
            }
          // Three passes over the (k, mt) pairs: the two MMAs into one acs
          // are 12 MMAs apart, not back to back (a warp runs in order).
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              if (k < klo || k > khi) continue;
              const uint32_t wb[2] = {bw[k].x, bw[k].y};
              const uint32_t ws[2] = {bw[k].z, bw[k].w};
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                if (pass == 0) mvs::mma_tf32_1688(acs[k][mt], as[mt], wb);
                if (pass == 1) mvs::mma_tf32_1688(acc[k][mt], ab[mt], wb);
                if (pass == 2) mvs::mma_tf32_1688(acs[k][mt], ab[mt], ws);
              }
            }
        }
      }
    }

    // Output plane z0 + i - 2 has all three of its planes: the upper
    // half's sums go through shared memory to the lower half, which adds
    // them and stores.
    if (i >= 2 && half == 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        red[(wr * 2 + mt) * 32 + lane] = make_float4(
            __fadd_rn(acc[2][mt][0], acs[2][mt][0]),
            __fadd_rn(acc[2][mt][1], acs[2][mt][1]),
            __fadd_rn(acc[2][mt][2], acs[2][mt][2]),
            __fadd_rn(acc[2][mt][3], acs[2][mt][3]));
    }
    __syncthreads();
    if (i >= 2 && half == 0) {
      const int64_t zrow = ((int64_t)b * D + z0 + i - 2) * H;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int oh = h0 + wr * 2 + mt;
        const float4 up = red[(wr * 2 + mt) * 32 + lane];
        const float other[4] = {up.x, up.y, up.z, up.w};
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = __fadd_rn(
              __fmul_rn(__fadd_rn(__fadd_rn(acc[2][mt][e], acs[2][mt][e]),
                                  other[e]),
                        sc[e & 1]),
              sh[e & 1]);
          if (relu) v[e] = fmaxf(v[e], 0.f);
        }
        float* yp = y + (zrow + oh) * W * Cout + co0 + 2 * t4;
        if (oh < H && w0 + g < W)
          *reinterpret_cast<float2*>(yp + (int64_t)(w0 + g) * Cout) =
              make_float2(v[0], v[1]);
        if (oh < H && w0 + g + 8 < W)
          *reinterpret_cast<float2*>(yp + (int64_t)(w0 + g + 8) * Cout) =
              make_float2(v[2], v[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2][mt][e] = acc[1][mt][e];
        acc[1][mt][e] = acc[0][mt][e];
        acc[0][mt][e] = 0.f;
        acs[2][mt][e] = acs[1][mt][e];
        acs[1][mt][e] = acs[0][mt][e];
        acs[0][mt][e] = 0.f;
      }
    __syncthreads();  // slot i % kC64Ring is refilled at step i + 1
  }
}

int launch_tf32x3_cin64(const void* x, const void* w, const void* scale,
                        const void* shift, void* y, int B, int D, int H,
                        int W, int Cout, int ldw, int relu,
                        cudaStream_t stream) {
  static_assert(kC64Smem <= 227 * 1024, "shared memory");
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3d_tf32x3_cin64_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kC64Smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int nns = ldw / 8;
  const int64_t gx = (int64_t)nns * ((W + kTW - 1) / kTW);
  const int64_t tiles = gx * ((H + kTH - 1) / kTH) * B;
  // One CTA an SM: shorter runs under one wave.
  const int zrun = z_run(D, tiles, sm_count());
  const int nzrun = (D + zrun - 1) / zrun;
  const int64_t gz = (int64_t)B * nzrun;
  if (gx > 0x7fffffff || gz > 65535 || (H + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (H + kTH - 1) / kTH, (unsigned)gz);
  conv3d_tf32x3_cin64_kernel<<<grid, kC64Threads, kC64Smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), D, H, W, Cout, relu, zrun, nzrun, nns);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mvs_conv3d_direct(const void* x, const void* w,
                                 const void* scale, const void* shift,
                                 void* y, int B, int D, int H, int W, int Cin,
                                 int Cout, int ldw, int relu, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_direct<float>(x, w, scale, shift, y, B, D, H, W, Cin, Cout,
                                ldw, relu, s);
  if (dtype == 1)
    return launch_direct<__nv_bfloat16>(x, w, scale, shift, y, B, D, H, W,
                                        Cin, Cout, ldw, relu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mvs_conv3d_mma(const void* x, const void* w, const void* scale,
                              const void* shift, void* y, int B, int D, int H,
                              int W, int Cin, int Cout, int ldw, int relu,
                              void* stream) {
  return dispatch_mma<__nv_bfloat16, 8, 16, 32, 64>(
      x, w, scale, shift, y, B, D, H, W, Cin, Cout, ldw, relu, stream);
}

extern "C" int mvs_conv3d_tf32x3(const void* x, const void* w,
                                 const void* scale, const void* shift,
                                 void* y, int B, int D, int H, int W, int Cin,
                                 int Cout, int ldw, int relu, void* stream) {
  return dispatch_mma<float, 4, 8, 16, 32>(x, w, scale, shift, y, B, D, H, W,
                                           Cin, Cout, ldw, relu, stream);
}

extern "C" int mvs_conv3d_tf32x3_cin64(const void* x, const void* w,
                                       const void* scale, const void* shift,
                                       void* y, int B, int D, int H, int W,
                                       int Cin, int Cout, int ldw, int relu,
                                       void* stream) {
  if ((B * (int64_t)D * H * W) == 0) return cudaSuccess;
  if (Cin != 64 || Cout < 8 || Cout % 8 != 0 || ldw % 8 != 0 ||
      Cout > ldw)
    return (int)cudaErrorInvalidValue;
  return launch_tf32x3_cin64(x, w, scale, shift, y, B, D, H, W, Cout, ldw,
                             relu, static_cast<cudaStream_t>(stream));
}
