// Rotated patch sampling from the scale pyramid (refinement and eye patches).
//
// Replaces the TPU kernel pyfaceanalysis_tpu/ops/pallas_gather.py
// sample_patches_pyramid (body _gather_kernel). Per patch b, output pixel
// (i, j) maps to the continuous texel of pyramid level levels[b]
//
//   lx = (ax * (j + .5) + bx * (i + .5)) + cx
//   ly = (ay * (j + .5) + by * (i + .5)) + cy
//
// Nearest rounds half to even (rintf, as torch.round); bilinear blends the
// four neighbours, x first, then y. Texels outside the level read as 0.
//
// One launch per call: the kernel takes scales, levels, boxes and angles as
// the caller holds them (any element strides, int32 or int64 levels) and
// computes the six coefficients itself, once per block, by one thread, into
// shared memory (patch_affine below: box extent, rotation about the box
// centre, canvas u -> level u/s - 0.5). Its specification is
// ops/patches.py pyramid_affine, followed operation for operation:
// every + - * / is an _rn intrinsic in that function's order, so the
// compiler can neither reassociate nor contract a multiply and an add into
// an FMA; deg2rad is the one float multiply by float(pi/180) that
// torch.deg2rad does; cosf and sinf are the accurate libdevice functions
// that torch.cos and torch.sin call (never compile this file with
// --use_fast_math). The per-pixel map is evaluated from (j + .5) and
// (i + .5) each time, never incrementally, which would round differently.
// So the kernel performs the same IEEE operations as its plain version
// (ops/patches.py sample_patches_pyramid_ref) and agrees with it bit for
// bit; pfa_gather_coeffs_launch exposes the coefficients so that a check
// can hold them against pyramid_affine directly.
// Unlike the TPU kernel it samples float32 texels: the TPU's bf16 texel
// rounding fed its matrix unit and is not part of the function.
//
// Bound: bytes. Each output pixel reads 1 (nearest) or 4 (bilinear)
// texels and writes one float. The TPU kernel's tiles, (8, 128) snapping,
// rolls and one-hot matmul sampling existed because a TPU has no scalar
// gather; a GPU thread gathers directly. A thread produces 4 consecutive
// pixels of an output row and stores them as one float4 (scalar stores
// when the width is not a multiple of 4, where rows are not 16-byte
// aligned); i and j come from the block and thread indices, with no
// integer division. A block is (ceil(ow / 4), rows) threads, about
// PFA_GATHER_THREADS in all, and walks a band of one patch's rows. The
// launch cuts each patch into as few bands as still give
// PFA_GATHER_MIN_BLOCKS blocks in all (fewer, longer blocks compute the
// coefficients less often; about four blocks per SM were fastest at every
// batch size of the detect path, tools/torch_gather_variants.py): B = 512
// patches of 64x64 are 512 blocks of a whole patch, B = 128 are 512 blocks
// of 16 rows. Texels are read with __ldg from global memory: a patch's
// footprint is a few tens of KB inside a pyramid of some 26 MB that the
// 50 MB L2 holds. TMA, shared-memory tiles and wgmma have no use here: a
// rotated box is not a rectangle of the level, and there is no product.
// No tile, no size limit on the box or on out_hw.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/cuda_gather.py).

#include <cuda_runtime.h>
#include <algorithm>
#include <cstddef>

#ifndef PFA_GATHER_THREADS
#define PFA_GATHER_THREADS 256
#endif
#ifndef PFA_GATHER_MIN_BLOCKS
#define PFA_GATHER_MIN_BLOCKS 512
#endif

namespace {

// float(pi / 180): torch.deg2rad multiplies by this constant in float32.
constexpr float kDegToRad = 0.017453292519943295f;

// The per-patch inputs as the caller holds them; strides in elements.
struct PatchInputs {
  const float* scales;   // (L,)
  const void* levels;    // (B,) int32 or int64
  const float* boxes;    // (B, 4) [x0, y0, x1, y1], x1/y1 inclusive
  const float* angles;   // (B,) degrees
  long long scales_stride, levels_stride, boxes_stride0, boxes_stride1,
      angles_stride;
  int levels_are_64;
  int L;
};

__device__ __forceinline__ int patch_level(const PatchInputs& in, int b) {
  const long long at = b * in.levels_stride;
  const long long lev =
      in.levels_are_64 ? static_cast<const long long*>(in.levels)[at]
                       : static_cast<const int*>(in.levels)[at];
  return static_cast<int>(min(max(lev, 0LL),
                              static_cast<long long>(in.L - 1)));
}

// c = [ax, bx, cx, ay, by, cy] of patch b at level lev: ops/patches.py
// pyramid_affine, one rounding per operation, in its order.
__device__ void patch_affine(const PatchInputs& in, int b, int lev, int oh,
                             int ow, float* c) {
  const float s_k = in.scales[lev * in.scales_stride];
  const float* box = in.boxes + b * in.boxes_stride0;
  const float x0 = box[0];
  const float y0 = box[in.boxes_stride1];
  const float x1 = box[2 * in.boxes_stride1];
  const float y1 = box[3 * in.boxes_stride1];
  const float bw = __fsub_rn(__fadd_rn(x1, 1.0f), x0);
  const float bh = __fsub_rn(__fadd_rn(y1, 1.0f), y0);
  const float cx = __fadd_rn(x0, __fmul_rn(bw, 0.5f));
  const float cy = __fadd_rn(y0, __fmul_rn(bh, 0.5f));
  const float rad = __fmul_rn(in.angles[b * in.angles_stride], kDegToRad);
  const float co = cosf(rad);
  const float si = sinf(rad);
  const float dx = __fsub_rn(x0, cx);
  const float dy = __fsub_rn(y0, cy);
  const float sw = __fmul_rn(static_cast<float>(ow), s_k);
  const float sh = __fmul_rn(static_cast<float>(oh), s_k);
  c[0] = __fdiv_rn(__fmul_rn(co, bw), sw);
  c[1] = __fdiv_rn(__fmul_rn(-si, bh), sh);
  c[2] = __fsub_rn(
      __fdiv_rn(__fsub_rn(__fadd_rn(cx, __fmul_rn(co, dx)),
                          __fmul_rn(si, dy)), s_k), 0.5f);
  c[3] = __fdiv_rn(__fmul_rn(si, bw), sw);
  c[4] = __fdiv_rn(__fmul_rn(co, bh), sh);
  c[5] = __fsub_rn(
      __fdiv_rn(__fadd_rn(__fadd_rn(cy, __fmul_rn(si, dx)),
                          __fmul_rn(co, dy)), s_k), 0.5f);
}

__device__ __forceinline__ float texel(const float* __restrict__ level,
                                       int lh, int lw, int iy, int ix) {
  return (ix >= 0 && ix < lw && iy >= 0 && iy < lh)
             ? __ldg(level + static_cast<size_t>(iy) * lw + ix)
             : 0.0f;
}

template <bool kBilinear>
__device__ __forceinline__ float sample(const float* __restrict__ level,
                                        int lh, int lw, float lx, float ly) {
  if constexpr (kBilinear) {
    const float fx0 = floorf(lx);
    const float fy0 = floorf(ly);
    const float tx = __fsub_rn(lx, fx0);
    const float ty = __fsub_rn(ly, fy0);
    const int ix0 = static_cast<int>(fx0);
    const int iy0 = static_cast<int>(fy0);
    const float top = __fadd_rn(
        __fmul_rn(texel(level, lh, lw, iy0, ix0), __fsub_rn(1.0f, tx)),
        __fmul_rn(texel(level, lh, lw, iy0, ix0 + 1), tx));
    const float bot = __fadd_rn(
        __fmul_rn(texel(level, lh, lw, iy0 + 1, ix0), __fsub_rn(1.0f, tx)),
        __fmul_rn(texel(level, lh, lw, iy0 + 1, ix0 + 1), tx));
    return __fadd_rn(__fmul_rn(top, __fsub_rn(1.0f, ty)),
                     __fmul_rn(bot, ty));
  } else {
    return texel(level, lh, lw, static_cast<int>(rintf(ly)),
                 static_cast<int>(rintf(lx)));
  }
}

// grid (B, row bands); block (ceil(ow / 4) capped, rows). Thread
// (threadIdx.x, threadIdx.y) writes pixels 4 * threadIdx.x .. + 3 of the
// band's rows threadIdx.y, threadIdx.y + blockDim.y, ...
template <bool kBilinear>
__global__ void gather_kernel(const float* __restrict__ pyr, PatchInputs in,
                              float* __restrict__ out, int lh, int lw,
                              int oh, int ow, int band_rows) {
  __shared__ float c[6];
  __shared__ int level_of_patch;
  const int b = blockIdx.x;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int lev = patch_level(in, b);
    level_of_patch = lev;
    patch_affine(in, b, lev, oh, ow, c);
  }
  __syncthreads();
  const float* level =
      pyr + static_cast<size_t>(level_of_patch) * lh * lw;
  const bool vector_rows = (ow & 3) == 0;
  const int i_end = min(oh, (static_cast<int>(blockIdx.y) + 1) * band_rows);
  for (int i = blockIdx.y * band_rows + threadIdx.y; i < i_end;
       i += blockDim.y) {
    const float ii = static_cast<float>(i) + 0.5f;
    const float bx_i = __fmul_rn(c[1], ii);
    const float by_i = __fmul_rn(c[4], ii);
    float* row = out + (static_cast<size_t>(b) * oh + i) * ow;
    for (int j = 4 * threadIdx.x; j < ow; j += 4 * blockDim.x) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float jj = static_cast<float>(j + k) + 0.5f;
        const float lx =
            __fadd_rn(__fadd_rn(__fmul_rn(c[0], jj), bx_i), c[2]);
        const float ly =
            __fadd_rn(__fadd_rn(__fmul_rn(c[3], jj), by_i), c[5]);
        v[k] = (j + k < ow) ? sample<kBilinear>(level, lh, lw, lx, ly)
                            : 0.0f;
      }
      if (vector_rows) {
        *reinterpret_cast<float4*>(row + j) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j + k < ow) row[j + k] = v[k];
        }
      }
    }
  }
}

// One thread per patch writes the six coefficients the gather would use.
__global__ void coeffs_kernel(PatchInputs in, float* __restrict__ coeffs,
                              int B, int oh, int ow) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c[6];
  patch_affine(in, b, patch_level(in, b), oh, ow, c);
  for (int k = 0; k < 6; ++k) coeffs[6 * static_cast<size_t>(b) + k] = c[k];
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// Strides are in elements; out is (B, oh, ow) contiguous, pyr (L, lh, lw)
// contiguous.
extern "C" int pfa_gather_launch(
    const float* pyr, const float* scales, const void* levels,
    const float* boxes, const float* angles, float* out,
    long long scales_stride, long long levels_stride, long long boxes_stride0,
    long long boxes_stride1, long long angles_stride, int levels_are_64,
    int B, int L, int lh, int lw, int oh, int ow, int bilinear,
    void* stream) {
  if (B == 0 || oh == 0 || ow == 0) return 0;
  const PatchInputs in{scales, levels, boxes, angles, scales_stride,
                       levels_stride, boxes_stride0, boxes_stride1,
                       angles_stride, levels_are_64, L};
  const int tx = std::min((ow + 3) / 4, PFA_GATHER_THREADS);
  const int ty = std::max(1, std::min(PFA_GATHER_THREADS / tx, oh));
  const int max_bands = (oh + ty - 1) / ty;
  const int bands =
      std::max(1, std::min(max_bands, (PFA_GATHER_MIN_BLOCKS + B - 1) / B));
  const int band_rows = ty * ((max_bands + bands - 1) / bands);
  const dim3 block(tx, ty);
  const dim3 grid(B, (oh + band_rows - 1) / band_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bilinear) {
    gather_kernel<true><<<grid, block, 0, s>>>(pyr, in, out, lh, lw, oh, ow,
                                               band_rows);
  } else {
    gather_kernel<false><<<grid, block, 0, s>>>(pyr, in, out, lh, lw, oh, ow,
                                                band_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The (B, 6) coefficients alone, for checks against pyramid_affine.
extern "C" int pfa_gather_coeffs_launch(
    const float* scales, const void* levels, const float* boxes,
    const float* angles, float* coeffs, long long scales_stride,
    long long levels_stride, long long boxes_stride0,
    long long boxes_stride1, long long angles_stride, int levels_are_64,
    int B, int L, int oh, int ow, void* stream) {
  if (B == 0) return 0;
  const PatchInputs in{scales, levels, boxes, angles, scales_stride,
                       levels_stride, boxes_stride0, boxes_stride1,
                       angles_stride, levels_are_64, L};
  const int threads = 128;
  coeffs_kernel<<<(B + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in, coeffs, B, oh,
                                                       ow);
  return static_cast<int>(cudaGetLastError());
}
