// Rotated patch sampling from the scale pyramid (refinement and eye patches).
//
// Replaces the TPU kernel pyfaceanalysis_tpu/ops/pallas_gather.py
// sample_patches_pyramid (body _gather_kernel). Per patch b, output pixel
// (i, j) maps to the continuous texel of pyramid level levels[b]
//
//   lx = c0 * (j + .5) + c1 * (i + .5) + c2
//   ly = c3 * (j + .5) + c4 * (i + .5) + c5
//
// with the six coefficients computed by the caller (ops/patches.py
// pyramid_affine: box extent, rotation about the box centre, canvas u ->
// level u/s - 0.5). Nearest rounds half to even (rintf, as jnp.round);
// bilinear blends the four neighbours, x first, then y. Texels outside the
// level read as 0.
//
// Every float operation is written as an _rn intrinsic, so the compiler
// cannot contract a multiply and an add into an FMA: the kernel performs
// the same IEEE operations, in the same order, as its plain version
// (ops/patches.py sample_patches_pyramid_ref) and agrees with it exactly.
// Unlike the TPU kernel it samples float32 texels: the TPU's bf16 texel
// rounding fed its matrix unit and is not part of the function.
//
// Bound: bytes. Each output pixel reads 1 (nearest) or 4 (bilinear)
// texels and writes one float. The TPU kernel's tiles, (8, 128) snapping,
// rolls and one-hot matmul sampling existed because a TPU has no scalar
// gather; a GPU thread gathers directly. So: one thread per output pixel,
// reading the level from global memory (neighbouring threads read
// neighbouring texels, mostly within the same cache lines; a patch's
// footprint is a few tens of KB and stays in L1/L2). No tile, no size
// limit on the box or on out_hw.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/cuda_gather.py).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

__device__ __forceinline__ float texel(const float* __restrict__ level,
                                       int lh, int lw, int iy, int ix) {
  return (ix >= 0 && ix < lw && iy >= 0 && iy < lh)
             ? level[static_cast<size_t>(iy) * lw + ix]
             : 0.0f;
}

template <bool kBilinear>
__global__ void gather_kernel(const float* __restrict__ pyr,
                              const int* __restrict__ levels,
                              const float* __restrict__ coeffs,
                              float* __restrict__ out,
                              int L, int lh, int lw, int oh, int ow) {
  const int b = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= oh * ow) return;
  const int i = p / ow;
  const int j = p - i * ow;
  const float* c = coeffs + 6 * b;
  const float jj = static_cast<float>(j) + 0.5f;
  const float ii = static_cast<float>(i) + 0.5f;
  const float lx = __fadd_rn(__fadd_rn(__fmul_rn(c[0], jj),
                                       __fmul_rn(c[1], ii)), c[2]);
  const float ly = __fadd_rn(__fadd_rn(__fmul_rn(c[3], jj),
                                       __fmul_rn(c[4], ii)), c[5]);
  const int lev = min(max(levels[b], 0), L - 1);
  const float* level = pyr + static_cast<size_t>(lev) * lh * lw;
  float v;
  if (kBilinear) {
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
    v = __fadd_rn(__fmul_rn(top, __fsub_rn(1.0f, ty)), __fmul_rn(bot, ty));
  } else {
    v = texel(level, lh, lw, static_cast<int>(rintf(ly)),
              static_cast<int>(rintf(lx)));
  }
  out[static_cast<size_t>(b) * oh * ow + p] = v;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int pfa_gather_launch(const float* pyr, const int* levels,
                                 const float* coeffs, float* out, int B,
                                 int L, int lh, int lw, int oh, int ow,
                                 int bilinear, void* stream) {
  if (B == 0) return 0;
  const int threads = 256;
  const dim3 grid(B, (oh * ow + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bilinear) {
    gather_kernel<true><<<grid, threads, 0, s>>>(pyr, levels, coeffs, out,
                                                 L, lh, lw, oh, ow);
  } else {
    gather_kernel<false><<<grid, threads, 0, s>>>(pyr, levels, coeffs, out,
                                                  L, lh, lw, oh, ow);
  }
  return static_cast<int>(cudaGetLastError());
}
