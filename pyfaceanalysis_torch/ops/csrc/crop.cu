// Batched axis-aligned crops from the scale pyramid (the iter-0 grid).
//
// Replaces the TPU kernel pyfaceanalysis_tpu/ops/pallas_crop.py
// crop_patches_pallas (body _crop_kernel): (B, 3) int32 [level, y, x] ->
// (B, h, w) float32, out[b] = pyr[level, y:y+h, x:x+w], starts clamped into
// the pyramid as lax.dynamic_slice clamps them. A pure copy, so it is
// bit-exact with its plain version (ops/pyramid.py crop_patches).
//
// Bound: bytes. Each patch reads h*w texels and writes h*w floats; there is
// no arithmetic. The TPU kernel's (8, 128) DMA snapping, rolls and one-hot
// row matmul exist only for the TPU's tiled memory and are not carried
// over. Here one block copies one patch: a warp covers 32 neighbouring
// texels of one row, so every read and write is a coalesced 128-byte line.
// No shared-memory staging: each texel is read once, so there is nothing
// to reuse.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/cuda_crop.py).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

__global__ void crop_kernel(const float* __restrict__ pyr,
                            const int* __restrict__ crops,
                            float* __restrict__ out,
                            int L, int lh, int lw, int h, int w) {
  const int b = blockIdx.x;
  const int lev = min(max(crops[3 * b + 0], 0), L - 1);
  const int y = min(max(crops[3 * b + 1], 0), lh - h);
  const int x = min(max(crops[3 * b + 2], 0), lw - w);
  const float* src = pyr + (static_cast<size_t>(lev) * lh + y) * lw + x;
  float* dst = out + static_cast<size_t>(b) * h * w;
  for (int r = threadIdx.y; r < h; r += blockDim.y) {
    const float* srow = src + static_cast<size_t>(r) * lw;
    float* drow = dst + static_cast<size_t>(r) * w;
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      drow[c] = srow[c];
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int pfa_crop_launch(const float* pyr, const int* crops,
                               float* out, int B, int L, int lh, int lw,
                               int h, int w, void* stream) {
  if (B == 0) return 0;
  const dim3 block(32, 8);
  crop_kernel<<<B, block, 0, static_cast<cudaStream_t>(stream)>>>(
      pyr, crops, out, L, lh, lw, h, w);
  return static_cast<int>(cudaGetLastError());
}
