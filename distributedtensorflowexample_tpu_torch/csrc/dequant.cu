// Fused row gather + affine dequant for the device-resident uint8 split.
//
// Replaces: distributedtensorflowexample_tpu/ops/pallas/dequant.py
//           _dequant_row_kernel (driven by _fused_gather_dequant_flat).
//
// Computes out[i, j] = fma(f32(images[idx[i], j]), scale[j % C], bias[j % C])
// with ONE rounding (__fmaf_rn), bitwise equal to data/dequant.affine_numpy
// (which reproduces the single rounding in float64).
//
// What bounds it on an H100: bytes.  It reads B*R uint8 and writes B*R
// float32 (5 B per pixel): 0.25 MB at the main path's B=64, R=784 — about
// 75 ns at 3.35 TB/s, far below one launch, so at main-path shapes it is
// launch-bound.  The design reads every source byte once and never
// materializes a uint8 minibatch: one block per output row loads its own
// index (the TPU kernel's scalar prefetch) and its threads stride over R,
// neighbouring threads on neighbouring bytes.
//
// Out-of-range indices are CLAMPED to [0, n_rows - 1] (never read out of
// bounds, never trap: a trap would poison the CUDA context).  The plain
// version in ops/kernels/dequant.py clamps the same way, so the two agree
// on every input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void dequant_gather_kernel(const uint8_t* __restrict__ images,
                                      int64_t n_rows, int64_t row_len,
                                      const int32_t* __restrict__ idx,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      int channels,
                                      float* __restrict__ out) {
  int64_t src = idx[blockIdx.x];
  src = src < 0 ? 0 : (src >= n_rows ? n_rows - 1 : src);
  const uint8_t* in = images + src * row_len;
  float* o = out + static_cast<int64_t>(blockIdx.x) * row_len;
  for (int64_t j = threadIdx.x; j < row_len; j += blockDim.x) {
    const int c = static_cast<int>(j % channels);
    o[j] = __fmaf_rn(static_cast<float>(in[j]), scale[c], bias[c]);
  }
}

}  // namespace

extern "C" int dequant_gather(const void* images, int64_t n_rows,
                              int64_t row_len, const void* idx, int batch,
                              const void* scale, const void* bias,
                              int channels, void* out, void* stream) {
  if (batch > 0) {
    dequant_gather_kernel<<<batch, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(images), n_rows, row_len,
        static_cast<const int32_t*>(idx), static_cast<const float*>(scale),
        static_cast<const float*>(bias), channels, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dequant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
