// Fused momentum-SGD apply over flat float32 buffers, in place.
//
// Replaces: distributedtensorflowexample_tpu/ops/pallas/sgd.py _sgd_kernel
//           (driven by fused_sgd_flat; entries fused_momentum_sgd and
//           fused_sgd_apply).
//
// Computes, for every parameter i at once:
//   m[i] = fma(mu, m[i], g[i])          (optax.sgd trace: mu * m + g)
//   p[i] = fma(-lr, m[i], p[i])         (p - lr * m, one rounding)
// Each line rounds once, which is what the JAX reference computes on the
// CPU (XLA contracts both multiply-adds; measured against the Pallas
// kernel in interpret mode and against jitted optax.sgd).  lr arrives as
// a float read on the host (the port's schedule is host-side); mu is a
// float argument too.
//
// What bounds it on an H100: bytes.  It reads p, m, g and writes p, m:
// 20 B per parameter, 65.5 MB for MnistCNN's 3,274,634 parameters — about
// 19.5 us at 3.35 TB/s, larger than the 50 MB L2, so it streams from
// device memory.  The design touches each byte once: one grid-stride pass
// with 16-byte (float4) loads and stores over the 4-aligned bulk and a
// scalar tail, a few blocks per SM.  The port keeps the model's
// parameters, the momentum and the gradients as views into three flat
// buffers (training/optimizers.py), so the apply is ONE launch per step
// with no per-step pack or unpack — the round trip that made the TPU
// version lose (sgd.py's module note).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ void step1(float& p, float& m, float g, float lr,
                                      float mu) {
  m = __fmaf_rn(mu, m, g);
  p = __fmaf_rn(-lr, m, p);
}

__global__ void sgd_momentum_kernel(float* __restrict__ p,
                                    float* __restrict__ m,
                                    const float* __restrict__ g, int64_t n,
                                    float lr, float mu) {
  const int64_t n4 = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 pv = p4[i], mv = m4[i];
    const float4 gv = g4[i];
    step1(pv.x, mv.x, gv.x, lr, mu);
    step1(pv.y, mv.y, gv.y, lr, mu);
    step1(pv.z, mv.z, gv.z, lr, mu);
    step1(pv.w, mv.w, gv.w, lr, mu);
    m4[i] = mv;
    p4[i] = pv;
  }
  if (blockIdx.x == 0) {
    for (int64_t i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) {
      float pv = p[i], mv = m[i];
      step1(pv, mv, g[i], lr, mu);
      m[i] = mv;
      p[i] = pv;
    }
  }
}

}  // namespace

// p, m and g must be 16-byte aligned (the wrapper checks).
extern "C" int sgd_momentum(void* p, void* m, const void* g, int64_t n,
                            float lr, float mu, void* stream) {
  if (n > 0) {
    const int64_t n4 = n / 4;
    int64_t blocks = (n4 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    sgd_momentum_kernel<<<static_cast<int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<float*>(m),
        static_cast<const float*>(g), n, lr, mu);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
