// Fused softmax cross-entropy, forward and backward, one warp per row.
//
// Replaces: distributedtensorflowexample_tpu/ops/pallas/cross_entropy.py
//           _ce_fwd_kernel (driven by _ce_fwd) and _ce_bwd_kernel (driven
//           by _ce_bwd, the custom_vjp backward).
//
// Forward, per row of logits [B, C] f32 with int32 label y:
//   m = max_c x, lse = m + log(sum_c exp(x - m)), picked = x[y] (0 if y is
//   not a column), target = picked, or with smoothing s > 0
//   (1 - s) * picked + s * mean_c(x); loss = lse - target, 0 where y < 0.
// Backward recomputes the softmax from the logits and writes
//   dlogits = (softmax - target) * g[row], target = onehot(y), or with
//   smoothing (1 - s) * onehot(y) + s / C; 0 on rows where y < 0.
// (1 - s) and s / C arrive from the host already rounded to float32, as
// the JAX kernel folds its Python-float smoothing constants.
//
// What bounds it on an H100: launch overhead.  At the main path's B=64,
// C=10 each direction moves a few KB (bytes bound ~1 ns at 3.35 TB/s), so
// the kernel is one short launch; the design reads each logit row from
// device memory once per pass (the warp's loads are coalesced) and keeps
// max, sum, picked and the row total in registers, reduced across the
// warp with __shfl_xor_sync.  Rows are warp-uniform, so a warp that falls
// off the batch exits whole and the full-mask shuffles stay legal.  Any C
// works: each lane loops over columns lane, lane + 32, ...  (C = 250 for
// the LM head).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float row_max(const float* x, int classes,
                                         int lane) {
  float m = -INFINITY;
  for (int c = lane; c < classes; c += kWarp) m = fmaxf(m, x[c]);
  return warp_max(m);
}

__global__ void ce_fwd_kernel(const float* __restrict__ logits,
                              const int32_t* __restrict__ labels, int batch,
                              int classes, int smooth, float one_minus_s,
                              float s, float* __restrict__ loss) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= batch) return;
  const float* x = logits + static_cast<int64_t>(row) * classes;
  const int label = labels[row];
  const float m = row_max(x, classes, lane);
  float sum = 0.f, picked = 0.f, total = 0.f;
  for (int c = lane; c < classes; c += kWarp) {
    const float v = x[c];
    sum += expf(v - m);
    total += v;
    if (c == label) picked = v;
  }
  sum = warp_sum(sum);
  picked = warp_sum(picked);
  total = warp_sum(total);
  if (lane == 0) {
    const float lse = m + logf(sum);
    const float target =
        smooth ? one_minus_s * picked + s * (total / static_cast<float>(classes))
               : picked;
    loss[row] = label >= 0 ? lse - target : 0.f;
  }
}

__global__ void ce_bwd_kernel(const float* __restrict__ logits,
                              const int32_t* __restrict__ labels,
                              const float* __restrict__ g, int batch,
                              int classes, int smooth, float one_minus_s,
                              float s_over_c, float* __restrict__ dlogits) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= batch) return;
  const int64_t base = static_cast<int64_t>(row) * classes;
  const float* x = logits + base;
  float* dx = dlogits + base;
  const int label = labels[row];
  const float m = row_max(x, classes, lane);
  float sum = 0.f;
  for (int c = lane; c < classes; c += kWarp) sum += expf(x[c] - m);
  sum = warp_sum(sum);
  const float gr = g[row];
  for (int c = lane; c < classes; c += kWarp) {
    const float p = expf(x[c] - m) / sum;
    const float onehot = c == label ? 1.f : 0.f;
    const float target = smooth ? one_minus_s * onehot + s_over_c : onehot;
    dx[c] = label >= 0 ? (p - target) * gr : 0.f;
  }
}

inline int blocks_for(int batch) {
  return (batch + kRowsPerBlock - 1) / kRowsPerBlock;
}

}  // namespace

extern "C" int ce_fwd(const void* logits, const void* labels, int batch,
                      int classes, int smooth, float one_minus_s, float s,
                      void* loss, void* stream) {
  if (batch > 0) {
    ce_fwd_kernel<<<blocks_for(batch), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), static_cast<const int32_t*>(labels),
        batch, classes, smooth, one_minus_s, s, static_cast<float*>(loss));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ce_bwd(const void* logits, const void* labels, const void* g,
                      int batch, int classes, int smooth, float one_minus_s,
                      float s_over_c, void* dlogits, void* stream) {
  if (batch > 0) {
    ce_bwd_kernel<<<blocks_for(batch), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), static_cast<const int32_t*>(labels),
        static_cast<const float*>(g), batch, classes, smooth, one_minus_s,
        s_over_c, static_cast<float*>(dlogits));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cross_entropy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
