// Fused softmax cross-entropy, forward and backward.
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
// What bounds it on an H100: launch latency.  At the main path's B=64,
// C=10 each direction moves a few KB (bytes bound ~1 ns at 3.35 TB/s), so
// the kernel's device time is the launch plus the length of each row's
// dependent instruction chain; the forward is shaped to shorten that
// chain:
// - a row belongs to a group of W lanes, W the next power of two >= C
//   capped at 32, so at C = 10 a warp holds two rows in two 16-lane
//   groups (no idle half-warp); every shuffle takes the group's width;
// - each row is read from device memory once, into registers: K values
//   per lane for C <= 32 * kMaxRegs, with max, sum, picked and total all
//   taken from those registers; above that cap each lane keeps a running
//   max and a sum rescaled when the max grows (online softmax), so one
//   read still suffices (C = 250 for the LM head sits in registers,
//   C = 1000 takes the online form);
// - the reduction is one max tree, then one tree that carries sum,
//   picked and total together: three independent shuffles per round.
// A group past the end of the batch recomputes the last row and stores
// nothing, so every lane reaches the full-mask shuffles.  The backward
// keeps one warp per row: its lanes loop over the columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
// The forward: threads per block, and registers per lane that hold a row
// (C up to 32 * 8 = 256).
constexpr int kFwdThreads = 128;
constexpr int kMaxRegs = 8;

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

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o, W));
  return v;
}

template <int W>
__device__ __forceinline__ void group_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    const float a2 = __shfl_xor_sync(kFull, a, o, W);
    const float b2 = __shfl_xor_sync(kFull, b, o, W);
    const float c2 = __shfl_xor_sync(kFull, c, o, W);
    a += a2;
    b += b2;
    c += c2;
  }
}

// K > 0: each lane holds columns lane, lane + W, ..., K of them, in
// registers.  K == 0: the online form for any C.
template <int W, int K>
__global__ void __launch_bounds__(kFwdThreads)
    ce_fwd_kernel(const float* __restrict__ logits,
                  const int32_t* __restrict__ labels, int batch, int classes,
                  int smooth, float one_minus_s, float s,
                  float* __restrict__ loss) {
  const int row = (blockIdx.x * kFwdThreads + threadIdx.x) / W;
  const int lane = threadIdx.x & (W - 1);
  const int r = row < batch ? row : batch - 1;
  const float* x = logits + static_cast<int64_t>(r) * classes;
  const int label = __ldg(labels + r);
  float m = -INFINITY, sum = 0.f, picked = 0.f, total = 0.f;
  if constexpr (K > 0) {
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + k * W;
      v[k] = c < classes ? __ldg(x + c) : -INFINITY;
      m = fmaxf(m, v[k]);
    }
    m = group_max<W>(m);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + k * W;
      if (c < classes) {
        sum += expf(v[k] - m);
        total += v[k];
        if (c == label) picked = v[k];
      }
    }
  } else {
    for (int c = lane; c < classes; c += W) {
      const float v = __ldg(x + c);
      if (v > m) {
        sum = sum * expf(m - v) + 1.f;
        m = v;
      } else if (m > -INFINITY) {
        sum += expf(v - m);
      }
      total += v;
      if (c == label) picked = v;
    }
    const float lane_max = m;
    m = group_max<W>(m);
    if (lane_max > -INFINITY) sum *= expf(lane_max - m);
  }
  group_sum3<W>(sum, picked, total);
  if (row < batch && lane == 0) {
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

template <int W, int K>
void launch_fwd(const void* logits, const void* labels, int batch,
                int classes, int smooth, float one_minus_s, float s,
                void* loss, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * W;
  const int blocks =
      static_cast<int>((threads + kFwdThreads - 1) / kFwdThreads);
  ce_fwd_kernel<W, K><<<blocks, kFwdThreads, 0, stream>>>(
      static_cast<const float*>(logits), static_cast<const int32_t*>(labels),
      batch, classes, smooth, one_minus_s, s, static_cast<float*>(loss));
}

}  // namespace

extern "C" int ce_fwd(const void* logits, const void* labels, int batch,
                      int classes, int smooth, float one_minus_s, float s,
                      void* loss, void* stream) {
  if (batch > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    // Group width W = next power of two >= C (at most 32); then K
    // registers per lane, or the online form above the register cap.
    const auto launch = classes <= 1     ? launch_fwd<1, 1>
                        : classes <= 2   ? launch_fwd<2, 1>
                        : classes <= 4   ? launch_fwd<4, 1>
                        : classes <= 8   ? launch_fwd<8, 1>
                        : classes <= 16  ? launch_fwd<16, 1>
                        : classes <= 32  ? launch_fwd<32, 1>
                        : classes <= 64  ? launch_fwd<32, 2>
                        : classes <= 128 ? launch_fwd<32, 4>
                        : classes <= kWarp * kMaxRegs
                            ? launch_fwd<32, kMaxRegs>
                            : launch_fwd<32, 0>;
    launch(logits, labels, batch, classes, smooth, one_minus_s, s, loss, st);
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
