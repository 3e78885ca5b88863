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
// C=10 each direction moves a few KB (bytes bound ~1-2 ns at 3.35 TB/s),
// so the kernel's device time is the launch plus the length of each row's
// dependent instruction chain.  Both directions are shaped to shorten that
// chain, and share one launch table (with_row_shape):
// - a row belongs to a group of W lanes, W the next power of two >= C
//   capped at 32, so at C = 10 a warp holds two rows in two 16-lane
//   groups (no idle half-warp); every shuffle takes the group's width;
// - each row is read from device memory once, into registers: K values
//   per lane for C <= 32 * kMaxRegs; above that cap each lane keeps a
//   running max and a sum rescaled when the max grows (online softmax)
//   (C = 250 for the LM head sits in registers, C = 1000 takes the online
//   form);
// - a group past the end of the batch recomputes the last row and stores
//   nothing, so every lane reaches the full-mask shuffles.
// The forward reduces in one max tree, then one tree that carries sum,
// picked and total together (three independent shuffles per round).
// The backward reduces in one max tree and one sum tree; each lane keeps
// e = exp(x - m) in its registers (one exp per element) and writes
// (e / sum - target) * g from them, neighbouring lanes on neighbouring
// columns (at C = 10 a warp stores two adjacent 40-byte rows).  The label
// and g[row] are read once per row.  In the online form the backward
// reads the row a second time, from L1/L2, to write it.  At the LM head's
// [2048, 250] the backward moves ~4.1 MB (bound ~1.2 us), so there the
// register form's coalesced loads and stores are what count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// Threads per block, and registers per lane that hold a row (C up to
// 32 * 8 = 256).
constexpr int kThreads = 128;
constexpr int kMaxRegs = 8;

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o, W));
  return v;
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, W);
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
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const float* __restrict__ logits,
                  const int32_t* __restrict__ labels, int batch, int classes,
                  int smooth, float one_minus_s, float s,
                  float* __restrict__ loss) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / W;
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

// One element of the backward: (p - target) * g, target = onehot(label) or
// (1 - s) * onehot + s / C; 0 where the label is < 0.
__device__ __forceinline__ float ce_grad(float p, int c, int label,
                                         int smooth, float one_minus_s,
                                         float s_over_c, float gr) {
  const float onehot = c == label ? 1.f : 0.f;
  const float target = smooth ? one_minus_s * onehot + s_over_c : onehot;
  return label >= 0 ? (p - target) * gr : 0.f;
}

// Same row groups and K as the forward.  K > 0: the lane's K values stay in
// registers from the load to the store, as e = exp(x - m).
template <int W, int K>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const float* __restrict__ logits,
                  const int32_t* __restrict__ labels,
                  const float* __restrict__ g, int batch, int classes,
                  int smooth, float one_minus_s, float s_over_c,
                  float* __restrict__ dlogits) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / W;
  const int lane = threadIdx.x & (W - 1);
  const int r = row < batch ? row : batch - 1;
  const int64_t base = static_cast<int64_t>(r) * classes;
  const float* x = logits + base;
  float* dx = dlogits + base;
  const int label = __ldg(labels + r);
  const float gr = __ldg(g + r);
  float m = -INFINITY, sum = 0.f;
  if constexpr (K > 0) {
    float e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + k * W;
      e[k] = c < classes ? __ldg(x + c) : -INFINITY;
      m = fmaxf(m, e[k]);
    }
    m = group_max<W>(m);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + k * W < classes) {
        e[k] = expf(e[k] - m);
        sum += e[k];
      }
    }
    sum = group_sum<W>(sum);
    if (row < batch) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = lane + k * W;
        if (c < classes)
          dx[c] = ce_grad(e[k] / sum, c, label, smooth, one_minus_s,
                          s_over_c, gr);
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
    }
    const float lane_max = m;
    m = group_max<W>(m);
    if (lane_max > -INFINITY) sum *= expf(lane_max - m);
    sum = group_sum<W>(sum);
    if (row < batch) {
      for (int c = lane; c < classes; c += W)
        dx[c] = ce_grad(expf(__ldg(x + c) - m) / sum, c, label, smooth,
                        one_minus_s, s_over_c, gr);
    }
  }
}

template <int W_, int K_>
struct RowShape {
  static constexpr int W = W_;
  static constexpr int K = K_;
};

// Calls launch(RowShape<W, K>{}) for C classes: group width W = the next
// power of two >= C (at most 32), then K registers per lane, or K = 0 (the
// online form) above the register cap.  Both directions launch through it.
template <typename Launch>
void with_row_shape(int classes, Launch&& launch) {
  if (classes <= 1) launch(RowShape<1, 1>{});
  else if (classes <= 2) launch(RowShape<2, 1>{});
  else if (classes <= 4) launch(RowShape<4, 1>{});
  else if (classes <= 8) launch(RowShape<8, 1>{});
  else if (classes <= 16) launch(RowShape<16, 1>{});
  else if (classes <= 32) launch(RowShape<32, 1>{});
  else if (classes <= 64) launch(RowShape<32, 2>{});
  else if (classes <= 128) launch(RowShape<32, 4>{});
  else if (classes <= kWarp * kMaxRegs) launch(RowShape<32, kMaxRegs>{});
  else launch(RowShape<32, 0>{});
}

// Blocks for one group of `width` lanes per row.
inline int grid_for(int batch, int width) {
  const int64_t threads = static_cast<int64_t>(batch) * width;
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int ce_fwd(const void* logits, const void* labels, int batch,
                      int classes, int smooth, float one_minus_s, float s,
                      void* loss, void* stream) {
  if (batch > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    with_row_shape(classes, [&](auto shape) {
      using S = decltype(shape);
      ce_fwd_kernel<S::W, S::K><<<grid_for(batch, S::W), kThreads, 0, st>>>(
          static_cast<const float*>(logits),
          static_cast<const int32_t*>(labels), batch, classes, smooth,
          one_minus_s, s, static_cast<float*>(loss));
    });
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ce_bwd(const void* logits, const void* labels, const void* g,
                      int batch, int classes, int smooth, float one_minus_s,
                      float s_over_c, void* dlogits, void* stream) {
  if (batch > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    with_row_shape(classes, [&](auto shape) {
      using S = decltype(shape);
      ce_bwd_kernel<S::W, S::K><<<grid_for(batch, S::W), kThreads, 0, st>>>(
          static_cast<const float*>(logits),
          static_cast<const int32_t*>(labels), static_cast<const float*>(g),
          batch, classes, smooth, one_minus_s, s_over_c,
          static_cast<float*>(dlogits));
    });
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cross_entropy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
