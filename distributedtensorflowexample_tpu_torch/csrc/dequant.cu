// Fused row gather + affine dequant for the device-resident uint8 split.
//
// Replaces: distributedtensorflowexample_tpu/ops/pallas/dequant.py
//           _dequant_row_kernel (driven by _fused_gather_dequant_flat).
//
// Computes out[i, j] = fma(f32(images[idx[i], j]), scale[j % C], bias[j % C])
// with ONE rounding (__fmaf_rn), bitwise equal to data/dequant.affine_numpy
// (which reproduces the single rounding in float64).
//
// What bounds it on an H100: bytes, in principle.  It reads B*R uint8 and
// writes B*R float32 (5 B per pixel): 0.25 MB at the main path's B=64,
// R=784, about 75 ns at 3.35 TB/s and far below one launch, so at the
// main path's shapes its device time is the launch plus one thread's
// chain of instructions; at the eval's B=1000 (3.9 MB) the bytes start to
// count.  The design keeps the chain short and every access wide:
// - one thread per 16 source bytes: one 16-byte read-only load (uint4).
//   Threads are laid flat over the batch (thread t takes vector
//   t % (R/16) of output row t / (R/16)), so rows share blocks and the
//   only idle lanes are in the last block: 3136 threads at B=64, R=784,
//   49000 at B=1000.  Output row r starts at float r*R, so vector t's 16
//   floats are floats 16t .. 16t+15 of the flat output, whatever the row;
// - the stores are coalesced through a warp transpose: each lane parks
//   its 16 bytes in shared memory, then the warp writes its 512
//   consecutive output floats as four float4 stores per lane, store i of
//   lane l at float4 l + 32i, so every store instruction writes 512
//   contiguous bytes (without it, a lane's own four float4s sit 64 bytes
//   from its neighbour's and every store half-fills its sectors);
// - every thread loads its row's index itself (the TPU kernel's scalar
//   prefetch); the row's threads read the same word, served once;
// - index arithmetic is 32-bit (the wrapper keeps B*R and N below 2^31);
//   only a source row's base offset is 64-bit;
// - the channel count is a template parameter (1, 3, or any C at run
//   time).  With C=1 or 3 the constants sit in registers; the channel of
//   a float4's first element is computed once (flat index % C: R is a
//   multiple of C) and advanced.
// A row whose length or source base is not a multiple of 16 bytes (a
// sliced view, a 5x7x1 sample), or an output that is not 16-byte aligned,
// takes the same kernel's scalar path, one thread per byte; the wrapper
// makes that choice (ops/kernels/dequant.py vector_path).  TMA and wgmma
// do not apply: there is no matrix product, and a 784-byte row gains
// nothing from a bulk copy into shared memory over 16-byte register loads.
//
// Out-of-range indices are CLAMPED to [0, n_rows - 1] (never read out of
// bounds, never trap: a trap would poison the CUDA context).  The plain
// version in ops/kernels/dequant.py clamps the same way, so the two agree
// on every input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kVec = 16;  // source bytes per thread on the vector path

// The affine constants of CH channels in registers; CH == 0: `channels`
// of them, read through the read-only cache.
template <int CH>
struct Affine {
  float s[CH], b[CH];
  __device__ Affine(const float* scale, const float* bias, int) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      s[c] = __ldg(scale + c);
      b[c] = __ldg(bias + c);
    }
  }
  __device__ int count() const { return CH; }
  __device__ float operator()(uint32_t u, int c) const {
    float sc = s[0], bc = b[0];
#pragma unroll
    for (int i = 1; i < CH; ++i) {
      sc = c == i ? s[i] : sc;
      bc = c == i ? b[i] : bc;
    }
    return __fmaf_rn(static_cast<float>(u), sc, bc);
  }
};

template <>
struct Affine<0> {
  const float* scale;
  const float* bias;
  int channels;
  __device__ Affine(const float* s, const float* b, int c)
      : scale(s), bias(b), channels(c) {}
  __device__ int count() const { return channels; }
  __device__ float operator()(uint32_t u, int c) const {
    return __fmaf_rn(static_cast<float>(u), __ldg(scale + c), __ldg(bias + c));
  }
};

// work: B*R/16 vectors (vec) or B*R bytes (scalar); per_row: R/16 or R.
template <int CH>
__global__ void __launch_bounds__(kThreads)
    dequant_gather_kernel(const uint8_t* __restrict__ images, int n_rows,
                          int row_len, const int32_t* __restrict__ idx,
                          int work, int per_row,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, int channels,
                          int vec, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const Affine<CH> affine(scale, bias, channels);
  const int ch = affine.count();
  const int row = t / per_row;
  const int k = t - row * per_row;
  if (!vec) {
    if (t >= work) return;
    const int src = min(max(__ldg(idx + row), 0), n_rows - 1);
    const uint8_t* in = images + static_cast<int64_t>(src) * row_len;
    out[t] = affine(__ldg(in + k), CH == 1 ? 0 : k % ch);
    return;
  }
  __shared__ uint4 stage[kThreads];
  if (t < work) {
    const int src = min(max(__ldg(idx + row), 0), n_rows - 1);
    const uint8_t* in = images + static_cast<int64_t>(src) * row_len;
    stage[threadIdx.x] = __ldg(reinterpret_cast<const uint4*>(in) + k);
  }
  __syncwarp();
  const int lane = threadIdx.x % kWarp;
  const int first = t - lane;  // the warp's first vector
  const int words = min(kWarp, work - first) * (kVec / 4);
  const uint32_t* w =
      reinterpret_cast<const uint32_t*>(stage + (threadIdx.x - lane));
  float4* o4 = reinterpret_cast<float4*>(out) + first * (kVec / 4);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i) {
    const int j = lane + kWarp * i;  // word j -> output float4 j
    if (j < words) {
      const uint32_t u = w[j];
      int c = CH == 1 ? 0 : (first * kVec + 4 * j) % ch;  // flat index % C
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = affine((u >> (8 * e)) & 0xffu, c);
        c = c + 1 == ch ? 0 : c + 1;
      }
      o4[j] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

}  // namespace

// n_rows, row_len and batch * row_len are below 2^31 (the wrapper checks).
// vec: 1 for the 16-byte path (row_len, images and out all multiples of
// 16 bytes), 0 for the scalar path.
extern "C" int dequant_gather(const void* images, int n_rows, int row_len,
                              const void* idx, int batch, const void* scale,
                              const void* bias, int channels, int vec,
                              void* out, void* stream) {
  const int per_row = vec ? row_len / kVec : row_len;
  const int work = batch * per_row;
  if (work > 0) {
    const auto kernel = channels == 1   ? dequant_gather_kernel<1>
                        : channels == 3 ? dequant_gather_kernel<3>
                                        : dequant_gather_kernel<0>;
    kernel<<<(work + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(images), n_rows, row_len,
        static_cast<const int32_t*>(idx), work, per_row,
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        channels, vec, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dequant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
