// Native host data loader (a copy of the JAX package's native/dataio.cc,
// which the port builds and binds itself: native/loader.py).
//
// Host C++ with OpenMP for the per-step host work of the host-fed input
// path (data/pipeline.py): IDX and CIFAR-10 parsing, the shuffled batch
// gather, and the CIFAR crop and flip fused with the gather, on float32
// or uint8 rows.  It runs on the CPU; no device kernel is here.
//
// Randomness is drawn by the Python caller and passed in (crop offsets,
// flip bits), so the native and numpy paths are bit-identical and runs
// stay deterministic per seed.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -fopenmp (see loader.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Big-endian u32 read (IDX headers are big-endian).
inline uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// numpy 'reflect' padding index map for pad=4: padded coord p -> source
// coord in [0, n): mirror without repeating the edge sample.
inline int64_t reflect4(int64_t p, int64_t n) {
  int64_t m = p - 4;
  if (m < 0) m = -m;
  if (m >= n) m = 2 * n - 2 - m;
  return m;
}

}  // namespace

extern "C" {

// ---- IDX (MNIST) ----------------------------------------------------------

// Header query. Returns 0 on success, nonzero error code otherwise.
int idx_images_dims(const unsigned char* buf, size_t len, int64_t* n,
                    int64_t* rows, int64_t* cols) {
  if (len < 16 || be32(buf) != 2051) return 1;
  *n = be32(buf + 4);
  *rows = be32(buf + 8);
  *cols = be32(buf + 12);
  if (len < 16 + size_t(*n) * size_t(*rows) * size_t(*cols)) return 2;
  return 0;
}

// Parse pixels into out[n*rows*cols] floats scaled to [0, 1].
int idx_images_parse(const unsigned char* buf, size_t len, float* out) {
  int64_t n, rows, cols;
  int rc = idx_images_dims(buf, len, &n, &rows, &cols);
  if (rc) return rc;
  const unsigned char* px = buf + 16;
  const int64_t total = n * rows * cols;
  // Multiply by the rounded f32 reciprocal (data/dequant.py
  // U8_UNIT_SCALE): the repo-wide canonical byte->float arithmetic —
  // bit-identical to the numpy loader AND to the in-step affine dequant
  // of a uint8-resident split.  A division would round differently on
  // 126 of the 256 byte values.
  const float kScale = 1.0f / 255.0f;  // constant-folded to the f32 value
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < total; ++i) out[i] = float(px[i]) * kScale;
  return 0;
}

int idx_labels_dims(const unsigned char* buf, size_t len, int64_t* n) {
  if (len < 8 || be32(buf) != 2049) return 1;
  *n = be32(buf + 4);
  if (len < 8 + size_t(*n)) return 2;
  return 0;
}

int idx_labels_parse(const unsigned char* buf, size_t len, int32_t* out) {
  int64_t n;
  int rc = idx_labels_dims(buf, len, &n);
  if (rc) return rc;
  const unsigned char* p = buf + 8;
  for (int64_t i = 0; i < n; ++i) out[i] = int32_t(p[i]);
  return 0;
}

// ---- CIFAR-10 binary ------------------------------------------------------

// Records of [label u8][3072 u8, CHW].  Emits NHWC floats in [0, 1] and
// int32 labels.  n_records = len / 3073.
int cifar_parse(const unsigned char* buf, size_t len, float* out_images,
                int32_t* out_labels) {
  if (len % 3073 != 0) return 1;
  const int64_t n = int64_t(len / 3073);
  const float kScale = 1.0f / 255.0f;  // canonical affine scale (see above)
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const unsigned char* rec = buf + i * 3073;
    out_labels[i] = int32_t(rec[0]);
    const unsigned char* chw = rec + 1;
    float* img = out_images + i * 3072;
    for (int64_t y = 0; y < 32; ++y)
      for (int64_t x = 0; x < 32; ++x)
        for (int64_t c = 0; c < 3; ++c)
          img[(y * 32 + x) * 3 + c] = float(chw[c * 1024 + y * 32 + x]) * kScale;
  }
  return 0;
}

// ---- Batch assembly -------------------------------------------------------
// Templates need C++ linkage; the extern "C" block reopens for the
// concrete entry points below.
}  // extern "C"

namespace {

// out[i, :] = src[idx[i], :] — the per-step shuffled-minibatch gather.
// T = float (f32 splits) or uint8_t (quantized splits: 4x fewer bytes
// through the gather AND the later host->device copy).
template <typename T>
void gather_rows(const T* src, const int64_t* idx, int64_t batch,
                 int64_t row_elems, T* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < batch; ++i)
    std::memcpy(out + i * row_elems, src + idx[i] * row_elems,
                size_t(row_elems) * sizeof(T));
}

// One implementation of the crop/flip indexing for every entry point:
// idx == nullptr means identity (output row i sources input row i).
// Pure pixel rearrangement, so it is dtype-generic (f32 and u8).
template <typename T>
void crop_flip_impl(const T* src, const int64_t* idx, int64_t batch,
                    int64_t h, int64_t w, int64_t c, const int32_t* ys,
                    const int32_t* xs, const uint8_t* flips, T* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < batch; ++i) {
    const T* img = src + (idx ? idx[i] : i) * h * w * c;
    T* dst = out + i * h * w * c;
    const int64_t y0 = ys[i], x0 = xs[i];
    const bool flip = flips[i] != 0;
    for (int64_t y = 0; y < h; ++y) {
      const int64_t sy = reflect4(y0 + y, h);
      for (int64_t x = 0; x < w; ++x) {
        const int64_t ox = flip ? (w - 1 - x) : x;
        const int64_t sx = reflect4(x0 + ox, w);
        const T* s = img + (sy * w + sx) * c;
        T* d = dst + (y * w + x) * c;
        for (int64_t ch = 0; ch < c; ++ch) d[ch] = s[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

void gather_f32(const float* src, const int64_t* idx, int64_t batch,
                int64_t row_elems, float* out) {
  gather_rows(src, idx, batch, row_elems, out);
}

void gather_u8(const unsigned char* src, const int64_t* idx, int64_t batch,
               int64_t row_elems, unsigned char* out) {
  gather_rows(src, idx, batch, row_elems, out);
}

void gather_i32(const int32_t* src, const int64_t* idx, int64_t batch,
                int32_t* out) {
  for (int64_t i = 0; i < batch; ++i) out[i] = src[idx[i]];
}

// ---- CIFAR train augmentation --------------------------------------------

// Random crop from a reflect-padded (pad=4) image + horizontal flip,
// fused: the padded image is never materialized.  src/out are
// [batch, h, w, c]; ys/xs in [0, 8], flips in {0, 1}.
void augment_crop_flip(const float* src, int64_t batch, int64_t h, int64_t w,
                       int64_t c, const int32_t* ys, const int32_t* xs,
                       const uint8_t* flips, float* out) {
  crop_flip_impl(src, nullptr, batch, h, w, c, ys, xs, flips, out);
}

void augment_crop_flip_u8(const unsigned char* src, int64_t batch, int64_t h,
                          int64_t w, int64_t c, const int32_t* ys,
                          const int32_t* xs, const uint8_t* flips,
                          unsigned char* out) {
  crop_flip_impl(src, nullptr, batch, h, w, c, ys, xs, flips, out);
}

// Gather + augment in one pass: rows are pulled from the full training
// array and augmented straight into the output batch (no intermediate
// batch copy).
void gather_augment_f32(const float* src, const int64_t* idx, int64_t batch,
                        int64_t h, int64_t w, int64_t c, const int32_t* ys,
                        const int32_t* xs, const uint8_t* flips, float* out) {
  crop_flip_impl(src, idx, batch, h, w, c, ys, xs, flips, out);
}

void gather_augment_u8(const unsigned char* src, const int64_t* idx,
                       int64_t batch, int64_t h, int64_t w, int64_t c,
                       const int32_t* ys, const int32_t* xs,
                       const uint8_t* flips, unsigned char* out) {
  crop_flip_impl(src, idx, batch, h, w, c, ys, xs, flips, out);
}

int omp_max_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
