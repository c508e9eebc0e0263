// Host data runtime of the PyTorch/CUDA port: the port's own copy of the JAX package's
// csrc/dtp_native.cpp, with the same seven extern "C" entry points and the same results,
// and the codec-free entry points the port adds.
//
// JPEG decode (the library's own decoder, below: no libjpeg), PNG decode (libpng),
// OpenCV-compatible bilinear resize (half-pixel centres), normalisation, and a
// deterministic crop/flip(/normalise) augmenter: all batch-level, multithreaded inside, and
// GIL-free (called through ctypes, one call per batch). This is host C++, built with g++ by
// data/native.py at first use.
//
// Determinism: augmentation randomness is Philox4x32 keyed by
// (seed, epoch<<40 | record_index), the key layout of data/transforms.py::philox_key,
// so results are the same on every host, across resumes and whatever the threads do.
//
// Built with -DDTP_NO_CODECS where libpng is not installed: the crop/flip and normalise
// entry points are the same, the decode entries still take JPEG and fail every PNG
// payload, and dtp_has_codecs() returns 0 so that the bindings send PNG payloads to the
// codec-free route.

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#ifndef DTP_NO_CODECS
#include <png.h>
#include <csetjmp>
#endif

extern "C" {

// ---------------------------------------------------------------- Philox4x32
// Counter-based RNG (Salmon et al. 2011), 10 rounds. Key = 2x32, ctr = 4x32.
struct Philox {
  uint32_t key[2];
  uint32_t ctr[4];
  uint32_t out[4];
  int have = 0;

  static void round_(uint32_t* c, const uint32_t* k) {
    const uint64_t m0 = 0xD2511F53, m1 = 0xCD9E8D57;
    uint64_t p0 = m0 * c[0], p1 = m1 * c[2];
    uint32_t n0 = (uint32_t)(p1 >> 32) ^ c[1] ^ k[0];
    uint32_t n1 = (uint32_t)p1;
    uint32_t n2 = (uint32_t)(p0 >> 32) ^ c[3] ^ k[1];
    uint32_t n3 = (uint32_t)p0;
    c[0] = n0; c[1] = n1; c[2] = n2; c[3] = n3;
  }

  void init(uint64_t seed, uint64_t stream) {
    key[0] = (uint32_t)seed;
    key[1] = (uint32_t)(seed >> 32);
    ctr[0] = (uint32_t)stream;
    ctr[1] = (uint32_t)(stream >> 32);
    ctr[2] = 0; ctr[3] = 0;
    have = 0;
  }

  uint32_t next() {
    if (!have) {
      uint32_t c[4] = {ctr[0], ctr[1], ctr[2], ctr[3]};
      uint32_t k[2] = {key[0], key[1]};
      const uint32_t w0 = 0x9E3779B9, w1 = 0xBB67AE85;
      for (int r = 0; r < 10; ++r) {
        round_(c, k);
        k[0] += w0; k[1] += w1;
      }
      out[0] = c[0]; out[1] = c[1]; out[2] = c[2]; out[3] = c[3];
      have = 4;
      if (++ctr[2] == 0) ++ctr[3];  // bump counter for the next block
    }
    return out[--have];
  }

  // Uniform in [0, 1).
  double uniform() { return next() * (1.0 / 4294967296.0); }
  // Uniform integer in [0, n).
  uint32_t randint(uint32_t n) { return (uint32_t)(uniform() * n); }
};

// ------------------------------------------------------------------- resize
// Bilinear with half-pixel centers (cv2 INTER_LINEAR convention), RGB u8.
static void bilinear_resize_u8(const uint8_t* src, int sh, int sw,
                               uint8_t* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, (size_t)sh * sw * 3);
    return;
  }
  const double sy = (double)sh / dh, sx = (double)sw / dw;
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int y0 = (int)fy; double wy = fy - y0;
    if (fy < 0) { y0 = 0; wy = 0.0; }
    int y1 = std::min(y0 + 1, sh - 1);
    for (int x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int x0 = (int)fx; double wx = fx - x0;
      if (fx < 0) { x0 = 0; wx = 0.0; }
      int x1 = std::min(x0 + 1, sw - 1);
      const uint8_t* p00 = src + ((size_t)y0 * sw + x0) * 3;
      const uint8_t* p01 = src + ((size_t)y0 * sw + x1) * 3;
      const uint8_t* p10 = src + ((size_t)y1 * sw + x0) * 3;
      const uint8_t* p11 = src + ((size_t)y1 * sw + x1) * 3;
      uint8_t* d = dst + ((size_t)y * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        double v = p00[c] * (1 - wy) * (1 - wx) + p01[c] * (1 - wy) * wx +
                   p10[c] * wy * (1 - wx) + p11[c] * wy * wx;
        d[c] = (uint8_t)(v + 0.5);
      }
    }
  }
}

// Bilinear resize sampling a WINDOW (x0, y0, cw, ch) of the source — the
// crop+resize core of random-resized-crop; optional horizontal mirror of the
// destination. Same half-pixel-center convention as bilinear_resize_u8.
static void bilinear_resize_window_u8(const uint8_t* src, int sh, int sw,
                                      int x0, int y0, int cw, int ch,
                                      uint8_t* dst, int dh, int dw, bool mirror) {
  const double sy = (double)ch / dh, sx = (double)cw / dw;
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int iy0 = (int)fy; double wy = fy - iy0;
    if (fy < 0) { iy0 = 0; wy = 0.0; }
    int iy1 = iy0 + 1 < ch ? iy0 + 1 : ch - 1;
    for (int x = 0; x < dw; ++x) {
      int gx = mirror ? (dw - 1 - x) : x;
      double fx = (gx + 0.5) * sx - 0.5;
      int ix0 = (int)fx; double wx = fx - ix0;
      if (fx < 0) { ix0 = 0; wx = 0.0; }
      int ix1 = ix0 + 1 < cw ? ix0 + 1 : cw - 1;
      const uint8_t* p00 = src + ((size_t)(y0 + iy0) * sw + x0 + ix0) * 3;
      const uint8_t* p01 = src + ((size_t)(y0 + iy0) * sw + x0 + ix1) * 3;
      const uint8_t* p10 = src + ((size_t)(y0 + iy1) * sw + x0 + ix0) * 3;
      const uint8_t* p11 = src + ((size_t)(y0 + iy1) * sw + x0 + ix1) * 3;
      uint8_t* d = dst + ((size_t)y * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        double v = p00[c] * (1 - wy) * (1 - wx) + p01[c] * (1 - wy) * wx +
                   p10[c] * wy * (1 - wx) + p11[c] * wy * wx;
        d[c] = (uint8_t)(v + 0.5);
      }
    }
  }
}

static uint8_t* jpeg_decode_alloc(const uint8_t* data, size_t len, int* h, int* w);

#ifndef DTP_NO_CODECS
// ------------------------------------------------------------------- decode
struct PngMemReader {
  const uint8_t* data;
  size_t len, pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t count) {
  PngMemReader* r = (PngMemReader*)png_get_io_ptr(png);
  if (r->pos + count > r->len) png_error(png, "png: read past end of buffer");
  memcpy(out, r->data + r->pos, count);
  r->pos += count;
}

static uint8_t* decode_png_mem(const uint8_t* data, size_t len, int* h, int* w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  uint8_t* volatile buf = nullptr;
  png_bytep* volatile rows = nullptr;
  PngMemReader reader{data, len, 0};
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(buf);
    free(rows);
    return nullptr;
  }
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);
  buf = (uint8_t*)malloc((size_t)(*w) * (*h) * 3);
  rows = (png_bytep*)malloc((size_t)(*h) * sizeof(png_bytep));
  for (int y = 0; y < *h; ++y) rows[y] = buf + (size_t)y * (*w) * 3;
  png_read_image(png, rows);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);
  return buf;
}

int dtp_has_codecs() { return 1; }
#else
int dtp_has_codecs() { return 0; }
#endif  // DTP_NO_CODECS

// A JPEG goes to the library's own decoder in both builds; a PNG to libpng where it is
// linked (the caller decodes it otherwise).
static uint8_t* decode_bytes(const uint8_t* data, size_t len, int* h, int* w) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) return jpeg_decode_alloc(data, len, h, w);
#ifndef DTP_NO_CODECS
  if (len >= 8 && png_sig_cmp(const_cast<png_bytep>(data), 0, 8) == 0)
    return decode_png_mem(data, len, h, w);
#endif
  return nullptr;
}

// File path: slurp and delegate, so there is exactly ONE decoder per format
// (the mem/file paths previously duplicated the setjmp/transform logic).
static uint8_t* decode_file(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  rewind(f);
  if (size <= 0) { fclose(f); return nullptr; }
  uint8_t* data = (uint8_t*)malloc((size_t)size);
  if (!data) { fclose(f); return nullptr; }
  size_t got = fread(data, 1, (size_t)size, f);
  fclose(f);
  uint8_t* out = (got == (size_t)size) ? decode_bytes(data, got, h, w) : nullptr;
  free(data);
  return out;
}

// ------------------------------------------------------------------ helpers
static void run_parallel(int64_t n, int threads, void (*fn)(int64_t, void*), void* arg) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i, arg);
    return;
  }
  std::vector<std::thread> pool;
  std::atomic<int64_t>* next = new std::atomic<int64_t>(0);
  int t = (int)std::min<int64_t>(threads, n);
  for (int i = 0; i < t; ++i) {
    pool.emplace_back([=] {
      for (;;) {
        int64_t j = next->fetch_add(1);
        if (j >= n) break;
        fn(j, arg);
      }
    });
  }
  for (auto& th : pool) th.join();
  delete next;
}

// ------------------------------------------------------------------- public

// Decode + resize + normalize a batch of image files.
//   paths:  n file paths
//   out:    [n, out_h, out_w, 3] float32
//   mean/stdv: per-channel (RGB), applied as (px/255 - mean) / stdv
// Returns 0 on success, or (1 + index) of the first file that failed.
struct DecodeArgs {
  const char* const* paths;
  int out_h, out_w;
  const float* mean;
  const float* stdv;
  float* out;
  std::atomic<int64_t>* failed;
};

// img (h x w RGB) -> resized + normalized floats at out slot i.
static void resize_normalize_into(const uint8_t* img, int h, int w, int out_h,
                                  int out_w, const float* mean,
                                  const float* stdv, float* out, int64_t i) {
  std::vector<uint8_t> resized((size_t)out_h * out_w * 3);
  bilinear_resize_u8(img, h, w, resized.data(), out_h, out_w);
  float* dst = out + (size_t)i * out_h * out_w * 3;
  const size_t npx = (size_t)out_h * out_w;
  for (size_t px = 0; px < npx; ++px)
    for (int c = 0; c < 3; ++c)
      dst[px * 3 + c] = (resized[px * 3 + c] / 255.0f - mean[c]) / stdv[c];
}

static void decode_one(int64_t i, void* p) {
  DecodeArgs* a = (DecodeArgs*)p;
  int h = 0, w = 0;
  uint8_t* img = decode_file(a->paths[i], &h, &w);
  if (!img) {
    int64_t expect = -1;
    a->failed->compare_exchange_strong(expect, i);
    return;
  }
  resize_normalize_into(img, h, w, a->out_h, a->out_w, a->mean, a->stdv, a->out, i);
  free(img);
}

int64_t dtp_decode_resize_normalize(const char* const* paths, int64_t n,
                                    int out_h, int out_w, const float* mean,
                                    const float* stdv, float* out, int threads) {
  std::atomic<int64_t> failed(-1);
  DecodeArgs a{paths, out_h, out_w, mean, stdv, out, &failed};
  run_parallel(n, threads, decode_one, &a);
  return failed.load() >= 0 ? failed.load() + 1 : 0;
}

// Same batch kernel over in-memory payloads (record-file shards): per-record
// pointers + lengths (zero-copy from the caller's buffers, same shape as the
// path-based entry).
struct DecodeBytesArgs {
  const uint8_t* const* bufs;
  const int64_t* lengths;
  int out_h, out_w;
  const float* mean;
  const float* stdv;
  float* out;
  std::atomic<int64_t>* failed;
};

static void decode_bytes_one(int64_t i, void* p) {
  DecodeBytesArgs* a = (DecodeBytesArgs*)p;
  int h = 0, w = 0;
  uint8_t* img = decode_bytes(a->bufs[i], (size_t)a->lengths[i], &h, &w);
  if (!img) {
    int64_t expect = -1;
    a->failed->compare_exchange_strong(expect, i);
    return;
  }
  resize_normalize_into(img, h, w, a->out_h, a->out_w, a->mean, a->stdv, a->out, i);
  free(img);
}

int64_t dtp_decode_resize_normalize_bytes(
    const uint8_t* const* bufs, const int64_t* lengths, int64_t n, int out_h,
    int out_w, const float* mean, const float* stdv, float* out, int threads) {
  std::atomic<int64_t> failed(-1);
  DecodeBytesArgs a{bufs, lengths, out_h, out_w, mean, stdv, out, &failed};
  run_parallel(n, threads, decode_bytes_one, &a);
  return failed.load() >= 0 ? failed.load() + 1 : 0;
}

// Decode + resize only, uint8 out — the ship-uint8 TRAIN path over record
// payloads: decode -> resize stays uint8, augmentation stays uint8
// (dtp_augment_crop_flip_u8), normalization runs on device
// (models.InputNormalizer fuses it into the first conv). The float decode
// entries above keep host-side normalize for val/eval pipelines.
struct DecodeU8Args {
  const uint8_t* const* bufs;
  const int64_t* lengths;
  int out_h, out_w;
  uint8_t* out;
  std::atomic<int64_t>* failed;
};

static void decode_u8_one(int64_t i, void* p) {
  DecodeU8Args* a = (DecodeU8Args*)p;
  int h = 0, w = 0;
  uint8_t* img = decode_bytes(a->bufs[i], (size_t)a->lengths[i], &h, &w);
  if (!img) {
    int64_t expect = -1;
    a->failed->compare_exchange_strong(expect, i);
    return;
  }
  bilinear_resize_u8(img, h, w,
                     a->out + (size_t)i * a->out_h * a->out_w * 3,
                     a->out_h, a->out_w);
  free(img);
}

int64_t dtp_decode_resize_u8_bytes(const uint8_t* const* bufs,
                                   const int64_t* lengths, int64_t n,
                                   int out_h, int out_w, uint8_t* out,
                                   int threads) {
  std::atomic<int64_t> failed(-1);
  DecodeU8Args a{bufs, lengths, out_h, out_w, out, &failed};
  run_parallel(n, threads, decode_u8_one, &a);
  return failed.load() >= 0 ? failed.load() + 1 : 0;
}

// Decode + RANDOM-RESIZED-CROP + optional hflip, uint8 out — the ImageNet
// train augmentation: 10 attempts sampling an area fraction in
// [scale_lo, scale_hi] and a log-uniform aspect ratio in [ratio_lo,
// ratio_hi], center-SQUARE fallback — matching this repo's
// transforms.random_resized_crop (torchvision instead clamps the fallback
// crop to the ratio bounds; the distributions differ only on extreme-aspect
// images that exhaust all 10 attempts). Fused with the decode so the
// full-size image never leaves this call. Philox keyed (seed,
// epoch<<40 | index[i]) like every other augmenter here.
struct DecodeRrcArgs {
  const uint8_t* const* bufs;
  const int64_t* lengths;
  int out_h, out_w;
  uint64_t seed, epoch;
  const int64_t* indices;
  int hflip;
  float scale_lo, scale_hi, ratio_lo, ratio_hi;
  uint8_t* out;
  std::atomic<int64_t>* failed;
};

// The random-resized-crop + flip of one decoded h x w image into dst (out_h x out_w):
// shared by the fused decode entry and the codec-free entry below, so both draw the same
// window and flip for the same (seed, epoch, index).
static void rrc_flip_into(const uint8_t* img, int h, int w, uint64_t seed, uint64_t epoch,
                          int64_t index, int hflip, float scale_lo, float scale_hi,
                          float ratio_lo, float ratio_hi, uint8_t* dst, int out_h, int out_w) {
  Philox rng;
  rng.init(seed, (epoch << 40) | (uint64_t)index);
  const double area = (double)h * w;
  const double log_rlo = std::log((double)ratio_lo);
  const double log_rhi = std::log((double)ratio_hi);
  int x0 = 0, y0 = 0, cw = w, ch = h;
  bool found = false;
  for (int att = 0; att < 10 && !found; ++att) {
    double target = area * (scale_lo + rng.uniform() * (scale_hi - scale_lo));
    double r = std::exp(log_rlo + rng.uniform() * (log_rhi - log_rlo));
    int tw = (int)std::lround(std::sqrt(target * r));
    int th = (int)std::lround(std::sqrt(target / r));
    if (tw > 0 && tw <= w && th > 0 && th <= h) {
      y0 = (int)rng.randint((uint32_t)(h - th + 1));
      x0 = (int)rng.randint((uint32_t)(w - tw + 1));
      cw = tw; ch = th;
      found = true;
    }
  }
  if (!found) {  // center-square fallback (transforms.random_resized_crop)
    int side = h < w ? h : w;
    y0 = (h - side) / 2; x0 = (w - side) / 2;
    cw = side; ch = side;
  }
  bool flip = hflip && rng.uniform() < 0.5;
  bilinear_resize_window_u8(img, h, w, x0, y0, cw, ch, dst, out_h, out_w, flip);
}

static void decode_rrc_one(int64_t i, void* p) {
  DecodeRrcArgs* a = (DecodeRrcArgs*)p;
  int h = 0, w = 0;
  uint8_t* img = decode_bytes(a->bufs[i], (size_t)a->lengths[i], &h, &w);
  if (!img) {
    int64_t expect = -1;
    a->failed->compare_exchange_strong(expect, i);
    return;
  }
  rrc_flip_into(img, h, w, a->seed, a->epoch, a->indices[i], a->hflip, a->scale_lo,
                a->scale_hi, a->ratio_lo, a->ratio_hi,
                a->out + (size_t)i * a->out_h * a->out_w * 3, a->out_h, a->out_w);
  free(img);
}

int64_t dtp_decode_rrc_flip_u8_bytes(
    const uint8_t* const* bufs, const int64_t* lengths, int64_t n, int out_h,
    int out_w, uint64_t seed, uint64_t epoch, const int64_t* indices,
    int hflip, float scale_lo, float scale_hi, float ratio_lo, float ratio_hi,
    uint8_t* out, int threads) {
  std::atomic<int64_t> failed(-1);
  DecodeRrcArgs a{bufs, lengths, out_h, out_w, seed, epoch, indices, hflip,
                  scale_lo, scale_hi, ratio_lo, ratio_hi, out, &failed};
  run_parallel(n, threads, decode_rrc_one, &a);
  return failed.load() >= 0 ? failed.load() + 1 : 0;
}

// Codec-free counterparts of the two uint8 decode entries above, for images the caller
// decoded (a build with -DDTP_NO_CODECS decodes nothing itself: the port decodes PNG
// payloads with zlib and dtp_png_unfilter). imgs[i] is an h[i] x w[i] RGB image; out is
// [n, out_h, out_w, 3]. Each returns 0, or 1 + the index of an image with no pixels.
// The same resize and the same random-resized-crop as the fused entries, so a payload
// gives the same bytes through either route.
struct PixelsArgs {
  const uint8_t* const* imgs;
  const int64_t* heights;
  const int64_t* widths;
  int out_h, out_w;
  uint64_t seed, epoch;
  const int64_t* indices;
  int hflip;
  float scale_lo, scale_hi, ratio_lo, ratio_hi;
  uint8_t* out;
  std::atomic<int64_t>* failed;
};

static bool pixels_ok(const PixelsArgs* a, int64_t i) {
  if (a->heights[i] > 0 && a->widths[i] > 0) return true;
  int64_t expect = -1;
  a->failed->compare_exchange_strong(expect, i);
  return false;
}

static void resize_pixels_one(int64_t i, void* p) {
  PixelsArgs* a = (PixelsArgs*)p;
  if (!pixels_ok(a, i)) return;
  bilinear_resize_u8(a->imgs[i], (int)a->heights[i], (int)a->widths[i],
                     a->out + (size_t)i * a->out_h * a->out_w * 3, a->out_h, a->out_w);
}

int64_t dtp_resize_u8_batch(const uint8_t* const* imgs, const int64_t* heights,
                            const int64_t* widths, int64_t n, int out_h, int out_w,
                            uint8_t* out, int threads) {
  std::atomic<int64_t> failed(-1);
  PixelsArgs a{imgs, heights, widths, out_h, out_w, 0, 0, nullptr, 0, 0, 0, 0, 0, out, &failed};
  run_parallel(n, threads, resize_pixels_one, &a);
  return failed.load() >= 0 ? failed.load() + 1 : 0;
}

static void rrc_pixels_one(int64_t i, void* p) {
  PixelsArgs* a = (PixelsArgs*)p;
  if (!pixels_ok(a, i)) return;
  rrc_flip_into(a->imgs[i], (int)a->heights[i], (int)a->widths[i], a->seed, a->epoch,
                a->indices[i], a->hflip, a->scale_lo, a->scale_hi, a->ratio_lo, a->ratio_hi,
                a->out + (size_t)i * a->out_h * a->out_w * 3, a->out_h, a->out_w);
}

int64_t dtp_rrc_flip_u8_batch(const uint8_t* const* imgs, const int64_t* heights,
                              const int64_t* widths, int64_t n, int out_h, int out_w,
                              uint64_t seed, uint64_t epoch, const int64_t* indices, int hflip,
                              float scale_lo, float scale_hi, float ratio_lo, float ratio_hi,
                              uint8_t* out, int threads) {
  std::atomic<int64_t> failed(-1);
  PixelsArgs a{imgs, heights, widths, out_h, out_w, seed, epoch, indices, hflip,
               scale_lo, scale_hi, ratio_lo, ratio_hi, out, &failed};
  run_parallel(n, threads, rrc_pixels_one, &a);
  return failed.load() >= 0 ? failed.load() + 1 : 0;
}

// Deterministic CIFAR-style augmentation over an in-memory uint8 batch:
// reflect-pad by `pad`, random crop back to (h, w), optional horizontal
// flip (p=0.5), normalize. Randomness keyed by (seed, epoch<<40 | index[i]).
struct AugArgs {
  const uint8_t* in;
  int h, w, pad;
  uint64_t seed, epoch;
  const int64_t* indices;
  const float* mean;
  const float* stdv;
  int hflip;
  float* out;
};

static void augment_one(int64_t i, void* p) {
  AugArgs* a = (AugArgs*)p;
  const int h = a->h, w = a->w, pad = a->pad;
  Philox rng;
  rng.init(a->seed, (a->epoch << 40) | (uint64_t)a->indices[i]);
  int dy = pad ? (int)rng.randint(2 * pad + 1) : 0;
  int dx = pad ? (int)rng.randint(2 * pad + 1) : 0;
  bool flip = a->hflip && rng.uniform() < 0.5;
  const uint8_t* src = a->in + (size_t)i * h * w * 3;
  float* dst = a->out + (size_t)i * h * w * 3;
  for (int y = 0; y < h; ++y) {
    // Reflect-pad source row index (numpy 'reflect': no edge duplication).
    int sy = y + dy - pad;
    if (sy < 0) sy = -sy;
    if (sy >= h) sy = 2 * h - 2 - sy;
    for (int x = 0; x < w; ++x) {
      int gx = flip ? (w - 1 - x) : x;
      int sx = gx + dx - pad;
      if (sx < 0) sx = -sx;
      if (sx >= w) sx = 2 * w - 2 - sx;
      const uint8_t* s = src + ((size_t)sy * w + sx) * 3;
      float* d = dst + ((size_t)y * w + x) * 3;
      for (int c = 0; c < 3; ++c)
        d[c] = (s[c] / 255.0f - a->mean[c]) / a->stdv[c];
    }
  }
}

int64_t dtp_augment_crop_flip(const uint8_t* in, int64_t n, int h, int w,
                              int pad, uint64_t seed, uint64_t epoch,
                              const int64_t* indices, const float* mean,
                              const float* stdv, int hflip, float* out,
                              int threads) {
  AugArgs a{in, h, w, pad, seed, epoch, indices, mean, stdv, hflip, out};
  run_parallel(n, threads, augment_one, &a);
  return 0;
}

// uint8-out augment: same crop/flip (same Philox stream), no normalize —
// for pipelines that ship uint8 over the host->device link (4x fewer bytes)
// and normalize on-device, where XLA fuses it into the first conv.
struct AugU8Args {
  const uint8_t* in;
  int h, w, pad;
  uint64_t seed, epoch;
  const int64_t* indices;
  int hflip;
  uint8_t* out;
};

static void augment_one_u8(int64_t i, void* p) {
  AugU8Args* a = (AugU8Args*)p;
  const int h = a->h, w = a->w, pad = a->pad;
  Philox rng;
  rng.init(a->seed, (a->epoch << 40) | (uint64_t)a->indices[i]);
  int dy = pad ? (int)rng.randint(2 * pad + 1) : 0;
  int dx = pad ? (int)rng.randint(2 * pad + 1) : 0;
  bool flip = a->hflip && rng.uniform() < 0.5;
  const uint8_t* src = a->in + (size_t)i * h * w * 3;
  uint8_t* dst = a->out + (size_t)i * h * w * 3;
  for (int y = 0; y < h; ++y) {
    int sy = y + dy - pad;
    if (sy < 0) sy = -sy;
    if (sy >= h) sy = 2 * h - 2 - sy;
    for (int x = 0; x < w; ++x) {
      int gx = flip ? (w - 1 - x) : x;
      int sx = gx + dx - pad;
      if (sx < 0) sx = -sx;
      if (sx >= w) sx = 2 * w - 2 - sx;
      std::memcpy(dst + ((size_t)y * w + x) * 3,
                  src + ((size_t)sy * w + sx) * 3, 3);
    }
  }
}

int64_t dtp_augment_crop_flip_u8(const uint8_t* in, int64_t n, int h, int w,
                                 int pad, uint64_t seed, uint64_t epoch,
                                 const int64_t* indices, int hflip,
                                 uint8_t* out, int threads) {
  AugU8Args a{in, h, w, pad, seed, epoch, indices, hflip, out};
  run_parallel(n, threads, augment_one_u8, &a);
  return 0;
}

// Normalize-only batch (uint8 NHWC -> float32), the val-path hot loop.
struct NormArgs {
  const uint8_t* in;
  int h, w;
  const float* mean;
  const float* stdv;
  float* out;
};

static void normalize_one(int64_t i, void* p) {
  NormArgs* a = (NormArgs*)p;
  const size_t npx = (size_t)a->h * a->w;
  const uint8_t* src = a->in + (size_t)i * npx * 3;
  float* dst = a->out + (size_t)i * npx * 3;
  for (size_t px = 0; px < npx; ++px)
    for (int c = 0; c < 3; ++c)
      dst[px * 3 + c] = (src[px * 3 + c] / 255.0f - a->mean[c]) / a->stdv[c];
}

int64_t dtp_normalize(const uint8_t* in, int64_t n, int h, int w,
                      const float* mean, const float* stdv, float* out,
                      int threads) {
  NormArgs a{in, h, w, mean, stdv, out};
  run_parallel(n, threads, normalize_one, &a);
  return 0;
}

// Resize + normalise one decoded uint8 RGB image (decoded by the caller: the folder
// sources' PNG and BMP records), with the decode entries' resize and normalisation, so
// such records come out as a decoded JPEG/PNG payload does.
int64_t dtp_resize_normalize_u8(const uint8_t* in, int h, int w, int out_h, int out_w,
                                const float* mean, const float* stdv, float* out) {
  if (h <= 0 || w <= 0 || out_h <= 0 || out_w <= 0) return 1;
  resize_normalize_into(in, h, w, out_h, out_w, mean, stdv, out, 0);
  return 0;
}

// ------------------------------------------------- per-image codec-free ops
// Five per-image entry points that need no library, so the card's machine (no OpenCV,
// no libjpeg/libpng: built with -DDTP_NO_CODECS) has them too. uint8 HWC in, uint8 out;
// each returns 0, or a nonzero code for arguments it does not take. Each reproduces the
// integer (or float) arithmetic of the OpenCV / libjpeg-turbo call the JAX package makes,
// so the results are bit-equal to it (tests/test_torch_folder_transforms.py).

// OpenCV's borderInterpolate for BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba).
static int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

// PNG: reverse the scanline filters of a non-interlaced IDAT stream (already inflated,
// h rows of one filter byte and ceil(w * channels * depth / 8) bytes) and convert to RGB
// as cv2.imread(path, IMREAD_COLOR)[..., ::-1] does: gray and gray+alpha replicated
// (1/2/4-bit gray scaled to 0..255), palette expanded (an index past the palette is black,
// as libpng's zero-filled palette gives), alpha dropped, 16-bit samples' high byte kept.
// Returns 0, 1 for an unsupported type/depth, 2 for a short stream, 3 for a bad filter.
static int png_channels(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

int64_t dtp_png_unfilter(const uint8_t* raw, int64_t raw_len, int height, int width,
                         int depth, int color, const uint8_t* palette, int palette_entries,
                         uint8_t* out) {
  const int ch = png_channels(color);
  bool ok_depth = (depth == 8) || (depth == 16 && color != 3) ||
                  ((depth == 1 || depth == 2 || depth == 4) && (color == 0 || color == 3));
  if (!ch || !ok_depth || height <= 0 || width <= 0) return 1;
  const int64_t rowbytes = ((int64_t)width * ch * depth + 7) / 8;
  if (raw_len < (int64_t)height * (rowbytes + 1)) return 2;
  const int bpp = std::max(1, ch * depth / 8);
  std::vector<uint8_t> prev((size_t)rowbytes, 0), cur((size_t)rowbytes);
  uint8_t pal[256 * 3] = {0};
  if (color == 3) std::memcpy(pal, palette, (size_t)std::min(palette_entries, 256) * 3);
  const int gray_scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw + (int64_t)y * (rowbytes + 1);
    const int f = src[0];
    ++src;
    for (int64_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
      int v;
      switch (f) {
        case 0: v = src[i]; break;
        case 1: v = src[i] + a; break;
        case 2: v = src[i] + b; break;
        case 3: v = src[i] + ((a + b) >> 1); break;
        case 4: v = src[i] + paeth(a, b, c); break;
        default: return 3;
      }
      cur[i] = (uint8_t)v;
    }
    uint8_t* dst = out + (int64_t)y * width * 3;
    for (int x = 0; x < width; ++x) {
      int s[4];
      for (int k = 0; k < ch; ++k) {
        const int64_t idx = (int64_t)x * ch + k;
        if (depth == 16) {
          s[k] = cur[idx * 2];
        } else if (depth == 8) {
          s[k] = cur[idx];
        } else {
          const int64_t bit = idx * depth;
          s[k] = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
        }
      }
      if (color == 3) {
        std::memcpy(dst + x * 3, pal + s[0] * 3, 3);
      } else if (ch <= 2) {
        const uint8_t g = (uint8_t)(s[0] * gray_scale);
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = g;
      } else {
        dst[x * 3] = (uint8_t)s[0];
        dst[x * 3 + 1] = (uint8_t)s[1];
        dst[x * 3 + 2] = (uint8_t)s[2];
      }
    }
    std::swap(prev, cur);
  }
  return 0;
}

// cv2.blur(img, (k, k)): BORDER_REFLECT_101, integer window sums, and sum / k^2 rounded
// to nearest (k^2 is odd, so there are no ties). Odd k >= 1.
int64_t dtp_box_blur_u8(const uint8_t* in, int height, int width, int channels, int k,
                        uint8_t* out) {
  if (k < 1 || !(k & 1) || height <= 0 || width <= 0 || channels <= 0) return 1;
  const int r = k / 2, d = k * k;
  std::vector<int> xmap((size_t)width + 2 * r), rows((size_t)height * width * channels);
  for (int i = -r; i < width + r; ++i) xmap[i + r] = reflect101(i, width);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      for (int c = 0; c < channels; ++c) {
        int s = 0;
        for (int j = 0; j < k; ++j) s += in[((size_t)y * width + xmap[x + j]) * channels + c];
        rows[((size_t)y * width + x) * channels + c] = s;
      }
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      for (int c = 0; c < channels; ++c) {
        int s = 0;
        for (int j = -r; j <= r; ++j)
          s += rows[((size_t)reflect101(y + j, height) * width + x) * channels + c];
        out[((size_t)y * width + x) * channels + c] = (uint8_t)((2 * s + d) / (2 * d));
      }
  return 0;
}

// cv2.medianBlur(img, k): the median of each channel over the k x k window,
// BORDER_REPLICATE. k in {3, 5} (OpenCV's 8-bit sorting-network sizes). A 256-bin
// histogram slides along each row (Huang's method): a step moves one column out and one
// in, and the median moves from the last one.
int64_t dtp_median_blur_u8(const uint8_t* in, int height, int width, int channels, int k,
                           uint8_t* out) {
  if ((k != 3 && k != 5) || height <= 0 || width <= 0 || channels <= 0) return 1;
  const int r = k / 2, half = k * k / 2;
  auto at = [&](int y, int x, int c) {
    return in[((size_t)y * width + std::min(std::max(x, 0), width - 1)) * channels + c];
  };
  for (int y = 0; y < height; ++y) {
    int rows[5];
    for (int j = 0; j < k; ++j) rows[j] = std::min(std::max(y + j - r, 0), height - 1);
    for (int c = 0; c < channels; ++c) {
      int hist[256] = {0};
      for (int j = 0; j < k; ++j)
        for (int dx = -r; dx <= r; ++dx) ++hist[at(rows[j], dx, c)];
      int med = 0, below = 0;  // below: how many window values are < med
      for (int x = 0; x < width; ++x) {
        if (x > 0)
          for (int j = 0; j < k; ++j) {
            const int gone = at(rows[j], x - r - 1, c), come = at(rows[j], x + r, c);
            --hist[gone];
            below -= gone < med;
            ++hist[come];
            below += come < med;
          }
        while (below > half) below -= hist[--med];
        while (below + hist[med] <= half) below += hist[med++];
        out[((size_t)y * width + x) * channels + c] = (uint8_t)med;
      }
    }
  }
  return 0;
}

// ---- CLAHE over LAB: cv2.cvtColor(RGB2LAB) -> createCLAHE(clip, (t, t)).apply(L) ->
// cvtColor(LAB2RGB), with OpenCV's 8-bit fixed-point colour conversions (its tables, built
// as OpenCV builds them in float/double) and its CLAHE (clip, redistribution, float LUT
// and bilinear interpolation between tile centres).
struct LabTables {
  uint16_t gamma[256];     // sRGB -> linear, x 255 * 8
  uint16_t cbrt[3072];     // f(t) of CIE LAB, x 2^15
  uint16_t inv_gamma[4096];  // linear -> sRGB, 0..255
  int y_of_l[256], fy_of_l[256];
  int c_fwd[9], c_inv[9];
  LabTables() {
    const float lthresh = 216.f / 24389.f, lscale = 841.f / 108.f, lbias = 16.f / 116.f;
    const float cb_scale = 1.f / 2040.f, third = 1.f / 3.f;
    for (int i = 0; i < 3072; ++i) {
      const float x = cb_scale * (float)i;
      const float f = x < lthresh ? std::fma(x, lscale, lbias)
                                  : (float)std::pow((double)x, (double)third);
      cbrt[i] = (uint16_t)std::lrint(32768.f * f);
    }
    for (int i = 0; i < 256; ++i) {
      const double x = (double)((float)i / 255.f);
      const double g = x <= 809.0 / 20000.0 ? x / (323.0 / 25.0)
                                            : std::pow((x + 11.0 / 200.0) / (1.0 + 11.0 / 200.0), 12.0 / 5.0);
      gamma[i] = (uint16_t)std::lrint(2040.f * (float)g);
    }
    for (int i = 0; i < 4096; ++i) {
      const double x = (double)((1.f / 4096.f) * (float)i);
      const double g = x <= 7827.0 / 2500000.0 ? x * (323.0 / 25.0)
                                               : std::pow(x, 1.0 / (12.0 / 5.0)) * (1.0 + 11.0 / 200.0) - 11.0 / 200.0;
      inv_gamma[i] = (uint16_t)std::lrint(255.f * (float)g);
    }
    const int base = 1 << 14;
    for (int i = 0; i < 256; ++i) {
      if (i <= 20) {
        y_of_l[i] = (int)std::lrint((float)(i * base * 20 * 9) / (float)(17 * 29 * 29 * 29));
        fy_of_l[i] = (int)std::lrint((float)base * (16.f / 116.f + (float)(i * 5) / (float)(3 * 17 * 29)));
      } else {
        const float fy = (float)(i * 100 * base) / (float)(255 * 116) + (float)(16 * base) / 116.f;
        fy_of_l[i] = (int)std::lrint(fy);
        y_of_l[i] = (int)std::lrint(fy * fy * fy / (float)(base * base));
      }
    }
    static const double rgb2xyz[9] = {0.412453, 0.357580, 0.180423, 0.212671, 0.715160,
                                      0.072169, 0.019334, 0.119193, 0.950227};
    static const double xyz2rgb[9] = {3.240479, -1.53715, -0.498535, -0.969256, 1.875991,
                                      0.041556, 0.055648, -0.204043, 1.057311};
    static const double d65[3] = {0.950456, 1.0, 1.088754};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        c_fwd[i * 3 + j] = (int)std::lrint(4096.0 * rgb2xyz[i * 3 + j] / d65[i]);
        c_inv[i * 3 + j] = (int)std::lrint(4096.0 * xyz2rgb[i * 3 + j] * d65[j]);
      }
  }
  // OpenCV's abToXZ_b: f^-1 of an a/b-shifted f(Y), on the 2^14 scale.
  static int ab_to_xz(int i) {
    const int base = 1 << 14;
    return i <= 3390 ? i * 108 / 841 - base * 16 / 116 * 108 / 841 : i * i / base * i / base;
  }
};

static const LabTables& lab_tables() {
  static const LabTables t;  // built once, thread-safe (C++11 static init)
  return t;
}

static inline int descale(int64_t x, int n) { return (int)((x + ((int64_t)1 << (n - 1))) >> n); }
static inline uint8_t sat_u8(int v) { return (uint8_t)std::min(std::max(v, 0), 255); }

int64_t dtp_clahe_u8(const uint8_t* in, int height, int width, double clip_limit, int tiles,
                     uint8_t* out) {
  if (height <= 0 || width <= 0 || tiles <= 0) return 1;
  const LabTables& T = lab_tables();
  const size_t npx = (size_t)height * width;
  std::vector<uint8_t> L(npx), A(npx), B(npx);
  const int* C = T.c_fwd;
  for (size_t p = 0; p < npx; ++p) {
    const int r = T.gamma[in[p * 3]], g = T.gamma[in[p * 3 + 1]], b = T.gamma[in[p * 3 + 2]];
    const int fx = T.cbrt[descale(r * C[0] + g * C[1] + b * C[2], 12)];
    const int fy = T.cbrt[descale(r * C[3] + g * C[4] + b * C[5], 12)];
    const int fz = T.cbrt[descale(r * C[6] + g * C[7] + b * C[8], 12)];
    L[p] = sat_u8(descale((int64_t)296 * fy - 1336934, 15));
    A[p] = sat_u8(descale((int64_t)500 * (fx - fy) + (128 << 15), 15));
    B[p] = sat_u8(descale((int64_t)200 * (fy - fz) + (128 << 15), 15));
  }
  // CLAHE on L. A size the tiles do not divide is padded (bottom/right) with
  // BORDER_REFLECT_101 by tiles - size % tiles rows and columns, as OpenCV pads it (a full
  // extra tile's worth on the side that did divide).
  const bool divides = width % tiles == 0 && height % tiles == 0;
  const int eh = divides ? height : height + tiles - height % tiles;
  const int ew = divides ? width : width + tiles - width % tiles;
  const int th = eh / tiles, tw = ew / tiles, area = th * tw;
  const float lut_scale = 255.f / (float)area;
  int limit = 0;
  if (clip_limit > 0.0) limit = std::max((int)(clip_limit * area / 256), 1);
  std::vector<uint8_t> lut((size_t)tiles * tiles * 256);
  for (int ty = 0; ty < tiles; ++ty)
    for (int tx = 0; tx < tiles; ++tx) {
      int hist[256] = {0};
      for (int y = ty * th; y < (ty + 1) * th; ++y) {
        const int sy = reflect101(y, height);
        for (int x = tx * tw; x < (tx + 1) * tw; ++x) ++hist[L[(size_t)sy * width + reflect101(x, width)]];
      }
      if (limit > 0) {
        int clipped = 0;
        for (int i = 0; i < 256; ++i)
          if (hist[i] > limit) {
            clipped += hist[i] - limit;
            hist[i] = limit;
          }
        const int batch = clipped / 256;
        int residual = clipped - batch * 256;
        for (int i = 0; i < 256; ++i) hist[i] += batch;
        if (residual) {
          const int step = std::max(256 / residual, 1);
          for (int i = 0; i < 256 && residual > 0; i += step, --residual) ++hist[i];
        }
      }
      uint8_t* tl = &lut[((size_t)ty * tiles + tx) * 256];
      int sum = 0;
      for (int i = 0; i < 256; ++i) {
        sum += hist[i];
        tl[i] = sat_u8((int)std::lrint((float)sum * lut_scale));
      }
    }
  const float inv_tw = 1.f / (float)tw, inv_th = 1.f / (float)th;
  std::vector<int> x1((size_t)width), x2((size_t)width);
  std::vector<float> xa((size_t)width), xa1((size_t)width);
  for (int x = 0; x < width; ++x) {
    const float txf = (float)x * inv_tw - 0.5f;
    const int t1 = (int)std::floor(txf);
    xa[x] = txf - (float)t1;
    xa1[x] = 1.f - xa[x];
    x1[x] = std::max(t1, 0) * 256;
    x2[x] = std::min(t1 + 1, tiles - 1) * 256;
  }
  for (int y = 0; y < height; ++y) {
    const float tyf = (float)y * inv_th - 0.5f;
    const int t1 = (int)std::floor(tyf);
    const float ya = tyf - (float)t1, ya1 = 1.f - ya;
    const uint8_t* p1 = &lut[(size_t)std::max(t1, 0) * tiles * 256];
    const uint8_t* p2 = &lut[(size_t)std::min(t1 + 1, tiles - 1) * tiles * 256];
    for (int x = 0; x < width; ++x) {
      uint8_t& v = L[(size_t)y * width + x];
      const float res = ((float)p1[x1[x] + v] * xa1[x] + (float)p1[x2[x] + v] * xa[x]) * ya1 +
                        ((float)p2[x1[x] + v] * xa1[x] + (float)p2[x2[x] + v] * xa[x]) * ya;
      v = sat_u8((int)std::lrint(res));
    }
  }
  // LAB -> RGB (OpenCV's Lab2RGBinteger).
  const int base = 1 << 14;
  const int* D = T.c_inv;
  for (size_t p = 0; p < npx; ++p) {
    const int y = T.y_of_l[L[p]], ify = T.fy_of_l[L[p]];
    const int adiv = ((5 * A[p] * 53687 + (1 << 7)) >> 13) - 128 * base / 500;
    const int bdiv = ((B[p] * 41943 + (1 << 4)) >> 9) - 128 * base / 200 + 1;
    const int x = LabTables::ab_to_xz(ify + adiv), z = LabTables::ab_to_xz(ify - bdiv);
    for (int c = 0; c < 3; ++c) {
      const int v = descale((int64_t)D[c * 3] * x + (int64_t)D[c * 3 + 1] * y + (int64_t)D[c * 3 + 2] * z, 14);
      out[p * 3 + c] = (uint8_t)T.inv_gamma[std::min(std::max(v, 0), 4095)];
    }
  }
  return 0;
}

// ---- JPEG, with libjpeg-turbo's arithmetic: the round trip, the baseline encoder and the
// decoder share the colour conversions, the h2v2 downsampling, jfdctint and the quantiser,
// jidctint with its range limit, and the upsamplers.
//
// The round trip is what cv2.imdecode(cv2.imencode(".jpg", img, quality)) gives with
// libjpeg-turbo's defaults (baseline, 4:2:0, islow DCT, fancy upsampling), without an
// entropy coder (Huffman coding is lossless): RGB -> YCbCr (jccolor, 16-bit fixed point),
// h2v2 downsampling with the alternating 1,2 bias, edge replication to whole blocks,
// jfdctint, quantisation by libjpeg-turbo's reciprocal multiply (the standard tables at
// jpeg_quality_scaling, clamped to 1..255), dequantisation, jidctint with its range
// limit, h2v2 fancy upsampling (3/4-1/4, biases 8 and 7), and jdcolor's YCbCr -> RGB.
static const int kLumQ[64] = {16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const int kChrQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Zigzag position -> natural (row-major) index, with libjpeg's 16 extra entries of 63 so
// that a corrupt run length past the block's end lands on its last coefficient.
static const uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum : int64_t {
  F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172
};

static inline int64_t dsc(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// jpeg_fdct_islow over one 8x8 block (row pass, then column pass), in place.
static void fdct_islow(int64_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    const int n = pass ? 15 : 11;
    for (int k = 0; k < 8; ++k) {
      int64_t* p = d + k * stride;
      const int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      const int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      const int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
      const int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
      const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      p[0] = pass ? dsc(t10 + t11, 2) : (t10 + t11) * 4;
      p[4 * step] = pass ? dsc(t10 - t11, 2) : (t10 - t11) * 4;
      const int64_t z1e = (t12 + t13) * F0541;
      p[2 * step] = dsc(z1e + t13 * F0765, n);
      p[6 * step] = dsc(z1e - t12 * F1847, n);
      const int64_t z5 = (t4 + t6 + t5 + t7) * F1175;
      const int64_t z1 = -(t4 + t7) * F0899, z2 = -(t5 + t6) * F2562;
      const int64_t z3 = -(t4 + t6) * F1961 + z5, z4 = -(t5 + t7) * F0390 + z5;
      p[7 * step] = dsc(t4 * F0298 + z1 + z3, n);
      p[5 * step] = dsc(t5 * F2053 + z2 + z4, n);
      p[3 * step] = dsc(t6 * F3072 + z2 + z3, n);
      p[step] = dsc(t7 * F1501 + z1 + z4, n);
    }
  }
}

// jpeg_idct_islow over one dequantised 8x8 block (column pass, then row pass), in place;
// the row pass's outputs are samples before the range limit. A column or row whose AC
// terms are all zero takes jidctint's shortcut, which gives the same values.
static void idct_islow(int64_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 1 : 8, stride = pass ? 8 : 1;
    const int n = pass ? 18 : 11;
    for (int k = 0; k < 8; ++k) {
      int64_t* p = d + k * stride;
      if (!(p[step] | p[2 * step] | p[3 * step] | p[4 * step] | p[5 * step] | p[6 * step] | p[7 * step])) {
        const int64_t dc = pass ? dsc(p[0], 5) : p[0] * 4;
        for (int i = 0; i < 8; ++i) p[i * step] = dc;
        continue;
      }
      const int64_t z2 = p[2 * step], z3 = p[6 * step];
      const int64_t z1e = (z2 + z3) * F0541;
      const int64_t tmp2 = z1e - z3 * F1847, tmp3 = z1e + z2 * F0765;
      const int64_t tmp0 = (p[0] + p[4 * step]) * 8192, tmp1 = (p[0] - p[4 * step]) * 8192;
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      int64_t o0 = p[7 * step], o1 = p[5 * step], o2 = p[3 * step], o3 = p[step];
      const int64_t z5 = (o0 + o2 + o1 + o3) * F1175;
      const int64_t z1 = -(o0 + o3) * F0899, zz2 = -(o1 + o2) * F2562;
      const int64_t z3o = -(o0 + o2) * F1961 + z5, z4 = -(o1 + o3) * F0390 + z5;
      o0 = o0 * F0298 + z1 + z3o;
      o1 = o1 * F2053 + zz2 + z4;
      o2 = o2 * F3072 + zz2 + z3o;
      o3 = o3 * F1501 + z1 + z4;
      p[0] = dsc(t10 + o3, n);
      p[7 * step] = dsc(t10 - o3, n);
      p[step] = dsc(t11 + o2, n);
      p[6 * step] = dsc(t11 - o2, n);
      p[2 * step] = dsc(t12 + o1, n);
      p[5 * step] = dsc(t12 - o1, n);
      p[3 * step] = dsc(t13 + o0, n);
      p[4 * step] = dsc(t13 - o0, n);
    }
  }
}

// One block of coefficients (natural order, 16-bit as libjpeg's JCOEF) through
// dequantisation and jidctint into 8 rows of dst. The range limit saturates: OpenCV's
// libjpeg-turbo runs the SIMD islow IDCT, whose signed packs clamp every sample to -128..127
// before the +128 level shift (the C version wraps values 512 or more past the range).
static void idct_block(const int16_t* coef, const uint16_t* qv, uint8_t* dst, size_t stride) {
  int64_t blk[64];
  for (int i = 0; i < 64; ++i) blk[i] = (int64_t)coef[i] * qv[i];
  idct_islow(blk);
  for (int r = 0; r < 8; ++r, dst += stride)
    for (int c = 0; c < 8; ++c) {
      const int64_t v = blk[r * 8 + c] + 128;
      dst[c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
}

// The standard tables scaled to a quality (jpeg_quality_scaling, clamped to 1..255 for
// baseline), and libjpeg-turbo's compute_reciprocal for each islow divisor q * 8.
struct Quantizer {
  int q[64];
  int64_t fq[64], corr[64];
  int shift[64];
  Quantizer(const int* base, int quality) {
    const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
    for (int i = 0; i < 64; ++i) {
      q[i] = std::min(std::max((base[i] * scale + 50) / 100, 1), 255);
      const int64_t div = (int64_t)q[i] * 8;
      int b = 0;
      while ((div >> (b + 1)) != 0) ++b;
      int r = 16 + b;
      int64_t f = ((int64_t)1 << r) / div, fr = ((int64_t)1 << r) % div, c = div / 2;
      if (fr == 0) {
        f >>= 1;
        --r;
      } else if (fr <= div / 2) {
        ++c;
      } else {
        ++f;
      }
      fq[i] = f;
      corr[i] = c;
      shift[i] = r;
    }
  }
  // The 8x8 block of plane at (bx, by) (a multiple of 8) through jfdctint and quantisation.
  void forward(const std::vector<int>& plane, int cols, int bx, int by, int16_t* coef) const {
    int64_t blk[64];
    for (int i = 0; i < 64; ++i) blk[i] = plane[(size_t)(by + i / 8) * cols + bx + i % 8] - 128;
    fdct_islow(blk);
    for (int i = 0; i < 64; ++i) {
      const int64_t a = blk[i] < 0 ? -blk[i] : blk[i];
      const int64_t v = ((a + corr[i]) * fq[i]) >> shift[i];
      coef[i] = (int16_t)(blk[i] < 0 ? -v : v);
    }
  }
};

// The encoder's component planes, as libjpeg's compressor builds them: jccolor's RGB ->
// YCbCr (or the grey samples as they are), h2v2 downsampling for 4:2:0 chroma, the right
// edge replicated to whole blocks and the bottom rows replicated to whole blocks.
struct EncodePlanes {
  int ncomp, maxs;  // maxs: the luma sampling factor (2 for 4:2:0, else 1)
  std::vector<int> plane[3];
  int cols[3], rows[3];  // whole blocks: width_in_blocks * 8, height_in_blocks * 8
  EncodePlanes(const uint8_t* in, int H, int W, int channels, bool sub420) {
    ncomp = channels == 1 ? 1 : 3;
    maxs = (ncomp == 3 && sub420) ? 2 : 1;
    const int yc = (W + 7) / 8 * 8, yr = (H + 7) / 8 * 8;
    const int cc = (W + 8 * maxs - 1) / (8 * maxs) * 8, cr = (H + 8 * maxs - 1) / (8 * maxs) * 8;
    const int fullc = ncomp == 3 ? std::max(yc, maxs * cc) : yc;  // full-resolution columns needed
    cols[0] = yc; rows[0] = yr;
    std::vector<int> full[3];
    for (int k = 0; k < ncomp; ++k) full[k].assign((size_t)H * fullc, 0);
    const int64_t half = 1 << 15, cbcr_off = (int64_t)128 << 16;
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < fullc; ++x) {
        const size_t o = (size_t)y * fullc + x;
        if (ncomp == 1) {
          full[0][o] = in[(size_t)y * W + std::min(x, W - 1)];
          continue;
        }
        const uint8_t* p = in + ((size_t)y * W + std::min(x, W - 1)) * 3;
        const int64_t r = p[0], g = p[1], b = p[2];
        full[0][o] = (int)((19595 * r + 38470 * g + 7471 * b + half) >> 16);
        full[1][o] = (int)((-11059 * r - 21709 * g + 32768 * b + cbcr_off + half - 1) >> 16);
        full[2][o] = (int)((32768 * r - 27439 * g - 5329 * b + cbcr_off + half - 1) >> 16);
      }
    for (int k = 0; k < ncomp; ++k) {
      const bool down = k > 0 && maxs == 2;
      const int c = k == 0 ? yc : (maxs == 2 ? cc : yc), r = k == 0 ? yr : (maxs == 2 ? cr : yr);
      const int valid = down ? (H + 1) / 2 : H;
      cols[k] = c; rows[k] = r;
      std::vector<int>& d = plane[k];
      d.assign((size_t)r * c, 0);
      for (int y = 0; y < valid; ++y) {
        if (!down) {
          for (int x = 0; x < c; ++x) d[(size_t)y * c + x] = full[k][(size_t)y * fullc + x];
          continue;
        }
        const int* r0 = &full[k][(size_t)(2 * y) * fullc];
        const int* r1 = &full[k][(size_t)std::min(2 * y + 1, H - 1) * fullc];
        for (int x = 0; x < c; ++x)
          d[(size_t)y * c + x] = (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + 1 + (x & 1)) >> 2;
      }
      for (int y = valid; y < r; ++y) std::memcpy(&d[(size_t)y * c], &d[(size_t)(valid - 1) * c], sizeof(int) * c);
    }
  }
};

// A decoded component ready for upsampling: dw x dh valid samples (the downsampled size)
// in rows of `stride`, to be stretched hf x vf to the image's size.
struct SamplePlane {
  std::vector<uint8_t> px;
  size_t stride;
  int dw, dh, hf, vf;
};

// One output row of a component, as libjpeg-turbo 3's upsamplers give it: h2v1 and h2v2
// fancy (triangle filters; h2v2 with biases 8 and 7) where the component is more than 2
// samples wide, else replication; h1v2 fancy (biases 1 and 2) at any width; replication for
// every other integral ratio (int_upsample: 4:1:1 and the like). Rows above the top and
// below the bottom repeat the edge rows, as the main controller's context rows do.
static void upsample_row(const SamplePlane& p, int y, int W, int* dst, int* colsum) {
  auto row = [&](int r) { return &p.px[(size_t)std::min(std::max(r, 0), p.dh - 1) * p.stride]; };
  const int hf = p.hf, vf = p.vf, dw = p.dw;
  if (hf == 1 && vf == 1) {
    const uint8_t* s = row(y);
    for (int x = 0; x < W; ++x) dst[x] = s[x];
  } else if (hf == 2 && vf == 1 && dw > 2) {
    const uint8_t* s = row(y);
    dst[0] = s[0];
    for (int i = 0; i < dw; ++i) {
      const int t = 3 * s[i];
      if (i > 0) dst[2 * i] = (t + s[i - 1] + 1) >> 2;
      if (2 * i + 1 < W) dst[2 * i + 1] = (t + s[std::min(i + 1, dw - 1)] + 2) >> 2;
    }
  } else if (hf == 1 && vf == 2) {
    const uint8_t* s = row(y >> 1);
    const uint8_t* t = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
    const int bias = 1 + (y & 1);
    for (int x = 0; x < W; ++x) dst[x] = (3 * s[x] + t[x] + bias) >> 2;
  } else if (hf == 2 && vf == 2 && dw > 2) {
    const uint8_t* s = row(y >> 1);
    const uint8_t* t = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
    for (int i = 0; i < dw; ++i) colsum[i] = 3 * s[i] + t[i];
    for (int i = 0; i < dw; ++i) {
      const int c3 = 3 * colsum[i];
      dst[2 * i] = (c3 + colsum[i > 0 ? i - 1 : 0] + 8) >> 4;
      if (2 * i + 1 < W) dst[2 * i + 1] = (c3 + colsum[i + 1 < dw ? i + 1 : i] + 7) >> 4;
    }
  } else {
    const uint8_t* s = row(y / vf);
    for (int x = 0; x < W; ++x) dst[x] = s[x / hf];
  }
}

enum JpegColor { kGrey = 0, kYCbCr = 1, kRGB = 2 };

// Upsample each component and convert to RGB (jdcolor's fixed-point YCbCr -> RGB; a grey
// image replicated to three channels, as IMREAD_COLOR gives it).
struct YccTables {  // jdcolor's build_ycc_rgb_table
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + half) >> 16);
      cb_b[i] = (int)((116130 * x + half) >> 16);
      cr_g[i] = (int)(-46802 * x);
      cb_g[i] = (int)(-22554 * x + half);
    }
  }
};

static const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

static void planes_to_rgb(const SamplePlane* planes, int ncomp, JpegColor color, int H, int W, uint8_t* out) {
  std::vector<int> rows[3], colsum((size_t)W + 2);
  for (int k = 0; k < ncomp; ++k) rows[k].resize((size_t)W + 1);
  const YccTables& T = ycc_tables();
  for (int y = 0; y < H; ++y) {
    for (int k = 0; k < ncomp; ++k) upsample_row(planes[k], y, W, rows[k].data(), colsum.data());
    uint8_t* o = out + (size_t)y * W * 3;
    const int* r0 = rows[0].data();
    if (color == kGrey) {
      for (int x = 0; x < W; ++x, o += 3) o[0] = o[1] = o[2] = (uint8_t)r0[x];
      continue;
    }
    const int *r1 = rows[1].data(), *r2 = rows[2].data();
    if (color == kRGB) {
      for (int x = 0; x < W; ++x, o += 3) {
        o[0] = (uint8_t)r0[x];
        o[1] = (uint8_t)r1[x];
        o[2] = (uint8_t)r2[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x, o += 3) {
      const int yy = r0[x], cb = r1[x], cr = r2[x];
      o[0] = sat_u8(yy + T.cr_r[cr]);
      o[1] = sat_u8(yy + ((T.cb_g[cb] + T.cr_g[cr]) >> 16));
      o[2] = sat_u8(yy + T.cb_b[cb]);
    }
  }
}

int64_t dtp_jpeg_roundtrip_u8(const uint8_t* in, int height, int width, int quality, uint8_t* out) {
  if (height <= 0 || width <= 0 || quality < 1 || quality > 100) return 1;
  const EncodePlanes enc(in, height, width, 3, true);
  const Quantizer lum(kLumQ, quality), chr(kChrQ, quality);
  SamplePlane planes[3];
  for (int k = 0; k < 3; ++k) {
    const Quantizer& Q = k ? chr : lum;
    uint16_t qv[64];
    for (int i = 0; i < 64; ++i) qv[i] = (uint16_t)Q.q[i];
    SamplePlane& p = planes[k];
    p.stride = (size_t)enc.cols[k];
    p.px.resize(p.stride * enc.rows[k]);
    p.dw = k ? (width + 1) / 2 : width;
    p.dh = k ? (height + 1) / 2 : height;
    p.hf = p.vf = k ? 2 : 1;
    int16_t coef[64];
    for (int by = 0; by < enc.rows[k]; by += 8)
      for (int bx = 0; bx < enc.cols[k]; bx += 8) {
        Q.forward(enc.plane[k], enc.cols[k], bx, by, coef);
        idct_block(coef, qv, &p.px[(size_t)by * p.stride + bx], p.stride);
      }
  }
  planes_to_rgb(planes, 3, kYCbCr, height, width, out);
  return 0;
}

// ---- Huffman tables: the standard ones of Annex K (jstdhuff.c), which the encoder writes
// and the decoder takes for a missing table 0 or 1, as libjpeg-turbo does.
static const uint8_t kBitsDcLum[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kBitsDcChr[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kBitsAcLum[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kValsAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t kBitsAcChr[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kValsAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Canonical codes from a table's BITS (counts of codes of length 1..16): sizes[i] and
// codes[i] for each of the n symbols in order. Returns false for a table whose codes do
// not fit their lengths (libjpeg's JERR_BAD_HUFF_TABLE).
static bool huff_codes(const uint8_t* bits, int* sizes, uint32_t* codes, int* n) {
  int k = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l - 1]; ++i) sizes[k++] = l;
  *n = k;
  uint32_t code = 0;
  int si = k ? sizes[0] : 0;
  for (int p = 0; p < k;) {
    while (p < k && sizes[p] == si) codes[p++] = code++;
    if (code > (1u << si)) return false;
    code <<= 1;
    ++si;
  }
  return true;
}

// ---- the baseline encoder: the counterpart of cv2.imencode(".jpg") with libjpeg-turbo's
// defaults (JFIF, the standard tables at a quality, Annex K Huffman tables, islow DCT),
// for writing test data where there is no OpenCV. 4:2:0 or 4:4:4 from RGB, or grey.
struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;
  int bits = 0;
  bool overflow = false;
  void byte(uint8_t b) {
    if (n < cap) out[n] = b; else overflow = true;
    ++n;
  }
  void put(uint32_t code, int len) {
    if (!len) return;
    acc = (acc << len) | (code & ((1u << len) - 1));
    bits += len;
    while (bits >= 8) {
      const uint8_t b = (uint8_t)(acc >> (bits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      bits -= 8;
    }
  }
  void flush() {  // pad the last byte with 1 bits
    if (bits) put(0x7F, 8 - bits);
    acc = 0;
    bits = 0;
  }
  void marker(uint8_t m, const std::vector<uint8_t>& body) {
    byte(0xFF);
    byte(m);
    byte((uint8_t)((body.size() + 2) >> 8));
    byte((uint8_t)(body.size() + 2));
    for (uint8_t b : body) byte(b);
  }
};

struct EncTable {
  uint32_t code[256];
  int size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    int sizes[256], n = 0;
    uint32_t codes[256];
    huff_codes(bits, sizes, codes, &n);
    std::memset(size, 0, sizeof(size));
    for (int i = 0; i < n; ++i) {
      code[vals[i]] = codes[i];
      size[vals[i]] = sizes[i];
    }
  }
};

static int bit_length(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

static void encode_block(BitWriter& bw, const int16_t* coef, int* last_dc, const EncTable& dc, const EncTable& ac) {
  int diff = coef[0] - *last_dc;
  *last_dc = coef[0];
  int mag = diff < 0 ? -diff : diff, nb = bit_length(mag);
  bw.put(dc.code[nb], dc.size[nb]);
  bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = coef[kNatural[k]];
    if (!v) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) bw.put(ac.code[0xF0], ac.size[0xF0]);
    mag = v < 0 ? -v : v;
    nb = bit_length(mag);
    const int sym = (run << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v), nb);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

// in: height x width x channels (1: grey, 3: RGB) uint8; subsampling 420 or 444 (RGB only);
// restart_interval in MCUs (0: none). Writes the file into out (capacity bytes) and
// returns its length; -1 for arguments it does not take, -2 when capacity is too small.
int64_t dtp_jpeg_encode_u8(const uint8_t* in, int height, int width, int channels, int quality, int subsampling,
                           int restart_interval, uint8_t* out, int64_t capacity) {
  if (height <= 0 || width <= 0 || height > 65500 || width > 65500 || quality < 1 || quality > 100 ||
      (channels != 1 && channels != 3) || (subsampling != 420 && subsampling != 444) || restart_interval < 0 ||
      restart_interval > 65535)
    return -1;
  const EncodePlanes enc(in, height, width, channels, subsampling == 420);
  const int nc = enc.ncomp, ms = enc.maxs;
  const Quantizer lum(kLumQ, quality), chr(kChrQ, quality);
  const EncTable dcl(kBitsDcLum, kValsDc), acl(kBitsAcLum, kValsAcLum);
  const EncTable dcc(kBitsDcChr, kValsDc), acc_(kBitsAcChr, kValsAcChr);
  BitWriter bw{out, capacity};
  bw.byte(0xFF);
  bw.byte(0xD8);
  bw.marker(0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
    std::vector<uint8_t> body{(uint8_t)t};
    for (int i = 0; i < 64; ++i) body.push_back((uint8_t)(t ? chr : lum).q[kNatural[i]]);
    bw.marker(0xDB, body);
  }
  std::vector<uint8_t> sof{8, (uint8_t)(height >> 8), (uint8_t)height, (uint8_t)(width >> 8), (uint8_t)width,
                           (uint8_t)nc};
  for (int k = 0; k < nc; ++k) {
    const int s = k ? 1 : ms;
    sof.insert(sof.end(), {(uint8_t)(k + 1), (uint8_t)(s << 4 | s), (uint8_t)(k ? 1 : 0)});
  }
  bw.marker(0xC0, sof);
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t)
    for (int ac = 0; ac < 2; ++ac) {
      const uint8_t* bits = ac ? (t ? kBitsAcChr : kBitsAcLum) : (t ? kBitsDcChr : kBitsDcLum);
      const uint8_t* vals = ac ? (t ? kValsAcChr : kValsAcLum) : kValsDc;
      std::vector<uint8_t> body{(uint8_t)(ac << 4 | t)};
      int n = 0;
      for (int i = 0; i < 16; ++i) {
        body.push_back(bits[i]);
        n += bits[i];
      }
      body.insert(body.end(), vals, vals + n);
      bw.marker(0xC4, body);
    }
  if (restart_interval) bw.marker(0xDD, {(uint8_t)(restart_interval >> 8), (uint8_t)restart_interval});
  std::vector<uint8_t> sos{(uint8_t)nc};
  for (int k = 0; k < nc; ++k) sos.insert(sos.end(), {(uint8_t)(k + 1), (uint8_t)(k ? 0x11 : 0x00)});
  sos.insert(sos.end(), {0, 63, 0});
  bw.marker(0xDA, sos);
  // One MCU: ms x ms luma blocks (1 x 1 without subsampling) and one block of each chroma.
  // libjpeg's dummy blocks past the right edge repeat the DC of the block before them; a
  // row of them past the bottom repeats the DC of the last block above.
  const int mcu_px = 8 * ms;
  const int mcus_x = nc == 1 ? enc.cols[0] / 8 : (width + mcu_px - 1) / mcu_px;
  const int mcus_y = nc == 1 ? enc.rows[0] / 8 : (height + mcu_px - 1) / mcu_px;
  int last_dc[3] = {0, 0, 0}, rst = 0;
  int16_t blocks[4][64];
  for (int64_t m = 0; m < (int64_t)mcus_x * mcus_y; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      bw.flush();
      bw.byte(0xFF);
      bw.byte((uint8_t)(0xD0 + rst));
      rst = (rst + 1) & 7;
      last_dc[0] = last_dc[1] = last_dc[2] = 0;
    }
    const int mx = (int)(m % mcus_x), my = (int)(m / mcus_x);
    for (int k = 0; k < nc; ++k) {
      const int s = (k == 0 && nc == 3) ? ms : 1;
      const Quantizer& Q = k ? chr : lum;
      const int bw_blocks = enc.cols[k] / 8, bh_blocks = enc.rows[k] / 8;
      for (int yi = 0; yi < s; ++yi)
        for (int xi = 0; xi < s; ++xi) {
          int16_t* b = blocks[yi * s + xi];
          const int bx = mx * s + xi, by = my * s + yi;
          if (by >= bh_blocks) {
            std::memset(b, 0, sizeof(blocks[0]));
            b[0] = blocks[yi * s - 1][0];
          } else if (bx >= bw_blocks) {
            std::memset(b, 0, sizeof(blocks[0]));
            b[0] = blocks[yi * s + xi - 1][0];
          } else {
            Q.forward(enc.plane[k], enc.cols[k], bx * 8, by * 8, b);
          }
        }
      for (int i = 0; i < s * s; ++i) encode_block(bw, blocks[i], &last_dc[k], k ? dcc : dcl, k ? acc_ : acl);
    }
  }
  bw.flush();
  bw.byte(0xFF);
  bw.byte(0xD9);
  return bw.overflow ? -2 : bw.n;
}

// ---- the decoder: baseline, extended sequential (8-bit) and progressive Huffman JPEG, as
// libjpeg-turbo decodes them (jdmarker, jdhuff, jdphuff, jdcoefct, jidctint, jdsample,
// jdcolor) for cv2.imdecode(..., IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION): RGB out. The
// whole image's coefficients are kept, the scans fill them, and the back end runs once.
// Everything it does not decode, and every file that is cut or corrupt, is refused with one
// of these codes (data/native.py names them).
enum JpegError {
  kJpegNotJpeg = 1, kJpegTruncated, kJpegBadMarker, kJpegArithmetic, kJpegLossless, kJpegHierarchical,
  kJpegPrecision, kJpegComponents, kJpegDnl, kJpegTooLarge, kJpegSampling, kJpegHuffTable, kJpegQuantTable,
  kJpegCorruptData, kJpegRestart, kJpegProgression, kJpegIncomplete, kJpegNoImage, kJpegCmyk
};

struct JpegFail {
  int code;
};

[[noreturn]] static void jfail(int code) { throw JpegFail{code}; }

struct DecTable {
  bool defined = false;
  uint8_t bits[16], vals[256];
  int nvals = 0;
  uint8_t fast_len[512], fast_sym[512];  // codes of up to 9 bits by their first 9 bits
  int32_t maxcode[18], valoffset[18];
  void build() {
    int sizes[256], n = 0;
    uint32_t codes[256];
    if (!huff_codes(bits, sizes, codes, &n)) jfail(kJpegHuffTable);
    std::memset(fast_len, 0, sizeof(fast_len));
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valoffset[l] = p - (int32_t)codes[p];
        p += bits[l - 1];
        maxcode[l] = (int32_t)codes[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < n; ++i)
      if (sizes[i] <= 9)
        for (uint32_t c = codes[i] << (9 - sizes[i]), e = (codes[i] + 1) << (9 - sizes[i]); c < e; ++c) {
          fast_len[c] = (uint8_t)sizes[i];
          fast_sym[c] = vals[i];
        }
    defined = true;
  }
  void standard(bool ac, int index) {
    std::memcpy(bits, ac ? (index ? kBitsAcChr : kBitsAcLum) : (index ? kBitsDcChr : kBitsDcLum), 16);
    nvals = ac ? 162 : 12;
    std::memcpy(vals, ac ? (index ? kValsAcChr : kValsAcLum) : kValsDc, (size_t)nvals);
    build();
  }
};

struct JpegComp {
  int id, h, v, tq;
  int bw, bh;    // blocks that hold image samples (width_in_blocks, height_in_blocks)
  int bwp, bhp;  // blocks stored: whole MCUs of an interleaved scan
  int dw, dh;    // downsampled size in samples
  std::vector<int16_t> coef;
  uint16_t qv[64];
  bool latched = false, scanned = false;
  int coef_bits[64];
  int pred = 0, dc_tbl = 0, ac_tbl = 0;
};

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  // Parses up to the frame header: the image's height and width.
  void header(int* h, int* w) {
    start();
    for (;;) {
      const int m = next_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
        read_sof(m, false);
        *h = H_;
        *w = W_;
        return;
      }
      if (m == 0xDA || m == 0xD9) jfail(kJpegNoImage);
      if (!other_marker(m)) jfail(kJpegBadMarker);
    }
  }

  // Decodes the whole file into out (H x W x 3 RGB).
  void decode(uint8_t* out) {
    start();
    for (;;) {
      const int m = next_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
        read_sof(m, true);
      } else if (m == 0xDA) {
        read_sos();
      } else if (m == 0xD9) {
        break;
      } else if (!other_marker(m)) {
        jfail(kJpegBadMarker);
      }
    }
    if (!frame_ || !scans_) jfail(kJpegNoImage);
    finish(out);
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int H_ = 0, W_ = 0, ncomp_ = 0, maxh_ = 1, maxv_ = 1, mcux_ = 0, mcuy_ = 0;
  bool frame_ = false, progressive_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1, restart_interval_ = 0, scans_ = 0;
  bool sequential_done_ = false;
  JpegComp comp_[3];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  DecTable dc_[4], ac_[4];
  // the entropy-coded segment's bit reader
  uint64_t acc_ = 0;
  int nbits_ = 0, pad_ = 0;
  bool stop_ = false;
  int eobrun_ = 0;

  void start() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) jfail(kJpegNotJpeg);
    pos_ = 2;
  }

  int byte_at(size_t p) const {
    if (p >= n_) jfail(kJpegTruncated);
    return d_[p];
  }

  // jdmarker's next_marker: bytes before a marker are skipped (libjpeg warns of them and
  // reads on), fill 0xFF bytes swallowed.
  int next_marker() {
    for (;;) {
      while (byte_at(pos_) != 0xFF) ++pos_;
      int c;
      do c = byte_at(++pos_);
      while (c == 0xFF);
      ++pos_;
      if (c != 0) return c;
    }
  }

  // A marker segment's body: [pos_, pos_ + length - 2) after its length; advances past it.
  size_t segment(size_t* len) {
    const int length = byte_at(pos_) << 8 | byte_at(pos_ + 1);
    if (length < 2) jfail(kJpegBadMarker);
    const size_t body = pos_ + 2;
    if (body + (size_t)(length - 2) > n_) jfail(kJpegTruncated);
    *len = (size_t)length - 2;
    pos_ = body + *len;
    return body;
  }

  // The markers other than SOF, SOS and EOI; false for one that ends or breaks the header.
  bool other_marker(int m) {
    size_t len, b;
    if (m == 0xC4) {
      b = segment(&len);
      read_dht(b, len);
    } else if (m == 0xDB) {
      b = segment(&len);
      read_dqt(b, len);
    } else if (m == 0xDD) {
      b = segment(&len);
      if (len != 2) jfail(kJpegBadMarker);
      restart_interval_ = d_[b] << 8 | d_[b + 1];
    } else if (m == 0xE0) {
      b = segment(&len);
      if (len >= 14 && !std::memcmp(d_ + b, "JFIF\0", 5)) jfif_ = true;
    } else if (m == 0xEE) {
      b = segment(&len);
      if (len >= 12 && !std::memcmp(d_ + b, "Adobe", 5)) {
        adobe_ = true;
        adobe_transform_ = d_[b + 11];
      }
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xCC) {
      segment(&len);  // APPn, COM, DAC
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // RSTn or TEM outside a scan: no body, ignored as libjpeg ignores them
    } else if (m == 0xDC) {
      jfail(kJpegDnl);
    } else if (m == 0xDE || m == 0xDF) {
      jfail(kJpegHierarchical);
    } else if (m == 0xD8) {
      jfail(kJpegBadMarker);
    } else {
      return false;
    }
    return true;
  }

  void read_dqt(size_t b, size_t len) {
    const size_t end = b + len;
    while (b < end) {
      const int pq = d_[b] >> 4, tq = d_[b] & 15;
      ++b;
      if (pq > 1 || tq > 3) jfail(kJpegQuantTable);
      if (b + (size_t)64 * (pq + 1) > end) jfail(kJpegBadMarker);
      for (int i = 0; i < 64; ++i) {
        qt_[tq][kNatural[i]] = (uint16_t)(pq ? d_[b] << 8 | d_[b + 1] : d_[b]);
        b += pq + 1;
      }
      qt_defined_[tq] = true;
    }
  }

  void read_dht(size_t b, size_t len) {
    const size_t end = b + len;
    while (b < end) {
      if (b + 17 > end) jfail(kJpegBadMarker);
      const int tc = d_[b] >> 4, th = d_[b] & 15;
      if (tc > 1 || th > 3) jfail(kJpegHuffTable);
      DecTable& t = tc ? ac_[th] : dc_[th];
      int count = 0;
      for (int i = 0; i < 16; ++i) count += t.bits[i] = d_[b + 1 + i];
      b += 17;
      if (count > 256 || b + (size_t)count > end) jfail(kJpegHuffTable);
      std::memcpy(t.vals, d_ + b, (size_t)count);
      t.nvals = count;
      b += count;
      t.build();
    }
  }

  void read_sof(int m, bool decoding) {
    if (m == 0xC3) jfail(kJpegLossless);
    if (m == 0xC5 || m == 0xC6 || m == 0xC7) jfail(kJpegHierarchical);
    if (m >= 0xC9) jfail(kJpegArithmetic);
    if (m == 0xC8) jfail(kJpegBadMarker);
    if (frame_) jfail(kJpegBadMarker);
    size_t len;
    const size_t b = segment(&len);
    if (len < 6) jfail(kJpegBadMarker);
    if (d_[b] != 8) jfail(kJpegPrecision);
    H_ = d_[b + 1] << 8 | d_[b + 2];
    W_ = d_[b + 3] << 8 | d_[b + 4];
    ncomp_ = d_[b + 5];
    if (H_ == 0) jfail(kJpegDnl);
    if (W_ == 0 || ncomp_ == 0) jfail(kJpegNoImage);
    if (len != (size_t)(6 + 3 * ncomp_)) jfail(kJpegBadMarker);
    if (ncomp_ == 4) jfail(kJpegCmyk);
    if (ncomp_ != 1 && ncomp_ != 3) jfail(kJpegComponents);
    // OpenCV's CV_IO_MAX_IMAGE_PIXELS, refused before anything is allocated.
    if ((int64_t)H_ * W_ > ((int64_t)1 << 30) || H_ > 65500 || W_ > 65500) jfail(kJpegTooLarge);
    progressive_ = m == 0xC2;
    for (int k = 0; k < ncomp_; ++k) {
      JpegComp& c = comp_[k];
      c.id = d_[b + 6 + 3 * k];
      c.h = d_[b + 7 + 3 * k] >> 4;
      c.v = d_[b + 7 + 3 * k] & 15;
      c.tq = d_[b + 8 + 3 * k];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) jfail(kJpegSampling);
      if (c.tq > 3) jfail(kJpegQuantTable);
      maxh_ = std::max(maxh_, c.h);
      maxv_ = std::max(maxv_, c.v);
    }
    mcux_ = (W_ + 8 * maxh_ - 1) / (8 * maxh_);
    mcuy_ = (H_ + 8 * maxv_ - 1) / (8 * maxv_);
    for (int k = 0; k < ncomp_; ++k) {
      JpegComp& c = comp_[k];
      if (maxh_ % c.h || maxv_ % c.v) jfail(kJpegSampling);  // a fractional ratio
      c.dw = (int)(((int64_t)W_ * c.h + maxh_ - 1) / maxh_);
      c.dh = (int)(((int64_t)H_ * c.v + maxv_ - 1) / maxv_);
      c.bw = (int)(((int64_t)W_ * c.h + 8 * maxh_ - 1) / (8 * maxh_));
      c.bh = (int)(((int64_t)H_ * c.v + 8 * maxv_ - 1) / (8 * maxv_));
      c.bwp = mcux_ * c.h;
      c.bhp = mcuy_ * c.v;
      for (int i = 0; i < 64; ++i) c.coef_bits[i] = -1;
      if (decoding) c.coef.assign((size_t)c.bwp * c.bhp * 64, 0);
    }
    frame_ = true;
  }

  // ---- bits of the entropy-coded segment
  void fill() {
    while (nbits_ <= 56) {
      int b = 0;
      if (!stop_) {
        if (pos_ >= n_) {
          stop_ = true;
        } else if (d_[pos_] != 0xFF) {
          b = d_[pos_++];
        } else {
          size_t p = pos_ + 1;
          while (p < n_ && d_[p] == 0xFF) ++p;
          if (p < n_ && d_[p] == 0) {
            b = 0xFF;
            pos_ = p + 1;
          } else {
            stop_ = true;  // a marker (or the end of the data): pos_ stays on its 0xFF
          }
        }
      }
      if (stop_) pad_ += 8;  // zero bits past the segment, as libjpeg inserts them
      acc_ = acc_ << 8 | (uint64_t)b;
      nbits_ += 8;
    }
  }

  void consume(int k) {
    nbits_ -= k;
    if (nbits_ < pad_) jfail(pos_ >= n_ ? kJpegTruncated : kJpegCorruptData);  // it read past the segment
  }

  int get_bits(int k) {
    if (!k) return 0;
    if (nbits_ < 32) fill();
    const int v = (int)((acc_ >> (nbits_ - k)) & ((1u << k) - 1));
    consume(k);
    return v;
  }

  static int extend(int v, int s) { return s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  int decode_huff(const DecTable& t) {
    if (nbits_ < 32) fill();
    const int look = (int)((acc_ >> (nbits_ - 9)) & 511);
    if (t.fast_len[look]) {
      consume(t.fast_len[look]);
      return t.fast_sym[look];
    }
    const int32_t code16 = (int32_t)((acc_ >> (nbits_ - 16)) & 0xFFFF);
    for (int l = 10; l <= 16; ++l) {
      const int32_t c = code16 >> (16 - l);
      if (c <= t.maxcode[l]) {
        consume(l);
        const int i = c + t.valoffset[l];
        if (i < 0 || i >= t.nvals) jfail(kJpegCorruptData);
        return t.vals[i];
      }
    }
    jfail(kJpegCorruptData);  // no code of 16 bits or fewer (libjpeg's JWRN_HUFF_BAD_CODE)
  }

  void reset_bits() {
    acc_ = 0;
    nbits_ = pad_ = 0;
    stop_ = false;
  }

  // ---- a scan
  void read_sos() {
    if (!frame_) jfail(kJpegBadMarker);
    if (!progressive_ && sequential_done_) jfail(kJpegBadMarker);  // libjpeg: JERR_EOI_EXPECTED
    size_t len;
    const size_t b = segment(&len);
    if (len < 1) jfail(kJpegBadMarker);
    const int ns = d_[b];
    if (ns < 1 || ns > 4 || len != (size_t)(4 + 2 * ns)) jfail(kJpegBadMarker);
    JpegComp* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = d_[b + 1 + 2 * i];
      sc[i] = nullptr;
      for (int k = 0; k < ncomp_; ++k)
        if (comp_[k].id == id) sc[i] = &comp_[k];
      if (!sc[i]) jfail(kJpegBadMarker);
      for (int j = 0; j < i; ++j)
        if (sc[j] == sc[i]) jfail(kJpegBadMarker);
      sc[i]->dc_tbl = d_[b + 2 + 2 * i] >> 4;
      sc[i]->ac_tbl = d_[b + 2 + 2 * i] & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) jfail(kJpegHuffTable);
    }
    const int ss = d_[b + 1 + 2 * ns], se = d_[b + 2 + 2 * ns];
    const int ah = d_[b + 3 + 2 * ns] >> 4, al = d_[b + 3 + 2 * ns] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) jfail(kJpegSampling);
    }
    if (!progressive_) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) jfail(kJpegProgression);
    } else {
      // jdphuff's start_pass checks, the warnings among them made errors.
      const bool dc = ss == 0;
      if (dc ? se != 0 : (ss > se || se > 63 || ns != 1)) jfail(kJpegProgression);
      if ((ah != 0 && al != ah - 1) || al > 13) jfail(kJpegProgression);
      for (int i = 0; i < ns; ++i) {
        int* cb = sc[i]->coef_bits;
        if (!dc && cb[0] < 0) jfail(kJpegProgression);
        for (int k = ss; k <= se; ++k) {
          if (ah != (cb[k] < 0 ? 0 : cb[k])) jfail(kJpegProgression);
          cb[k] = al;
        }
      }
    }
    for (int i = 0; i < ns; ++i) {
      JpegComp& c = *sc[i];
      if (!c.latched) {  // libjpeg latches a component's table at its first scan
        if (!qt_defined_[c.tq]) jfail(kJpegQuantTable);
        std::memcpy(c.qv, qt_[c.tq], sizeof(c.qv));
        c.latched = true;
      }
      const bool need_dc = !progressive_ || (ss == 0 && ah == 0), need_ac = !progressive_ || ss > 0;
      if (need_dc) table(dc_, c.dc_tbl, false);
      if (need_ac) table(ac_, c.ac_tbl, true);
      c.scanned = true;
      c.pred = 0;
    }
    ++scans_;
    if (!progressive_) {
      bool all = true;
      for (int k = 0; k < ncomp_; ++k) all = all && comp_[k].scanned;
      sequential_done_ = all;
    }
    decode_scan(sc, ns, ss, se, ah, al);
  }

  void table(DecTable* tables, int index, bool ac) {
    DecTable& t = tables[index];
    if (!t.defined) {
      if (index > 1) jfail(kJpegHuffTable);
      t.standard(ac, index);
    }
    if (!ac)
      for (int i = 0; i < t.nvals; ++i)
        if (t.vals[i] > 15) jfail(kJpegHuffTable);
  }

  void decode_scan(JpegComp** sc, int ns, int ss, int se, int ah, int al) {
    reset_bits();
    eobrun_ = 0;
    const int mx = ns == 1 ? sc[0]->bw : mcux_, my = ns == 1 ? sc[0]->bh : mcuy_;
    int restarts_to_go = restart_interval_, next_rst = 0;
    for (int64_t m = 0; m < (int64_t)mx * my; ++m) {
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          eobrun_ = 0;
          restarts_to_go = restart_interval_;
        }
        --restarts_to_go;
      }
      const int x = (int)(m % mx), y = (int)(m / mx);
      for (int i = 0; i < ns; ++i) {
        JpegComp& c = *sc[i];
        const int bh = ns == 1 ? 1 : c.v, bwid = ns == 1 ? 1 : c.h;
        for (int yi = 0; yi < bh; ++yi)
          for (int xi = 0; xi < bwid; ++xi) {
            const int bx = x * bwid + xi, by = y * bh + yi;
            int16_t* blk = &c.coef[((size_t)by * c.bwp + bx) * 64];
            if (!progressive_) {
              block_sequential(c, blk);
            } else if (ss == 0) {
              if (ah == 0) {
                const int s = decode_huff(dc_[c.dc_tbl]);
                c.pred += extend(get_bits(s), s);
                blk[0] = (int16_t)(int)((unsigned)c.pred << al);
              } else if (get_bits(1)) {
                blk[0] = (int16_t)(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              block_ac_first(c, blk, ss, se, al);
            } else {
              block_ac_refine(c, blk, ss, se, al);
            }
          }
      }
    }
    // The scan's data ends here: the next marker follows, after any bytes libjpeg skips.
    reset_bits();
  }

  // jdhuff's process_restart: the bits left are dropped and the next marker must be the
  // expected RSTn (libjpeg resynchronises on another one; this decoder refuses the file).
  void restart(int expected) {
    reset_bits();
    if (next_marker() != 0xD0 + expected) jfail(kJpegRestart);
  }

  void block_sequential(JpegComp& c, int16_t* blk) {
    const int s = decode_huff(dc_[c.dc_tbl]);
    c.pred += extend(get_bits(s), s);
    blk[0] = (int16_t)c.pred;
    const DecTable& t = ac_[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_huff(t), r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(get_bits(sz), sz);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_ac_first(JpegComp& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const DecTable& t = ac_[c.ac_tbl];
    for (int k = ss; k <= se; ++k) {
      const int rs = decode_huff(t);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(get_bits(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        --eobrun_;
        break;
      }
    }
  }

  // jdphuff's decode_mcu_AC_refine: new coefficients of magnitude 1 << al, and a
  // correction bit for each coefficient already nonzero that the run passes over.
  void block_ac_refine(JpegComp& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
    const DecTable& t = ac_[c.ac_tbl];
    auto correct = [&](int16_t& coef) {
      if (get_bits(1) && (coef & p1) == 0) coef = (int16_t)(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; ++k) {
        const int rs = decode_huff(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) jfail(kJpegCorruptData);
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun_;
    }
  }

  // ---- the back end
  void finish(uint8_t* out) {
    for (int k = 0; k < ncomp_; ++k) {
      const JpegComp& c = comp_[k];
      if (!c.scanned) jfail(kJpegIncomplete);
      // A progressive file whose first ten coefficients are not all known to full precision
      // gets libjpeg's block smoothing (jdcoefct.c); this decoder refuses it.
      if (progressive_)
        for (int i = 0; i < 10; ++i)
          if (c.coef_bits[kNatural[i]] != 0) jfail(kJpegIncomplete);
    }
    JpegColor color = kYCbCr;
    if (ncomp_ == 1) {
      color = kGrey;
    } else if (!jfif_ && adobe_) {
      color = adobe_transform_ == 0 ? kRGB : kYCbCr;
    } else if (!jfif_ && comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B') {
      color = kRGB;
    }
    SamplePlane planes[3];
    for (int k = 0; k < ncomp_; ++k) {
      const JpegComp& c = comp_[k];
      SamplePlane& p = planes[k];
      p.stride = (size_t)c.bw * 8;
      p.px.resize(p.stride * c.bh * 8);
      p.dw = c.dw;
      p.dh = c.dh;
      p.hf = maxh_ / c.h;
      p.vf = maxv_ / c.v;
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_block(&c.coef[((size_t)by * c.bwp + bx) * 64], c.qv, &p.px[(size_t)by * 8 * p.stride + bx * 8],
                     p.stride);
    }
    planes_to_rgb(planes, ncomp_, color, H_, W_, out);
  }
};

// Header query: the image's height and width into hw[0], hw[1]. Returns 0 or a JpegError.
int64_t dtp_jpeg_header(const uint8_t* data, int64_t len, int64_t* hw) {
  try {
    JpegDecoder dec(data, (size_t)len);
    int h = 0, w = 0;
    dec.header(&h, &w);
    hw[0] = h;
    hw[1] = w;
    return 0;
  } catch (const JpegFail& e) {
    return e.code;
  }
}

// Decodes a JPEG of height x width (from dtp_jpeg_header) into out, RGB HWC uint8.
// Returns 0 or a JpegError.
int64_t dtp_jpeg_decode_u8(const uint8_t* data, int64_t len, int height, int width, uint8_t* out) {
  try {
    JpegDecoder dec(data, (size_t)len);
    int h = 0, w = 0;
    dec.header(&h, &w);
    if (h != height || w != width) return kJpegBadMarker;
    JpegDecoder full(data, (size_t)len);
    full.decode(out);
    return 0;
  } catch (const JpegFail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kJpegTooLarge;
  }
}

static uint8_t* jpeg_decode_alloc(const uint8_t* data, size_t len, int* h, int* w) {
  try {
    JpegDecoder dec(data, len);
    dec.header(h, w);
    uint8_t* buf = (uint8_t*)malloc((size_t)(*h) * (*w) * 3);
    if (!buf) return nullptr;
    try {
      JpegDecoder full(data, len);
      full.decode(buf);
    } catch (...) {
      free(buf);
      throw;
    }
    return buf;
  } catch (...) {
    return nullptr;
  }
}

int dtp_version() { return 3; }

}  // extern "C"
