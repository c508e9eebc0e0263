// Host data runtime of the PyTorch/CUDA port: the port's own copy of the JAX package's
// csrc/dtp_native.cpp, with the same seven extern "C" entry points and the same results,
// and the codec-free entry points the port adds.
//
// JPEG/PNG decode (libjpeg/libpng), OpenCV-compatible bilinear resize (half-pixel
// centres), normalisation, and a deterministic crop/flip(/normalise) augmenter: all
// batch-level, multithreaded inside, and GIL-free (called through ctypes, one call per
// batch). This is host C++, built with g++ by data/native.py at first use.
//
// Determinism: augmentation randomness is Philox4x32 keyed by
// (seed, epoch<<40 | record_index), the key layout of data/transforms.py::philox_key,
// so results are the same on every host, across resumes and whatever the threads do.
//
// Built with -DDTP_NO_CODECS where libjpeg/libpng are not installed: the crop/flip and
// normalise entry points are the same, decoding fails every payload, and
// dtp_has_codecs() returns 0 so that the bindings refuse the decode calls.

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
#include <jpeglib.h>
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

#ifndef DTP_NO_CODECS
// ------------------------------------------------------------------- decode
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = (JpegErr*)cinfo->err;
  longjmp(err->jb, 1);
}

// ---- in-memory decoders (file path slurps and delegates) ------------------

static uint8_t* decode_jpeg_mem(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  uint8_t* volatile buf = nullptr;  // setjmp liveness, see decode_jpeg
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  buf = (uint8_t*)malloc((size_t)(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return buf;
}

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

static uint8_t* decode_bytes(const uint8_t* data, size_t len, int* h, int* w) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg_mem(data, len, h, w);
  if (len >= 8 && png_sig_cmp(const_cast<png_bytep>(data), 0, 8) == 0)
    return decode_png_mem(data, len, h, w);
  return nullptr;
}

int dtp_has_codecs() { return 1; }
#else
static uint8_t* decode_bytes(const uint8_t*, size_t, int*, int*) { return nullptr; }

int dtp_has_codecs() { return 0; }
#endif  // DTP_NO_CODECS

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

// ---- JPEG round trip: what cv2.imdecode(cv2.imencode(".jpg", img, quality)) gives with
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
      p[0] = pass ? dsc(t10 + t11, 2) : (t10 + t11) << 2;
      p[4 * step] = pass ? dsc(t10 - t11, 2) : (t10 - t11) << 2;
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
// the row pass's outputs are samples before the range limit.
static void idct_islow(int64_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 1 : 8, stride = pass ? 8 : 1;
    const int n = pass ? 18 : 11;
    for (int k = 0; k < 8; ++k) {
      int64_t* p = d + k * stride;
      const int64_t z2 = p[2 * step], z3 = p[6 * step];
      const int64_t z1e = (z2 + z3) * F0541;
      const int64_t tmp2 = z1e - z3 * F1847, tmp3 = z1e + z2 * F0765;
      const int64_t tmp0 = (p[0] + p[4 * step]) << 13, tmp1 = (p[0] - p[4 * step]) << 13;
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

// One plane (rows x cols, multiples of 8) through DCT, quantisation and back, in place.
static void jpeg_plane(std::vector<int>& plane, int rows, int cols, const int* base, int quality) {
  const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  int q[64];
  int64_t fq[64], corr[64];
  int shift[64];
  for (int i = 0; i < 64; ++i) {
    q[i] = std::min(std::max((base[i] * scale + 50) / 100, 1), 255);
    // libjpeg-turbo's compute_reciprocal for the islow divisor q * 8 (16-bit DCTELEM).
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
  int64_t blk[64];
  for (int by = 0; by < rows; by += 8)
    for (int bx = 0; bx < cols; bx += 8) {
      for (int i = 0; i < 64; ++i) blk[i] = plane[(size_t)(by + i / 8) * cols + bx + i % 8] - 128;
      fdct_islow(blk);
      for (int i = 0; i < 64; ++i) {
        const int64_t a = blk[i] < 0 ? -blk[i] : blk[i];
        const int64_t v = ((a + corr[i]) * fq[i]) >> shift[i];
        blk[i] = (blk[i] < 0 ? -v : v) * q[i];
      }
      idct_islow(blk);
      for (int i = 0; i < 64; ++i) {
        const int64_t x10 = ((blk[i] + 512) & 1023) - 512;  // RANGE_MASK wrap, then clamp
        plane[(size_t)(by + i / 8) * cols + bx + i % 8] = (int)std::min<int64_t>(std::max<int64_t>(x10 + 128, 0), 255);
      }
    }
}

int64_t dtp_jpeg_roundtrip_u8(const uint8_t* in, int height, int width, int quality, uint8_t* out) {
  if (height <= 0 || width <= 0 || quality < 1 || quality > 100) return 1;
  const int H = height, W = width;
  const int64_t FIXY[3] = {19595, 38470, 7471};  // FIX(0.299), FIX(0.587), FIX(0.114)
  const int64_t half = 1 << 15, cbcr_off = (int64_t)128 << 16;
  // Luma plane, right/bottom edges replicated to whole 8x8 blocks.
  const int yr = (H + 7) / 8 * 8, yc = (W + 7) / 8 * 8;
  // Chroma: ceil(H/2) x ceil(W/2) samples, blocks cover ceil(W/16)*8 columns and
  // ceil(H/16)*8 rows.
  const int ch = (H + 1) / 2, cw = (W + 1) / 2;
  const int cc = (W + 15) / 16 * 8, cr = (H + 15) / 16 * 8;
  std::vector<int> Y((size_t)yr * yc), Cb((size_t)H * 2 * cc), Cr((size_t)H * 2 * cc);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < 2 * cc; ++x) {
      const uint8_t* p = in + ((size_t)y * W + std::min(x, W - 1)) * 3;
      const int64_t r = p[0], g = p[1], b = p[2];
      if (x < yc) Y[(size_t)y * yc + x] = (int)((FIXY[0] * r + FIXY[1] * g + FIXY[2] * b + half) >> 16);
      Cb[(size_t)y * 2 * cc + x] = (int)((-11059 * r - 21709 * g + 32768 * b + cbcr_off + half - 1) >> 16);
      Cr[(size_t)y * 2 * cc + x] = (int)((32768 * r - 27439 * g - 5329 * b + cbcr_off + half - 1) >> 16);
    }
  for (int y = H; y < yr; ++y) std::memcpy(&Y[(size_t)y * yc], &Y[(size_t)(H - 1) * yc], sizeof(int) * yc);
  std::vector<int> planes[2];
  for (int k = 0; k < 2; ++k) {
    const std::vector<int>& full = k ? Cr : Cb;
    std::vector<int>& d = planes[k];
    d.assign((size_t)cr * cc, 0);
    for (int y = 0; y < ch; ++y) {
      const int* r0 = &full[(size_t)(2 * y) * 2 * cc];
      const int* r1 = &full[(size_t)std::min(2 * y + 1, H - 1) * 2 * cc];
      for (int x = 0; x < cc; ++x)
        d[(size_t)y * cc + x] = (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + 1 + (x & 1)) >> 2;
    }
    for (int y = ch; y < cr; ++y) std::memcpy(&d[(size_t)y * cc], &d[(size_t)(ch - 1) * cc], sizeof(int) * cc);
    jpeg_plane(d, cr, cc, kChrQ, quality);
  }
  jpeg_plane(Y, yr, yc, kLumQ, quality);
  // Fancy upsampling: each output sample is 3/4 the nearer chroma sample and 1/4 the
  // next nearer in each direction, edges replicated; libjpeg-turbo replicates each sample
  // 2x2 instead where the chroma rows are 2 samples wide or less. Then YCbCr -> RGB.
  const bool fancy = cw > 2;
  std::vector<int> up[2];
  for (int k = 0; k < 2; ++k) {
    const std::vector<int>& d = planes[k];
    up[k].assign((size_t)2 * ch * 2 * cw, 0);
    for (int y = 0; y < ch; ++y)
      for (int v = 0; v < 2; ++v) {
        const int ny = std::min(std::max(v ? y + 1 : y - 1, 0), ch - 1);
        int* o = &up[k][(size_t)(2 * y + v) * 2 * cw];
        auto colsum = [&](int x) {
          x = std::min(std::max(x, 0), cw - 1);
          return d[(size_t)y * cc + x] * 3 + d[(size_t)ny * cc + x];
        };
        for (int x = 0; x < cw; ++x) {
          if (!fancy) {
            o[2 * x] = o[2 * x + 1] = d[(size_t)y * cc + x];
            continue;
          }
          const int t = colsum(x);
          o[2 * x] = (t * 3 + colsum(x - 1) + 8) >> 4;
          o[2 * x + 1] = (t * 3 + colsum(x + 1) + 7) >> 4;
        }
      }
  }
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      const int64_t yy = Y[(size_t)y * yc + x];
      const int64_t cb = up[0][(size_t)y * 2 * cw + x] - 128, crv = up[1][(size_t)y * 2 * cw + x] - 128;
      uint8_t* o = out + ((size_t)y * W + x) * 3;
      o[0] = sat_u8((int)(yy + ((91881 * crv + half) >> 16)));
      o[1] = sat_u8((int)(yy + ((-22554 * cb + half - 46802 * crv) >> 16)));
      o[2] = sat_u8((int)(yy + ((116130 * cb + half) >> 16)));
    }
  return 0;
}

int dtp_version() { return 2; }

}  // extern "C"
