// Host data runtime of the PyTorch/CUDA port: the port's own copy of the JAX package's
// csrc/dtp_native.cpp, with the same seven extern "C" entry points and the same results.
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

// img (h x w RGB, freed here) -> resized + normalized floats at out slot i.
static void resize_normalize_into(uint8_t* img, int h, int w, int out_h,
                                  int out_w, const float* mean,
                                  const float* stdv, float* out, int64_t i) {
  std::vector<uint8_t> resized((size_t)out_h * out_w * 3);
  bilinear_resize_u8(img, h, w, resized.data(), out_h, out_w);
  free(img);
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

static void decode_rrc_one(int64_t i, void* p) {
  DecodeRrcArgs* a = (DecodeRrcArgs*)p;
  int h = 0, w = 0;
  uint8_t* img = decode_bytes(a->bufs[i], (size_t)a->lengths[i], &h, &w);
  if (!img) {
    int64_t expect = -1;
    a->failed->compare_exchange_strong(expect, i);
    return;
  }
  Philox rng;
  rng.init(a->seed, (a->epoch << 40) | (uint64_t)a->indices[i]);
  const double area = (double)h * w;
  const double log_rlo = std::log((double)a->ratio_lo);
  const double log_rhi = std::log((double)a->ratio_hi);
  int x0 = 0, y0 = 0, cw = w, ch = h;
  bool found = false;
  for (int att = 0; att < 10 && !found; ++att) {
    double target = area * (a->scale_lo + rng.uniform() * (a->scale_hi - a->scale_lo));
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
  bool flip = a->hflip && rng.uniform() < 0.5;
  bilinear_resize_window_u8(img, h, w, x0, y0, cw, ch,
                            a->out + (size_t)i * a->out_h * a->out_w * 3,
                            a->out_h, a->out_w, flip);
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

int dtp_version() { return 1; }

}  // extern "C"
