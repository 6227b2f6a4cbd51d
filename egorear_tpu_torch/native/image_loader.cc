// The port's native image loader (the JAX package's native/image_loader.cc,
// same C ABI and same arithmetic, so both give the same bytes): a C++ thread
// pool reads each file, decodes JPEG (libjpeg) or PNG (libpng) to RGB8,
// resizes it with PIL's separable antialiased bicubic (Keys a = -0.5, the
// support scaled by the downscale ratio, an 8-bit intermediate after the
// horizontal pass: Image.resize(BICUBIC) to within one LSB) and writes
// uint8 HWC or ImageNet-normalised float32 CHW into the caller's batch.
// Python hands in paths and gets the batch back; the calls release the GIL.
//
// Built at first use by egorear_tpu_torch/native/__init__.py against the
// libjpeg and libpng that Pillow loads, with the headers in third_party/
// (libjpeg-turbo 2.1.5's, jpeg62 ABI; libpng 1.6's API declared by hand).
// Exposed as a C ABI for ctypes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include "png_api.h"

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode JPEG bytes to RGB8. Returns true on success; fills w/h/pixels.
// jpeg_create_decompress hands the library JPEG_LIB_VERSION (62) and the
// size of this build's struct: a library of another ABI refuses both
// through error_exit, so the decode fails and nothing is written.
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->size) {
    png_error(png, "png: read past end");
  }
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

// 16-bit samples keep their high byte (png_set_strip_16), palettes and
// 1-8 bit gray expand to RGB8, alpha is dropped.
bool decode_png(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* w, int* h) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  out->resize(size_t(*w) * *h * 3);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) rows[y] = out->data() + size_t(y) * *w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_any(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* w, int* h) {
  if (len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8) {
    return decode_jpeg(buf, len, out, w, h);
  }
  if (len >= 8 && !png_sig_cmp(buf, 0, 8)) {
    return decode_png(buf, len, out, w, h);
  }
  return decode_jpeg(buf, len, out, w, h);  // last resort
}

// ---------------------------------------------------------------------------
// PIL-equivalent bicubic resampling (separable, antialiased)
// ---------------------------------------------------------------------------

double bicubic_filter(double x) {  // Keys cubic, a = -0.5 (PIL BICUBIC)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  std::vector<int> bounds_min;
  std::vector<int> bounds_size;
  std::vector<double> weights;  // [out][kmax]
  int kmax;
};

ResampleCoeffs precompute(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = double(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  rc.kmax = int(std::ceil(support)) * 2 + 1;
  rc.bounds_min.resize(out_size);
  rc.bounds_size.resize(out_size);
  rc.weights.assign(size_t(out_size) * rc.kmax, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double* w = &rc.weights[size_t(xx) * rc.kmax];
    double ww = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double v = bicubic_filter((x - center + 0.5) / filterscale);
      w[x - xmin] = v;
      ww += v;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax - xmin; ++x) w[x] /= ww;
    }
    rc.bounds_min[xx] = xmin;
    rc.bounds_size[xx] = xmax - xmin;
  }
  return rc;
}

inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return uint8_t(v + 0.5);
}

// uint8 HWC RGB -> uint8 HWC RGB at (out, out); PIL-style two-pass with an
// 8-bit intermediate (horizontal first), matching Image.resize(BICUBIC).
void resize_bicubic(const uint8_t* src, int in_w, int in_h, uint8_t* dst,
                    int out_size) {
  const ResampleCoeffs rx = precompute(in_w, out_size);
  const ResampleCoeffs ry = precompute(in_h, out_size);

  std::vector<uint8_t> tmp(size_t(in_h) * out_size * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + size_t(y) * in_w * 3;
    uint8_t* trow = tmp.data() + size_t(y) * out_size * 3;
    for (int xx = 0; xx < out_size; ++xx) {
      const double* w = &rx.weights[size_t(xx) * rx.kmax];
      const int xmin = rx.bounds_min[xx];
      const int n = rx.bounds_size[xx];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + size_t(xmin + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      trow[xx * 3 + 0] = clip8(acc[0]);
      trow[xx * 3 + 1] = clip8(acc[1]);
      trow[xx * 3 + 2] = clip8(acc[2]);
    }
  }
  for (int yy = 0; yy < out_size; ++yy) {
    const double* w = &ry.weights[size_t(yy) * ry.kmax];
    const int ymin = ry.bounds_min[yy];
    const int n = ry.bounds_size[yy];
    uint8_t* drow = dst + size_t(yy) * out_size * 3;
    for (int xx = 0; xx < out_size; ++xx) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const uint8_t* px =
            tmp.data() + (size_t(ymin + k) * out_size + xx) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      drow[xx * 3 + 0] = clip8(acc[0]);
      drow[xx * 3 + 1] = clip8(acc[1]);
      drow[xx * 3 + 2] = clip8(acc[2]);
    }
  }
}

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

// ---------------------------------------------------------------------------
// thread pool
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return !jobs_.empty(); });
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
};

// One pool per thread count, made at the first call that asks for it and
// never freed: concurrent callers (the data loader's worker threads) may
// ask for different counts, and a pool deleted on a change would be freed
// with other callers' jobs still queued on it. The pools' threads end with
// the process.
std::map<int, ThreadPool*> pools;
std::mutex pools_mu;

ThreadPool* get_pool(int n_threads) {
  std::lock_guard<std::mutex> lk(pools_mu);
  ThreadPool*& pool = pools[n_threads];
  if (!pool) pool = new ThreadPool(n_threads);
  return pool;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) {  // not a seekable file (a directory, a pipe)
    fclose(f);
    return false;
  }
  out->resize(n);
  const bool ok = fread(out->data(), 1, n, f) == size_t(n);
  fclose(f);
  return ok;
}

// One sample: file -> decoded -> resized -> (optional) normalized CHW f32.
int process_one(const char* path, int out_size, uint8_t* out_u8,
                float* out_f32) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return 1;
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_any(bytes.data(), bytes.size(), &rgb, &w, &h)) return 2;
  std::vector<uint8_t> resized(size_t(out_size) * out_size * 3);
  const uint8_t* final_rgb;
  if (w == out_size && h == out_size) {
    final_rgb = rgb.data();
  } else {
    resize_bicubic(rgb.data(), w, h, resized.data(), out_size);
    final_rgb = resized.data();
  }
  if (out_u8) {
    memcpy(out_u8, final_rgb, size_t(out_size) * out_size * 3);
  }
  if (out_f32) {
    const size_t plane = size_t(out_size) * out_size;
    for (size_t i = 0; i < plane; ++i) {
      for (int c = 0; c < 3; ++c) {
        out_f32[c * plane + i] =
            (final_rgb[i * 3 + c] / 255.0f - kMean[c]) / kStd[c];
      }
    }
  }
  return 0;
}

// A failed allocation (a corrupt header's huge size) counts as a failure of
// that sample instead of ending the process from a pool thread.
int process_one_safe(const char* path, int out_size, uint8_t* out_u8,
                     float* out_f32) {
  try {
    return process_one(path, out_size, out_u8, out_f32);
  } catch (const std::exception&) {
    return 3;
  }
}

// What a batch's jobs report to the caller that waits for them. The jobs
// own it with the caller (a shared_ptr each), so a job that signals the last
// completion may still unlock and release it after the caller has returned.
struct BatchState {
  std::mutex mu;
  std::condition_variable cv;
  int done = 0;
  int failures = 0;
};

// Runs process_one_safe over the batch on the pool; returns the failures.
// Each job counts its completion under the lock and touches nothing of the
// caller's after it: the caller may return as soon as the count is complete.
int load_batch(const char** paths, int count, int out_size, uint8_t* out_u8,
               float* out_f32, int n_threads) {
  ThreadPool* tp = get_pool(std::max(1, n_threads));
  auto state = std::make_shared<BatchState>();
  const size_t stride = size_t(3) * out_size * out_size;
  for (int i = 0; i < count; ++i) {
    uint8_t* u8 = out_u8 ? out_u8 + size_t(i) * stride : nullptr;
    float* f32 = out_f32 ? out_f32 + size_t(i) * stride : nullptr;
    const char* path = paths[i];
    tp->submit([state, path, out_size, u8, f32, count] {
      const bool failed = process_one_safe(path, out_size, u8, f32) != 0;
      std::lock_guard<std::mutex> lk(state->mu);
      state->failures += failed;
      if (++state->done == count) state->cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(state->mu);
  state->cv.wait(lk, [&] { return state->done == count; });
  return state->failures;
}

}  // namespace

extern "C" {

// Decode + resize a batch of image files into uint8 HWC batches.
// paths: array of C strings; out: (count, out_size, out_size, 3) uint8.
// Returns the number of failures.
int er_load_u8_batch(const char** paths, int count, int out_size, uint8_t* out,
                     int n_threads) {
  return load_batch(paths, count, out_size, out, nullptr, n_threads);
}

// Decode + resize + ImageNet-normalize into float32 CHW batches.
// out: (count, 3, out_size, out_size) float32. Returns failure count.
int er_load_f32_batch(const char** paths, int count, int out_size, float* out,
                      int n_threads) {
  return load_batch(paths, count, out_size, nullptr, out, n_threads);
}

// 1 when the linked libjpeg takes this build's jpeg_decompress_struct (its
// version and size), 0 when it refuses them.
int er_jpeg_abi_ok() {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

}  // extern "C"
