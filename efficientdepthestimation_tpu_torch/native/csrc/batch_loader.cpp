// Native batch image decoder for the TPU data pipeline.
//
// The host-side bottleneck of the serving pipeline is PNG/JPEG decode (the
// device does all resize/augment math). This library decodes batches of
// image files into caller-provided contiguous NHWC buffers on a C++ thread
// pool, replacing per-sample PIL decode in Python worker threads (the role
// DataLoader workers play in the reference, ReSIDE/loaddata.py:62).
//
// Exposed as a plain C ABI for ctypes; no Python headers required.
//
// Supported:
//   * 8-bit RGB/RGBA/gray PNG  -> RGB uint8 (HWC)
//   * 16-bit gray PNG          -> uint16 (HW)  [NYU test depth convention]
//   * JPEG (via libjpeg)       -> RGB uint8 (HWC)

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct PngReader {
  FILE* fp = nullptr;
  png_structp png = nullptr;
  png_infop info = nullptr;

  ~PngReader() {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    if (fp) fclose(fp);
  }

  bool open(const char* path) {
    fp = fopen(path, "rb");
    if (!fp) return false;
    unsigned char sig[8];
    if (fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) return false;
    png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return false;
    info = png_create_info_struct(png);
    if (!info) return false;
    if (setjmp(png_jmpbuf(png))) return false;
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);
    return true;
  }
};

bool decode_png_rgb_impl(const char* path, uint8_t* out, int64_t height,
                         int64_t width) {
  PngReader r;
  if (!r.open(path)) return false;
  if (setjmp(png_jmpbuf(r.png))) return false;

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(r.png, r.info, &w, &h, &bit_depth, &color_type, nullptr,
               nullptr, nullptr);
  if ((int64_t)h != height || (int64_t)w != width) return false;

  if (bit_depth == 16) png_set_strip_16(r.png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(r.png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(r.png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(r.png);
  png_set_strip_alpha(r.png);
  png_read_update_info(r.png, r.info);

  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + y * width * 3;
  png_read_image(r.png, rows.data());
  return true;
}

bool decode_png_depth16_impl(const char* path, uint16_t* out, int64_t height,
                             int64_t width) {
  PngReader r;
  if (!r.open(path)) return false;
  if (setjmp(png_jmpbuf(r.png))) return false;

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(r.png, r.info, &w, &h, &bit_depth, &color_type, nullptr,
               nullptr, nullptr);
  if ((int64_t)h != height || (int64_t)w != width) return false;
  if (color_type != PNG_COLOR_TYPE_GRAY) return false;

  if (bit_depth == 16) {
    // PNG stores big-endian 16-bit samples; we want host little-endian.
    png_set_swap(r.png);
    png_read_update_info(r.png, r.info);
    std::vector<png_bytep> rows(h);
    for (png_uint_32 y = 0; y < h; ++y)
      rows[y] = reinterpret_cast<png_bytep>(out + y * width);
    png_read_image(r.png, rows.data());
  } else {
    std::vector<uint8_t> tmp(h * w);
    std::vector<png_bytep> rows(h);
    for (png_uint_32 y = 0; y < h; ++y) rows[y] = tmp.data() + y * width;
    png_read_image(r.png, rows.data());
    for (int64_t i = 0; i < height * width; ++i) out[i] = tmp[i];
  }
  return true;
}

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg_rgb_impl(const char* path, uint8_t* out, int64_t height,
                          int64_t width) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  bool ok = (int64_t)cinfo.output_height == height &&
            (int64_t)cinfo.output_width == width;
  if (ok) {
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = out + (int64_t)cinfo.output_scanline * width * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return ok;
}

bool has_suffix(const char* path, const char* suffix) {
  size_t lp = strlen(path), ls = strlen(suffix);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; ++i) {
    char a = path[lp - ls + i], b = suffix[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

bool decode_rgb_any(const char* path, uint8_t* out, int64_t h, int64_t w) {
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    return decode_jpeg_rgb_impl(path, out, h, w);
  return decode_png_rgb_impl(path, out, h, w);
}

// Minimal work-stealing-free thread pool: one task per image index.
void parallel_for(int64_t n, int threads, const std::function<void(int64_t)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  int n_threads = std::min<int64_t>(threads, n);
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Single-image entry points. Return 1 on success, 0 on failure.
int ede_decode_rgb(const char* path, uint8_t* out, int64_t height,
                   int64_t width) {
  return decode_rgb_any(path, out, height, width) ? 1 : 0;
}

int ede_decode_depth16(const char* path, uint16_t* out, int64_t height,
                       int64_t width) {
  return decode_png_depth16_impl(path, out, height, width) ? 1 : 0;
}

// Batch entry points: decode `n` files into a contiguous NHWC (or NHW)
// buffer on a thread pool. `status[i]` receives 1/0 per file.
void ede_decode_rgb_batch(const char** paths, int64_t n, uint8_t* out,
                          int64_t height, int64_t width, int threads,
                          int* status) {
  parallel_for(n, threads, [&](int64_t i) {
    status[i] = decode_rgb_any(paths[i], out + i * height * width * 3,
                               height, width)
                    ? 1
                    : 0;
  });
}

void ede_decode_depth16_batch(const char** paths, int64_t n, uint16_t* out,
                              int64_t height, int64_t width, int threads,
                              int* status) {
  parallel_for(n, threads, [&](int64_t i) {
    status[i] =
        decode_png_depth16_impl(paths[i], out + i * height * width, height,
                                width)
            ? 1
            : 0;
  });
}

int ede_loader_version() { return 1; }

}  // extern "C"
