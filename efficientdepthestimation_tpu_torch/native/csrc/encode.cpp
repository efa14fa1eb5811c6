// Native image/video ENCODERS for the host-side output pipeline.
//
// Round-4 E2E profiling showed ~85% of total wall time in host encoding
// (PIL PNG + OpenCV DIVX/AVI on one core) while the device idled
// (e2e/timings.json). This library provides the write-side counterpart of
// batch_loader.cpp: PNG (8/16-bit, libpng at a caller-chosen zlib level)
// and MJPEG-in-AVI video (libjpeg per frame — typically libjpeg-turbo's
// SIMD path — inside a minimal RIFF/AVI container), with a thread pool for
// batch encodes on multi-core hosts. Replaces the per-frame
// cv2.cvtColor+VideoWriter and PIL .save calls in the renderer and the
// async writers (reference behaviour being matched-then-beaten:
// Benchmark/benchmark.py:947-962 async writers).
//
// Plain C ABI for ctypes; no Python headers required.

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------- PNG

bool encode_png_impl(const char* path, const uint8_t* data, int64_t height,
                     int64_t width, int channels, int bit16,
                     int compress_level) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return false;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_write_struct(&png, info ? &info : nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  int color = channels == 3 ? PNG_COLOR_TYPE_RGB
              : channels == 4 ? PNG_COLOR_TYPE_RGBA
                              : PNG_COLOR_TYPE_GRAY;
  png_set_IHDR(png, info, (png_uint_32)width, (png_uint_32)height,
               bit16 ? 16 : 8, color, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_set_compression_level(png, compress_level);
  png_write_info(png, info);
  if (bit16) png_set_swap(png);  // in-memory little-endian -> PNG big-endian
  int64_t stride = width * channels * (bit16 ? 2 : 1);
  std::vector<png_bytep> rows(height);
  for (int64_t y = 0; y < height; ++y)
    rows[y] = const_cast<png_bytep>(data + y * stride);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return true;
}

// --------------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Encode one RGB frame to an in-memory JPEG buffer. Returns empty on error.
std::vector<uint8_t> encode_jpeg_mem(const uint8_t* pix, int64_t height,
                                     int64_t width, int quality,
                                     int channels = 3) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  unsigned char* mem = nullptr;
  unsigned long mem_size = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return {};
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_size);
  cinfo.image_width = (JDIMENSION)width;
  cinfo.image_height = (JDIMENSION)height;
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        pix + (int64_t)cinfo.next_scanline * width * channels);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::vector<uint8_t> out(mem, mem + mem_size);
  free(mem);
  return out;
}

bool encode_jpeg_impl(const char* path, const uint8_t* pix, int64_t height,
                      int64_t width, int quality, int channels) {
  auto buf = encode_jpeg_mem(pix, height, width, quality, channels);
  if (buf.empty()) return false;
  FILE* fp = fopen(path, "wb");
  if (!fp) return false;
  bool ok = fwrite(buf.data(), 1, buf.size(), fp) == buf.size();
  fclose(fp);
  return ok;
}

// -------------------------------------------------------------- MJPEG / AVI
//
// Minimal RIFF AVI 1.0 writer: hdrl(avih + one video strl) + movi(00dc
// chunks, one baseline JPEG per frame) + idx1. MJPEG-in-AVI is read by
// ffmpeg/OpenCV/VLC; every JPEG carries the standard Huffman tables
// (libjpeg default), as MJPEG players require.

void put_u32(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back(v & 0xff);
  b.push_back((v >> 8) & 0xff);
  b.push_back((v >> 16) & 0xff);
  b.push_back((v >> 24) & 0xff);
}

void put_tag(std::vector<uint8_t>& b, const char* t) {
  b.insert(b.end(), t, t + 4);
}

// Thread pool over frame indices (same shape as batch_loader.cpp).
void parallel_frames(int64_t n, int threads,
                     const std::function<void(int64_t)>& fn) {
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
  int n_threads = (int)std::min<int64_t>(threads, n);
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

bool write_mjpeg_avi_impl(const char* path, const uint8_t* frames_rgb,
                          int64_t n, int64_t height, int64_t width, int fps,
                          int quality, int threads) {
  // 1. encode every frame to JPEG (parallel on multi-core hosts)
  std::vector<std::vector<uint8_t>> jpegs(n);
  std::atomic<bool> ok(true);
  parallel_frames(n, threads, [&](int64_t i) {
    jpegs[i] = encode_jpeg_mem(frames_rgb + i * height * width * 3, height,
                               width, quality);
    if (jpegs[i].empty()) ok = false;
  });
  if (!ok) return false;

  // 2. lay out the container
  std::vector<uint8_t> hdr;
  uint32_t max_bytes = 0;
  uint64_t movi_payload = 0;
  for (auto& j : jpegs) {
    uint32_t sz = (uint32_t)((j.size() + 1) & ~1ull);  // chunks are 16-bit padded
    max_bytes = std::max(max_bytes, sz);
    movi_payload += 8 + sz;
  }
  const uint32_t movi_size = 4 + (uint32_t)movi_payload;          // 'movi' + chunks
  const uint32_t idx1_size = (uint32_t)(16 * n);

  // RIFF('AVI ' ...)
  put_tag(hdr, "RIFF");
  const size_t riff_size_at = hdr.size();
  put_u32(hdr, 0);  // patched below
  put_tag(hdr, "AVI ");

  // LIST hdrl
  std::vector<uint8_t> hdrl;
  put_tag(hdrl, "hdrl");
  {
    put_tag(hdrl, "avih");
    put_u32(hdrl, 56);
    put_u32(hdrl, fps > 0 ? 1000000u / (uint32_t)fps : 0);  // usec/frame
    put_u32(hdrl, (uint32_t)(max_bytes * (uint64_t)fps));   // max bytes/sec
    put_u32(hdrl, 0);                                       // padding
    put_u32(hdrl, 0x10);                                    // AVIF_HASINDEX
    put_u32(hdrl, (uint32_t)n);
    put_u32(hdrl, 0);  // initial frames
    put_u32(hdrl, 1);  // streams
    put_u32(hdrl, max_bytes);
    put_u32(hdrl, (uint32_t)width);
    put_u32(hdrl, (uint32_t)height);
    for (int i = 0; i < 4; ++i) put_u32(hdrl, 0);  // reserved
  }
  {
    std::vector<uint8_t> strl;
    put_tag(strl, "strl");
    put_tag(strl, "strh");
    put_u32(strl, 56);
    put_tag(strl, "vids");
    put_tag(strl, "MJPG");
    put_u32(strl, 0);  // flags
    put_u32(strl, 0);  // priority+language
    put_u32(strl, 0);  // initial frames
    put_u32(strl, 1);  // scale
    put_u32(strl, (uint32_t)fps);  // rate -> fps frames per second
    put_u32(strl, 0);              // start
    put_u32(strl, (uint32_t)n);    // length
    put_u32(strl, max_bytes);      // suggested buffer
    put_u32(strl, 0xFFFFFFFFu);    // quality
    put_u32(strl, 0);              // sample size (0 = varying)
    put_u32(strl, 0);              // rcFrame x,y
    put_u32(strl, ((uint32_t)height << 16) | (uint32_t)width);  // rcFrame r,b
    put_tag(strl, "strf");
    put_u32(strl, 40);  // BITMAPINFOHEADER
    put_u32(strl, 40);
    put_u32(strl, (uint32_t)width);
    put_u32(strl, (uint32_t)height);
    uint32_t planes_bits = 1u | (24u << 16);
    put_u32(strl, planes_bits);
    put_tag(strl, "MJPG");                              // biCompression
    put_u32(strl, (uint32_t)(width * height * 3));      // biSizeImage
    put_u32(strl, 0);
    put_u32(strl, 0);
    put_u32(strl, 0);
    put_u32(strl, 0);
    put_tag(hdrl, "LIST");
    put_u32(hdrl, (uint32_t)strl.size());
    hdrl.insert(hdrl.end(), strl.begin(), strl.end());
  }
  put_tag(hdr, "LIST");
  put_u32(hdr, (uint32_t)hdrl.size());
  hdr.insert(hdr.end(), hdrl.begin(), hdrl.end());

  put_tag(hdr, "LIST");
  put_u32(hdr, movi_size);
  put_tag(hdr, "movi");

  FILE* fp = fopen(path, "wb");
  if (!fp) return false;
  bool wok = fwrite(hdr.data(), 1, hdr.size(), fp) == hdr.size();

  // 3. stream the frame chunks + build the index
  std::vector<uint8_t> idx;
  put_tag(idx, "idx1");
  put_u32(idx, idx1_size);
  uint32_t offset = 4;  // offsets are relative to the start of 'movi' data
  for (auto& j : jpegs) {
    uint32_t raw = (uint32_t)j.size();
    uint32_t padded = (raw + 1) & ~1u;
    std::vector<uint8_t> chunk;
    put_tag(chunk, "00dc");
    put_u32(chunk, raw);
    wok &= fwrite(chunk.data(), 1, chunk.size(), fp) == chunk.size();
    wok &= fwrite(j.data(), 1, raw, fp) == raw;
    if (padded != raw) wok &= fputc(0, fp) != EOF;
    put_tag(idx, "00dc");
    put_u32(idx, 0x10);  // AVIIF_KEYFRAME
    put_u32(idx, offset);
    put_u32(idx, raw);
    offset += 8 + padded;
  }
  wok &= fwrite(idx.data(), 1, idx.size(), fp) == idx.size();

  // 4. patch the RIFF size
  long total = ftell(fp);
  if (total < 0) wok = false;
  if (wok) {
    uint32_t riff_size = (uint32_t)(total - 8);
    fseek(fp, (long)riff_size_at, SEEK_SET);
    uint8_t sz[4] = {(uint8_t)(riff_size & 0xff), (uint8_t)(riff_size >> 8),
                     (uint8_t)(riff_size >> 16), (uint8_t)(riff_size >> 24)};
    wok &= fwrite(sz, 1, 4, fp) == 4;
  }
  fclose(fp);
  return wok;
}

// Streaming AVI writer: open → append frames → close. The header fields
// that depend on the frame count (avih dwTotalFrames, strh dwLength, movi
// LIST size, RIFF size, max-chunk sizes) are patched at close; the index
// is accumulated in memory and appended last. Lets arbitrarily long videos
// stream without buffering frames (depth_video's 3840×1440 hstack would
// not fit in RAM).

struct AviStream {
  FILE* fp = nullptr;
  int64_t width = 0, height = 0;
  int fps = 24, quality = 90;
  long riff_size_at = 0, total_frames_at = 0, max_bytes_at = 0;
  long strh_length_at = 0, strh_maxbytes_at = 0, movi_size_at = 0;
  long avih_sugbuf_at = 0;
  uint32_t n_frames = 0, max_bytes = 0;
  uint64_t movi_payload = 0;
  std::vector<uint8_t> idx;  // idx1 entries (16 bytes per frame)
};

void patch_u32(FILE* fp, long at, uint32_t v) {
  fseek(fp, at, SEEK_SET);
  uint8_t b[4] = {(uint8_t)(v & 0xff), (uint8_t)(v >> 8 & 0xff),
                  (uint8_t)(v >> 16 & 0xff), (uint8_t)(v >> 24 & 0xff)};
  fwrite(b, 1, 4, fp);
}

AviStream* avi_open_impl(const char* path, int64_t height, int64_t width,
                         int fps, int quality) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return nullptr;
  auto* s = new AviStream();
  s->fp = fp;
  s->width = width;
  s->height = height;
  s->fps = fps;
  s->quality = quality;

  std::vector<uint8_t> hdr;
  put_tag(hdr, "RIFF");
  s->riff_size_at = (long)hdr.size();
  put_u32(hdr, 0);
  put_tag(hdr, "AVI ");

  std::vector<uint8_t> hdrl;
  put_tag(hdrl, "hdrl");
  put_tag(hdrl, "avih");
  put_u32(hdrl, 56);
  put_u32(hdrl, fps > 0 ? 1000000u / (uint32_t)fps : 0);
  const long avih_base = (long)(hdr.size() + 8 + hdrl.size());
  put_u32(hdrl, 0);  // max bytes/sec — patched
  s->max_bytes_at = avih_base;
  put_u32(hdrl, 0);
  put_u32(hdrl, 0x10);  // AVIF_HASINDEX
  s->total_frames_at = (long)(hdr.size() + 8 + hdrl.size());
  put_u32(hdrl, 0);  // total frames — patched
  put_u32(hdrl, 0);
  put_u32(hdrl, 1);
  const long sug_at = (long)(hdr.size() + 8 + hdrl.size());
  put_u32(hdrl, 0);  // suggested buffer — patched (reuse strh_maxbytes slot list)
  put_u32(hdrl, (uint32_t)width);
  put_u32(hdrl, (uint32_t)height);
  for (int i = 0; i < 4; ++i) put_u32(hdrl, 0);

  std::vector<uint8_t> strl;
  put_tag(strl, "strl");
  put_tag(strl, "strh");
  put_u32(strl, 56);
  put_tag(strl, "vids");
  put_tag(strl, "MJPG");
  put_u32(strl, 0);
  put_u32(strl, 0);
  put_u32(strl, 0);
  put_u32(strl, 1);
  put_u32(strl, (uint32_t)fps);
  put_u32(strl, 0);
  const long strh_len_rel = (long)strl.size();
  put_u32(strl, 0);  // length — patched
  const long strh_max_rel = (long)strl.size();
  put_u32(strl, 0);  // suggested buffer — patched
  put_u32(strl, 0xFFFFFFFFu);
  put_u32(strl, 0);
  put_u32(strl, 0);
  put_u32(strl, ((uint32_t)height << 16) | (uint32_t)width);
  put_tag(strl, "strf");
  put_u32(strl, 40);
  put_u32(strl, 40);
  put_u32(strl, (uint32_t)width);
  put_u32(strl, (uint32_t)height);
  put_u32(strl, 1u | (24u << 16));
  put_tag(strl, "MJPG");
  put_u32(strl, (uint32_t)(width * height * 3));
  put_u32(strl, 0);
  put_u32(strl, 0);
  put_u32(strl, 0);
  put_u32(strl, 0);

  const long strl_base = (long)(hdr.size() + 8 + hdrl.size() + 8);
  s->strh_length_at = strl_base + strh_len_rel;
  s->strh_maxbytes_at = strl_base + strh_max_rel;
  put_tag(hdrl, "LIST");
  put_u32(hdrl, (uint32_t)strl.size());
  hdrl.insert(hdrl.end(), strl.begin(), strl.end());

  put_tag(hdr, "LIST");
  put_u32(hdr, (uint32_t)hdrl.size());
  hdr.insert(hdr.end(), hdrl.begin(), hdrl.end());

  put_tag(hdr, "LIST");
  s->movi_size_at = (long)hdr.size();
  put_u32(hdr, 0);  // movi size — patched
  put_tag(hdr, "movi");

  s->avih_sugbuf_at = sug_at;
  s->idx.reserve(1024);
  if (fwrite(hdr.data(), 1, hdr.size(), fp) != hdr.size()) {
    fclose(fp);
    delete s;
    return nullptr;
  }
  return s;
}

bool avi_append_impl(AviStream* s, const uint8_t* rgb) {
  auto j = encode_jpeg_mem(rgb, s->height, s->width, s->quality);
  if (j.empty()) return false;
  uint32_t raw = (uint32_t)j.size();
  uint32_t padded = (raw + 1) & ~1u;
  std::vector<uint8_t> chunk;
  put_tag(chunk, "00dc");
  put_u32(chunk, raw);
  bool ok = fwrite(chunk.data(), 1, chunk.size(), s->fp) == chunk.size();
  ok &= fwrite(j.data(), 1, raw, s->fp) == raw;
  if (padded != raw) ok &= fputc(0, s->fp) != EOF;
  put_tag(s->idx, "00dc");
  put_u32(s->idx, 0x10);
  put_u32(s->idx, 4 + (uint32_t)s->movi_payload);
  put_u32(s->idx, raw);
  s->movi_payload += 8 + padded;
  s->max_bytes = std::max(s->max_bytes, padded);
  s->n_frames += 1;
  return ok;
}

bool avi_close_impl(AviStream* s) {
  FILE* fp = s->fp;
  std::vector<uint8_t> idx1;
  put_tag(idx1, "idx1");
  put_u32(idx1, (uint32_t)s->idx.size());
  bool ok = fwrite(idx1.data(), 1, idx1.size(), fp) == idx1.size();
  ok &= fwrite(s->idx.data(), 1, s->idx.size(), fp) == s->idx.size();
  long total = ftell(fp);
  ok &= total > 0;
  if (ok) {
    patch_u32(fp, s->riff_size_at, (uint32_t)(total - 8));
    patch_u32(fp, s->total_frames_at, s->n_frames);
    patch_u32(fp, s->max_bytes_at,
              (uint32_t)((uint64_t)s->max_bytes * s->fps));
    patch_u32(fp, s->avih_sugbuf_at, s->max_bytes);
    patch_u32(fp, s->strh_length_at, s->n_frames);
    patch_u32(fp, s->strh_maxbytes_at, s->max_bytes);
    patch_u32(fp, s->movi_size_at, 4 + (uint32_t)s->movi_payload);
  }
  fclose(fp);
  delete s;
  return ok;
}

}  // namespace

extern "C" {

// data layout: HW (channels=1), HWC. bit16 only valid for channels=1
// (uint16 little-endian in memory). Returns 1 on success.
int ede_encode_png(const char* path, const uint8_t* data, int64_t height,
                   int64_t width, int channels, int bit16,
                   int compress_level) {
  if (channels != 1 && bit16) return 0;
  return encode_png_impl(path, data, height, width, channels, bit16,
                         compress_level)
             ? 1
             : 0;
}

// channels: 3 (RGB) or 1 (grayscale).
int ede_encode_jpeg(const char* path, const uint8_t* pix, int64_t height,
                    int64_t width, int quality, int channels) {
  if (channels != 1 && channels != 3) return 0;
  return encode_jpeg_impl(path, pix, height, width, quality, channels) ? 1 : 0;
}

// frames_rgb: contiguous (n, height, width, 3) uint8 RGB.
int ede_write_mjpeg_avi(const char* path, const uint8_t* frames_rgb,
                        int64_t n, int64_t height, int64_t width, int fps,
                        int quality, int threads) {
  return write_mjpeg_avi_impl(path, frames_rgb, n, height, width, fps,
                              quality, threads)
             ? 1
             : 0;
}

// Streaming AVI: open → append → close. Handle is opaque; close frees it.
void* ede_avi_open(const char* path, int64_t height, int64_t width, int fps,
                   int quality) {
  return avi_open_impl(path, height, width, fps, quality);
}

int ede_avi_append(void* handle, const uint8_t* frame_rgb) {
  if (!handle) return 0;
  return avi_append_impl(static_cast<AviStream*>(handle), frame_rgb) ? 1 : 0;
}

int ede_avi_close(void* handle) {
  if (!handle) return 0;
  return avi_close_impl(static_cast<AviStream*>(handle)) ? 1 : 0;
}

int ede_encoder_version() { return 2; }

}  // extern "C"
