// Native batch JPEG loader for the input pipeline.
//
// A thread-pooled libjpeg decoder that fills a caller-provided uint8
// [N, H, W, 3] batch, applying nearest-neighbor resize (tf half-pixel or
// cv2 index semantics, matching ops/image.py::nearest_indices) during row
// decode. Exposed as a C ABI consumed via ctypes
// (ab_line_classifier_torch/data/native.py), which builds it on first use:
//   g++ -O3 -fPIC -shared -std=c++17 loader.cc -o <lib> -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Nearest-neighbor source index for output position i.
// mode 0 = 'tf' (half-pixel centers), mode 1 = 'cv2' (floor(i*scale)).
inline int nearest_idx(int i, int src, int dst, int mode) {
  double scale = static_cast<double>(src) / dst;
  double v = (mode == 0) ? std::floor((i + 0.5) * scale)
                         : std::floor(i * scale);
  if (v < 0) v = 0;
  if (v > src - 1) v = src - 1;
  return static_cast<int>(v);
}

// Scratch buffers for one decode. Declared BEFORE setjmp so a longjmp
// from the libjpeg error handler never jumps over their initialization:
// control returns to the setjmp site and decode_one exits by a normal
// `return`, running the destructors (a longjmp across live vectors would
// be UB and leak the heap blocks on every corrupt file).
struct DecodeBuffers {
  std::vector<int> cidx, ridx;
  std::vector<uint8_t> row;
};

// Decode one JPEG file to RGB and nearest-resize into out[H*W*3].
// Returns 0 on success, nonzero error code otherwise.
int decode_one(const char* path, uint8_t* out, int out_h, int out_w,
               int resize_mode) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  DecodeBuffers buf;  // before setjmp — see struct comment
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  const int src_w = cinfo.output_width;
  const int src_h = cinfo.output_height;
  const int comps = cinfo.output_components;  // 3 after JCS_RGB

  // Column gather map (precomputed once per image).
  std::vector<int>& cidx = buf.cidx;
  cidx.resize(out_w);
  for (int j = 0; j < out_w; ++j) {
    cidx[j] = nearest_idx(j, src_w, out_w, resize_mode);
  }
  // Row map: for each source row, which output rows consume it (rows are
  // monotone, so store the source row for each output row).
  std::vector<int>& ridx = buf.ridx;
  ridx.resize(out_h);
  for (int i = 0; i < out_h; ++i) {
    ridx[i] = nearest_idx(i, src_h, out_h, resize_mode);
  }

  std::vector<uint8_t>& row = buf.row;
  row.resize(static_cast<size_t>(src_w) * comps);
  JSAMPROW rowp = row.data();
  int next_out = 0;  // next output row waiting for its source row
  while (cinfo.output_scanline < cinfo.output_height) {
    const int src_row = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    while (next_out < out_h && ridx[next_out] == src_row) {
      uint8_t* dst = out + static_cast<size_t>(next_out) * out_w * 3;
      for (int j = 0; j < out_w; ++j) {
        const uint8_t* src_px = row.data() + static_cast<size_t>(cidx[j]) * comps;
        dst[j * 3 + 0] = src_px[0];
        dst[j * 3 + 1] = comps > 1 ? src_px[1] : src_px[0];
        dst[j * 3 + 2] = comps > 2 ? src_px[2] : src_px[0];
      }
      ++next_out;
    }
    if (next_out >= out_h) break;  // remaining rows not needed
  }
  // jpeg requires consuming all scanlines before finish unless we abort.
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return next_out == out_h ? 0 : 3;
}

}  // namespace

extern "C" {

// Decode n JPEGs into out [n, out_h, out_w, 3] (uint8, C-contiguous) with
// nearest resize. paths: array of n C strings. codes: per-file result codes
// (0 = ok). n_threads <= 0 selects hardware concurrency. Returns number of
// failures.
int ablc_decode_jpeg_batch(const char** paths, int n, uint8_t* out,
                           int out_h, int out_w, int resize_mode,
                           int* codes, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n) n_threads = n > 0 ? n : 1;

  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int code = decode_one(paths[i], out + frame_bytes * i, out_h, out_w,
                            resize_mode);
      codes[i] = code;
      if (code != 0) failures.fetch_add(1);
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

// ABI version for the ctypes wrapper to sanity-check.
int ablc_loader_version() { return 1; }

}  // extern "C"
