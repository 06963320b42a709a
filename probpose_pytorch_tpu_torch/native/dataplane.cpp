// The port's copy of the native ingestion pre-stage (the JAX package's
// native/dataplane.cpp, the same C ABI): threaded JPEG decode + crop +
// bilinear resize on the host, for the first-epoch ingestion of the COCO and
// YOLO loaders (`resample="native"`) and the crop cache.
//
// The bilinear sampling convention is ops/preprocess.py's "bilinear_gather":
// output pixel j samples source coordinate (j + 0.5) * (bw / W) + x0 - 0.5,
// 4-tap, zero outside the frame, so a crop made here equals the device crop
// to uint8 rounding.
//
// Built with g++ at first use (native/__init__.py): no Python.h, no pybind,
// a plain C ABI. Where jpeglib.h is missing, the build defines
// PROBPOSE_NO_JPEG and holds the crop-resize half alone; the JPEG entry
// points are then absent and dataplane_has_jpeg() returns 0.

#include <cstdio>  // jpeglib.h uses FILE without including it

#ifndef PROBPOSE_NO_JPEG
#include <jpeglib.h>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

#ifndef PROBPOSE_NO_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG buffer to tightly-packed RGB. Returns false on corrupt input.
bool decode_jpeg(const uint8_t* buf, unsigned long size,
                 std::vector<uint8_t>& rgb, int& h, int& w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  h = cinfo.output_height;
  w = cinfo.output_width;
  rgb.resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#endif  // PROBPOSE_NO_JPEG

// Bilinear crop-resize of one RGB frame into out (H, W, 3).
// Convention identical to ops/preprocess.py:_crop_one_bilinear.
void crop_resize_one(const uint8_t* frame, int hs, int ws, const float* box,
                     uint8_t* out, int H, int W) {
  const float x0 = box[0], y0 = box[1], bw = box[2], bh = box[3];
  const float sx = bw / W, sy = bh / H;
  std::vector<int> xi0(W), xi1(W);
  std::vector<float> wx(W);
  for (int j = 0; j < W; ++j) {
    float ox = (j + 0.5f) * sx + x0 - 0.5f;
    float xf = std::floor(ox);
    wx[j] = ox - xf;
    xi0[j] = static_cast<int>(xf);
    xi1[j] = xi0[j] + 1;
  }
  for (int i = 0; i < H; ++i) {
    float oy = (i + 0.5f) * sy + y0 - 0.5f;
    float yf = std::floor(oy);
    float vy = oy - yf;
    int yi0 = static_cast<int>(yf), yi1 = yi0 + 1;
    bool y0_in = yi0 >= 0 && yi0 < hs;
    bool y1_in = yi1 >= 0 && yi1 < hs;
    const uint8_t* row0 = y0_in ? frame + static_cast<size_t>(yi0) * ws * 3 : nullptr;
    const uint8_t* row1 = y1_in ? frame + static_cast<size_t>(yi1) * ws * 3 : nullptr;
    uint8_t* orow = out + (static_cast<size_t>(i) * W) * 3;
    for (int j = 0; j < W; ++j) {
      bool x0_in = xi0[j] >= 0 && xi0[j] < ws;
      bool x1_in = xi1[j] >= 0 && xi1[j] < ws;
      float w00 = (1 - vy) * (1 - wx[j]), w01 = (1 - vy) * wx[j];
      float w10 = vy * (1 - wx[j]), w11 = vy * wx[j];
      for (int c = 0; c < 3; ++c) {
        float v = 0.f;
        if (row0 && x0_in) v += w00 * row0[xi0[j] * 3 + c];
        if (row0 && x1_in) v += w01 * row0[xi1[j] * 3 + c];
        if (row1 && x0_in) v += w10 * row1[xi0[j] * 3 + c];
        if (row1 && x1_in) v += w11 * row1[xi1[j] * 3 + c];
        orow[j * 3 + c] =
            static_cast<uint8_t>(std::min(255.f, std::max(0.f, v + 0.5f)));
      }
    }
  }
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, n);
  if (n_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// frames: (n, hs, ws, 3) uint8; boxes: (n, 4) [x0, y0, w, h] in frame pixels;
// out: (n, H, W, 3) uint8. Returns 0 on success.
int crop_resize_batch_u8(const uint8_t* frames, int n, int hs, int ws,
                         const float* boxes, uint8_t* out, int H, int W,
                         int n_threads) {
  const size_t frame_sz = static_cast<size_t>(hs) * ws * 3;
  const size_t out_sz = static_cast<size_t>(H) * W * 3;
  parallel_for(n, n_threads, [&](int i) {
    crop_resize_one(frames + i * frame_sz, hs, ws, boxes + i * 4,
                    out + i * out_sz, H, W);
  });
  return 0;
}

#ifndef PROBPOSE_NO_JPEG
// bufs/sizes: n JPEG byte buffers; boxes as above (frame-pixel coordinates of
// each decoded image); out: (n, H, W, 3). Returns the number of failed
// decodes (their crops are zeroed).
int decode_crop_resize_batch(const uint8_t** bufs, const unsigned long* sizes,
                             int n, const float* boxes, uint8_t* out, int H,
                             int W, int n_threads) {
  const size_t out_sz = static_cast<size_t>(H) * W * 3;
  std::atomic<int> failures(0);
  parallel_for(n, n_threads, [&](int i) {
    std::vector<uint8_t> rgb;
    int h = 0, w = 0;
    if (!decode_jpeg(bufs[i], sizes[i], rgb, h, w)) {
      std::memset(out + i * out_sz, 0, out_sz);
      failures.fetch_add(1);
      return;
    }
    crop_resize_one(rgb.data(), h, w, boxes + i * 4, out + i * out_sz, H, W);
  });
  return failures.load();
}

// Decode only (for probing/size checks): returns 0 and fills h/w on success.
int jpeg_size(const uint8_t* buf, unsigned long size, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, size);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
#endif  // PROBPOSE_NO_JPEG

// 1 where the JPEG half is built, 0 where the build had no jpeglib.h.
int dataplane_has_jpeg() {
#ifdef PROBPOSE_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

}  // extern "C"
