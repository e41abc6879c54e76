// Native host I/O for the streaming path (SURVEY.md §2.4): the port's copy
// of fav_tpu/native/src/jpegio.cpp. The INTER_AREA resize lives in its own
// translation unit, resize_area.cpp, which needs no libjpeg.
//
// The reference's only native execution is inside OpenCV wheels
// (reference video_source.py:144-148 resize, main.py:97-100 imencode).
// Here the equivalents are first-class C++: a libjpeg encode/decode pair for
// the 30 Hz browser stream and upload path, and an INTER_AREA-style box
// resize for capture normalization — all exposed through a minimal C ABI
// consumed via ctypes.
//
// Build (fav_tpu_torch/native/__init__.py, at first use, under build/native/):
//   g++ -O3 -shared -fPIC jpegio.cpp -ljpeg -o jpegio-<hash>.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cstdio>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

void fav_free(void* p) { std::free(p); }

// Encode a BGR8 frame to JPEG. Returns 0 on success; *out is malloc'd and
// must be released with fav_free.
int fav_jpeg_encode_bgr(const uint8_t* bgr, int width, int height, int stride,
                        int quality, uint8_t** out, unsigned long* out_size) {
  if (!bgr || width <= 0 || height <= 0 || !out || !out_size) return -1;
  if (stride <= 0) stride = width * 3;

  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  *out = nullptr;  // initialized before setjmp so the handler can free safely
  *out_size = 0;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    // jpeg_mem_dest's buffer is malloc'd by libjpeg; callers ignore *out on
    // error, so it must be released here or the 30 Hz hot path leaks.
    std::free(*out);
    *out = nullptr;
    *out_size = 0;
    return -2;
  }
  jpeg_create_compress(&cinfo);

  jpeg_mem_dest(&cinfo, out, out_size);

  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_EXT_BGR;  // direct BGR input: no swizzle pass
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);

  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(bgr) +
                   static_cast<size_t>(cinfo.next_scanline) * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

// Decode a JPEG to BGR8. Caller provides the output query in two phases:
// pass out=nullptr to get dimensions, then a buffer of *width * *height * 3.
int fav_jpeg_decode_bgr(const uint8_t* data, unsigned long size,
                        uint8_t* out, int* width, int* height) {
  if (!data || size == 0 || !width || !height) return -1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.out_color_space = JCS_EXT_BGR;
  *width = cinfo.image_width;
  *height = cinfo.image_height;
  if (!out) {  // dimension probe only
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  const int stride = cinfo.output_width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
