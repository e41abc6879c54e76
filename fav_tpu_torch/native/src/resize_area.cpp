// INTER_AREA box resize for the live path's CNN input (fav_tpu/native/src/
// jpegio.cpp:124, copied). Its own translation unit, so that it builds and
// links without libjpeg:
//   g++ -O3 -shared -fPIC resize_area.cpp -o resize_area-<hash>.so

#include <cstdint>
#include <cstddef>

extern "C" {

// INTER_AREA-style box resize for uint8 interleaved images (any channel
// count). Matches cv2.resize semantics for integer and fractional
// downscale: each destination pixel averages the exact (possibly fractional)
// source box it covers.
int fav_resize_area_u8(const uint8_t* src, int sw, int sh, int channels,
                       uint8_t* dst, int dw, int dh) {
  if (!src || !dst || sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0 || channels <= 0)
    return -1;
  const double sx = static_cast<double>(sw) / dw;
  const double sy = static_cast<double>(sh) / dh;

  for (int dy = 0; dy < dh; ++dy) {
    const double fy0 = dy * sy, fy1 = (dy + 1) * sy;
    const int y0 = static_cast<int>(fy0), y1 = static_cast<int>(fy1 - 1e-9);
    for (int dx = 0; dx < dw; ++dx) {
      const double fx0 = dx * sx, fx1 = (dx + 1) * sx;
      const int x0 = static_cast<int>(fx0), x1 = static_cast<int>(fx1 - 1e-9);
      for (int c = 0; c < channels; ++c) {
        double acc = 0.0, wsum = 0.0;
        for (int y = y0; y <= y1 && y < sh; ++y) {
          const double wy = (y1 == y0) ? 1.0
                          : ((y == y0) ? (y0 + 1 - fy0)
                          : ((y == y1) ? (fy1 - y1) : 1.0));
          for (int x = x0; x <= x1 && x < sw; ++x) {
            const double wx = (x1 == x0) ? 1.0
                            : ((x == x0) ? (x0 + 1 - fx0)
                            : ((x == x1) ? (fx1 - x1) : 1.0));
            const double w = wx * wy;
            acc += w * src[(static_cast<size_t>(y) * sw + x) * channels + c];
            wsum += w;
          }
        }
        dst[(static_cast<size_t>(dy) * dw + dx) * channels + c] =
            static_cast<uint8_t>(acc / (wsum > 0 ? wsum : 1.0) + 0.5);
      }
    }
  }
  return 0;
}

}  // extern "C"
