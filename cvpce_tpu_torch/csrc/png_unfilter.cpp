// PNG row unfiltering for the port's image decoder (data/png.py).
//
// The card's machine has no image library (no PIL, no cv2), so the port
// decodes PNG itself: Python reads the chunks and inflates the image
// data with zlib; this file undoes the five row filters of the PNG
// specification (section 9: None, Sub, Up, Average, Paeth). Average and
// Paeth take the byte just reconstructed to their left, a dependency
// along the row that numpy cannot vectorise, so a photo would cost
// seconds in a per-byte Python loop. This replaces no TPU kernel: the
// JAX package decodes with PIL and cv2 on the host.
//
// Host code, built with g++ into a shared library with a plain C
// interface and loaded with ctypes (_build.py). A plain numpy version,
// data/png.py:unfilter_reference, is held against it by the tests.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

}  // namespace

extern "C" {

// `src` holds `rows` filtered rows of 1 + `stride` bytes each (the
// filter type, then the row's bytes); `dst` receives rows x stride
// reconstructed bytes. `bpp` is the byte distance to the corresponding
// byte of the pixel to the left (1 for bit depths below 8). The row
// above the first is taken as zeros. Returns 0, or r + 1 when row r has
// a filter type outside 0-4 (the rows before it are reconstructed).
int64_t png_unfilter(const uint8_t* src, int64_t rows, int64_t stride,
                     int32_t bpp, uint8_t* dst) {
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* in = src + r * (stride + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + r * stride;
    const uint8_t* up = r ? out - stride : nullptr;
    switch (type) {
      case 0:
        for (int64_t x = 0; x < stride; ++x) out[x] = in[x];
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          out[x] = uint8_t(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x)
          out[x] = uint8_t(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          out[x] = uint8_t(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          out[x] = uint8_t(in[x] + paeth(a, b, c));
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
