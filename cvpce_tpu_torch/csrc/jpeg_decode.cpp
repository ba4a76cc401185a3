// Baseline JPEG decoder for the port's image reader (data/jpeg.py).
//
// The card's machine has no image library (no PIL, no cv2), and the
// SKU-110K and Grocery Products photos are JPEG. This file reads
// Huffman-coded sequential DCT files (SOF0, and SOF1, which libjpeg
// writes when a quantisation table has 16-bit entries) at 8-bit
// precision, with 1 or 3 components in one interleaved scan, and gives
// the pixels that libjpeg-turbo's default decompression gives, which is
// what PIL's convert("RGB") and cv2's IMREAD_UNCHANGED return:
//
//   - the coefficients are dequantised as coef * q in int;
//   - the IDCT is jidctint.c's jpeg_idct_islow (CONST_BITS 13,
//     PASS1_BITS 2), its output taken through jdmaster.c's range-limit
//     table (indexed by value & 1023, so far out-of-range values wrap);
//   - chroma is upsampled as jdsample.c does with do_fancy_upsampling:
//     the triangle filters for 2:1 across (when the component is more
//     than 2 samples wide), 2:1 down, and 2:1 both ways (more than 2
//     wide), with their alternating rounding biases; replication for
//     every other integral ratio. The row above the first and below the
//     last is the edge row itself (jdmainct.c's context rows); a
//     component holds ceil(image_w * h / h_max) x ceil(image_h * v /
//     v_max) samples;
//   - YCbCr -> RGB with jdcolor.c's tables (SCALEBITS 16).
//
// Refused with status 2 (data/jpeg.py raises NotImplementedError):
// progressive, lossless, hierarchical and arithmetic-coded files,
// 12-bit samples, other than 1 or 3 components, RGB three-component
// files (Adobe transform 0, or component ids 'R' 'G' 'B' without JFIF),
// one scan a component, and DNL. Corrupt or truncated data gives status
// 1 (OSError), as does a file that ends before its EOI marker, which is
// what PIL's read does with one.
//
// Host code, built with g++ into a shared library with a plain C
// interface and loaded with ctypes (_build.py). It keeps no mutable
// global state, so loader threads may decode at once. This replaces no
// TPU kernel: the JAX package decodes with PIL and cv2 on the host. The
// plain versions the tests hold it against are data/jpeg.py's
// decode_reference and reconstruct_reference.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = 1;
constexpr int kRefused = 2;

struct Failure {
  int status;
  std::string message;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{kCorrupt, m}; }
[[noreturn]] void refuse(const std::string& m) { throw Failure{kRefused, m}; }
[[noreturn]] void truncated() {
  throw Failure{kCorrupt, "image file is truncated"};
}

std::string hex2(int v) {
  char b[8];
  std::snprintf(b, sizeof b, "%02X", v & 0xFF);
  return b;
}

// zigzag position -> natural (row-major) position; a corrupt run past
// the end lands on 63, as with libjpeg's jpeg_natural_order
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The tables of JPEG Annex K.3, which libjpeg-turbo puts in table slots
// 0 and 1 when a file defines none there (jstdhuff.c: Motion-JPEG
// frames omit them).
constexpr uint8_t kStdCounts[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},      // DC luminance
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},   // AC luminance
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},      // DC chrominance
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};  // AC chrominance
constexpr uint8_t kStdDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kFastBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t symbols[256] = {};
  int32_t maxcode[18] = {};  // the largest code of length l, or -1
  int32_t offset[17] = {};   // symbols index of a code of length l minus it
  uint16_t fast[1 << kFastBits] = {};  // (length << 8) | symbol, 0: longer

  // cnt[l - 1]: the codes of length l; sym: the symbols in code order
  void set(const uint8_t* cnt, const uint8_t* sym, bool is_dc) {
    defined = true;
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += cnt[l - 1];
    if (total > 256) corrupt("bad Huffman table (more than 256 codes)");
    std::memcpy(symbols, sym, total);
    if (is_dc)
      for (int i = 0; i < total; ++i)
        if (symbols[i] > 15) corrupt("bad Huffman table (DC symbol > 15)");
    std::memset(fast, 0, sizeof fast);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      offset[l] = k - code;
      for (int i = 0; i < cnt[l - 1]; ++i, ++code, ++k) {
        // no code may be all ones (libjpeg's jpeg_make_d_derived_tbl)
        if (code + 1 >= (1 << l)) corrupt("bad Huffman table (code overflow)");
        if (l <= kFastBits) {
          const int lo = code << (kFastBits - l);
          const int hi = (code + 1) << (kFastBits - l);
          for (int j = lo; j < hi; ++j) fast[j] = uint16_t((l << 8) | symbols[k]);
        }
      }
      maxcode[l] = cnt[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
  }
};

// The entropy-coded bytes of a scan, read MSB first into a 64-bit
// buffer. 0xFF 0x00 is a data byte 0xFF; any other marker stops the
// reading, after which zero bits are fed and counted as `fake`: a decode
// that consumes one of them ran past the end of its segment.
struct BitReader {
  const uint8_t* data = nullptr;
  size_t n = 0, pos = 0;
  uint64_t buf = 0;
  int bits = 0;
  int fake = 0;
  int marker = 0;          // the code of the marker reached, -1 at the end
  size_t marker_pos = 0;   // where its 0xFF is

  void reset(size_t at) {
    pos = at;
    buf = 0;
    bits = fake = marker = 0;
  }

  void fill() {
    while (bits <= 56) {
      unsigned byte = 0;
      if (marker) {
        fake += 8;
      } else if (pos >= n) {
        marker = -1;
        fake += 8;
      } else if (data[pos] != 0xFF) {
        byte = data[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && data[q] == 0xFF) ++q;
        if (q >= n) {
          marker = -1;
          fake += 8;
        } else if (data[q] == 0) {
          byte = 0xFF;
          pos = q + 1;
        } else {
          marker = data[q];
          marker_pos = pos;
          fake += 8;
        }
      }
      buf |= uint64_t(byte) << (56 - bits);
      bits += 8;
    }
  }

  uint32_t get(int s) {  // 1 <= s <= 16, with bits >= s
    const uint32_t v = uint32_t(buf >> (64 - s));
    buf <<= s;
    bits -= s;
    return v;
  }

  int decode(const Huffman& h) {  // with bits >= 32
    const uint16_t f = h.fast[buf >> (64 - kFastBits)];
    if (f) {
      const int l = f >> 8;
      buf <<= l;
      bits -= l;
      return f & 0xFF;
    }
    for (int l = kFastBits + 1; l <= 16; ++l) {
      const int32_t code = int32_t(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        bits -= l;
        return h.symbols[h.offset[l] + code];
      }
    }
    overrun();
    corrupt("corrupt JPEG data (bad Huffman code)");
  }

  // raises if the decode consumed bits past the end of the segment
  void overrun() const {
    if (bits >= fake) return;
    if (marker == -1) truncated();
    corrupt("corrupt JPEG data (premature end of data segment)");
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? int(v) - (1 << s) + 1 : int(v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // Huffman tables of the scan
  int bw = 0, bh = 0;  // blocks decoded across and down
  int dw = 0, dh = 0;  // samples across and down
  std::vector<int16_t> coef;  // bh x bw blocks of 64, natural order
};

struct Jpeg {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, sof = 0;
  int hmax = 1, vmax = 1;
  Component comp[4];
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int scan[4] = {};
  int nscan = 0;
  int mcux = 0, mcuy = 0;

  Jpeg(const uint8_t* d, size_t len) : data(d), n(len) {}

  int byte() {
    if (pos >= n) truncated();
    return data[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // libjpeg's next_marker: bytes before a 0xFF and 0xFF 0x00 pairs are
  // skipped, 0xFF fill bytes are skipped
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // the segment's body [start, end); pos moves past it
  size_t segment(size_t* end) {
    const int len = word();
    if (len < 2) corrupt("bad JPEG segment length");
    const size_t start = pos;
    *end = start + size_t(len - 2);
    if (*end > n) truncated();
    pos = *end;
    return start;
  }

  void read_sof(int m) {
    if (sof) corrupt("two SOF markers");
    sof = m;
    size_t end;
    size_t p = segment(&end);
    if (end - p < 6) corrupt("bad SOF length");
    const int precision = data[p];
    height = (data[p + 1] << 8) | data[p + 2];
    width = (data[p + 3] << 8) | data[p + 4];
    ncomp = data[p + 5];
    if (precision == 12) refuse("12-bit JPEG; the port reads 8-bit samples only");
    if (precision != 8) corrupt("bad JPEG sample precision " + std::to_string(precision));
    if (height == 0) refuse("JPEG with its height in a DNL marker; the port reads no DNL");
    if (width == 0) corrupt("empty JPEG image (width 0)");
    if (ncomp == 0) corrupt("JPEG frame with no components");
    if (ncomp != 1 && ncomp != 3)
      refuse(std::to_string(ncomp) + "-component JPEG (" +
             (ncomp == 4 ? "CMYK or YCCK" : "neither grey nor YCbCr") +
             "); the port reads grey and YCbCr only");
    if (end - p != size_t(6 + 3 * ncomp)) corrupt("bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      const uint8_t* c = data + p + 6 + 3 * i;
      comp[i].id = c[0];
      comp[i].h = c[1] >> 4;
      comp[i].v = c[1] & 15;
      comp[i].tq = c[2];
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4)
        corrupt("bad JPEG sampling factors");
      if (comp[i].tq > 3) corrupt("bad JPEG quantisation table index");
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
  }

  void read_dqt() {
    size_t end;
    size_t p = segment(&end);
    while (p < end) {
      const int pq = data[p] >> 4, tq = data[p] & 15;
      ++p;
      if (tq > 3) corrupt("bad DQT table index");
      const size_t size = pq ? 128 : 64;
      if (end - p < size) corrupt("bad DQT length");
      for (int k = 0; k < 64; ++k)
        quant[tq][kNatural[k]] =
            pq ? uint16_t((data[p + 2 * k] << 8) | data[p + 2 * k + 1])
               : data[p + k];
      quant_defined[tq] = true;
      p += size;
    }
  }

  void read_dht() {
    size_t end;
    size_t p = segment(&end);
    while (p < end) {
      const int index = data[p++];
      if ((index & 0xEC) != 0) corrupt("bad DHT table index");
      if (end - p < 16) corrupt("bad DHT length");
      int total = 0;
      for (int i = 0; i < 16; ++i) total += data[p + i];
      if (total > 256 || size_t(16 + total) > end - p) corrupt("bad DHT length");
      Huffman& h = (index & 0x10) ? ac[index & 3] : dc[index & 3];
      h.set(data + p, data + p + 16, !(index & 0x10));
      p += 16 + total;
    }
  }

  void read_app(int m) {
    size_t end;
    const size_t p = segment(&end);
    const size_t len = end - p;
    if (m == 0xE0 && len >= 14 && std::memcmp(data + p, "JFIF\0", 5) == 0)
      jfif = true;
    if (m == 0xEE && len >= 12 && std::memcmp(data + p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[p + 11];
    }
  }

  void read_sos() {
    if (!sof) corrupt("SOS before SOF");
    size_t end;
    const size_t p = segment(&end);
    if (end - p < 1) corrupt("bad SOS length");
    nscan = data[p];
    if (nscan < 1 || nscan > 4 || end - p != size_t(4 + 2 * nscan))
      corrupt("bad SOS length");
    for (int i = 0; i < nscan; ++i) {
      const int id = data[p + 1 + 2 * i], tables = data[p + 2 + 2 * i];
      int ci = 0;
      while (ci < ncomp && comp[ci].id != id) ++ci;
      if (ci == ncomp) corrupt("SOS names no frame component");
      for (int j = 0; j < i; ++j)
        if (scan[j] == ci) corrupt("SOS names a component twice");
      if ((tables >> 4) > 3 || (tables & 15) > 3) corrupt("bad SOS table index");
      scan[i] = ci;
      comp[ci].td = tables >> 4;
      comp[ci].ta = tables & 15;
    }
    if (nscan != ncomp)
      refuse("JPEG with one scan a component (" + std::to_string(nscan) +
             " of " + std::to_string(ncomp) +
             " in the first scan); the port reads one interleaved scan");
  }

  // up to and including the first SOS, then checks what the decode needs
  void parse_header() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG file");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: read_sof(m); break;
        case 0xC2: refuse("progressive JPEG (SOF2); the port reads baseline and extended sequential JPEG only");
        case 0xC3: refuse("lossless JPEG (SOF3); the port reads baseline and extended sequential JPEG only");
        case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
          refuse("hierarchical JPEG (marker FF" + hex2(m) + "); the port reads baseline and extended sequential JPEG only");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          refuse("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + "); the port reads Huffman-coded JPEG only");
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: {
          size_t end;
          const size_t p = segment(&end);
          if (end - p != 2) corrupt("bad DRI length");
          restart = (data[p] << 8) | data[p + 1];
          break;
        }
        case 0xDA: read_sos(); check(); return;
        case 0xD8: corrupt("two SOI markers");
        case 0xD9: corrupt("JPEG ends before its image (EOI before SOS)");
        case 0xDC: refuse("DNL marker; the port reads no DNL");
        case 0xCC: case 0xFE: { size_t end; segment(&end); break; }
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
        case 0xD6: case 0xD7: case 0x01: break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
            break;
          }
          corrupt("unknown JPEG marker FF" + hex2(m));
      }
    }
  }

  void check() {
    if (ncomp == 3) {
      bool rgb;
      if (jfif) rgb = false;
      else if (adobe) rgb = adobe_transform == 0;
      else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
      if (rgb)
        refuse("RGB JPEG (Adobe transform 0 or components 'R' 'G' 'B'); the port reads YCbCr and grey only");
    }
    int blocks = 0;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        corrupt("JPEG sampling ratio that is not integral (libjpeg reads none)");
      if (!quant_defined[c.tq]) corrupt("JPEG quantisation table not defined");
      // libjpeg-turbo fills the undefined slots 0 and 1 with Annex K's
      if (!dc[c.td].defined) {
        if (c.td > 1) corrupt("JPEG Huffman table not defined");
        dc[c.td].set(kStdCounts[2 * c.td], kStdDc, true);
      }
      if (!ac[c.ta].defined) {
        if (c.ta > 1) corrupt("JPEG Huffman table not defined");
        ac[c.ta].set(kStdCounts[2 * c.ta + 1],
                     c.ta ? kStdAcChroma : kStdAcLuma, false);
      }
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      blocks += c.h * c.v;
    }
    if (ncomp > 1) {
      if (blocks > 10) corrupt("JPEG MCU of more than 10 blocks");
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int i = 0; i < ncomp; ++i) {
        comp[i].bw = mcux * comp[i].h;
        comp[i].bh = mcuy * comp[i].v;
      }
    } else {
      comp[0].bw = (comp[0].dw + 7) / 8;
      comp[0].bh = (comp[0].dh + 7) / 8;
      mcux = comp[0].bw;
      mcuy = comp[0].bh;
    }
  }

  // the next marker at or after the reader's position
  static void seek_marker(BitReader& br) {
    if (br.marker) return;
    size_t p = br.pos;
    for (;;) {
      while (p < br.n && br.data[p] != 0xFF) ++p;
      size_t q = p + 1;
      while (q < br.n && br.data[q] == 0xFF) ++q;
      if (q >= br.n) {
        br.marker = -1;
        return;
      }
      if (br.data[q] != 0) {
        br.marker = br.data[q];
        br.marker_pos = p;
        return;
      }
      p = q + 1;
    }
  }

  static void decode_block(BitReader& br, const Huffman& dc,
                           const Huffman& ac, int* pred, int16_t* blk) {
    if (br.bits < 32) br.fill();
    int s = br.decode(dc);
    int diff = 0;
    if (s) diff = extend(br.get(s), s);
    *pred = int(unsigned(*pred) + unsigned(diff));
    blk[0] = int16_t(*pred);
    for (int k = 1; k < 64; ++k) {
      if (br.bits < 32) br.fill();
      const int rs = br.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_scan() {
    for (int i = 0; i < ncomp; ++i)
      comp[i].coef.assign(size_t(comp[i].bw) * comp[i].bh * 64, 0);
    BitReader br;
    br.data = data;
    br.n = n;
    br.reset(pos);
    int pred[4] = {0, 0, 0, 0};
    const int64_t total = int64_t(mcux) * mcuy;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart && m && m % restart == 0) {
        br.overrun();
        seek_marker(br);
        if (br.marker == -1) truncated();
        if (br.marker != 0xD0 + next_rst)
          corrupt("corrupt JPEG data (RST" + std::to_string(next_rst) +
                  " expected, marker FF" + hex2(br.marker) + " found)");
        next_rst = (next_rst + 1) & 7;
        br.reset(br.marker_pos + 2);
        std::fill(pred, pred + 4, 0);
      }
      const int my = int(m / mcux), mx = int(m % mcux);
      for (int s = 0; s < nscan; ++s) {
        Component& c = comp[scan[s]];
        const int h = ncomp > 1 ? c.h : 1, v = ncomp > 1 ? c.v : 1;
        for (int by = 0; by < v; ++by)
          for (int bx = 0; bx < h; ++bx) {
            const size_t b = size_t(my * v + by) * c.bw + size_t(mx * h + bx);
            decode_block(br, dc[c.td], ac[c.ta], &pred[scan[s]],
                         c.coef.data() + b * 64);
          }
      }
      br.overrun();
    }
    seek_marker(br);
    if (br.marker == -1) truncated();
    pos = br.marker_pos;
  }

  // the markers after the scan, up to EOI
  void finish() {
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) return;
      if (m == 0xDC) refuse("DNL marker; the port reads no DNL");
      if (m == 0xDA) corrupt("a second scan in a sequential JPEG");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD8 || (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC))
        corrupt("marker FF" + hex2(m) + " after the scan");
      size_t end;
      segment(&end);
    }
  }
};

// jidctint.c's jpeg_idct_islow on one block, into 8 rows of `out`
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
constexpr int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range-limit table: the value taken & 1023 as a
// 10-bit signed number, plus 128, clamped to 0..255
inline uint8_t range_limit(int64_t x) {
  const int s = (int(x & 1023) ^ 512) - 512;
  return uint8_t(std::min(std::max(s + 128, 0), 255));
}

// the 1-D transform of both passes; in[k] holds coefficient k
inline void idct_1d(const int64_t* in, int64_t* out8) {
  int64_t z2 = in[2], z3 = in[6];
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
  int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  z2 = in[0];
  z3 = in[4];
  int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
  int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7];
  tmp1 = in[5];
  tmp2 = in[3];
  tmp3 = in[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  const int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out8[0] = tmp10 + tmp3;
  out8[7] = tmp10 - tmp3;
  out8[1] = tmp11 + tmp2;
  out8[6] = tmp11 - tmp2;
  out8[2] = tmp12 + tmp1;
  out8[5] = tmp12 - tmp1;
  out8[3] = tmp13 + tmp0;
  out8[4] = tmp13 - tmp0;
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int32_t ws[64];
  int64_t in[8], res[8];
  for (int col = 0; col < 8; ++col) {
    for (int k = 0; k < 8; ++k)
      in[k] = int64_t(int32_t(coef[8 * k + col]) * int32_t(q[8 * k + col]));
    idct_1d(in, res);
    for (int k = 0; k < 8; ++k)
      ws[8 * k + col] = int32_t(descale(res[k], CONST_BITS - PASS1_BITS));
  }
  for (int row = 0; row < 8; ++row) {
    for (int k = 0; k < 8; ++k) in[k] = ws[8 * row + k];
    idct_1d(in, res);
    uint8_t* o = out + row * stride;
    for (int k = 0; k < 8; ++k)
      o[k] = range_limit(descale(res[k], CONST_BITS + PASS1_BITS + 3));
  }
}

struct Plane {
  std::vector<uint8_t> px;
  int w = 0, h = 0;  // stride and rows: the decoded blocks' samples
};

Plane reconstruct(const Jpeg& j, const Component& c) {
  Plane p;
  p.w = c.bw * 8;
  p.h = c.bh * 8;
  p.px.resize(size_t(p.w) * p.h);
  const uint16_t* q = j.quant[c.tq];
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, q,
                 p.px.data() + size_t(by) * 8 * p.w + bx * 8, size_t(p.w));
  return p;
}

// output row y of component c at full resolution (jdsample.c), into out
void upsample_row(const Component& c, const Plane& p, int hr, int vr, int y,
                  int width, uint8_t* out, std::vector<int>& colsum,
                  std::vector<uint8_t>& wide) {
  const int dw = c.dw, dh = c.dh;
  const uint8_t* row = p.px.data() + size_t(y / vr) * p.w;
  if (hr == 1 && vr == 1) {
    std::memcpy(out, row, width);
    return;
  }
  if (vr == 2 && (hr == 1 || (hr == 2 && dw > 2))) {
    const int near = y >> 1;
    const int far = (y & 1) ? std::min(near + 1, dh - 1) : std::max(near - 1, 0);
    const uint8_t* a = p.px.data() + size_t(near) * p.w;
    const uint8_t* b = p.px.data() + size_t(far) * p.w;
    if (hr == 1) {  // h1v2_fancy_upsample
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x) out[x] = uint8_t((3 * a[x] + b[x] + bias) >> 2);
      return;
    }
    // h2v2_fancy_upsample
    colsum.resize(dw);
    for (int i = 0; i < dw; ++i) colsum[i] = 3 * a[i] + b[i];
    wide.resize(2 * size_t(dw));
    uint8_t* o = wide.data();
    o[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
    for (int i = 0; i < dw - 1; ++i) {
      o[2 * i + 1] = uint8_t((colsum[i] * 3 + colsum[i + 1] + 7) >> 4);
      o[2 * i + 2] = uint8_t((colsum[i + 1] * 3 + colsum[i] + 8) >> 4);
    }
    o[2 * dw - 1] = uint8_t((colsum[dw - 1] * 4 + 7) >> 4);
    std::memcpy(out, o, width);
    return;
  }
  if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
    wide.resize(2 * size_t(dw));
    uint8_t* o = wide.data();
    o[0] = row[0];
    for (int i = 0; i < dw - 1; ++i) {
      o[2 * i + 1] = uint8_t((row[i] * 3 + row[i + 1] + 2) >> 2);
      o[2 * i + 2] = uint8_t((row[i + 1] * 3 + row[i] + 1) >> 2);
    }
    o[2 * dw - 1] = row[dw - 1];
    std::memcpy(out, o, width);
    return;
  }
  for (int x = 0; x < width; ++x) out[x] = row[x / hr];  // replication
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {  // jdcolor.c's build_ycc_rgb_table
    constexpr int64_t one_half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((91881 * x + one_half) >> 16);   // FIX(1.40200)
      cb_b[i] = int((116130 * x + one_half) >> 16);  // FIX(1.77200)
      cr_g[i] = -46802 * x;                          // FIX(0.71414)
      cb_g[i] = -22554 * x + one_half;               // FIX(0.34414)
    }
  }
};

inline uint8_t clamp255(int v) { return uint8_t(std::min(std::max(v, 0), 255)); }

void decode_pixels(Jpeg& j, uint8_t* out) {
  const int W = j.width, H = j.height;
  if (j.ncomp == 1) {
    const Plane p = reconstruct(j, j.comp[0]);
    for (int y = 0; y < H; ++y)
      std::memcpy(out + size_t(y) * W, p.px.data() + size_t(y) * p.w, W);
    return;
  }
  Plane planes[3];
  for (int i = 0; i < 3; ++i) {
    planes[i] = reconstruct(j, j.comp[i]);
    j.comp[i].coef.clear();
    j.comp[i].coef.shrink_to_fit();
  }
  const ColorTables t;
  std::vector<uint8_t> rows(3 * size_t(W));
  std::vector<int> colsum;
  std::vector<uint8_t> wide;
  for (int y = 0; y < H; ++y) {
    for (int i = 0; i < 3; ++i)
      upsample_row(j.comp[i], planes[i], j.hmax / j.comp[i].h,
                   j.vmax / j.comp[i].v, y, W, rows.data() + size_t(i) * W,
                   colsum, wide);
    const uint8_t* Y = rows.data();
    const uint8_t* Cb = Y + W;
    const uint8_t* Cr = Cb + W;
    uint8_t* o = out + size_t(y) * W * 3;
    for (int x = 0; x < W; ++x) {
      const int yy = Y[x], cb = Cb[x], cr = Cr[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

int fail(const Failure& f, char* message, int64_t message_len) {
  if (message && message_len > 0) {
    std::strncpy(message, f.message.c_str(), size_t(message_len) - 1);
    message[message_len - 1] = 0;
  }
  return f.status;
}

}  // namespace

extern "C" {

// Parses up to the first SOS and checks that the port reads the file.
// info receives 8 + 8 x 4 int32: width, height, components, h_max,
// v_max, restart interval, SOF marker (0xC0 / 0xC1), then for each
// component id, h, v, quantisation table, blocks across, blocks down,
// samples across, samples down. quant receives the 4 x 64 tables of the
// components (natural order). Returns 0, 1 (corrupt or truncated) or 2
// (refused), with the reason in message.
int32_t jpeg_header(const uint8_t* data, int64_t n, int32_t* info,
                    uint16_t* quant, char* message, int64_t message_len) {
  try {
    Jpeg j(data, size_t(n));
    j.parse_header();
    const int32_t head[8] = {j.width, j.height, j.ncomp, j.hmax,
                             j.vmax, j.restart, j.sof, 0};
    std::memcpy(info, head, sizeof head);
    for (int i = 0; i < j.ncomp; ++i) {
      const Component& c = j.comp[i];
      const int32_t row[8] = {c.id, c.h, c.v, c.tq, c.bw, c.bh, c.dw, c.dh};
      std::memcpy(info + 8 + 8 * i, row, sizeof row);
      std::memcpy(quant + 64 * i, j.quant[c.tq], 64 * sizeof(uint16_t));
    }
    return 0;
  } catch (const Failure& f) {
    return fail(f, message, message_len);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, message, message_len);
  }
}

// Decodes the whole file into out: height x width x components bytes,
// grey or RGB. Returns as jpeg_header does.
int32_t jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                    char* message, int64_t message_len) {
  try {
    Jpeg j(data, size_t(n));
    j.parse_header();
    j.decode_scan();
    j.finish();
    decode_pixels(j, out);
    return 0;
  } catch (const Failure& f) {
    return fail(f, message, message_len);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, message, message_len);
  }
}

// The quantised coefficients, before the IDCT: for each component in
// frame order, blocks down x blocks across x 64 int16 (natural order),
// one after the other in out. Returns as jpeg_header does.
int32_t jpeg_coefficients(const uint8_t* data, int64_t n, int16_t* out,
                          char* message, int64_t message_len) {
  try {
    Jpeg j(data, size_t(n));
    j.parse_header();
    j.decode_scan();
    j.finish();
    for (int i = 0; i < j.ncomp; ++i) {
      std::memcpy(out, j.comp[i].coef.data(),
                  j.comp[i].coef.size() * sizeof(int16_t));
      out += j.comp[i].coef.size();
    }
    return 0;
  } catch (const Failure& f) {
    return fail(f, message, message_len);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, message, message_len);
  }
}

}  // extern "C"
