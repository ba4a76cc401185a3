// Baseline JPEG writer for the port (data/jpeg.py: encode_jpeg).
//
// The JAX package writes GroZi-120's extracted video frames with
// cv2.imwrite, and the card's machine has no cv2. This file writes the
// bytes that cv2.imwrite / cv2.imencode(".jpg") write at OpenCV's
// defaults through libjpeg-turbo, step by step:
//
//   - quality 95: the tables of JPEG Annex K.1 scaled by jcparam.c's
//     jpeg_quality_scaling (200 - 2 * 95 = 10 %) and clamped to 1..255;
//   - jccolor.c's RGB -> YCbCr tables (SCALEBITS 16, the Cb / Cr rounding
//     fudge of 0.5 - epsilon); grey is written as one component;
//   - 4:2:0: jcsample.c's h2v2_downsample with its alternating bias 1, 2
//     along a row, the full-resolution rows first padded to an even count
//     by repeating the last row (jcprepct.c) and the columns to two
//     chroma blocks' width by repeating the last column
//     (expand_right_edge); luma keeps its samples, its columns padded to
//     whole blocks the same way; the rows of each component padded to
//     whole blocks by repeating its last row;
//   - jfdctint.c's jpeg_fdct_islow on the samples minus 128, then
//     jcdctmgr.c's quantisation by reciprocal (compute_reciprocal and
//     quantize, DCTELEM 16 bits as in a SIMD build);
//   - jccoefct.c's dummy blocks where the image does not fill an MCU:
//     all AC zero, the DC of the block before it in the MCU;
//   - jchuff.c with the standard Huffman tables (Annex K.3, no
//     optimisation), 0xFF bytes stuffed, the last byte padded with ones;
//   - jcmarker.c's markers: SOI, JFIF APP0 1.01 (no units, density 1:1),
//     one DQT a table, SOF0, one DHT a table in the order the scan's
//     components first use them, SOS, EOI.
//
// Host code, built with g++ into a shared library with a plain C
// interface and loaded with ctypes (_build.py). It keeps no mutable
// global state. This replaces no TPU kernel: the JAX package writes with
// cv2 on the host. The tests hold it against cv2.imencode byte for byte.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural order (jcparam.c's std_luminance_quant_tbl and
// std_chrominance_quant_tbl)
constexpr int kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};
constexpr int kQuality = 95;

// Annex K.3: code counts by length, then the symbols (jcparam.c's
// std_huff_tables)
constexpr uint8_t kDcCounts[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kDcSymbols[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcCounts[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kAcSymbols[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// jcparam.c's jpeg_add_quant_table at quality 95, natural order
void quant_table(int which, uint16_t* q) {
  const long scale = 200 - 2 * kQuality;  // quality 50 and above
  for (int i = 0; i < 64; ++i) {
    long t = (kStdQuant[which][i] * scale + 50) / 100;
    q[i] = uint16_t(std::min(std::max(t, 1L), 255L));
  }
}

// jcdctmgr.c's compute_reciprocal for a divisor of quantval << 3 and
// DCTELEM of 16 bits
struct Divisor {
  uint16_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return Divisor{1, 0, -16};
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  const uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{uint16_t(fq), uint16_t(c), r - 16};
}

// jfdctint.c's jpeg_fdct_islow, in place on 64 samples minus 128
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

// one pass over 8 values d[0], d[step], ...; the even outputs of the
// first pass are shifted up, the rest descaled by `bits`
void fdct_1d(int32_t* d, int step, bool first) {
  const int64_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
  const int64_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
  const int64_t tmp2 = d[2 * step] + d[5 * step];
  const int64_t tmp5 = d[2 * step] - d[5 * step];
  const int64_t tmp3 = d[3 * step] + d[4 * step];
  const int64_t tmp4 = d[3 * step] - d[4 * step];
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int bits = first ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
  if (first) {
    d[0] = int32_t((tmp10 + tmp11) * (1 << PASS1_BITS));
    d[4 * step] = int32_t((tmp10 - tmp11) * (1 << PASS1_BITS));
  } else {
    d[0] = int32_t(descale(tmp10 + tmp11, PASS1_BITS));
    d[4 * step] = int32_t(descale(tmp10 - tmp11, PASS1_BITS));
  }
  int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
  d[2 * step] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, bits));
  d[6 * step] = int32_t(descale(z1 + tmp12 * -FIX_1_847759065, bits));
  z1 = tmp4 + tmp7;
  int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int64_t z5 = (z3 + z4) * FIX_1_175875602;
  const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
  const int64_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  d[7 * step] = int32_t(descale(t4 + z1 + z3, bits));
  d[5 * step] = int32_t(descale(t5 + z2 + z4, bits));
  d[3 * step] = int32_t(descale(t6 + z2 + z3, bits));
  d[step] = int32_t(descale(t7 + z1 + z4, bits));
}

// a component's samples, padded to whole blocks, and its quantised blocks
struct Component {
  int id, h, v, table;
  int width, height;  // samples in the buffer: whole blocks
  std::vector<uint8_t> px;
  std::vector<Divisor> div;
  std::vector<int16_t> coef;  // blocks_down x blocks_across x 64, natural

  int across() const { return width / 8; }

  // the FDCT and quantisation of block (by, bx)
  void transform(int by, int bx, int16_t* out) const {
    int32_t d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        d[8 * y + x] = int32_t(px[size_t(by * 8 + y) * width + bx * 8 + x]) - 128;
    for (int r = 0; r < 8; ++r) fdct_1d(d + 8 * r, 1, true);
    for (int c = 0; c < 8; ++c) fdct_1d(d + c, 8, false);
    for (int i = 0; i < 64; ++i) {  // quantize, DCTELEM 16 bits
      int16_t t = int16_t(d[i]);
      const bool neg = t < 0;
      if (neg) t = int16_t(-t);
      uint32_t product = uint32_t(uint16_t(t) + div[i].corr) * div[i].recip;
      product >>= div[i].shift + 16;
      t = int16_t(product);
      out[i] = neg ? int16_t(-t) : t;
    }
  }
};

struct HuffTable {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  // jchuff.c's jpeg_make_c_derived_tbl
  void set(const uint8_t* counts, const uint8_t* symbols) {
    int k = 0, code_value = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code_value) {
        code[symbols[k]] = uint16_t(code_value);
        size[symbols[k]] = uint8_t(l);
      }
      code_value <<= 1;
    }
  }
};

struct Writer {
  std::vector<uint8_t> out;
  uint64_t buffer = 0;
  int bits = 0;

  void byte(int b) { out.push_back(uint8_t(b)); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void put(uint32_t value, int n) {
    if (!n) return;
    buffer = (buffer << n) | (value & ((uint32_t(1) << n) - 1));
    bits += n;
    while (bits >= 8) {
      const int b = int((buffer >> (bits - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      bits -= 8;
    }
  }
  // jchuff.c's flush_bits: pad the last byte with ones
  void flush() {
    put(0x7F, 7);
    bits = 0;
    buffer = 0;
  }
};

inline int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jchuff.c's encode_one_block
void encode_block(Writer& w, const int16_t* blk, int last_dc,
                  const HuffTable& dc, const HuffTable& ac) {
  int t = blk[0] - last_dc, t2 = t;
  if (t < 0) {
    t = -t;
    --t2;
  }
  int n = nbits(t);
  w.put(dc.code[n], dc.size[n]);
  w.put(uint32_t(t2), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    t = blk[kNatural[k]];
    if (t == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      --t2;
    }
    n = nbits(t);
    const int sym = (run << 4) + n;
    w.put(ac.code[sym], ac.size[sym]);
    w.put(uint32_t(t2), n);
    run = 0;
  }
  if (run > 0) w.put(ac.code[0], ac.size[0]);
}

// jccolor.c's rgb_ycc_start tables (SCALEBITS 16)
struct YccTables {
  int64_t t[8 * 256];
  YccTables() {
    constexpr int64_t half = int64_t(1) << 15, offset = int64_t(128) << 16;
    for (int64_t i = 0; i < 256; ++i) {
      t[i] = 19595 * i;                              // FIX(0.29900)
      t[256 + i] = 38470 * i;                        // FIX(0.58700)
      t[512 + i] = 7471 * i + half;                  // FIX(0.11400)
      t[768 + i] = -11059 * i;                       // FIX(0.16874)
      t[1024 + i] = -21709 * i;                      // FIX(0.33126)
      t[1280 + i] = 32768 * i + offset + half - 1;   // FIX(0.5): B->Cb, R->Cr
      t[1536 + i] = -27439 * i;                      // FIX(0.41869)
      t[1792 + i] = -5329 * i;                       // FIX(0.08131)
    }
  }
};

void write_markers(Writer& w, const std::vector<Component>& comps,
                   const uint16_t quant[2][64], int height, int width) {
  w.word(0xFFD8);
  // JFIF APP0
  static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  w.word(0xFFE0);
  w.word(16);
  for (uint8_t b : jfif) w.byte(b);
  const int ntables = comps.size() > 1 ? 2 : 1;
  for (int t = 0; t < ntables; ++t) {
    w.word(0xFFDB);
    w.word(67);
    w.byte(t);
    for (int k = 0; k < 64; ++k) w.byte(quant[t][kNatural[k]]);
  }
  w.word(0xFFC0);
  w.word(8 + 3 * int(comps.size()));
  w.byte(8);
  w.word(height);
  w.word(width);
  w.byte(int(comps.size()));
  for (const Component& c : comps) {
    w.byte(c.id);
    w.byte((c.h << 4) | c.v);
    w.byte(c.table);
  }
  for (int t = 0; t < ntables; ++t) {
    for (int ac = 0; ac < 2; ++ac) {
      const uint8_t* counts = ac ? kAcCounts[t] : kDcCounts[t];
      int total = 0;
      for (int l = 0; l < 16; ++l) total += counts[l];
      w.word(0xFFC4);
      w.word(2 + 1 + 16 + total);
      w.byte((ac << 4) | t);
      for (int l = 0; l < 16; ++l) w.byte(counts[l]);
      const uint8_t* symbols = ac ? kAcSymbols[t] : kDcSymbols;
      for (int i = 0; i < total; ++i) w.byte(symbols[i]);
    }
  }
  w.word(0xFFDA);
  w.word(6 + 2 * int(comps.size()));
  w.byte(int(comps.size()));
  for (const Component& c : comps) {
    w.byte(c.id);
    w.byte((c.table << 4) | c.table);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);
}

std::vector<uint8_t> encode(const uint8_t* px, int height, int width,
                            int channels) {
  uint16_t quant[2][64];
  quant_table(0, quant[0]);
  quant_table(1, quant[1]);
  const bool colour = channels == 3;
  const int hmax = colour ? 2 : 1, vmax = hmax;
  const int mcu_across = (width + 8 * hmax - 1) / (8 * hmax);
  const int mcu_down = (height + 8 * vmax - 1) / (8 * vmax);
  const YccTables t;
  std::vector<Component> comps;
  // luma, or grey: the samples, padded to whole blocks by repeating the
  // last column and the last row
  {
    Component y{1, hmax, vmax, 0, (width + 7) / 8 * 8, (height + 7) / 8 * 8, {}, {}, {}};
    y.px.resize(size_t(y.width) * y.height);
    for (int r = 0; r < y.height; ++r) {
      const uint8_t* src = px + size_t(std::min(r, height - 1)) * width * channels;
      uint8_t* dst = y.px.data() + size_t(r) * y.width;
      for (int x = 0; x < y.width; ++x) {
        const uint8_t* p = src + size_t(std::min(x, width - 1)) * channels;
        dst[x] = colour ? uint8_t((t.t[p[0]] + t.t[256 + p[1]] + t.t[512 + p[2]]) >> 16)
                        : p[0];
      }
    }
    comps.push_back(std::move(y));
  }
  if (colour) {
    // jcprepct.c + h2v2_downsample: full-resolution rows padded to an
    // even count and columns to the chroma blocks' width, both by
    // repetition, averaged 2x2 with the bias 1, 2, 1, ... along a row
    const int cw = (width + 15) / 16 * 8, rows = (height + 1) / 2;
    const int ch = (height + 15) / 16 * 8;
    for (int ci = 0; ci < 2; ++ci) {
      Component c{2 + ci, 1, 1, 1, cw, ch, {}, {}, {}};
      c.px.resize(size_t(cw) * ch);
      const int64_t* tr = t.t + (ci ? 1280 : 768);
      const int64_t* tg = t.t + (ci ? 1536 : 1024);
      const int64_t* tb = t.t + (ci ? 1792 : 1280);
      std::vector<uint8_t> full(size_t(2) * cw * 2);
      for (int r = 0; r < rows; ++r) {
        for (int k = 0; k < 2; ++k) {
          const uint8_t* src = px + size_t(std::min(2 * r + k, height - 1)) * width * 3;
          for (int x = 0; x < 2 * cw; ++x) {
            const uint8_t* p = src + size_t(std::min(x, width - 1)) * 3;
            full[size_t(k) * 2 * cw + x] = uint8_t((tr[p[0]] + tg[p[1]] + tb[p[2]]) >> 16);
          }
        }
        uint8_t* dst = c.px.data() + size_t(r) * cw;
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          const uint8_t* a = full.data() + 2 * x;
          const uint8_t* b = a + 2 * cw;
          dst[x] = uint8_t((a[0] + a[1] + b[0] + b[1] + bias) >> 2);
          bias ^= 3;
        }
      }
      for (int r = rows; r < ch; ++r)
        std::memcpy(c.px.data() + size_t(r) * cw, c.px.data() + size_t(rows - 1) * cw, cw);
      comps.push_back(std::move(c));
    }
  }
  for (Component& c : comps) {
    c.div.resize(64);
    for (int i = 0; i < 64; ++i) c.div[i] = reciprocal(uint16_t(quant[c.table][i] << 3));
  }
  HuffTable dc[2], ac[2];
  for (int t = 0; t < 2; ++t) {
    dc[t].set(kDcCounts[t], kDcSymbols);
    ac[t].set(kAcCounts[t], kAcSymbols[t]);
  }
  Writer w;
  w.out.reserve(size_t(width) * height * channels / 4 + 1024);
  write_markers(w, comps, quant, height, width);
  int last_dc[3] = {0, 0, 0};
  int16_t mcu[6][64];
  for (int my = 0; my < mcu_down; ++my) {
    for (int mx = 0; mx < mcu_across; ++mx) {
      int n = 0;
      for (size_t ci = 0; ci < comps.size(); ++ci) {
        const Component& c = comps[ci];
        const int bw = c.across(), bh = c.height / 8;
        const int h = comps.size() > 1 ? c.h : 1, v = comps.size() > 1 ? c.v : 1;
        for (int yy = 0; yy < v; ++yy) {
          const int by = my * v + yy;
          for (int xx = 0; xx < h; ++xx, ++n) {
            const int bx = mx * h + xx;
            if (by < bh && bx < bw) {
              c.transform(by, bx, mcu[n]);
            } else {  // jccoefct.c's dummy blocks
              std::memset(mcu[n], 0, sizeof mcu[n]);
              mcu[n][0] = by < bh ? mcu[n - 1][0] : mcu[n - xx - 1][0];
            }
          }
        }
      }
      n = 0;
      for (size_t ci = 0; ci < comps.size(); ++ci) {
        const Component& c = comps[ci];
        const int blocks = comps.size() > 1 ? c.h * c.v : 1;
        for (int b = 0; b < blocks; ++b, ++n) {
          encode_block(w, mcu[n], last_dc[ci], dc[c.table], ac[c.table]);
          last_dc[ci] = mcu[n][0];
        }
      }
    }
  }
  w.flush();
  w.word(0xFFD9);
  return std::move(w.out);
}

}  // namespace

extern "C" {

// Encodes height x width x channels (1 grey, 3 RGB) uint8 samples. The
// file's length is returned; its bytes are copied into out when it fits
// in capacity (call again with a larger buffer otherwise). -1: the
// arguments are refused (empty image, more than 65535 rows or columns,
// another channel count).
int64_t jpeg_encode(const uint8_t* px, int32_t height, int32_t width,
                    int32_t channels, uint8_t* out, int64_t capacity) {
  if (height < 1 || width < 1 || height > 65535 || width > 65535 ||
      (channels != 1 && channels != 3))
    return -1;
  const std::vector<uint8_t> data = encode(px, height, width, channels);
  if (int64_t(data.size()) <= capacity) std::memcpy(out, data.data(), data.size());
  return int64_t(data.size());
}

}  // extern "C"
