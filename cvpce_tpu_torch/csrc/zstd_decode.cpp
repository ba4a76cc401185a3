// Zstandard decoder (RFC 8878) for the port's checkpoint reader
// (utils/zstd.py, under utils/ocdbt.py and utils/orbax_read.py).
//
// The JAX package's orbax checkpoints keep every b-tree node, manifest
// and zarr chunk as a zstd frame, and the card's machine has no zstd
// library. This file decodes:
//
//   - zstd frames with raw, RLE and compressed blocks, frames placed back
//     to back, and skippable frames (passed over);
//   - literals that are raw, RLE, Huffman-coded in one or four streams
//     (tree described by FSE-compressed or direct weights) or treeless
//     (the previous block's tree);
//   - sequences whose FSE tables are predefined, RLE, described in the
//     block or repeated from the previous block, with the repeat offsets;
//   - any window size (the whole output stays in memory, so a window only
//     bounds how far back a match may reach), the optional content size
//     (checked against the output) and the content checksum (XXH64,
//     checked where the frame carries one).
//
// A frame that names a dictionary gives status 2 (utils/zstd.py raises
// NotImplementedError naming the ID). Corrupt or truncated input gives
// status 1 (OSError): the decoder never returns short output.
//
// Host code, built with g++ into a shared library with a plain C
// interface and loaded with ctypes (_build.py). It keeps no mutable
// global state, so loader threads may decode at once. This replaces no
// TPU kernel: the JAX package reads its checkpoints through orbax and
// tensorstore, which link the zstd library on the host.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
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
[[noreturn]] void truncated() {
  throw Failure{kCorrupt, "zstd data is truncated"};
}

int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

uint64_t le64(const uint8_t* p) {
  return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32;
}

// ---- XXH64 (the frame's content checksum keeps its low 32 bits) ----

constexpr uint64_t kP1 = 11400714785074694791ULL;
constexpr uint64_t kP2 = 14029467366897019727ULL;
constexpr uint64_t kP3 = 1609587929392839161ULL;
constexpr uint64_t kP4 = 9650029242287828579ULL;
constexpr uint64_t kP5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t v, int r) { return (v << r) | (v >> (64 - r)); }

uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * kP2;
  return rotl(acc, 31) * kP1;
}

uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * kP1 + kP4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, le64(p));
      v2 = xxh_round(v2, le64(p + 8));
      v3 = xxh_round(v3, le64(p + 16));
      v4 = xxh_round(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = kP5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) {
    h ^= xxh_round(0, le64(p));
    h = rotl(h, 27) * kP1 + kP4;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(le32(p)) * kP1;
    h = rotl(h, 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) {
    h ^= uint64_t(*p) * kP5;
    h = rotl(h, 11) * kP1;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---- bit streams ----

// A forward stream, least significant bit first (FSE table
// descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;

  uint32_t peek(int count) const {  // count <= 24
    uint64_t v = 0;
    const size_t byte = bit >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i)
      v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (bit & 7)) & ((1u << count) - 1));
  }
  void skip(int count) {
    bit += count;
    if (bit > 8 * n) truncated();
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// A backward stream (Huffman streams, FSE-coded weights, sequences): the
// last byte's highest set bit marks the end, and bits are read from just
// below it towards the first byte. `pos` counts the bits not yet read;
// reading past the first byte gives zeros and makes pos negative, which
// the callers take as overflow.
struct BackwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;

  BackwardBits(const uint8_t* data, size_t size) : p(data), n(int64_t(size)) {
    if (size == 0) corrupt("empty bit stream");
    const uint8_t last = data[size - 1];
    if (last == 0) corrupt("bit stream lacks its end mark");
    pos = 8 * (n - 1) + highbit(last);
  }

  uint64_t window(int64_t byte) const {
    if (byte + 8 <= n) {
      uint64_t v;
      std::memcpy(&v, p + byte, 8);
      return v;
    }
    uint64_t v = 0;
    for (int64_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return v;
  }

  // the next `count` bits (count <= 56) without consuming them
  uint64_t peek(int count) const {
    if (count == 0) return 0;
    const int64_t lo = pos - count;
    if (lo >= 0)
      return (window(lo >> 3) >> (lo & 7)) & ((uint64_t(1) << count) - 1);
    if (pos <= 0) return 0;
    const uint64_t v = window(0) & ((uint64_t(1) << pos) - 1);
    return v << (-lo);
  }
  uint64_t read(int count) {
    const uint64_t v = peek(count);
    pos -= count;
    return v;
  }
};

// ---- FSE ----

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;
  bool defined = false;

  void build(const int16_t* norm, int nsym, int table_log) {
    log = table_log;
    const int size = 1 << table_log;
    cells.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(nsym);
    int high = size - 1;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        cells[high--].symbol = uint16_t(s);
        next[s] = 1;
      } else {
        next[s] = uint32_t(norm[s]);
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    const int mask = size - 1;
    int position = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        cells[position].symbol = uint16_t(s);
        do {
          position = (position + step) & mask;
        } while (position > high);
      }
    }
    if (position != 0) corrupt("FSE table spread does not close");
    for (int u = 0; u < size; ++u) {
      const int s = cells[u].symbol;
      const uint32_t state = next[s]++;
      const int bits = table_log - highbit(state);
      cells[u].bits = uint8_t(bits);
      cells[u].base = uint16_t((state << bits) - size);
    }
    defined = true;
  }

  void rle(int symbol) {
    log = 0;
    cells.assign(1, FseEntry{uint16_t(symbol), 0, 0});
    defined = true;
  }

  // Reads a table description from `src` (at most `n` bytes) and
  // returns the bytes it takes.
  size_t read(const uint8_t* src, size_t n, int max_symbol, int max_log) {
    if (n == 0) truncated();
    ForwardBits in{src, n};
    const int table_log = int(in.peek(4)) + 5;
    in.skip(4);
    if (table_log > max_log)
      corrupt("FSE table log " + std::to_string(table_log) + " above " +
              std::to_string(max_log));
    int16_t norm[256] = {};
    int remaining = (1 << table_log) + 1;
    int threshold = 1 << table_log;
    int bits = table_log + 1;
    int symbol = 0;
    while (remaining > 1) {
      if (symbol > max_symbol) corrupt("FSE table has too many symbols");
      const int max = (2 * threshold - 1) - remaining;
      int count;
      const uint32_t v = in.peek(bits);
      if (int(v & (threshold - 1)) < max) {
        count = int(v & (threshold - 1));
        in.skip(bits - 1);
      } else {
        count = int(v & (2 * threshold - 1));
        if (count >= threshold) count -= max;
        in.skip(bits);
      }
      --count;
      remaining -= count < 0 ? -count : count;
      norm[symbol++] = int16_t(count);
      if (count == 0) {
        for (;;) {
          const int repeat = int(in.peek(2));
          in.skip(2);
          for (int i = 0; i < repeat; ++i) {
            if (symbol > max_symbol) corrupt("FSE table has too many symbols");
            norm[symbol++] = 0;
          }
          if (repeat != 3) break;
        }
      }
      while (remaining < threshold && threshold > 1) {
        --bits;
        threshold >>= 1;
      }
    }
    if (remaining != 1) corrupt("FSE table probabilities do not add up");
    build(norm, symbol, table_log);
    return in.bytes_used();
  }
};

struct FseState {
  const FseTable* table;
  uint32_t state;

  void init(BackwardBits& in) { state = uint32_t(in.read(table->log)); }
  int symbol() const { return table->cells[state].symbol; }
  void update(BackwardBits& in) {
    const FseEntry& e = table->cells[state];
    state = e.base + uint32_t(in.read(e.bits));
  }
};

// ---- Huffman (literals) ----

struct HuffTable {
  int max_bits = 0;
  std::vector<uint16_t> cells;  // (bits << 8) | symbol
  bool defined = false;

  // Reads a tree description and returns the bytes it takes.
  size_t read(const uint8_t* src, size_t n) {
    if (n == 0) truncated();
    const int head = src[0];
    uint8_t weights[256] = {};
    int count = 0;
    size_t used;
    if (head < 128) {
      // FSE-compressed weights: two interleaved states, one stream
      used = 1 + size_t(head);
      if (used > n) truncated();
      FseTable table;
      const size_t desc = table.read(src + 1, head, 255, 6);
      if (desc >= size_t(head)) corrupt("Huffman weights lack their stream");
      BackwardBits in(src + 1 + desc, head - desc);
      FseState s1{&table, 0}, s2{&table, 0};
      s1.init(in);
      s2.init(in);
      for (;;) {
        if (count > 254) corrupt("too many Huffman weights");
        weights[count++] = uint8_t(s1.symbol());
        s1.update(in);
        if (in.pos < 0) {
          weights[count++] = uint8_t(s2.symbol());
          break;
        }
        if (count > 254) corrupt("too many Huffman weights");
        weights[count++] = uint8_t(s2.symbol());
        s2.update(in);
        if (in.pos < 0) {
          if (count > 254) corrupt("too many Huffman weights");
          weights[count++] = uint8_t(s1.symbol());
          break;
        }
      }
    } else {
      count = head - 127;
      used = 1 + size_t(count + 1) / 2;
      if (used > n) truncated();
      for (int i = 0; i < count; ++i) {
        const uint8_t b = src[1 + i / 2];
        weights[i] = (i % 2 == 0) ? b >> 4 : b & 15;
      }
    }
    uint32_t total = 0;
    for (int i = 0; i < count; ++i) {
      if (weights[i] > 12) corrupt("Huffman weight above 12");
      if (weights[i]) total += 1u << (weights[i] - 1);
    }
    if (total == 0) corrupt("Huffman weights are all zero");
    const int bits = highbit(total) + 1;
    if (bits > 12) corrupt("Huffman codes longer than 12 bits");
    const uint32_t rest = (1u << bits) - total;
    if (rest & (rest - 1)) corrupt("Huffman weights do not complete a tree");
    weights[count++] = uint8_t(highbit(rest) + 1);
    max_bits = bits;
    cells.assign(size_t(1) << bits, 0);
    size_t position = 0;
    for (int w = 1; w <= bits; ++w) {
      const int code_bits = bits + 1 - w;
      const size_t span = size_t(1) << (w - 1);
      for (int s = 0; s < count; ++s) {
        if (weights[s] != w) continue;
        const uint16_t cell = uint16_t(code_bits << 8 | s);
        for (size_t i = 0; i < span; ++i) cells[position++] = cell;
      }
    }
    defined = true;
    return used;
  }

  void decode_stream(const uint8_t* src, size_t n, uint8_t* out,
                     size_t count) const {
    BackwardBits in(src, n);
    const int bits = max_bits;
    const uint64_t mask = (uint64_t(1) << bits) - 1;
    const uint16_t* c = cells.data();
    size_t i = 0;
    // four symbols (at most 48 bits) out of one 56-bit load
    while (i + 4 <= count && in.pos >= 56) {
      const int64_t lo = in.pos - 56;
      const uint64_t v = in.window(lo >> 3) >> (lo & 7);
      int used = 0;
      for (int k = 0; k < 4; ++k) {
        const uint16_t cell = c[(v >> (56 - used - bits)) & mask];
        out[i++] = uint8_t(cell & 0xFF);
        used += cell >> 8;
      }
      in.pos -= used;
    }
    for (; i < count; ++i) {
      const uint16_t cell = c[in.peek(bits)];
      out[i] = uint8_t(cell & 0xFF);
      in.pos -= cell >> 8;
    }
    if (in.pos != 0) corrupt("Huffman stream does not end where it should");
  }
};

// ---- sequences ----

constexpr int kLLMax = 35, kMLMax = 52, kOFMax = 31;

constexpr uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  3,  3,
                                 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, -1, -1, -1, -1, -1};

// The output of the whole call: frames append to it; `limit` caps it
// where the caller knows the size.
struct Output {
  std::vector<uint8_t> buf;
  uint8_t* fixed = nullptr;
  size_t size = 0;
  size_t cap = 0;

  uint8_t* data() { return fixed ? fixed : buf.data(); }
  // room for `extra` more bytes, returning where they go
  uint8_t* reserve(size_t extra) {
    if (size + extra > cap) {
      if (fixed)
        corrupt("zstd data decodes to more than the " + std::to_string(cap) +
                " bytes expected");
      size_t want = cap ? cap : 1 << 16;
      while (want < size + extra) want *= 2;
      buf.resize(want);
      cap = want;
    }
    return data() + size;
  }
};

struct FrameState {
  HuffTable huff;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  size_t frame_start = 0;
  size_t block_max = 0;
  std::vector<uint8_t> literals;
};

size_t read_literals(FrameState& fs, const uint8_t* src, size_t n,
                     size_t* literal_count) {
  if (n == 0) truncated();
  const int type = src[0] & 3;
  const int format = (src[0] >> 2) & 3;
  if (type == 0 || type == 1) {
    size_t header, size;
    if (format == 0 || format == 2) {
      header = 1;
      size = src[0] >> 3;
    } else if (format == 1) {
      header = 2;
      if (n < 2) truncated();
      size = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      header = 3;
      if (n < 3) truncated();
      size = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (size > fs.block_max) corrupt("literals larger than a block");
    fs.literals.resize(size);
    if (type == 0) {
      if (header + size > n) truncated();
      std::memcpy(fs.literals.data(), src + header, size);
      *literal_count = size;
      return header + size;
    }
    if (header + 1 > n) truncated();
    std::memset(fs.literals.data(), src[header], size);
    *literal_count = size;
    return header + 1;
  }
  // Huffman-coded (2) or treeless (3)
  size_t header, size, compressed;
  int streams = format == 0 ? 1 : 4;
  if (format <= 1) {
    header = 3;
    if (n < 3) truncated();
    const uint32_t v = src[0] | uint32_t(src[1]) << 8 | uint32_t(src[2]) << 16;
    size = (v >> 4) & 0x3FF;
    compressed = (v >> 14) & 0x3FF;
  } else if (format == 2) {
    header = 4;
    if (n < 4) truncated();
    const uint32_t v = le32(src);
    size = (v >> 4) & 0x3FFF;
    compressed = (v >> 18) & 0x3FFF;
  } else {
    header = 5;
    if (n < 5) truncated();
    const uint64_t v = le32(src) | uint64_t(src[4]) << 32;
    size = (v >> 4) & 0x3FFFF;
    compressed = (v >> 22) & 0x3FFFF;
  }
  if (size > fs.block_max) corrupt("literals larger than a block");
  if (header + compressed > n) truncated();
  const uint8_t* p = src + header;
  size_t left = compressed;
  if (type == 2) {
    const size_t used = fs.huff.read(p, left);
    p += used;
    left -= used;
  } else if (!fs.huff.defined) {
    corrupt("treeless literals without an earlier Huffman tree");
  }
  fs.literals.resize(size);
  uint8_t* out = fs.literals.data();
  if (streams == 1) {
    fs.huff.decode_stream(p, left, out, size);
  } else {
    if (left < 6) truncated();
    const size_t s1 = p[0] | size_t(p[1]) << 8;
    const size_t s2 = p[2] | size_t(p[3]) << 8;
    const size_t s3 = p[4] | size_t(p[5]) << 8;
    if (6 + s1 + s2 + s3 > left) corrupt("Huffman jump table overruns");
    const size_t s4 = left - 6 - s1 - s2 - s3;
    const size_t quarter = (size + 3) / 4;
    if (3 * quarter > size) corrupt("too few literals for four streams");
    const uint8_t* q = p + 6;
    fs.huff.decode_stream(q, s1, out, quarter);
    fs.huff.decode_stream(q + s1, s2, out + quarter, quarter);
    fs.huff.decode_stream(q + s1 + s2, s3, out + 2 * quarter, quarter);
    fs.huff.decode_stream(q + s1 + s2 + s3, s4, out + 3 * quarter,
                          size - 3 * quarter);
  }
  *literal_count = size;
  return header + compressed;
}

size_t read_table(FseTable& table, int mode, const uint8_t* src, size_t n,
                  const int16_t* defaults, int ndefault, int default_log,
                  int max_symbol, int max_log, const char* name) {
  switch (mode) {
    case 0:
      table.build(defaults, ndefault, default_log);
      return 0;
    case 1:
      if (n < 1) truncated();
      if (src[0] > max_symbol)
        corrupt(std::string("RLE ") + name + " symbol out of range");
      table.rle(src[0]);
      return 1;
    case 2:
      return table.read(src, n, max_symbol, max_log);
    default:
      if (!table.defined)
        corrupt(std::string("repeated ") + name +
                " table without an earlier one");
      return 0;
  }
}

void copy_match(Output& out, uint64_t offset, size_t length) {
  uint8_t* dst = out.data() + out.size;
  const uint8_t* from = dst - offset;
  if (offset >= length) {
    std::memcpy(dst, from, length);
  } else {
    for (size_t i = 0; i < length; ++i) dst[i] = from[i];
  }
  out.size += length;
}

void decode_compressed_block(FrameState& fs, const uint8_t* src, size_t n,
                             Output& out) {
  size_t literal_count = 0;
  const size_t lit_bytes = read_literals(fs, src, n, &literal_count);
  const uint8_t* p = src + lit_bytes;
  size_t left = n - lit_bytes;
  if (left < 1) truncated();
  size_t nseq = p[0];
  size_t head = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (left < 2) truncated();
      nseq = ((nseq - 128) << 8) + p[1];
      head = 2;
    } else {
      if (left < 3) truncated();
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      head = 3;
    }
  }
  p += head;
  left -= head;
  const size_t block_start = out.size;
  const uint8_t* lit = fs.literals.data();
  if (nseq == 0) {
    if (left != 0) corrupt("extra data after an empty sequence section");
    std::memcpy(out.reserve(literal_count), lit, literal_count);
    out.size += literal_count;
    return;
  }
  if (left < 1) truncated();
  const int modes = p[0];
  if (modes & 3) corrupt("reserved bits set in the sequence modes");
  ++p;
  --left;
  size_t used = read_table(fs.ll, modes >> 6, p, left, kLLDefault, 36, 6,
                           kLLMax, 9, "literal length");
  p += used;
  left -= used;
  used = read_table(fs.of, (modes >> 4) & 3, p, left, kOFDefault, 29, 5,
                    kOFMax, 8, "offset");
  p += used;
  left -= used;
  used = read_table(fs.ml, (modes >> 2) & 3, p, left, kMLDefault, 53, 6,
                    kMLMax, 9, "match length");
  p += used;
  left -= used;

  BackwardBits in(p, left);
  FseState ll{&fs.ll, 0}, of{&fs.of, 0}, ml{&fs.ml, 0};
  ll.init(in);
  of.init(in);
  ml.init(in);
  size_t lit_pos = 0;
  uint64_t* rep = fs.rep;
  for (size_t i = 0; i < nseq; ++i) {
    const int of_code = of.symbol();
    const int ml_code = ml.symbol();
    const int ll_code = ll.symbol();
    if (of_code > kOFMax) corrupt("offset code out of range");
    const uint64_t of_value =
        (uint64_t(1) << of_code) + in.read(of_code);
    const size_t match = kMLBase[ml_code] + size_t(in.read(kMLBits[ml_code]));
    const size_t lits = kLLBase[ll_code] + size_t(in.read(kLLBits[ll_code]));
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const uint64_t index = of_value + (lits == 0 ? 1 : 0);
      if (index == 1) {
        offset = rep[0];
      } else if (index == 2) {
        offset = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else if (index == 3) {
        offset = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        offset = rep[0] - 1;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      ll.update(in);
      ml.update(in);
      of.update(in);
    }
    if (in.pos < 0) corrupt("sequence stream overruns");
    if (lits > literal_count - lit_pos) corrupt("sequence takes more literals than the block holds");
    if (out.size - block_start + lits + match > fs.block_max)
      corrupt("block decodes to more than its maximum size");
    uint8_t* dst = out.reserve(lits + match);
    std::memcpy(dst, lit + lit_pos, lits);
    lit_pos += lits;
    out.size += lits;
    if (offset == 0 || offset > out.size - fs.frame_start)
      corrupt("match offset reaches before the frame");
    copy_match(out, offset, match);
  }
  if (in.pos != 0) corrupt("sequence stream does not end where it should");
  const size_t rest = literal_count - lit_pos;
  if (out.size - block_start + rest > fs.block_max)
    corrupt("block decodes to more than its maximum size");
  std::memcpy(out.reserve(rest), lit + lit_pos, rest);
  out.size += rest;
}

// Decodes the frame at src (n bytes left in the input) and returns the
// bytes it took.
size_t decode_frame(const uint8_t* src, size_t n, Output& out) {
  if (n < 4) truncated();
  const uint32_t magic = le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    if (n < 8) truncated();
    const size_t size = le32(src + 4);
    if (8 + size > n) truncated();
    return 8 + size;
  }
  if (magic != 0xFD2FB528u) {
    char b[64];
    std::snprintf(b, sizeof b, "not a zstd frame (magic %08X)", magic);
    corrupt(b);
  }
  size_t at = 4;
  if (at >= n) truncated();
  const int fhd = src[at++];
  const int fcs_flag = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  const bool checksum = (fhd >> 2) & 1;
  const int did_flag = fhd & 3;
  if (fhd & 8) corrupt("reserved bit set in the frame header");
  uint64_t window = 0;
  if (!single) {
    if (at >= n) truncated();
    const int wd = src[at++];
    const int exponent = wd >> 3, mantissa = wd & 7;
    if (10 + exponent > 41) corrupt("window too large");
    const uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  const int did_size = did_flag == 3 ? 4 : did_flag;
  if (at + did_size > n) truncated();
  uint32_t dict = 0;
  for (int i = 0; i < did_size; ++i) dict |= uint32_t(src[at + i]) << (8 * i);
  at += did_size;
  if (dict != 0)
    throw Failure{kRefused, "zstd frame needs dictionary " +
                                std::to_string(dict) +
                                ", and the port decodes no dictionaries"};
  const int fcs_size =
      fcs_flag == 0 ? (single ? 1 : 0) : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
  bool has_size = fcs_size > 0;
  uint64_t content = 0;
  if (at + fcs_size > n) truncated();
  for (int i = 0; i < fcs_size; ++i) content |= uint64_t(src[at + i]) << (8 * i);
  if (fcs_size == 2) content += 256;
  at += fcs_size;
  if (single) window = content;

  FrameState fs;
  fs.frame_start = out.size;
  fs.block_max = size_t(window < (128 << 10) ? window : (128 << 10));
  // a corrupt header may claim any size: take room ahead only up to
  // 256 MiB, and grow past it as the blocks come
  if (has_size) out.reserve(size_t(std::min<uint64_t>(content, 1u << 28)));
  for (;;) {
    if (at + 3 > n) truncated();
    const uint32_t bh = src[at] | uint32_t(src[at + 1]) << 8 |
                        uint32_t(src[at + 2]) << 16;
    at += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) corrupt("reserved block type");
    if (size > fs.block_max) corrupt("block larger than its maximum size");
    if (type == 0) {
      if (at + size > n) truncated();
      std::memcpy(out.reserve(size), src + at, size);
      out.size += size;
      at += size;
    } else if (type == 1) {
      if (at + 1 > n) truncated();
      std::memset(out.reserve(size), src[at], size);
      out.size += size;
      at += 1;
    } else {
      if (at + size > n) truncated();
      decode_compressed_block(fs, src + at, size, out);
      at += size;
    }
    if (has_size && out.size - fs.frame_start > content)
      corrupt("frame decodes to more than its content size");
    if (last) break;
  }
  const size_t produced = out.size - fs.frame_start;
  if (has_size && produced != content)
    corrupt("frame decodes to " + std::to_string(produced) +
            " bytes, its header says " + std::to_string(content));
  if (checksum) {
    if (at + 4 > n) truncated();
    const uint32_t want = le32(src + at);
    at += 4;
    const uint32_t got =
        uint32_t(xxh64(out.data() + fs.frame_start, produced) & 0xFFFFFFFFu);
    if (got != want) corrupt("zstd content checksum mismatch");
  }
  return at;
}

void decode_all(const uint8_t* src, size_t n, Output& out) {
  if (n == 0) truncated();
  size_t at = 0;
  while (at < n) at += decode_frame(src + at, n - at, out);
}

int fail(const Failure& f, char* message, int64_t message_len) {
  if (message_len > 0) {
    const size_t m = std::min(f.message.size(), size_t(message_len - 1));
    std::memcpy(message, f.message.data(), m);
    message[m] = 0;
  }
  return f.status;
}

}  // namespace

extern "C" {

// Decodes every frame of src[0:n] into dst, which holds exactly
// `expected` bytes: output of another size is corrupt. Returns 0, 1
// (corrupt or truncated) or 2 (refused), with the reason in message.
int32_t zstd_decode_into(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t expected, char* message,
                         int64_t message_len) {
  try {
    Output out;
    out.fixed = dst;
    out.cap = size_t(expected);
    decode_all(src, size_t(n), out);
    if (out.size != size_t(expected))
      corrupt("zstd data decodes to " + std::to_string(out.size) +
              " bytes, " + std::to_string(expected) + " expected");
    return 0;
  } catch (const Failure& f) {
    return fail(f, message, message_len);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, message, message_len);
  }
}

// Decodes every frame of src[0:n] into a buffer of its own, whose size
// goes to *size; zstd_take copies it out and frees it. Returns the
// buffer (null on failure, with the status in *status and the reason in
// message).
void* zstd_decode(const uint8_t* src, int64_t n, int64_t* size,
                  int32_t* status, char* message, int64_t message_len) {
  try {
    auto* out = new Output;
    try {
      decode_all(src, size_t(n), *out);
    } catch (...) {
      delete out;
      throw;
    }
    *size = int64_t(out->size);
    *status = 0;
    return out;
  } catch (const Failure& f) {
    *status = fail(f, message, message_len);
  } catch (const std::bad_alloc&) {
    *status = fail(Failure{kCorrupt, "out of memory"}, message, message_len);
  }
  return nullptr;
}

void zstd_take(void* handle, uint8_t* dst) {
  auto* out = static_cast<Output*>(handle);
  std::memcpy(dst, out->data(), out->size);
  delete out;
}

uint64_t zstd_xxh64(const uint8_t* src, int64_t n) {
  return xxh64(src, size_t(n));
}

}  // extern "C"
