// Native record-cache reader: mmap + threaded batched copy.
//
// The data-loader half of the framework's native runtime (the reference
// leans on torch DataLoader worker processes + PIL/cv2 decode for every
// epoch — cvpce/datautils.py throughout). Here the Python pipeline decodes
// and canvas-transforms each image ONCE into a flat binary cache; from the
// second epoch on, batches are served by this reader: pread per record on
// a small thread pool, no JPEG decode, no Python per-item overhead.
//
// File layout: header (magic, record_bytes, n_records) then n_records
// fixed-size records.
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread record_cache.cpp

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x43564345435F5243ULL;  // "CVCEC_RC"

struct Header {
  uint64_t magic;
  uint64_t record_bytes;
  uint64_t n_records;
};

struct Cache {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped = 0;
  Header header{};
};

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* rc_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || size_t(st.st_size) < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* c = new Cache;
  c->fd = fd;
  c->base = static_cast<const uint8_t*>(mem);
  c->mapped = st.st_size;
  std::memcpy(&c->header, c->base, sizeof(Header));
  if (c->header.magic != kMagic ||
      sizeof(Header) + c->header.record_bytes * c->header.n_records >
          c->mapped) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete c;
    return nullptr;
  }
  return c;
}

int64_t rc_num_records(void* handle) {
  return handle ? int64_t(static_cast<Cache*>(handle)->header.n_records)
                : -1;
}

int64_t rc_record_bytes(void* handle) {
  return handle ? int64_t(static_cast<Cache*>(handle)->header.record_bytes)
                : -1;
}

// Copy `count` records given by `indices` into `out` (count*record_bytes),
// using up to `threads` workers. Returns 0 on success.
int32_t rc_read_batch(void* handle, const int64_t* indices, int64_t count,
                      uint8_t* out, int32_t threads) {
  if (!handle) return -1;
  auto* c = static_cast<Cache*>(handle);
  const uint64_t rb = c->header.record_bytes;
  const uint64_t n = c->header.n_records;
  for (int64_t k = 0; k < count; ++k)
    if (indices[k] < 0 || uint64_t(indices[k]) >= n) return -2;

  const int nthreads =
      std::max(1, std::min<int>(threads, int(std::min<int64_t>(count, 16))));
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t k = next.fetch_add(1);
      if (k >= count) break;
      const uint8_t* src = c->base + sizeof(Header) + rb * indices[k];
      std::memcpy(out + rb * k, src, rb);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return 0;
}

void rc_close(void* handle) {
  if (!handle) return;
  auto* c = static_cast<Cache*>(handle);
  munmap(const_cast<uint8_t*>(c->base), c->mapped);
  ::close(c->fd);
  delete c;
}

// Writer side: create a cache file (header only); records appended by the
// Python side with plain file writes for simplicity.
int32_t rc_write_header(const char* path, int64_t record_bytes,
                        int64_t n_records) {
  FILE* f = fopen(path, "r+b");
  if (!f) f = fopen(path, "wb");
  if (!f) return -1;
  Header h{kMagic, uint64_t(record_bytes), uint64_t(n_records)};
  fseek(f, 0, SEEK_SET);
  const size_t written = fwrite(&h, sizeof(Header), 1, f);
  fclose(f);
  return written == 1 ? 0 : -1;
}

}  // extern "C"
