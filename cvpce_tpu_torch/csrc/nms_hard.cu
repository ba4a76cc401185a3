// Greedy hard NMS over score-sorted boxes: a parallel IoU bitmask, then a
// one-warp walk per image.
//
// Replaces the TPU kernel cvpce_tpu/ops/nms_pallas.py:_nms_kernel (driven
// by nms_keep_sorted / nms_mask_pallas). The wrapper
// (cvpce_tpu_torch/ops/nms.py:nms_keep_sorted) pads, masks invalid scores
// to -inf, sorts stably by descending score and scatters the keep flags
// back to input order in torch; this file only decides, for the sorted
// list, which boxes survive.
//
// Semantics, as in _nms_kernel: candidate i < n_walk, if nothing before it
// has suppressed it, suppresses every later box j with
//   inter / max(union, 1e-12) > thresh,
// with inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0) and
// union = (area_i + area_j) - inter, in that expression order. Boxes
// j >= n_walk can be suppressed but are never walked. The file is built
// without fast-math and with -fmad=false, so every IoU rounds as the plain
// torch version's does and the keep flags are bit-equal.
//
// What bounds it: the serial walk. The greedy work these inputs need
// (live candidates x later boxes x ~12 flops) is microseconds of the
// card's arithmetic, and the inputs are 80 KB an image; what cannot be
// parallel is the suppression chain over the walked candidates. So the
// IoUs leave the chain, and the time is the walk's: one SM per image,
// chunk after chunk of 64 candidates, each chunk's mask rows moved
// through shared memory and its 64-step chain resolved in registers.
//   1. nms_mask_kernel, all SMs: a grid over (column word, row block,
//      image) writes mask[b][i][w], a 64-bit word whose bit t says that
//      box i suppresses box 64w + t, for 64w + t > i only (the lower
//      triangle and the ragged edge past n stay clear; words left of row
//      i's own are not written). A disjoint pair (inter == 0) has IoU 0
//      exactly, so its division is skipped.
//   2. nms_walk_kernel, one 512-thread block per image, the removed bits
//      in shared memory. The mask rows of a chunk of 64 candidates are
//      staged from L2 into shared memory with cp.async, double-buffered,
//      skipping rows already removed when the chunk is staged; one SM
//      pulls these bytes, and 16 warps keep more of them in flight than
//      4 do. One thread resolves the chain among the chunk's rows: it
//      loads their diagonal words into registers first, then a live row
//      ORs its word in, branch-free on 32-bit halves, so no load sits on
//      the chain. Then the 16 warps OR the live rows' later words into
//      the removed bits from shared memory (a warp 4 rows, a lane the
//      words). Three barriers a chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 64;            // boxes per row block, bits per word
constexpr int kWalkThreads = 512;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kSeg = kBits / kWalkWarps;    // rows of a chunk a warp ORs
constexpr unsigned long long kSegMask =
    kSeg == 64 ? ~0ull : (1ull << kSeg) - 1;
constexpr int kMaxWords = 224;       // N <= 224 * 64 = 14336

typedef unsigned long long u64;

// mask row stride in words: even, so every staged row starts 16-byte
// aligned
__host__ __device__ inline int row_words(int n) {
  const int nw = (n + kBits - 1) / kBits;
  return (nw + 1) & ~1;
}

__global__ void __launch_bounds__(kBits)
nms_mask_kernel(const float4* __restrict__ boxes,
                const int* __restrict__ n_walk, int n, int nwp, float thresh,
                u64* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  const int walk = n_walk[b] < n ? n_walk[b] : n;
  if (rb * kBits >= walk) return;  // rows never walked need no mask
  __shared__ float4 cbox[kBits];
  __shared__ float carea[kBits];
  const float4* img = boxes + static_cast<size_t>(b) * n;
  const int t = threadIdx.x;
  const int j = cb * kBits + t;
  if (j < n) {
    const float4 v = img[j];
    cbox[t] = v;
    carea[t] = (v.z - v.x) * (v.w - v.y);
  }
  __syncthreads();
  const int i = rb * kBits + t;
  if (i >= walk) return;
  const float4 r = img[i];
  const float ra = (r.z - r.x) * (r.w - r.y);
  const int ncol = n - cb * kBits < kBits ? n - cb * kBits : kBits;
  const bool zero_suppresses = 0.0f > thresh;
  u64 bits = 0;
  for (int c = cb == rb ? t + 1 : 0; c < ncol; ++c) {
    const float4 o = cbox[c];
    const float ix1 = fmaxf(r.x, o.x);
    const float iy1 = fmaxf(r.y, o.y);
    const float ix2 = fminf(r.z, o.z);
    const float iy2 = fminf(r.w, o.w);
    const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
    bool hit;
    if (inter == 0.0f) {
      hit = zero_suppresses;  // 0 / max(union, 1e-12) is 0
    } else {
      const float uni = (ra + carea[c]) - inter;
      hit = inter / fmaxf(uni, 1e-12f) > thresh;
    }
    if (hit) bits |= 1ull << c;
  }
  mask[(static_cast<size_t>(b) * n + i) * nwp + cb] = bits;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the rows of chunk c still live when it is staged (bit r of `dead` clear;
// rows past walk are never walked), words from the even word at or before
// c to the row's end, into dst (row r at r * len): a warp takes rows, its
// lanes 16-byte pairs of words
__device__ __forceinline__ void stage_chunk(u64* dst, const u64* img, int c,
                                            int walk, int nwp, u64 dead) {
  const int c0 = c & ~1, len = nwp - c0, pairs = len / 2;
  const int row0 = c * kBits;
  const int rows = walk - row0 < kBits ? walk - row0 : kBits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWalkWarps) {
    if ((dead >> r) & 1ull) continue;
    const u64* src = img + static_cast<size_t>(row0 + r) * nwp + c0;
    for (int p = lane; p < pairs; p += 32)
      cp_async16(dst + r * len + 2 * p, src + 2 * p);
  }
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const u64* __restrict__ mask, const int* __restrict__ n_walk,
                int n, int nwp, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 smem[];
  u64* removed = smem;            // [nwp] removed bits
  u64* stage = smem + nwp;        // [2][kBits * nwp] staged rows
  __shared__ u64 live_rows;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nw = (n + kBits - 1) / kBits;
  const int walk = n_walk[b] < n ? n_walk[b] : n;
  const int nchunks = (walk + kBits - 1) / kBits;
  const u64* img = mask + static_cast<size_t>(b) * n * nwp;

  for (int w = tid; w < nwp; w += kWalkThreads) removed[w] = 0;
  if (nchunks > 0) stage_chunk(stage, img, 0, walk, nwp, 0ull);
  cp_async_commit();
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      stage_chunk(stage + ((c + 1) & 1) * kBits * nwp, img, c + 1, walk,
                  nwp, removed[c + 1]);
    cp_async_commit();
    cp_async_wait_one();  // chunk c has landed
    __syncthreads();
    const u64* rows = stage + (c & 1) * kBits * nwp;
    const int c0 = c & ~1, len = nwp - c0;
    if (tid == 0) {
      // the chain: rows 64c .. 64c + 63 against each other. A live row
      // ORs its diagonal word in; the words are loaded first, so no load
      // sits on the chain, which runs branch-free on 32-bit halves (row
      // t's word has bits above t only)
      const int span = walk - c * kBits < kBits ? walk - c * kBits : kBits;
      const u64 cur0 = removed[c];
      u64 diag[kBits];
#pragma unroll
      for (int t = 0; t < kBits; ++t)
        diag[t] = t < span && !((cur0 >> t) & 1ull) ? rows[t * len + c - c0]
                                                    : 0ull;
      asm volatile("" ::: "memory");
      uint32_t lo = static_cast<uint32_t>(cur0);
      uint32_t hi = static_cast<uint32_t>(cur0 >> 32);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const uint32_t alive = 0u - ((~lo >> t) & 1u);
        lo |= static_cast<uint32_t>(diag[t]) & alive;
        hi |= static_cast<uint32_t>(diag[t] >> 32) & alive;
      }
#pragma unroll
      for (int t = 32; t < kBits; ++t) {
        const uint32_t alive = 0u - ((~hi >> (t - 32)) & 1u);
        hi |= static_cast<uint32_t>(diag[t] >> 32) & alive;
      }
      const u64 cur = (static_cast<u64>(hi) << 32) | lo;
      removed[c] = cur;
      live_rows = ~cur & (span == kBits ? ~0ull : (1ull << span) - 1);
    }
    __syncthreads();
    // off the chain: the live rows' later words OR into the removed bits,
    // warp k taking its segment of the chunk's rows, its lanes the words
    const u64 mine = live_rows & (kSegMask << (kSeg * warp));
    if (mine) {
      u64 acc[kMaxWords / 32];
#pragma unroll
      for (int s = 0; s < kMaxWords / 32; ++s) acc[s] = 0;
      for (u64 m = mine; m; m &= m - 1) {
        const u64* row =
            rows + (__ffsll(static_cast<long long>(m)) - 1) * len;
#pragma unroll
        for (int s = 0; s < kMaxWords / 32; ++s) {
          const int w = c + 1 + lane + 32 * s;
          if (w < nw) acc[s] |= row[w - c0];
        }
      }
#pragma unroll
      for (int s = 0; s < kMaxWords / 32; ++s) {
        const int w = c + 1 + lane + 32 * s;
        if (w < nw && acc[s]) atomicOr(&removed[w], acc[s]);
      }
    }
    __syncthreads();  // chunk c's buffer is free for chunk c + 2
  }

  uint8_t* out = keep + static_cast<size_t>(b) * n;
  for (int j = tid; j < n; j += kWalkThreads)
    out[j] = ((removed[j / kBits] >> (j % kBits)) & 1ull) ? 0 : 1;
}

size_t walk_smem(int n) {
  return (2 * static_cast<size_t>(kBits) + 1) * row_words(n) * sizeof(u64);
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

}  // namespace

extern "C" {

// Largest N: two staged chunks of 64 mask rows and the removed bits fit
// one block's shared memory (14336 on an H100).
int nms_hard_max_n() {
  int n = kMaxWords * kBits;
  while (n > 0 && walk_smem(n) > static_cast<size_t>(smem_optin()))
    n -= 2 * kBits;
  return n;
}

// Words per row of the mask scratch: the caller allocates
// batch * n * nms_hard_mask_words(n) 64-bit words.
int nms_hard_mask_words(int n) { return row_words(n); }

// boxes: (batch, n, 4) f32, sorted by descending score, contiguous.
// n_walk: (batch,) int32, candidates to walk per image. mask: scratch, see
// nms_hard_mask_words. keep: (batch, n) uint8 out. Two launches.
int nms_hard_launch(const void* boxes, const void* n_walk, void* mask,
                    void* keep, int batch, int n, float thresh,
                    void* stream) {
  if (n <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  if (n > nms_hard_max_n()) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = (n + kBits - 1) / kBits, nwp = row_words(n);
  const size_t smem = walk_smem(n);
  cudaError_t err = cudaFuncSetAttribute(
      nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_mask_kernel<<<dim3(nw, nw, batch), kBits, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(n_walk), n,
      nwp, thresh, static_cast<u64*>(mask));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<batch, kWalkThreads, smem, s>>>(
      static_cast<const u64*>(mask), static_cast<const int*>(n_walk), n, nwp,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

const char* nms_hard_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
