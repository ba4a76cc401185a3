// Fused maxpool 2x2/s2 -> per-tensor int8 quantize -> 3x3 same-pad int8
// conv (int32 accumulation) -> f32 dequant + bias (+ ReLU), NHWC.
//
// Replaces the TPU kernel cvpce_tpu/ops/conv_pallas.py:_kernel (driven by
// fused_pool_int8_conv, with its MXU tap packing _pack_kernel). The
// wrapper is cvpce_tpu_torch/ops/conv_fused.py:fused_pool_int8_conv; its
// plain version pool_int8_conv_plain is the composition this kernel
// must equal: the int32 accumulators bit for bit (int32 sums are exact in
// any order: |acc| <= 9 * Cin * 127 * 127 < 2^31 up to Cin = 14,800), the
// epilogue `float(acc) * scale + bias` rounded after the multiply and
// after the add (no FMA, as the torch ops round), then cast to the output
// type with round-to-nearest-even.
//
// Bound: at the VGG block-boundary sites (B = 128: 256^2 x 64 -> 128,
// 128^2 x 128 -> 256, 64^2 x 256 -> 512) each site does 3.1e11 int8
// operations, 0.16 ms on the int8 tensor cores, against 1.61 / 0.81 /
// 0.40 GB of bytes (0.48 / 0.24 / 0.12 ms). The first two are bound by
// bytes, the third by operations, so the kernel must read the pre-pool
// input once, keep the pooled intermediate in shared memory, and run the
// products on the tensor cores.
//
// Design: an implicit GEMM with M = output pixels, N = Cout, K = 9 taps x
// Cin, on mma.sync m16n8k32 s8 (int32 accumulators), one launch a call,
// one block an SM, in two warp roles:
//   - 4 producer warps walk the block's segments of one image in strips of
//     SH pooled rows and fill a ring of two halves in shared memory, each
//     one strip's SH + 2 pooled rows (zero columns left and right, zero
//     rows outside the image: the conv's padding). A segment's first
//     strip pools all SH + 2 rows; a later one copies its two halo rows
//     from the other half and pools only its SH new rows, so each input
//     row is read once a segment. A pooling item is 8 channels, 6 items
//     (24 16-byte loads) in flight a thread; the window maximum (bf16
//     pairs by __hmax2), then rintf(max / a_scale) with IEEE division,
//     clamped to +-127. A pixel's int8 vector is padded by 16 bytes, so
//     the 8 rows of an ldmatrix (8 neighbouring pixels) fall in 8
//     distinct bank groups.
//   - 4 consumer warps meanwhile compute all of Cout for the strip in the
//     other half: tiles of 256 pixels x 64 channels, a warp 64 x 64. A is
//     read from the ring by ldmatrix at the tap's shifted pixel, so the
//     im2col matrix never exists. B is the weights, repacked by the
//     wrapper into K-major (Cout, 9 Cin) int8 and streamed through a
//     6-stage cp.async ring of 64 channels x 64 bytes of K (XOR-swizzled
//     16-byte chunks), one consumer barrier a stage; the chunk sequence
//     repeats for every tile, so the ring runs across tiles and strips
//     without draining. The epilogue dequantizes from the accumulators and
//     stores bf16 pairs, or f32 / int32 in 32-byte runs after a transpose
//     across each quad of lanes, with streaming stores.
//   - The halves change hands through named barriers (a full and an empty
//     one a half): the producers pool strip t + 1 while the consumers
//     multiply strip t. The segment length is chosen so that the segments
//     fill the grid's waves evenly, each paying once for a first strip
//     that nothing hides.
// What bounds it on the card (PERF.md section 7): the consumers' mma.sync
// loop, one warp a scheduler, and the producers' pooling instructions;
// neither waits on the other.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Warp roles: 4 consumer warps (stacked along M, 64 x 64 each) run the
// products and the epilogue; 4 producer warps pool the next strip.
constexpr int kConsumerWarps = 4;
constexpr int kProducerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kMT = 256;          // output pixels per tile
constexpr int kNT = 64;           // output channels per tile
constexpr int kWarpM = 64;        // a warp: 4 m16 tiles
constexpr int kWarpN = 64;        //   x 8 n8 tiles
constexpr int kKC = 64;           // bytes of K per weight stage: 2 k-steps
constexpr int kStages = 6;
constexpr int kStageBytes = kNT * kKC;
constexpr int kWeightBytes = kStages * kStageBytes;
constexpr int kMaxSH = 16;
constexpr int kPoolLoads = 24;    // 16-byte loads in flight a producer

// named barriers (0 is __syncthreads): the consumers' weight ring, the
// producers' own, and a full and an empty barrier for each ring half
constexpr int kBarConsumers = 1;
constexpr int kBarProducers = 2;
constexpr int kBarFull = 3;   // + half
constexpr int kBarEmpty = 5;  // + half

static_assert(kConsumerWarps * kWarpM == kMT && kWarpN == kNT,
              "the consumer warps stack along M");
static_assert(kStageBytes / 16 == 2 * kConsumers, "two 16-byte copies a stage");

enum OutKind { kF32 = 0, kBF16 = 1, kI32 = 2 };

// kernels this file has launched, read by pool_int8_conv_kernels_launched
unsigned long long kernels_launched = 0;

struct Geometry {
  int H, W, Cin, Cout, P, Q;
  int SH;          // output rows a strip
  int ps;          // bytes a pooled pixel takes in the ring, Cin + 16
  int row_bytes;   // (Q + 2) * ps
  int half_bytes;  // (SH + 2) * row_bytes: one strip's pooled rows
  int seg_rows;    // pooled rows a block's segment covers, a multiple of SH
  int nseg;        // segments an image
  int items;       // B * nseg
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 input channels of one pre-pool pixel: one 16-byte load for bf16, two
// for f32
template <typename TIn>
struct Vec8 {
  static constexpr int kLoads = sizeof(TIn) / 2;
  uint4 r[kLoads];
};

template <typename TIn>
__device__ __forceinline__ void load8(Vec8<TIn>& v, const TIn* p) {
#pragma unroll
  for (int i = 0; i < Vec8<TIn>::kLoads; ++i)
    v.r[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
}

// the 2x2 window's maximum of 8 channels, in f32: bf16 pairs by __hmax2
// (a maximum is exact in either type), f32 by fmaxf
__device__ __forceinline__ void window_max(const Vec8<__nv_bfloat16> (&v)[4],
                                           float m[8]) {
  const uint32_t* w0 = &v[0].r[0].x;
  const uint32_t* w1 = &v[1].r[0].x;
  const uint32_t* w2 = &v[2].r[0].x;
  const uint32_t* w3 = &v[3].r[0].x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 mx = __hmax2(
        __hmax2(*reinterpret_cast<const __nv_bfloat162*>(w0 + k),
                *reinterpret_cast<const __nv_bfloat162*>(w1 + k)),
        __hmax2(*reinterpret_cast<const __nv_bfloat162*>(w2 + k),
                *reinterpret_cast<const __nv_bfloat162*>(w3 + k)));
    m[2 * k] = __low2float(mx);
    m[2 * k + 1] = __high2float(mx);
  }
}

__device__ __forceinline__ void window_max(const Vec8<float> (&v)[4],
                                           float m[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 a = v[0].r[i], b = v[1].r[i], c = v[2].r[i], d = v[3].r[i];
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
    const uint32_t wc[4] = {c.x, c.y, c.z, c.w}, wd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[4 * i + k] = fmaxf(
          fmaxf(__uint_as_float(wa[k]), __uint_as_float(wb[k])),
          fmaxf(__uint_as_float(wc[k]), __uint_as_float(wd[k])));
  }
}

// four int8 of clip(round_half_even(m / a_scale), +-127), packed
__device__ __forceinline__ uint32_t quant4(const float* m, float a_scale) {
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float qv = rintf(__fdiv_rn(m[k], a_scale));  // IEEE division
    qv = fminf(fmaxf(qv, -127.0f), 127.0f);
    packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                  static_cast<int8_t>(static_cast<int>(qv)))) << (8 * k);
  }
  return packed;
}

// Pool and quantize pooled rows i0 .. i0 + nrows - 1 of image b into the
// ring half `half`, row i0 + k at position pos0 + k, columns 1 .. Q; rows
// outside the image become zeros. A producer thread takes kItems
// 8-channel items a step, so kPoolLoads 16-byte loads are in flight.
template <typename TIn>
__device__ __forceinline__ void pool_rows(const TIn* __restrict__ x,
                                          uint8_t* half, const Geometry& g,
                                          int b, int i0, int pos0, int nrows,
                                          float a_scale, int ptid) {
  constexpr int kItems = kPoolLoads / 4 / Vec8<TIn>::kLoads;
  const int c8n = g.Cin / 8;
  const int per_row = g.Q * c8n;
  const int items = nrows * per_row;
  const size_t col_step = g.Cin;
  const size_t row_step = static_cast<size_t>(g.W) * g.Cin;
  for (int base = ptid; base < items; base += kItems * kProducers) {
    Vec8<TIn> v[kItems][4];
    int dst[kItems];
    bool live[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = base + u * kProducers;
      const int rr = it / per_row;
      const int rem = it - rr * per_row;
      const int q = rem / c8n;
      const int c8 = rem - q * c8n;
      const int i = i0 + rr;
      dst[u] = it < items
                   ? (pos0 + rr) * g.row_bytes + (q + 1) * g.ps + 8 * c8
                   : -1;
      live[u] = it < items && i >= 0 && i < g.P;
      if (live[u]) {
        const TIn* p00 = x + ((static_cast<size_t>(b) * g.H + 2 * i) * g.W
                              + 2 * q) * g.Cin + 8 * c8;
        load8(v[u][0], p00);
        load8(v[u][1], p00 + col_step);
        load8(v[u][2], p00 + row_step);
        load8(v[u][3], p00 + row_step + col_step);
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (dst[u] < 0) continue;
      uint2 packed = make_uint2(0u, 0u);
      if (live[u]) {
        float m[8];
        window_max(v[u], m);
        packed.x = quant4(m, a_scale);
        packed.y = quant4(m + 4, a_scale);
      }
      *reinterpret_cast<uint2*>(half + dst[u]) = packed;
    }
  }
}

// One weight stage: output channels nt * kNT .. + kNT of K bytes
// kc * kKC .. + kKC, 16-byte chunk j of row n at chunk j ^ ((n >> 1) & 3)
// so that ldmatrix's 8 rows hit 8 distinct bank groups. Channels past
// Cout and K past 9 Cin are not copied (never read into a product that is
// kept). Always commits one group.
__device__ __forceinline__ void load_weights(uint8_t* stage,
                                             const int8_t* __restrict__ w,
                                             int Cout, int K, int nt, int kc,
                                             int tid) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = tid + u * kConsumers;
    const int n = e >> 2, j = e & 3;
    const int gn = nt * kNT + n, kb = kc * kKC + j * 16;
    if (gn < Cout && kb < K)
      cp_async16(smem_u32(stage + n * kKC + ((j ^ ((n >> 1) & 3)) << 4)),
                 w + static_cast<size_t>(gn) * K + kb);
  }
  cp_async_commit();
}

// a[idx] for a lane-dependent idx in 0..3, by selects (no local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int idx) {
  const uint32_t lo = idx & 1 ? a[1] : a[0];
  const uint32_t hi = idx & 1 ? a[3] : a[2];
  return idx & 2 ? hi : lo;
}

// Transpose 32-bit words across a quad (lanes 4 g8 .. 4 g8 + 3): lane t
// holds w[j] for 4 n8 tiles j (its channels 2t, 2t + 1 of each); after,
// w[p] is lane p's word of tile t, so lane t has all 8 channels of tile t.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int tig) {
  uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    const int p = tig ^ s;
    // lane p sends its word of tile tig (its pick4(w, p ^ s))
    const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(w, p), s);
    r0 = p == 0 ? got : r0;
    r1 = p == 1 ? got : r1;
    r2 = p == 2 ? got : r2;
    r3 = p == 3 ? got : r3;
  }
  const uint32_t own = pick4(w, tig);
  w[0] = tig == 0 ? own : r0;
  w[1] = tig == 1 ? own : r1;
  w[2] = tig == 2 ? own : r2;
  w[3] = tig == 3 ? own : r3;
}

// The producer warps: for every strip of the block's segments, in order,
// fill ring half t % 2 with its SH + 2 pooled rows, once the consumers
// have released that half (strip t - 2), and signal it full. A segment's
// first strip pools all SH + 2 rows; a later one copies its two halo rows
// from the other half (strip t - 1's last two) and pools SH new rows.
template <typename TIn>
__device__ void produce(const TIn* __restrict__ x, uint8_t* ring,
                        const Geometry& g, float a_scale, int ptid) {
  int t = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const int b = item / g.nseg;
    const int row_begin = (item % g.nseg) * g.seg_rows;
    const int row_end = min(g.P, row_begin + g.seg_rows);
    for (int r0 = row_begin; r0 < row_end; r0 += g.SH, ++t) {
      if (t >= 2) bar_sync(kBarEmpty + (t & 1), kThreads);
      uint8_t* half = ring + (t & 1) * g.half_bytes;
      if (r0 == row_begin) {
        pool_rows(x, half, g, b, r0 - 1, 0, g.SH + 2, a_scale, ptid);
      } else {
        bar_sync(kBarProducers, kProducers);  // strip t - 1 is written
        const uint8_t* prev = ring + ((t & 1) ^ 1) * g.half_bytes
                              + g.SH * g.row_bytes;
        for (int e = ptid; e < 2 * g.row_bytes / 16; e += kProducers)
          reinterpret_cast<uint4*>(half)[e] =
              reinterpret_cast<const uint4*>(prev)[e];
        pool_rows(x, half, g, b, r0 + 1, 2, g.SH, a_scale, ptid);
      }
      bar_arrive(kBarFull + (t & 1), kThreads);
    }
  }
  // match the consumers' releases of the last two strips
  for (int s = t < 2 ? 0 : t - 2; s < t; ++s)
    bar_sync(kBarEmpty + (s & 1), kThreads);
}

template <typename TIn, int OUT>
__global__ void __launch_bounds__(kThreads, 1)
pool_int8_conv_kernel(const TIn* __restrict__ x,
                      const int8_t* __restrict__ w,  // (Cout, 9 Cin)
                      const float* __restrict__ a_scale_p,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, void* __restrict__ out,
                      int fuse_relu, Geometry g) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* wring = smem;                // kStages x kNT x kKC
  uint8_t* ring = smem + kWeightBytes;  // 2 halves x (SH + 2) rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a_scale = *a_scale_p;

  // the ring's zero columns (the conv's left and right padding)
  const int col16 = g.ps / 16;
  const int rows = 2 * (g.SH + 2);
  for (int e = tid; e < rows * 2 * col16; e += kThreads) {
    const int row = e / (2 * col16);
    const int side = (e / col16) & 1;
    const int j = e % col16;
    *reinterpret_cast<uint4*>(ring + row * g.row_bytes
                              + side * (g.Q + 1) * g.ps + 16 * j) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (warp >= kConsumerWarps) {
    produce(x, ring, g, a_scale, tid - kConsumers);
    return;
  }

  const int K = 9 * g.Cin;
  const int ksteps = K / 32;
  const int kchunks = (ksteps + 1) / 2;
  const int csteps = g.Cin / 32;  // k-steps a tap
  const int ntiles = (g.Cout + kNT - 1) / kNT;

  // weight ring: the chunk sequence (nt, kc) repeats for every tile
  int ld_nt = 0, ld_kc = 0, ld_stage = 0, stage = 0;
  auto next_load = [&]() {
    load_weights(wring + ld_stage * kStageBytes, w, g.Cout, K, ld_nt, ld_kc,
                 tid);
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
    if (++ld_kc == kchunks) {
      ld_kc = 0;
      ld_nt = ld_nt + 1 == ntiles ? 0 : ld_nt + 1;
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) next_load();

  const int g8 = lane >> 2, tig = lane & 3;
  // this lane's ldmatrix row of B: channel (lane & 7) + 8 (lane >> 4) of
  // each 16-channel pair of n8 tiles, K half (lane >> 3) & 1
  const int b_n = (lane & 7) + ((lane >> 4) << 3);
  const int b_half = (lane >> 3) & 1;

  int t = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const int b = item / g.nseg;
    const int row_begin = (item % g.nseg) * g.seg_rows;
    const int row_end = min(g.P, row_begin + g.seg_rows);
    for (int r0 = row_begin; r0 < row_end; r0 += g.SH, ++t) {
      bar_sync(kBarFull + (t & 1), kThreads);
      const uint32_t half = smem_u32(ring + (t & 1) * g.half_bytes);
      const int mvalid = min(g.SH, row_end - r0) * g.Q;
      for (int m0 = 0; m0 < mvalid; m0 += kMT) {
        // this lane's ldmatrix row of each m16 tile at tap (0, 0): output
        // row r reads ring rows r + dy
        uint32_t a_base[4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int m = min(m0 + warp * kWarpM + mt * 16 + (lane & 15),
                            mvalid - 1);
          const int r = m / g.Q, q = m - r * g.Q;
          a_base[mt] = half + r * g.row_bytes + q * g.ps + ((lane >> 4) << 4);
        }
        for (int nt = 0; nt < ntiles; ++nt) {
          const int n0 = nt * kNT;
          int acc[4][8][4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0;
          int tap = 0, cc = 0;
          for (int kc = 0; kc < kchunks; ++kc) {
            cp_async_wait<kStages - 2>();
            bar_sync(kBarConsumers, kConsumers);  // landed; one stage free
            next_load();
            const uint32_t bstage = smem_u32(wring + stage * kStageBytes);
            stage = stage + 1 == kStages ? 0 : stage + 1;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              if (2 * kc + kk < ksteps) {
                const int dy = tap >= 6 ? 2 : (tap >= 3 ? 1 : 0);
                const int dx = tap - 3 * dy;
                const uint32_t shift = dy * g.row_bytes + dx * g.ps + cc * 32;
                uint32_t bf[8][2];
#pragma unroll
                for (int nb = 0; nb < 4; ++nb) {
                  const int n = b_n + nb * 16;
                  const int j = 2 * kk + b_half;
                  uint32_t r[4];
                  ldmatrix_x4(r, bstage + n * kKC
                                     + ((j ^ ((n >> 1) & 3)) << 4));
                  bf[2 * nb][0] = r[0];
                  bf[2 * nb][1] = r[1];
                  bf[2 * nb + 1][0] = r[2];
                  bf[2 * nb + 1][1] = r[3];
                }
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                  uint32_t a[4];
                  ldmatrix_x4(a, a_base[mt] + shift);
#pragma unroll
                  for (int j = 0; j < 8; ++j)
                    mma_s8(acc[mt][j], a, bf[j][0], bf[j][1]);
                }
              }
              if (++cc == csteps) {
                cc = 0;
                ++tap;
              }
            }
          }

          // epilogue: the lane holds rows g8, g8 + 8 of each m16 tile and
          // channels 2 tig, 2 tig + 1 of each n8 tile. Dequantize there;
          // bf16 pairs are stored as they are, f32 and int32 are first
          // transposed across the quad so that a lane stores the 8
          // channels of n8 tiles tig and tig + 4 whole.
          float2 sc[8], bs[8];
          if (OUT != kI32) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int n = min(n0 + j * 8, g.Cout - 8) + 2 * tig;
              sc[j] = __ldg(reinterpret_cast<const float2*>(scale + n));
              bs[j] = __ldg(reinterpret_cast<const float2*>(bias + n));
            }
          }
          // output pixel of this warp's row 0 (a strip's pixels are
          // consecutive in NHWC)
          const size_t pix0 = (static_cast<size_t>(b) * g.P + r0) * g.Q
                              + m0 + warp * kWarpM;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int mr = mt * 16 + g8 + 8 * h;
              const bool row_ok = m0 + warp * kWarpM + mr < mvalid;
              const size_t o = (pix0 + mr) * g.Cout + n0;
              if (OUT == kBF16) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const float y0 = __fadd_rn(
                      __fmul_rn(__int2float_rn(acc[mt][j][2 * h]), sc[j].x),
                      bs[j].x);
                  const float y1 = __fadd_rn(
                      __fmul_rn(__int2float_rn(acc[mt][j][2 * h + 1]),
                                sc[j].y),
                      bs[j].y);
                  __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
                  if (fuse_relu) v = __hmax2(v, __float2bfloat162_rn(0.0f));
                  if (row_ok && n0 + j * 8 < g.Cout)
                    __stcs(reinterpret_cast<unsigned int*>(
                               static_cast<__nv_bfloat16*>(out) + o + j * 8
                               + 2 * tig),
                           *reinterpret_cast<unsigned int*>(&v));
                }
                continue;
              }
#pragma unroll
              for (int grp = 0; grp < 2; ++grp) {
                uint32_t lo[4], hi[4];  // channels 2 tig, 2 tig + 1
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                  const int j = 4 * grp + jj;
                  if (OUT == kI32) {
                    lo[jj] = static_cast<uint32_t>(acc[mt][j][2 * h]);
                    hi[jj] = static_cast<uint32_t>(acc[mt][j][2 * h + 1]);
                  } else {
                    float y0 = __fadd_rn(
                        __fmul_rn(__int2float_rn(acc[mt][j][2 * h]), sc[j].x),
                        bs[j].x);
                    float y1 = __fadd_rn(
                        __fmul_rn(__int2float_rn(acc[mt][j][2 * h + 1]),
                                  sc[j].y),
                        bs[j].y);
                    if (fuse_relu) {
                      y0 = fmaxf(y0, 0.0f);
                      y1 = fmaxf(y1, 0.0f);
                    }
                    lo[jj] = __float_as_uint(y0);
                    hi[jj] = __float_as_uint(y1);
                  }
                }
                quad_transpose(lo, tig);
                quad_transpose(hi, tig);
                const int n = (4 * grp + tig) * 8;  // after the transpose
                if (row_ok && n0 + n < g.Cout) {
                  uint4* dst = reinterpret_cast<uint4*>(
                      static_cast<uint32_t*>(out) + o + n);
                  __stcs(dst, make_uint4(lo[0], hi[0], lo[1], hi[1]));
                  __stcs(dst + 1, make_uint4(lo[2], hi[2], lo[3], hi[3]));
                }
              }
            }
          }
        }
      }
      bar_arrive(kBarEmpty + (t & 1), kThreads);
    }
  }
  cp_async_wait<0>();
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

size_t smem_bytes(int sh, int row_bytes) {
  return kWeightBytes + 2 * static_cast<size_t>(sh + 2) * row_bytes;
}

template <typename TIn, int OUT>
int launch(const void* x, const void* w, const void* a_scale,
           const void* scale, const void* bias, void* out, int fuse_relu,
           int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  Geometry g;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.P = H / 2;
  g.Q = W / 2;
  g.ps = Cin + 16;
  g.row_bytes = (g.Q + 2) * g.ps;
  const size_t optin = static_cast<size_t>(smem_optin());
  if (smem_bytes(1, g.row_bytes) > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  // strip height: the one whose SH * Q pixels fill the 256-pixel tiles
  // best, the lower on a tie, within the card's shared memory
  g.SH = 1;
  double best_fill = 0.0;
  for (int sh = 1; sh <= kMaxSH && sh <= g.P; ++sh) {
    if (smem_bytes(sh, g.row_bytes) > optin) break;
    const int m = sh * g.Q;
    const double fill = static_cast<double>(m) / ((m + kMT - 1) / kMT * kMT);
    if (fill > best_fill) {
      best_fill = fill;
      g.SH = sh;
    }
  }
  g.half_bytes = (g.SH + 2) * g.row_bytes;
  const size_t smem = smem_bytes(g.SH, g.row_bytes);
  auto kernel = pool_int8_conv_kernel<TIn, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  // segment length: strips a segment (spi) minimizing waves x (strips of
  // a segment + one, the first strip's pooling that nothing hides), the
  // longer on a tie
  const int strips = (g.P + g.SH - 1) / g.SH;
  int spi = strips;
  long long best_cost = -1;
  for (int s = 1; s <= strips; ++s) {
    const long long items =
        static_cast<long long>(B) * ((strips + s - 1) / s);
    const long long cost = (items + slots - 1) / slots * (s + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      spi = s;
    }
  }
  g.seg_rows = spi * g.SH;
  g.nseg = (g.P + g.seg_rows - 1) / g.seg_rows;
  g.items = B * g.nseg;
  const int grid = static_cast<int>(g.items < slots ? g.items : slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(a_scale), static_cast<const float*>(scale),
      static_cast<const float*>(bias), out, fuse_relu, g);
  ++kernels_launched;
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_in(int out_kind, const void* x, const void* w,
              const void* a_scale, const void* scale, const void* bias,
              void* out, int fuse_relu, int B, int H, int W, int Cin,
              int Cout, cudaStream_t s) {
  switch (out_kind) {
    case kF32:
      return launch<TIn, kF32>(x, w, a_scale, scale, bias, out, fuse_relu,
                               B, H, W, Cin, Cout, s);
    case kBF16:
      return launch<TIn, kBF16>(x, w, a_scale, scale, bias, out, fuse_relu,
                                B, H, W, Cin, Cout, s);
    case kI32:
      return launch<TIn, kI32>(x, w, a_scale, scale, bias, out, fuse_relu,
                               B, H, W, Cin, Cout, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) f32 or bf16 (x_bf16), contiguous, 16-byte aligned, H
// and W even. w: (Cout, 9 Cin) int8, K-major: w[n][(ky * 3 + kx) * Cin +
// c] = kq[ky][kx][c][n]. a_scale: one f32 on the device. scale, bias:
// (Cout,) f32. out: (B, H/2, W/2, Cout), out_kind 0 f32, 1 bf16, 2 int32
// accumulators. Cin % 32 == 0, Cout % 8 == 0, W / 2 <= max_q(Cin).
int pool_int8_conv_launch(const void* x, const void* w, const void* a_scale,
                          const void* scale, const void* bias, void* out,
                          int x_bf16, int out_kind, int fuse_relu, int B,
                          int H, int W, int Cin, int Cout, void* stream) {
  if (Cin % 32 || Cout % 8 || H % 2 || W % 2 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_in<__nv_bfloat16>(out_kind, x, w, a_scale, scale, bias,
                                    out, fuse_relu, B, H, W, Cin, Cout, s);
  return launch_in<float>(out_kind, x, w, a_scale, scale, bias, out,
                          fuse_relu, B, H, W, Cin, Cout, s);
}

// Widest pooled row (Q = W / 2) whose ring (two halves of three rows at
// SH = 1) and the weight stages fit one block's shared memory on this
// card.
int pool_int8_conv_max_q(int cin) {
  return static_cast<int>(
      (static_cast<size_t>(smem_optin()) - kWeightBytes) / (6 * (cin + 16)))
      - 2;
}

// Kernels launched from this file so far, for counting a call's launches.
unsigned long long pool_int8_conv_kernels_launched() {
  return kernels_launched;
}

const char* pool_int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
