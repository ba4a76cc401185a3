// Fused L2-normalize + cosine distance + top-k kNN over a gallery.
//
// Replaces the TPU kernel cvpce_tpu/ops/knn_pallas.py:_knn_kernel (driven
// by nearest_neighbors_fused): dist = 1 - (q . g) * inv_q * inv_g with
// inv = 1 / max(||x||, 1e-8), the k <= 8 smallest per query, ascending,
// ties to the lowest gallery index, rows past the gallery's end never
// ranked (the TPU wrapper's zero pad rows, distance 1.0, are not
// reproduced).
//
// What bounds it: bytes. At the serving shape (Q = 32 crops, A = 8192
// gallery rows, D = 1024) the gallery is a 33.6 MB read, 0.0101 ms at
// 3.35 TB/s; the 2*Q*A*D = 0.54 GFLOP of f32 FMA take 0.0080 ms at
// 67 TFLOP/s, so plain f32 FFMA (no tensor cores, no TF32: distances stay
// within 1e-5 of the plain version) can get near the byte bound if the
// loads are in flight while the FMAs run, and the inner loop is not bound
// by shared-memory loads.
//
// Two launches per search, both from this file:
//   1. knn_scan: one pass over the gallery. The grid is sized to the card
//      (every block resident at once; one per SM at D = 1024) and each
//      block takes a contiguous range of 32-row gallery tiles. In its
//      prologue a block loads its query tile (32 queries x D, 128 KB at
//      D = 1024) into shared memory once and takes the queries' norms
//      there. The gallery streams through a ring of stages of 32 rows x
//      256 depth (33 KB each; 3 fit beside the queries at D = 1024, so
//      two load while one is computed) with 16-byte cp.async, one barrier
//      a stage. Each of the 8 warps takes 32 of a stage's 256 depth; a
//      thread accumulates an 8-query x 4-row tile in registers (12 float4
//      shared loads feed 128 FFMA). At the end of a tile the warps'
//      partial dots are summed in a fixed order through the ring slot
//      just consumed, turned into distances, and each thread keeps the
//      best k of its query in registers; at the end of the block's range
//      the 8 threads of a query merge their lists with warp shuffles into
//      the block's partial top-k. Q > 32 loops over query tiles inside
//      the kernel, with a barrier between tiles: the last reduction's
//      ring slot is one the next tile's prologue loads into. D is at
//      most 1280 here (knn_fused_resident_max_dim).
//      Wider queries (MACResNet's 1536 to 3904) do not stay resident:
//      each ring slot then holds the query tile's slice of the same
//      depth beside the gallery's (66.5 KB a slot, 3 slots), so the
//      query tile is read again, from L2, once per gallery tile, and the
//      queries' norms are summed slice by slice over the block's first
//      gallery tile. The inner loop, the reduction and the epilogue are
//      the resident ones. D is at most kMaxStreamDim (knn_fused_max_dim).
//   2. knn_merge: one warp per query merges the blocks' partials: each
//      lane keeps a register top-k of its parts (reading a sorted part
//      only until an entry misses its list), then k rounds of a warp
//      shuffle argmin (ties to the lowest index) give the result.
// The gallery's inverse norms come from knn_inv_norm_launch, called once
// when a gallery is indexed (a resident gallery is not read a second time
// on every search).
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kQT = 32;                     // queries per tile, resident
constexpr int kTQ = 8;                      // queries per thread
constexpr int kTR = 4;                      // gallery rows per thread
constexpr int kQG = kQT / kTQ;              // query groups in a warp
constexpr int kRG = 32 / kQG;               // row groups in a warp
constexpr int kRows = kRG * kTR;            // gallery rows per tile
constexpr int kDC = 256;                    // depth per ring stage
constexpr int kWarps = 8;                   // each takes kDC / kWarps depth
constexpr int kThreads = 32 * kWarps;
constexpr int kSubD = kDC / kWarps;
constexpr int kTPQ = kThreads / kQT;        // epilogue threads per query
constexpr int kRPT = kRows / kTPQ;          // epilogue rows per thread
constexpr int kGStride = kDC + 4;           // padded stage row, in floats
constexpr int kStageFloats = kRows * kGStride;
constexpr int kRedFloats = kWarps * kQT * kRows;
// the query tile takes 33 KB at the least (D <= 256), so at most 5 stages
// fit an H100's 227 KB; the cap keeps cp_async_wait_pending's range
constexpr int kMaxStages = 5;
constexpr int kMinStages = 2;
constexpr int kMergeWarps = 4;
// widest D the streamed-query scan takes: 16 depth chunks, past
// MACResNet's widest descriptor (c1..c5, 3904)
constexpr int kMaxStreamDim = 4096;

// kernels this file has launched, read by knn_fused_kernels_launched
unsigned long long kernels_launched = 0;

static_assert(kQG * kRG == 32, "a warp covers the query tile");
static_assert(kSubD % 4 == 0, "a warp's depth slice is whole float4s");
static_assert(kTPQ <= 32 && kRows % kTPQ == 0, "epilogue mapping");
static_assert(kRows * kDC / 4 % kThreads == 0, "whole float4s a thread");
static_assert(kRedFloats <= kStageFloats, "the reduction fits a ring slot");
static_assert(kRows == kQT, "a query slice loads as a gallery stage does");

__device__ __forceinline__ bool better(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// insert (d, i) into a sorted register list of K slots, best first
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
  if (!better(d, i, bd[K - 1], bi[K - 1])) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (better(d, i, bd[s], bi[s])) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

template <int K>
__device__ __forceinline__ void pop_front(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int s = 0; s + 1 < K; ++s) {
    bd[s] = bd[s + 1];
    bi[s] = bi[s + 1];
  }
  bd[K - 1] = FLT_MAX;
  bi[K - 1] = INT32_MAX;
}

// the best head among `width` lanes (xor butterfly), ties to the lowest
// index; the lane that holds it drops it
template <int K>
__device__ __forceinline__ void take_best(float (&bd)[K], int (&bi)[K],
                                          int width, float* md, int* mi) {
  float d = bd[0];
  int i = bi[0];
  for (int off = 1; off < width; off <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
  if (bd[0] == d && bi[0] == i) pop_front(bd, bi);
  *md = d;
  *mi = i;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n committed groups are pending (n = stages - 2,
// in [0, kMaxStages - 2])
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  static_assert(kMaxStages - 2 == 3, "one case per reachable n");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// one ring stage: rows [row0, row0 + kRows) x depth [d0, d0 + kDC) of a
// gallery (or, streamed, of the queries), zero past its end and past dim
__device__ __forceinline__ void load_stage(float* dst,
                                           const float* __restrict__ g,
                                           int na, int dim, int row0, int d0,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < kRows * kDC / 4 / kThreads; ++u) {
    const int e = tid + u * kThreads;
    const int r = e / (kDC / 4), c = (e % (kDC / 4)) * 4;
    const int grow = row0 + r, gd = d0 + c;
    const bool ok = grow < na && gd < dim;
    cp_async16(dst + r * kGStride + c,
               ok ? g + static_cast<size_t>(grow) * dim + gd : g,
               ok ? 16 : 0);
  }
}

// kStream: the queries stream through the ring beside the gallery
// instead of staying resident (a ring slot is then [gallery][queries])
template <int K, bool kStream>
__global__ void __launch_bounds__(kThreads)
knn_scan(const float* __restrict__ q, const float* __restrict__ g,
         const float* __restrict__ inv_g, int nq, int na, int dim, int dpad,
         int stages, float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kSlot = kStream ? 2 * kStageFloats : kStageFloats;
  const int qstride = kStream ? kGStride : dpad + 4;
  float* sq = smem;                              // resident: [kQT][qstride]
  float* ring = sq + (kStream ? 0 : kQT * qstride);  // [stages][kSlot]
  float* inv_q = ring + stages * kSlot;          // [kQT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = lane / kRG, rg = lane % kRG;    // compute tile
  const int eq = tid / kTPQ, er = (tid % kTPQ) * kRPT;  // epilogue
  const int ntiles = (na + kRows - 1) / kRows;
  const int tile0 = static_cast<int>(
      static_cast<long long>(blockIdx.x) * ntiles / gridDim.x);
  const int tile1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * ntiles / gridDim.x);
  const int nchunks = dpad / kDC;
  const int total = (tile1 - tile0) * nchunks;   // ring stages to stream

  for (int q0 = 0; q0 < nq; q0 += kQT) {
    if constexpr (!kStream) {
      // the query tile, once per block (zero past nq and past dim); it
      // commits with the first stage
      for (int e = tid; e < kQT * (dpad / 4); e += kThreads) {
        const int r = e / (dpad / 4), c = (e % (dpad / 4)) * 4;
        const bool ok = q0 + r < nq && c < dim;
        cp_async16(sq + r * qstride + c,
                   ok ? q + static_cast<size_t>(q0 + r) * dim + c : q,
                   ok ? 16 : 0);
      }
    }
    for (int s = 0; s < stages - 1; ++s) {
      if (s < total) {
        load_stage(ring + s * kSlot, g, na, dim,
                   (tile0 + s / nchunks) * kRows, (s % nchunks) * kDC, tid);
        if constexpr (kStream)
          load_stage(ring + s * kSlot + kStageFloats, q, nq, dim, q0,
                     (s % nchunks) * kDC, tid);
      }
      cp_async_commit();
    }
    // streamed: each warp's partial sums of squares of its 4 queries
    float qss[kQT / kWarps];
#pragma unroll
    for (int j = 0; j < kQT / kWarps; ++j) qss[j] = 0.0f;

    float bd[K];
    int bi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = FLT_MAX;
      bi[s] = INT32_MAX;
    }
    float acc[kTQ][kTR];
#pragma unroll
    for (int j = 0; j < kTQ; ++j)
#pragma unroll
      for (int m = 0; m < kTR; ++m) acc[j][m] = 0.0f;

    for (int it = 0; it < total; ++it) {
      const int slot = it % stages;
      cp_async_wait_pending(stages - 2);  // stage `it` (and the queries)
      __syncthreads();                    // ... visible; slot it-1 free
      if constexpr (kStream) {
        // the queries' norms over the first gallery tile's depth chunks:
        // warp w sums queries 4w .. 4w + 3, 128 depth a pass; inv_q is
        // read after the epilogue's first barrier of this iteration
        if (it < nchunks) {
          const float* qsl = ring + slot * kSlot + kStageFloats;
#pragma unroll
          for (int j = 0; j < kQT / kWarps; ++j) {
            const int r = warp * (kQT / kWarps) + j;
#pragma unroll
            for (int c = lane * 4; c < kDC; c += 128) {
              const float4 v =
                  *reinterpret_cast<const float4*>(qsl + r * kGStride + c);
              qss[j] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
            }
          }
          if (it == nchunks - 1) {
#pragma unroll
            for (int j = 0; j < kQT / kWarps; ++j) {
              float ss = qss[j];
              for (int off = 16; off > 0; off >>= 1)
                ss += __shfl_xor_sync(0xffffffffu, ss, off);
              if (lane == 0)
                inv_q[warp * (kQT / kWarps) + j] =
                    1.0f / fmaxf(sqrtf(ss), 1e-8f);
            }
          }
        }
      } else if (it == 0) {
        // the queries' inverse norms: warp w takes queries 4w .. 4w + 3
#pragma unroll
        for (int j = 0; j < kQT / kWarps; ++j) {
          const int r = warp * (kQT / kWarps) + j;
          float ss = 0.0f;
          for (int c = lane * 4; c < dpad; c += 128) {
            const float4 v =
                *reinterpret_cast<const float4*>(sq + r * qstride + c);
            ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
          }
          for (int off = 16; off > 0; off >>= 1)
            ss += __shfl_xor_sync(0xffffffffu, ss, off);
          if (lane == 0) inv_q[r] = 1.0f / fmaxf(sqrtf(ss), 1e-8f);
        }
      }
      const int nx = it + stages - 1;
      if (nx < total) {
        load_stage(ring + (nx % stages) * kSlot, g, na, dim,
                   (tile0 + nx / nchunks) * kRows, (nx % nchunks) * kDC, tid);
        if constexpr (kStream)
          load_stage(ring + (nx % stages) * kSlot + kStageFloats, q, nq, dim,
                     q0, (nx % nchunks) * kDC, tid);
      }
      cp_async_commit();

      const int chunk = it % nchunks;
      const float* gs = ring + slot * kSlot + rg * kGStride + warp * kSubD;
      const float* qs =
          kStream ? ring + slot * kSlot + kStageFloats + qg * kGStride
                        + warp * kSubD
                  : sq + qg * qstride + chunk * kDC + warp * kSubD;
#pragma unroll
      for (int s = 0; s < kSubD; s += 4) {
        float4 a[kTQ], b[kTR];
#pragma unroll
        for (int j = 0; j < kTQ; ++j)
          a[j] = *reinterpret_cast<const float4*>(qs + j * kQG * qstride + s);
#pragma unroll
        for (int m = 0; m < kTR; ++m)
          b[m] = *reinterpret_cast<const float4*>(gs + m * kRG * kGStride
                                                  + s);
#pragma unroll
        for (int j = 0; j < kTQ; ++j)
#pragma unroll
          for (int m = 0; m < kTR; ++m) {
            acc[j][m] = fmaf(a[j].x, b[m].x, acc[j][m]);
            acc[j][m] = fmaf(a[j].y, b[m].y, acc[j][m]);
            acc[j][m] = fmaf(a[j].z, b[m].z, acc[j][m]);
            acc[j][m] = fmaf(a[j].w, b[m].w, acc[j][m]);
          }
      }

      if (chunk == nchunks - 1) {
        // tile done: sum the warps' depth slices through the ring slot
        // just consumed ([kWarps][kQT][kRows]; the next load into it is
        // issued after the next iteration's barrier), rank the rows
        __syncthreads();
        float* red = ring + slot * kSlot;
#pragma unroll
        for (int j = 0; j < kTQ; ++j)
#pragma unroll
          for (int m = 0; m < kTR; ++m) {
            red[(warp * kQT + qg + kQG * j) * kRows + rg + kRG * m] =
                acc[j][m];
            acc[j][m] = 0.0f;
          }
        __syncthreads();
        const int row0 = (tile0 + it / nchunks) * kRows;
        const float iq = inv_q[eq];
#pragma unroll
        for (int rr = 0; rr < kRPT; ++rr) {
          const int r = er + rr, grow = row0 + r;
          if (grow < na) {
            float dot = red[eq * kRows + r];
#pragma unroll
            for (int w = 1; w < kWarps; ++w)
              dot += red[(w * kQT + eq) * kRows + r];
            insert(bd, bi, 1.0f - dot * iq * inv_g[grow], grow);
          }
        }
      }
    }

    // the threads of a query merge into the block's partial top-K
    for (int s = 0; s < K; ++s) {
      float md;
      int mi;
      take_best(bd, bi, kTPQ, &md, &mi);
      if (tid % kTPQ == 0 && q0 + eq < nq) {
        const size_t o =
            (static_cast<size_t>(q0 + eq) * gridDim.x + blockIdx.x) * K + s;
        part_d[o] = md;
        part_i[o] = mi;
      }
    }
    // every warp is past its reads of `red` (a ring slot) and `inv_q`
    // before the next query tile's prologue loads into the ring
    __syncthreads();
  }
}

template <int K>
__global__ void __launch_bounds__(32 * kMergeWarps)
knn_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
          int nq, int nparts, int k, float* __restrict__ out_d,
          int64_t* __restrict__ out_i) {
  const int qr = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (qr >= nq) return;  // whole warps leave
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = FLT_MAX;
    bi[s] = INT32_MAX;
  }
  // a lane takes whole parts; each part's list is sorted, so the first
  // entry that misses the lane's list ends that part
  for (int p = lane; p < nparts; p += 32) {
    const size_t o = (static_cast<size_t>(qr) * nparts + p) * K;
    for (int s = 0; s < K; ++s) {
      const float d = part_d[o + s];
      const int i = part_i[o + s];
      if (!better(d, i, bd[K - 1], bi[K - 1])) break;
      insert(bd, bi, d, i);
    }
  }
  for (int s = 0; s < k; ++s) {
    float md;
    int mi;
    take_best(bd, bi, 32, &md, &mi);
    if (lane == 0) {
      out_d[static_cast<size_t>(qr) * k + s] = md;
      out_i[static_cast<size_t>(qr) * k + s] = mi;
    }
  }
}

__global__ void knn_inv_norm(const float* __restrict__ x, int rows, int dim,
                             float* __restrict__ inv) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const float* row = x + static_cast<size_t>(warp) * dim;
  float ss = 0.0f;
  for (int d = lane; d < dim; d += 32) ss += row[d] * row[d];
  for (int off = 16; off > 0; off /= 2)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) inv[warp] = 1.0f / fmaxf(sqrtf(ss), 1e-8f);
}

struct Plan {
  int dpad, stages, smem, nparts;
  bool stream;  // the queries stream through the ring (D past resident)
};

// shared memory besides the ring: the resident query tile and its norms,
// or (streamed) the norms alone
size_t fixed_smem(int dpad, bool stream) {
  return sizeof(float)
         * ((stream ? 0 : static_cast<size_t>(kQT) * (dpad + 4)) + kQT);
}

size_t slot_bytes(bool stream) {
  return sizeof(float) * kStageFloats * (stream ? 2 : 1);
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

int resident_max_dim() {
  int dpad = 0;
  while (fixed_smem(dpad + kDC, false) + kMinStages * slot_bytes(false)
         <= static_cast<size_t>(smem_optin()))
    dpad += kDC;
  return dpad;
}

template <int K, bool kStream>
cudaError_t configure(int dev, int na, Plan* p) {
  const size_t fixed = fixed_smem(p->dpad, kStream);
  const size_t slot = slot_bytes(kStream);
  const size_t optin = static_cast<size_t>(smem_optin());
  if (fixed + kMinStages * slot > optin) return cudaErrorInvalidValue;
  const size_t fit = (optin - fixed) / slot;
  p->stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  p->smem = static_cast<int>(fixed + p->stages * slot);
  cudaError_t err = cudaFuncSetAttribute(
      knn_scan<K, kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p->smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, knn_scan<K, kStream>, kThreads, p->smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (na + kRows - 1) / kRows;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  p->nparts = ntiles < resident ? ntiles : resident;
  return cudaSuccess;
}

template <int K>
cudaError_t plan_for(int na, int dim, Plan* p) {
  // the last plan per K: a search repeats the gallery's shape
  static int last_dev = -1, last_na = -1, last_dim = -1;
  static Plan last;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev == last_dev && na == last_na && dim == last_dim) {
    *p = last;
    return cudaSuccess;
  }
  if (dim > kMaxStreamDim) return cudaErrorInvalidValue;
  p->dpad = (dim + kDC - 1) / kDC * kDC;
  p->stream = p->dpad > resident_max_dim();
  const cudaError_t err = p->stream ? configure<K, true>(dev, na, p)
                                    : configure<K, false>(dev, na, p);
  if (err != cudaSuccess) return err;
  last = *p;
  last_dev = dev;
  last_na = na;
  last_dim = dim;
  return cudaSuccess;
}

template <int K>
cudaError_t launch(const float* q, const float* g, const float* inv_g, int nq,
                   int na, int dim, int k, float* part_d, int* part_i,
                   float* out_d, int64_t* out_i, cudaStream_t s) {
  Plan p;
  cudaError_t err = plan_for<K>(na, dim, &p);
  if (err != cudaSuccess) return err;
  if (p.stream)
    knn_scan<K, true><<<p.nparts, kThreads, p.smem, s>>>(
        q, g, inv_g, nq, na, dim, p.dpad, p.stages, part_d, part_i);
  else
    knn_scan<K, false><<<p.nparts, kThreads, p.smem, s>>>(
        q, g, inv_g, nq, na, dim, p.dpad, p.stages, part_d, part_i);
  ++kernels_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge<K><<<(nq + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
                 s>>>(part_d, part_i, nq, p.nparts, k, out_d, out_i);
  ++kernels_launched;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// x (rows, dim) f32, contiguous -> inv (rows,) f32, 1 / max(||x||, 1e-8).
int knn_inv_norm_launch(const void* x, int rows, int dim, void* inv,
                        void* stream) {
  constexpr int warps_per_block = 8;
  if (rows > 0) {
    knn_inv_norm<<<(rows + warps_per_block - 1) / warps_per_block,
                   32 * warps_per_block, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), rows, dim, static_cast<float*>(inv));
    ++kernels_launched;
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernels launched from this file so far (knn_inv_norm, knn_scan and
// knn_merge each count one), for counting a search's launches.
unsigned long long knn_fused_kernels_launched() { return kernels_launched; }

// Largest dim whose query tile stays resident beside a 2-stage ring in
// one block's shared memory (1280 on an H100); wider queries stream.
int knn_fused_resident_max_dim() { return resident_max_dim(); }

// Largest dim the scan takes: kMaxStreamDim where a 2-slot streamed ring
// fits one block's shared memory (4096 on an H100), else the resident
// maximum.
int knn_fused_max_dim() {
  return fixed_smem(0, true) + kMinStages * slot_bytes(true)
                 <= static_cast<size_t>(smem_optin())
             ? kMaxStreamDim
             : resident_max_dim();
}

// Partial top-k lists per query (the scan's grid size); the caller
// allocates part_d and part_i of nq * parts * (k == 1 ? 1 : 8) entries.
// Negative when dim is out of range.
int knn_fused_parts(int na, int dim, int k) {
  Plan p;
  const cudaError_t err =
      k == 1 ? plan_for<1>(na, dim, &p) : plan_for<kMaxK>(na, dim, &p);
  return err == cudaSuccess ? p.nparts : -static_cast<int>(err);
}

// q (nq, dim), g (na, dim): f32, contiguous, 16-byte aligned, dim % 4 == 0;
// inv_g (na,) the gallery's knn_inv_norm_launch. out_d (nq, k) f32, out_i
// (nq, k) int64. Requires 1 <= k <= 8 and k <= na.
int knn_fused_launch(const void* q, const void* g, const void* inv_g,
                     int nq, int na, int dim, int k, void* part_d,
                     void* part_i, void* out_d, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || k > na || dim % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(g))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* gf = static_cast<const float*>(g);
  const auto* ig = static_cast<const float*>(inv_g);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int64_t*>(out_i);
  const cudaError_t err =
      k == 1 ? launch<1>(qf, gf, ig, nq, na, dim, k, pd, pi, od, oi, s)
             : launch<kMaxK>(qf, gf, ig, nq, na, dim, k, pd, pi, od, oi, s);
  return static_cast<int>(err);
}

const char* knn_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
