// Fused L2-normalize + cosine distance + top-k kNN over a gallery.
//
// Replaces the TPU kernel cvpce_tpu/ops/knn_pallas.py:_knn_kernel (driven
// by nearest_neighbors_fused). On the TPU one core streams 512-row
// gallery tiles in order and carries a running top-k in scratch; here the
// blocks split the gallery across the SMs, each writes a partial top-k,
// and a second kernel merges the partials (blocks run in no order, so
// nothing carries over between them).
//
// Three launches, all from this file:
//   1. knn_inv_norm: one warp per row, 1 / max(||x||, 1e-8) for every
//      query row. The gallery's rows take the same pass once, through
//      knn_inv_norm_launch, when the gallery is indexed: a resident
//      gallery is not read a second time on every query batch.
//   2. knn_tile: a block takes 64 gallery rows against up to 32 queries,
//      computes the f32 dot products with its own shared-memory tiling
//      (no cuBLAS), dist = 1 - (q . g) * inv_q * inv_g, and keeps the best
//      k (k <= 8) per query; ties go to the lowest gallery index.
//   3. knn_merge: one warp per query merges the blocks' partials into the
//      final k, ascending by distance, ties to the lowest index.
// Rows past the gallery's end are masked: only real entries are ranked
// (the TPU wrapper's zero pad rows, distance 1.0, are not reproduced).
//
// Bound at Q = 32, A = 8192, D = 1024: 2*Q*A*D = 0.54 GFLOP of f32 FMA
// (8 us at 67 TFLOP/s) and a 32 MB gallery read (10 us at 3.35 TB/s):
// bytes bound it, by a little. The tile kernel reads each gallery row
// once per 32 queries, from device memory into shared memory, and the
// (Q, A) distance matrix never leaves the SM.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kQ = 32;        // queries per block
constexpr int kG = 64;        // gallery rows per block
constexpr int kDC = 64;       // depth per shared-memory chunk
constexpr int kPad = kDC + 1; // row stride, avoids bank conflicts
constexpr int kThreads = 256; // 32 queries x 8 row groups

__device__ __forceinline__ bool better(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// insert (d, i) into a sorted list of k slots, best first
__device__ __forceinline__ void insert(float* bd, int* bi, int k, float d,
                                       int i) {
  if (!better(d, i, bd[k - 1], bi[k - 1])) return;
  int s = k - 1;
  while (s > 0 && better(d, i, bd[s - 1], bi[s - 1])) {
    bd[s] = bd[s - 1];
    bi[s] = bi[s - 1];
    --s;
  }
  bd[s] = d;
  bi[s] = i;
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

__global__ void __launch_bounds__(kThreads)
knn_tile(const float* __restrict__ q, const float* __restrict__ g,
         const float* __restrict__ inv_q, const float* __restrict__ inv_g,
         int nq, int na, int dim, int k, float* __restrict__ part_d,
         int* __restrict__ part_i) {
  __shared__ float sq[kQ * kPad];
  __shared__ float sg[kG * kPad];
  __shared__ float cand_d[kQ][kG];
  __shared__ int cand_i[kQ][kG];

  const int t = threadIdx.x;
  const int qi = t / 8;          // this thread's query within the block
  const int grp = t % 8;         // rows grp, grp + 8, ..., grp + 56
  const int q0 = blockIdx.y * kQ;
  const int g0 = blockIdx.x * kG;

  float acc[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc[m] = 0.0f;

  for (int d0 = 0; d0 < dim; d0 += kDC) {
    for (int e = t; e < kQ * kDC; e += kThreads) {
      const int r = e / kDC, c = e % kDC;
      const int qr = q0 + r, dc = d0 + c;
      sq[r * kPad + c] = (qr < nq && dc < dim)
          ? q[static_cast<size_t>(qr) * dim + dc] : 0.0f;
    }
    for (int e = t; e < kG * kDC; e += kThreads) {
      const int r = e / kDC, c = e % kDC;
      const int gr = g0 + r, dc = d0 + c;
      sg[r * kPad + c] = (gr < na && dc < dim)
          ? g[static_cast<size_t>(gr) * dim + dc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kDC; ++c) {
      const float qv = sq[qi * kPad + c];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m] += qv * sg[(grp + 8 * m) * kPad + c];
    }
    __syncthreads();
  }

  const int qr = q0 + qi;
  const float iq = qr < nq ? inv_q[qr] : 0.0f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = grp + 8 * m;
    const int gr = g0 + r;
    const bool real = gr < na;
    cand_d[qi][r] = real ? 1.0f - acc[m] * iq * inv_g[gr] : FLT_MAX;
    cand_i[qi][r] = real ? gr : INT32_MAX;
  }
  __syncthreads();

  if (grp == 0 && qr < nq) {
    float bd[kMaxK];
    int bi[kMaxK];
    for (int s = 0; s < k; ++s) { bd[s] = FLT_MAX; bi[s] = INT32_MAX; }
    for (int r = 0; r < kG; ++r) insert(bd, bi, k, cand_d[qi][r], cand_i[qi][r]);
    const size_t base = (static_cast<size_t>(qr) * gridDim.x + blockIdx.x) * k;
    for (int s = 0; s < k; ++s) {
      part_d[base + s] = bd[s];
      part_i[base + s] = bi[s];
    }
  }
}

__global__ void knn_merge(const float* __restrict__ part_d,
                          const int* __restrict__ part_i, int nq,
                          int nparts, int k, float* __restrict__ out_d,
                          int64_t* __restrict__ out_i) {
  __shared__ float sd[32 * kMaxK];
  __shared__ int si[32 * kMaxK];
  const int qr = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(qr) * nparts * k;
  float bd[kMaxK];
  int bi[kMaxK];
  for (int s = 0; s < k; ++s) { bd[s] = FLT_MAX; bi[s] = INT32_MAX; }
  for (int c = lane; c < nparts * k; c += 32)
    insert(bd, bi, k, part_d[base + c], part_i[base + c]);
  for (int s = 0; s < k; ++s) {
    sd[lane * k + s] = bd[s];
    si[lane * k + s] = bi[s];
  }
  __syncwarp();
  if (lane == 0) {
    for (int c = k; c < 32 * k; ++c) insert(bd, bi, k, sd[c], si[c]);
    for (int s = 0; s < k; ++s) {
      out_d[static_cast<size_t>(qr) * k + s] = bd[s];
      out_i[static_cast<size_t>(qr) * k + s] = bi[s];
    }
  }
}

void launch_inv_norm(const float* x, int rows, int dim, float* inv,
                     cudaStream_t s) {
  constexpr int warps_per_block = 8;
  if (rows > 0)
    knn_inv_norm<<<(rows + warps_per_block - 1) / warps_per_block,
                   32 * warps_per_block, 0, s>>>(x, rows, dim, inv);
}

}  // namespace

extern "C" {

// x (rows, dim) f32, contiguous -> inv (rows,) f32, 1 / max(||x||, 1e-8).
int knn_inv_norm_launch(const void* x, int rows, int dim, void* inv,
                        void* stream) {
  launch_inv_norm(static_cast<const float*>(x), rows, dim,
                  static_cast<float*>(inv), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Scratch the caller allocates: inv_q (nq floats), part_d and part_i
// (nq * knn_fused_parts(na) * k each).
int knn_fused_parts(int na) { return (na + kG - 1) / kG; }

// q (nq, dim), g (na, dim): f32, contiguous; inv_g (na,) the gallery's
// knn_inv_norm_launch. out_d (nq, k) f32, out_i (nq, k) int64. Requires
// 1 <= k <= 8 and k <= na.
int knn_fused_launch(const void* q, const void* g, const void* inv_g,
                     int nq, int na, int dim, int k, void* inv_q,
                     void* part_d, void* part_i, void* out_d, void* out_i,
                     void* stream) {
  if (k < 1 || k > kMaxK || k > na) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_inv_norm(static_cast<const float*>(q), nq, dim,
                  static_cast<float*>(inv_q), s);
  const int nparts = knn_fused_parts(na);
  dim3 grid(nparts, (nq + kQ - 1) / kQ);
  knn_tile<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(g),
      static_cast<const float*>(inv_q), static_cast<const float*>(inv_g),
      nq, na, dim, k, static_cast<float*>(part_d),
      static_cast<int*>(part_i));
  knn_merge<<<nq, 32, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      nq, nparts, k, static_cast<float*>(out_d),
      static_cast<int64_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

const char* knn_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
