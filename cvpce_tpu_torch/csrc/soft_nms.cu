// Sequential Soft-NMS re-scoring (Bodla et al. 2017): one block per image.
//
// Replaces the TPU kernel cvpce_tpu/ops/nms_pallas.py:_soft_nms_kernel
// (driven by soft_nms_scores_pallas). The wrapper is
// cvpce_tpu_torch/ops/nms.py:soft_nms_scores_fused; its plain version
// soft_nms_scores computes the same rounds with torch ops.
//
// Semantics, as in _soft_nms_kernel: invalid entries start processed.
// Each round picks the unprocessed entry of highest current score (the
// lowest index on ties), marks it processed, and multiplies every other
// unprocessed score by exp(-iou^2 / sigma) (gaussian) or, where
// iou > thresh, by 1 - iou (linear). It stops when no unprocessed entry
// is left (the round's maximum is <= -1e37). The output is the current
// score of each valid entry and 0 at invalid ones. The IoU is
// inter / max((area_w + area_j) - inter, 1e-12) with the plain version's
// expression order; the file is built with -fmad=false, and expf is the
// CUDA math library's, so each decay rounds as torch's does.
//
// Bound: N dependent rounds (one per valid candidate, up to 5120 per
// image on the serving path), each an argmax over N scores followed by
// an IoU row and N decays: ~N^2 IoUs, microseconds of work for the card,
// on 100 KB of input per image. The kernel is bound by the latency of
// the dependent rounds. Design: boxes, areas, current scores and
// processed flags live in dynamic shared memory (28 B per entry, 140 KB
// at N = 5120); each thread owns the entries j = tid mod 1024, so the
// decay and the next round's scan touch only its own entries and need no
// barrier. One block holds one SM, so a round's cost is the SM's
// instruction throughput over N entries: the divisions and expf run only
// for boxes that overlap the winner (the others' decay is exactly 1). A
// round pays two barriers: one after each warp's shuffle-reduced
// (score, index) maximum, one after warp 0 combines the 32 partial
// maxima into the winner. Images of a batch run as independent blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3.0e38f;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
soft_nms_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int n, float sigma,
                float thresh, int linear, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;
  float* sarea = reinterpret_cast<float*>(sbox + n);
  float* scur = sarea + n;
  int* sproc = reinterpret_cast<int*>(scur + n);
  __shared__ float part_v[kWarps];
  __shared__ int part_i[kWarps];
  __shared__ int winner;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t base = static_cast<size_t>(b) * n;
  for (int j = tid; j < n; j += kThreads) {
    const float4 v = boxes[base + j];
    sbox[j] = v;
    sarea[j] = (v.z - v.x) * (v.w - v.y);
    scur[j] = scores[base + j];
    sproc[j] = valid[base + j] ? 0 : 1;
  }
  __syncthreads();

  for (;;) {
    float best = kNeg;
    int bi = kNoIndex;
    for (int j = tid; j < n; j += kThreads) {
      // j rises, so a later equal score never replaces an earlier one
      if (!sproc[j] && scur[j] > best) {
        best = scur[j];
        bi = j;
      }
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      part_v[warp] = best;
      part_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = part_v[lane];
      bi = part_i[lane];
      warp_argmax(best, bi);
      if (lane == 0) winner = best > -1.0e37f ? bi : -1;
    }
    __syncthreads();
    const int w = winner;
    if (w < 0) break;
    const float4 r = sbox[w];
    const float ra = sarea[w];
    for (int j = tid; j < n; j += kThreads) {
      if (sproc[j]) continue;
      if (j == w) {
        sproc[j] = 1;
        continue;
      }
      const float4 c = sbox[j];
      const float ix1 = fmaxf(r.x, c.x);
      const float iy1 = fmaxf(r.y, c.y);
      const float ix2 = fminf(r.z, c.z);
      const float iy2 = fminf(r.w, c.w);
      const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
      // a disjoint box has IoU +0, so its decay is exactly 1 (exp(-0) or
      // the linear rule's 1) and its score stays as it is: skip it
      if (inter == 0.0f) continue;
      const float uni = (ra + sarea[j]) - inter;
      const float iou = inter / fmaxf(uni, 1e-12f);
      const float decay = linear ? (iou > thresh ? 1.0f - iou : 1.0f)
                                 : expf(-(iou * iou) / sigma);
      scur[j] = scur[j] * decay;
    }
  }

  for (int j = tid; j < n; j += kThreads) {
    out[base + j] = valid[base + j] ? scur[j] : 0.0f;
  }
}

}  // namespace

extern "C" {

// Largest N one block can hold in shared memory.
int soft_nms_max_n() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return (bytes - 1024) / 28;
}

// boxes: (batch, n, 4) f32; scores: (batch, n) f32; valid: (batch, n)
// uint8; out: (batch, n) f32. All contiguous, in input order (no sort).
int soft_nms_launch(const void* boxes, const void* scores, const void* valid,
                    void* out, int batch, int n, float sigma, float thresh,
                    int linear, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 28;
  cudaError_t err = cudaFuncSetAttribute(
      soft_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  soft_nms_kernel<<<batch, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), n, sigma, thresh, linear,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* soft_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
