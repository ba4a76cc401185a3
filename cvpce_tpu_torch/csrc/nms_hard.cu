// Greedy hard NMS over score-sorted boxes: one block per image.
//
// Replaces the TPU kernel cvpce_tpu/ops/nms_pallas.py:_nms_kernel (driven
// by nms_keep_sorted / nms_mask_pallas). The wrapper
// (cvpce_tpu_torch/ops/nms.py:nms_keep_sorted) pads, masks invalid scores
// to -inf, sorts stably by descending score and scatters the keep flags
// back to input order in torch; this kernel only walks the sorted list.
//
// Semantics, as in _nms_kernel: candidate i, if nothing before it has
// suppressed it, suppresses every later box j with
//   inter / max(union, 1e-12) > thresh,
// with inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0) and
// union = (area_i + area_j) - inter, in that expression order. The file
// is built without fast-math and with -fmad=false, so every IoU rounds as
// the plain torch version's does and the keep flags are bit-equal.
//
// Bound: the walk has N sequential steps (N = 5120 candidates per image
// on the serving path) and each live step tests up to N later boxes:
// about N^2 / 2 = 13 M IoUs per image, ~10 flops each, which the card
// does in microseconds. The inputs are 80 KB per image. So the kernel is
// bound by the latency of the N dependent steps (a block barrier each),
// neither by FLOPs nor by bytes. Design: the image's boxes and areas sit
// in dynamic shared memory (24 B per box, 120 KB at N = 5120), the
// suppression flags too; a step whose candidate is already suppressed
// costs one shared-memory read and no barrier, since every thread sees
// the same flag. Images of a batch run as independent blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
nms_hard_kernel(const float4* __restrict__ boxes,
                const int* __restrict__ n_walk, int n, float thresh,
                uint8_t* __restrict__ keep) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;
  float* sarea = reinterpret_cast<float*>(sbox + n);
  volatile int* supp = reinterpret_cast<int*>(sarea + n);

  const int b = blockIdx.x;
  const float4* img = boxes + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4 v = img[j];
    sbox[j] = v;
    sarea[j] = (v.z - v.x) * (v.w - v.y);
    supp[j] = 0;
  }
  __syncthreads();

  const int walk = n_walk[b] < n ? n_walk[b] : n;
  for (int i = 0; i < walk; ++i) {
    // supp[i] was last written before the latest barrier: every thread
    // reads the same value and takes the same branch
    if (supp[i]) continue;
    const float4 r = sbox[i];
    const float ra = sarea[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      const float4 c = sbox[j];
      const float ix1 = fmaxf(r.x, c.x);
      const float iy1 = fmaxf(r.y, c.y);
      const float ix2 = fminf(r.z, c.z);
      const float iy2 = fminf(r.w, c.w);
      const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
      const float uni = (ra + sarea[j]) - inter;
      const float iou = inter / fmaxf(uni, 1e-12f);
      if (iou > thresh) supp[j] = 1;
    }
    __syncthreads();
  }

  uint8_t* out = keep + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    out[j] = supp[j] ? 0 : 1;
  }
}

}  // namespace

extern "C" {

// Largest N one block can hold in shared memory.
int nms_hard_max_n() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes / 24;
}

// boxes: (batch, n, 4) f32, sorted by descending score, contiguous.
// n_walk: (batch,) int32, candidates to walk per image (later ones are
// invalid and cannot affect valid ones). keep: (batch, n) uint8 out.
int nms_hard_launch(const void* boxes, const void* n_walk, void* keep,
                    int batch, int n, float thresh, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 24;
  cudaError_t err = cudaFuncSetAttribute(
      nms_hard_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_hard_kernel<<<batch, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(n_walk), n,
      thresh, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

const char* nms_hard_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
