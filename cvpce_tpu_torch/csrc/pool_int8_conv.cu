// Fused maxpool 2x2/s2 -> per-tensor int8 quantize -> 3x3 same-pad int8
// conv (int32 accumulation) -> f32 dequant + bias (+ ReLU), NHWC.
//
// Replaces the TPU kernel cvpce_tpu/ops/conv_pallas.py:_kernel (driven by
// fused_pool_int8_conv, with its MXU tap packing _pack_kernel). The
// wrapper is cvpce_tpu_torch/ops/conv_fused.py:fused_pool_int8_conv; its
// plain version pool_int8_conv_plain is the composition this kernel
// must equal: the int32 accumulators bit for bit, the epilogue
// `float(acc) * scale + bias` rounded after the multiply and after the
// add (no FMA, as the torch ops round), then cast to the output type
// with round-to-nearest-even.
//
// Bound: at the VGG block-boundary sites (e.g. B = 128, 256^2 x 64 bf16
// in, 128^2 x 128 bf16 out) the kernel must read the pre-pool input once
// and write the output once: ~1.6 GB, against ~0.3 T int8 operations.
// On an H100 the bytes take longer than the tensor-core int8 operations,
// so the fused kernel is bound by bytes, and its point is that the
// pooled, quantized intermediate never leaves shared memory.
//
// Design (correct first): a block takes one strip of SH pooled output
// rows, one batch element and a tile of 64 output channels. It pools and
// quantizes the SH + 2 pooled rows the strip needs (one halo row above
// and below, zero outside the image = the conv's zero padding) into
// shared memory as int8, with a zero column on each side. Each thread
// then accumulates 4 pixels x 4 output channels over the 9 taps with
// __dp4a (4 int8 products per instruction) on words of 4 input channels;
// the weights come from device memory through the read-only cache,
// packed as (9, Cin/4, Cout) words so a thread's 4 channels are one
// 16-byte load. Tensor-core int8 (mma.sync / wgmma s8) and TMA loads are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoTile = 64;  // output channels per block
constexpr int kPx = 4;       // pixels per thread (consecutive columns)
constexpr int kCo = 4;       // output channels per thread
constexpr int kSmemBudget = 110 * 1024;  // two blocks per SM

enum OutKind { kF32 = 0, kBF16 = 1, kI32 = 2 };

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

template <typename TIn, int OUT>
__global__ void __launch_bounds__(kThreads)
pool_int8_conv_kernel(const TIn* __restrict__ x,
                      const int* __restrict__ w,  // (9, Cin/4, Cout) words
                      const float* __restrict__ a_scale_p,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, void* __restrict__ out,
                      int fuse_relu, int H, int W, int Cin, int Cout,
                      int SH) {
  extern __shared__ int tile[];  // (SH + 2) x TQ x Cin/4 words of 4 int8
  const int P = H / 2, Q = W / 2;
  const int QP = (Q + kPx - 1) / kPx * kPx;  // columns padded to kPx
  const int TQ = QP + 2;
  const int cin4 = Cin / 4;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * SH;
  const int rows = min(SH, P - r0);
  const int TR = rows + 2;
  const int co_base = blockIdx.x * kCoTile;
  const float a_scale = *a_scale_p;

  // pool + quantize pooled rows r0 - 1 .. r0 + rows, columns -1 .. QP
  const int items = TR * TQ * cin4;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c4 = it % cin4;
    const int rest = it / cin4;
    const int tq = rest % TQ;
    const int pr = r0 - 1 + rest / TQ;
    const int pc = tq - 1;
    uint32_t packed = 0;
    if (pr >= 0 && pr < P && pc >= 0 && pc < Q) {
      const TIn* p00 = x + ((static_cast<size_t>(b) * H + 2 * pr) * W
                            + 2 * pc) * Cin + 4 * c4;
      float v00[4], v01[4], v10[4], v11[4];
      load4(p00, v00);
      load4(p00 + Cin, v01);
      load4(p00 + static_cast<size_t>(W) * Cin, v10);
      load4(p00 + static_cast<size_t>(W) * Cin + Cin, v11);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float m = fmaxf(fmaxf(v00[k], v01[k]), fmaxf(v10[k], v11[k]));
        float qv = rintf(m / a_scale);  // IEEE division, half to even
        qv = fminf(fmaxf(qv, -127.0f), 127.0f);
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                      static_cast<int8_t>(static_cast<int>(qv)))) << (8 * k);
      }
    }
    tile[it] = static_cast<int>(packed);
  }
  __syncthreads();

  const int co_groups = kCoTile / kCo;
  const int q_groups = QP / kPx;
  const int tiles = rows * q_groups * co_groups;
  for (int mt = threadIdx.x; mt < tiles; mt += kThreads) {
    const int co0 = co_base + (mt % co_groups) * kCo;
    if (co0 >= Cout) continue;
    const int pix = mt / co_groups;
    const int r = pix / q_groups;        // output row within the strip
    const int q0 = (pix % q_groups) * kPx;
    int acc[kPx][kCo];
#pragma unroll
    for (int p = 0; p < kPx; ++p)
#pragma unroll
      for (int c = 0; c < kCo; ++c) acc[p][c] = 0;

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int* arow = tile + ((r + dy) * TQ + q0 + dx) * cin4;
      const int* wrow = w + static_cast<size_t>(tap) * cin4 * Cout + co0;
      for (int c4 = 0; c4 < cin4; ++c4) {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(
            wrow + static_cast<size_t>(c4) * Cout));
#pragma unroll
        for (int p = 0; p < kPx; ++p) {
          const int av = arow[p * cin4 + c4];
          acc[p][0] = __dp4a(av, wv.x, acc[p][0]);
          acc[p][1] = __dp4a(av, wv.y, acc[p][1]);
          acc[p][2] = __dp4a(av, wv.z, acc[p][2]);
          acc[p][3] = __dp4a(av, wv.w, acc[p][3]);
        }
      }
    }

    float sc[kCo], bs[kCo];
    if (OUT != kI32) {
#pragma unroll
      for (int c = 0; c < kCo; ++c) {
        sc[c] = scale[co0 + c];
        bs[c] = bias[co0 + c];
      }
    }
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int q = q0 + p;
      if (q >= Q) continue;
      const size_t o = ((static_cast<size_t>(b) * P + r0 + r) * Q + q)
                       * Cout + co0;
      if (OUT == kI32) {
        *reinterpret_cast<int4*>(static_cast<int*>(out) + o) =
            make_int4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
        continue;
      }
      float y[kCo];
#pragma unroll
      for (int c = 0; c < kCo; ++c)
        y[c] = __fadd_rn(__fmul_rn(__int2float_rn(acc[p][c]), sc[c]), bs[c]);
      if (OUT == kF32) {
        if (fuse_relu) {
#pragma unroll
          for (int c = 0; c < kCo; ++c) y[c] = fmaxf(y[c], 0.0f);
        }
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
            make_float4(y[0], y[1], y[2], y[3]);
      } else {
        __nv_bfloat16 yb[kCo];
#pragma unroll
        for (int c = 0; c < kCo; ++c) {
          yb[c] = __float2bfloat16_rn(y[c]);
          if (fuse_relu && __bfloat162float(yb[c]) < 0.0f)
            yb[c] = __float2bfloat16_rn(0.0f);
        }
        uint2 packed;
        packed.x = static_cast<uint32_t>(__bfloat16_as_ushort(yb[0]))
                   | (static_cast<uint32_t>(__bfloat16_as_ushort(yb[1])) << 16);
        packed.y = static_cast<uint32_t>(__bfloat16_as_ushort(yb[2]))
                   | (static_cast<uint32_t>(__bfloat16_as_ushort(yb[3])) << 16);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
            packed;
      }
    }
  }
}

template <typename TIn, int OUT>
int launch(const void* x, const void* w, const void* a_scale,
           const void* scale, const void* bias, void* out, int fuse_relu,
           int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const int P = H / 2, Q = W / 2;
  const int TQ = (Q + kPx - 1) / kPx * kPx + 2;
  const size_t row_bytes = static_cast<size_t>(TQ) * Cin;
  int SH = 16;
  while (SH > 1 && (SH > P || (SH + 2) * row_bytes > kSmemBudget)) SH /= 2;
  const size_t smem = (SH + 2) * row_bytes;
  auto kernel = pool_int8_conv_kernel<TIn, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Cout + kCoTile - 1) / kCoTile, (P + SH - 1) / SH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int*>(w),
      static_cast<const float*>(a_scale), static_cast<const float*>(scale),
      static_cast<const float*>(bias), out, fuse_relu, H, W, Cin, Cout, SH);
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

// x: (B, H, W, Cin) f32 or bf16 (x_bf16), contiguous, H and W even.
// w: (9, Cin/4, Cout, 4) int8 = kq (3, 3, Cin, Cout) regrouped.
// a_scale: one f32 on the device. scale, bias: (Cout,) f32.
// out: (B, H/2, W/2, Cout), out_kind 0 f32, 1 bf16, 2 int32 accumulators.
// Cin and Cout multiples of 4.
int pool_int8_conv_launch(const void* x, const void* w, const void* a_scale,
                          const void* scale, const void* bias, void* out,
                          int x_bf16, int out_kind, int fuse_relu, int B,
                          int H, int W, int Cin, int Cout, void* stream) {
  if (Cin % 4 || Cout % 4 || H % 2 || W % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_in<__nv_bfloat16>(out_kind, x, w, a_scale, scale, bias,
                                    out, fuse_relu, B, H, W, Cin, Cout, s);
  return launch_in<float>(out_kind, x, w, a_scale, scale, bias, out,
                          fuse_relu, B, H, W, Cin, Cout, s);
}

const char* pool_int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
