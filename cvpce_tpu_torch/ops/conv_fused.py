"""Int8 convolution: the im2col int8 product, and fused maxpool2x2 ->
int8 3x3 conv (the plain torch version and the CUDA kernel's wrapper).

Counterpart of cvpce_tpu/ops/conv_pallas.py:fused_pool_int8_conv. It
computes exactly `max_pool(2, 2)` followed by
models/quant.py:Int8Conv(static) on NHWC activations: the pooled input
is quantized per tensor (`round_half_even(x / a_scale)` clipped to
+-127), convolved 3x3 same-pad with int32 accumulation, then
`acc * scale + bias` in f32 (`scale` = a_scale * per-channel w_scale),
cast to `out_dtype`, with an optional ReLU. `out_dtype=torch.int32`
returns the accumulators themselves (no epilogue), so a test can hold
them bit for bit.

- `int8_conv_nhwc`: int8 NHWC x HWIO -> int32, as an im2col of the
  padded input and one `torch._int_mm`. Int8Conv and the plain version
  below both use it.
- `pool_int8_conv_plain`: the composition, torch ops on any device.
- `fused_pool_int8_conv`: on a CUDA tensor, the kernel in
  csrc/pool_int8_conv.cu (int8 tensor cores, one launch a call); on a
  CPU tensor, the plain version. It counts its kernel launches in
  `fused_pool_int8_conv.launches`; `kernels_launched` reads the count
  the .so keeps itself.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from .. import _build

# cuBLASLt's int8 product (torch._int_mm on CUDA) takes more than 16
# rows, and K and N that are multiples of 8
_INT_MM_MIN_ROWS = 17

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _pads(padding: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (padding, padding) if isinstance(padding, int) else padding


def im2col_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                padding: Union[int, Tuple[int, int]] = 0) -> torch.Tensor:
    """(B, H, W, C) -> (B * Ho * Wo, kh * kw * C) patch rows, taps in
    (ky, kx, c) order, zero padding `padding` on each side (or
    (rows, columns))."""
    b, h, w, c = x.shape
    ph, pw = _pads(padding)
    ho = (h + 2 * ph - kh) // stride + 1
    wo = (w + 2 * pw - kw) // stride + 1
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    if kh == 1 and kw == 1:
        patches = x[:, :(ho - 1) * stride + 1:stride,
                    :(wo - 1) * stride + 1:stride, :]
    else:
        patches = torch.cat(
            [x[:, dy:dy + (ho - 1) * stride + 1:stride,
               dx:dx + (wo - 1) * stride + 1:stride, :]
             for dy in range(kh) for dx in range(kw)], dim=-1)
    return patches.reshape(b * ho * wo, kh * kw * c)


def int8_conv_nhwc(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
                   padding: Union[int, Tuple[int, int]] = 0) -> torch.Tensor:
    """(B, H, W, Cin) int8 x (kh, kw, Cin, Cout) int8 -> (B, Ho, Wo,
    Cout) int32, zero padding `padding` on each side (or (rows,
    columns)). The patch matrix holds taps in (ky, kx, cin) order,
    matching `kq.reshape(-1, Cout)`.
    On CUDA, fewer than 17 patch rows are padded with zero rows for
    `torch._int_mm` and cut off again."""
    b, h, w, cin = xq.shape
    kh, kw, _, cout = kq.shape
    ph, pw = _pads(padding)
    ho = (h + 2 * ph - kh) // stride + 1
    wo = (w + 2 * pw - kw) // stride + 1
    rows = im2col_nhwc(xq, kh, kw, stride, padding)
    # column-major (K, Cout): both operands contiguous along K, the
    # layout cuBLASLt's int8 product takes without a copy
    mat = kq.reshape(kh * kw * cin, cout).t().contiguous().t()
    m = rows.shape[0]
    if rows.is_cuda and m < _INT_MM_MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(rows.contiguous(), mat)
    return acc[:m].reshape(b, ho, wo, cout)


def quantize(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """Per-tensor int8: clip(round_half_even(x / a_scale), +-127)."""
    return torch.clamp(torch.round(x.float() / a_scale), -127,
                       127).to(torch.int8)


def _scale_tensor(a_scale, device) -> torch.Tensor:
    """a_scale as a 0-d f32 tensor on `device`; a number is filled in on
    the device, so a call does not wait for a host-to-device copy."""
    if isinstance(a_scale, torch.Tensor):
        return a_scale.to(device, torch.float32).reshape(())
    return torch.full((), float(a_scale), dtype=torch.float32, device=device)


def pool_int8_conv_plain(x: torch.Tensor, kq: torch.Tensor,
                         a_scale: Union[float, torch.Tensor],
                         scale: torch.Tensor, bias: torch.Tensor,
                         fuse_relu: bool = False,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """maxpool2x2/s2 -> quantize -> 3x3 same-pad int8 conv -> dequant
    (+ ReLU), torch ops on any device. x (B, H, W, Cin) NHWC with H, W
    even; kq (3, 3, Cin, Cout) int8; scale, bias (Cout,) f32. Returns
    (B, H/2, W/2, Cout) in out_dtype (int32: the accumulators)."""
    a = _scale_tensor(a_scale, x.device)
    pooled = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    acc = int8_conv_nhwc(quantize(pooled, a), kq, 1, 1)
    if out_dtype == torch.int32:
        return acc
    y = (acc.float() * scale.float() + bias.float()).to(out_dtype)
    return torch.relu(y) if fuse_relu else y


def fused_pool_int8_conv(x: torch.Tensor, kq: torch.Tensor,
                         a_scale: Union[float, torch.Tensor],
                         scale: torch.Tensor, bias: torch.Tensor,
                         fuse_relu: bool = False,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """`pool_int8_conv_plain` fused in one CUDA kernel for CUDA tensors;
    a CPU tensor takes the plain version. x is bf16 or f32, 16-byte
    aligned; out_dtype f32, bf16 or int32; Cin a multiple of 32, Cout of
    8, W / 2 at most `_lib().pool_int8_conv_max_q(Cin)` (two strips of
    three pooled rows must fit one block's shared memory). Raises
    ValueError on anything else."""
    if x.device.type == "cpu":
        return pool_int8_conv_plain(x, kq, a_scale, scale, bias, fuse_relu,
                                    out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError("x must be (B, H, W, Cin) float32 or bfloat16")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    b, h, w, cin = x.shape
    if h % 2 or w % 2:
        raise ValueError("H and W must be even")
    if kq.dtype != torch.int8 or tuple(kq.shape[:3]) != (3, 3, cin):
        raise ValueError("kq must be (3, 3, Cin, Cout) int8")
    cout = kq.shape[3]
    if cin % 32 or cout % 8:
        raise ValueError("Cin must be a multiple of 32 and Cout of 8 (the "
                         "kernel's k32 and n8 tensor-core tiles)")
    lib = _lib()
    if w // 2 > lib.pool_int8_conv_max_q(cin):
        raise ValueError(f"W / 2 = {w // 2} exceeds the "
                         f"{lib.pool_int8_conv_max_q(cin)} pooled columns "
                         f"whose rows fit shared memory at Cin = {cin}")
    dev = x.device
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    # (3, 3, Cin, Cout) -> (Cout, 9 Cin), K-major: the col operand of the
    # kernel's int8 mma, a channel's K bytes contiguous
    kw = kq.to(dev).reshape(9 * cin, cout).t().contiguous()
    a = _scale_tensor(a_scale, dev)
    sc = scale.to(dev, torch.float32).contiguous()
    bi = bias.to(dev, torch.float32).contiguous()
    if sc.shape != (cout,) or bi.shape != (cout,):
        raise ValueError("scale and bias must be (Cout,)")
    out = torch.empty((b, h // 2, w // 2, cout), dtype=out_dtype,
                      device=dev)
    if out.numel():
        code = lib.pool_int8_conv_launch(
            *(ctypes.c_void_p(t.data_ptr()) for t in (xc, kw, a, sc, bi,
                                                      out)),
            int(x.dtype == torch.bfloat16), _OUT_KIND[out_dtype],
            int(fuse_relu), b, h, w, cin, cout, _build.stream_ptr(xc))
        if code:
            raise RuntimeError(
                "pool_int8_conv launch failed: "
                + lib.pool_int8_conv_error_string(code).decode())
        fused_pool_int8_conv.launches += 1
    return out


fused_pool_int8_conv.launches = 0


def kernels_launched() -> int:
    """Kernels csrc/pool_int8_conv.cu has launched in this process: the
    difference across a call is that call's launches."""
    return _lib().pool_int8_conv_kernels_launched()


def _lib():
    lib = _build.load("pool_int8_conv")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pool_int8_conv_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.pool_int8_conv_launch.restype = ci
        lib.pool_int8_conv_max_q.argtypes = [ci]
        lib.pool_int8_conv_max_q.restype = ci
        lib.pool_int8_conv_kernels_launched.restype = ctypes.c_ulonglong
        lib.pool_int8_conv_error_string.argtypes = [ci]
        lib.pool_int8_conv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
