"""Image transforms (torch); counterpart of cvpce_tpu/data/transforms.py.

Bilinear resizing follows OpenCV's INTER_LINEAR (half-pixel centres,
edge clamping, no antialiasing), which `F.interpolate(mode="bilinear",
align_corners=False)` computes. Images are HWC float32 in [0, 1], numpy
arrays or tensors; results are tensors on `device` (the input's device
by default). `load_image` / `load_image_rgba` decode PNG (data/png.py)
and JPEG (data/jpeg.py) with the port's own decoders into numpy, the
format taken from the file's signature (`decode_image`). `gaussian_blur`,
`get_perspective_transform`, `warp_perspective`, `sobel3` and
`build_white_background_mask` are host numpy, like the cv2 calls they
replace, and follow cv2's arithmetic (OpenCV 5's, the version the tests
hold them to) so that they give its results.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import jpeg, png

CLASSIFICATION_IMAGE_SIZE = 256
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# signatures of the formats PIL and cv2 read and the port does not
_REFUSED_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
                    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def decode_image(data: bytes, name: str = "<bytes>",
                 alpha: bool = False) -> np.ndarray:
    """Decode image bytes by their signature, never the name's extension
    (as PIL does): PNG goes to data/png.py, JPEG to data/jpeg.py. Returns
    uint8 (H, W, 3), PIL's convert("RGB"), or with `alpha` (H, W, 4),
    cv2's IMREAD_UNCHANGED read as the JAX package turns it into RGBA.
    GIF, BMP, TIFF and WebP raise NotImplementedError naming the file
    (deliberately not an OSError: the SKU-110K reader replaces an image
    that raises OSError with item 0); anything else raises OSError."""
    if data.startswith(png.SIGNATURE):
        img = png.decode_png(data, name)
        return png.to_rgba(img) if alpha else png.to_rgb(img)
    if data.startswith(jpeg.SIGNATURE):
        img = jpeg.decode_jpeg(data, name)
        return jpeg.to_rgba(img) if alpha else jpeg.to_rgb(img)
    fmt = next((f for sig, f in _REFUSED_FORMATS if data.startswith(sig)),
               None)
    if fmt is None and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        fmt = "WebP"
    if fmt is not None:
        raise NotImplementedError(
            f"{name}: {fmt} file; the port decodes PNG and JPEG only")
    raise OSError(f"cannot identify image file {name}")


def _read(path, alpha: bool) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    return np.asarray(decode_image(data, str(path), alpha),
                      np.float32) / 255.0


def load_image(path) -> np.ndarray:
    """Decode an image file to HWC float32 RGB in [0, 1] (PIL's
    convert("RGB") / 255). PNG and JPEG; other formats raise
    (`decode_image`)."""
    return _read(path, alpha=False)


def load_image_rgba(path) -> np.ndarray:
    """Decode keeping alpha, HWC float32 RGBA in [0, 1] (cv2's
    IMREAD_UNCHANGED read as the JAX package turns it into RGBA; the
    internal trainset's BGRA PNGs; alpha 255 for JPEG)."""
    return _read(path, alpha=True)


def as_tensor(img, device=None) -> torch.Tensor:
    """HWC image (numpy or tensor) -> f32 tensor on `device` (default:
    where it already is)."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return img.to(device if device is not None else img.device,
                  torch.float32)


def resize_bilinear(img, out_h: int, out_w: int, device=None
                    ) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C), cv2.INTER_LINEAR semantics."""
    x = as_tensor(img, device).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).contiguous()


def scale_to_tanh(img):
    return img * 2.0 - 1.0


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def detection_canvas(img, boxes: Optional[np.ndarray], canvas_h: int,
                     canvas_w: int, min_size: int = 800,
                     max_size: int = 1333, normalize: bool = True,
                     device=None
                     ) -> Tuple[torch.Tensor, np.ndarray, Tuple[int, int],
                                float]:
    """Aspect-preserving resize into a fixed canvas (shorter side ->
    min_size, longer capped at max_size and by the canvas).

    Returns (canvas (canvas_h, canvas_w, C) tensor, scaled boxes (numpy),
    content (h, w), scale)."""
    h, w = img.shape[:2]
    scale = min(min_size / min(h, w), max_size / max(h, w))
    scale = min(scale, canvas_h / h, canvas_w / w)
    new_h = min(int(round(h * scale)), canvas_h)
    new_w = min(int(round(w * scale)), canvas_w)
    resized = resize_bilinear(img, new_h, new_w, device)
    if normalize:
        resized = normalize_imagenet(resized)
    canvas = torch.zeros((canvas_h, canvas_w, resized.shape[2]),
                         dtype=torch.float32, device=resized.device)
    canvas[:new_h, :new_w] = resized
    if boxes is not None and len(boxes):
        sboxes = np.asarray(boxes, np.float32).copy()
        sboxes[:, [0, 2]] *= new_w / w
        sboxes[:, [1, 3]] *= new_h / h
    else:
        sboxes = np.zeros((0, 4), np.float32)
    return canvas, sboxes, (new_h, new_w), scale


def resize_for_classification(img, size: int = CLASSIFICATION_IMAGE_SIZE,
                              pad_value: float = 0.5, device=None
                              ) -> torch.Tensor:
    """Square-pad (bottom/right) with gray, then resize to `size`."""
    x = as_tensor(img, device)
    h, w = x.shape[:2]
    side = max(h, w)
    canvas = torch.full((side, side, x.shape[2]), pad_value,
                        dtype=torch.float32, device=x.device)
    canvas[:h, :w] = x
    return resize_bilinear(canvas, size, size)


def aspect_resize_pad(img, size: int = CLASSIFICATION_IMAGE_SIZE,
                      tanh: bool = True, mask=None, device=None):
    """Resize so the longer side is `size`, optionally scale to tanh
    range, pad bottom/right (fill 0 in tanh scale, 0.5 plain); the
    `mask` ((H, W), bool or float) is resized alike and padded with 1.

    Returns the image tensor (size, size, C) [and the mask tensor
    (size, size, 1) if given], on `device` (the image's by default)."""
    x = as_tensor(img, device)
    if x.ndim == 2:
        x = x[..., None]
    h, w = x.shape[:2]
    if h > w:
        new_h, new_w = size, int(round(size * w / h))
    else:
        new_h, new_w = int(round(size * h / w)), size
    resized = resize_bilinear(x, new_h, new_w)
    if tanh:
        resized = scale_to_tanh(resized)
    out = torch.full((size, size, resized.shape[2]), 0.0 if tanh else 0.5,
                     dtype=torch.float32, device=x.device)
    out[:new_h, :new_w] = resized
    if mask is None:
        return out
    m = resize_bilinear(as_tensor(mask[..., None], x.device), new_h, new_w)
    m_out = torch.ones((size, size, 1), dtype=torch.float32, device=x.device)
    m_out[:new_h, :new_w] = m
    return out, m_out


def hflip_with_boxes(img: np.ndarray, boxes: np.ndarray):
    """Horizontal flip of an HWC numpy image and its (T, 4) xyxy boxes."""
    w = img.shape[1]
    flipped = img[:, ::-1].copy()
    fboxes = boxes.copy()
    if len(boxes):
        fboxes[:, 0] = w - boxes[:, 2]
        fboxes[:, 2] = w - boxes[:, 0]
    return flipped, fboxes


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """cv2.BORDER_REFLECT_101 source index of each (possibly far
    out-of-range) position along an axis of length n: reflection about
    the edge pixels, repeated for borders wider than the axis."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """cv2's automatic Gaussian kernel for f32 images: size
    cvRound(sigma * 8 + 1) | 1 (round half to even), coefficients
    exp(-x^2 / (2 sigma^2)) taken in f64, normalised to sum 1, then
    rounded to f32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k * (1.0 / k.sum())).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)` for an
    f32 (H, W) or (H, W, C) array: the separable kernel of
    `gaussian_kernel`, rows first, then columns, BORDER_REFLECT_101 at
    the edges (also where the kernel is wider than the image). f32
    sums in another order than cv2's, so results agree to f32
    rounding."""
    img = np.asarray(img, np.float32)
    k = gaussian_kernel(sigma)
    r = len(k) // 2
    out = img
    for axis in (1, 0):
        n = out.shape[axis]
        src = np.take(out, _reflect101(np.arange(-r, n + r), n), axis=axis)
        acc = np.zeros_like(out)
        for j, w in enumerate(k):
            acc += w * np.take(src, np.arange(j, j + n), axis=axis)
        out = acc
    return out


# f32 lanes of cv2's vectorised small-kernel filters on x86 (its AVX2
# dispatch, also taken on AVX-512 machines): they set which columns of
# a row take the SIMD body's order of operations
CV2_FILTER_LANES = 8


def _three_taps(a: np.ndarray, axis: int):
    """The left, centre and right neighbours of every element along
    `axis`, BORDER_REFLECT_101 at the edges."""
    n = a.shape[axis]
    src = np.take(a, _reflect101(np.arange(-1, n + 1), n), axis=axis)
    return tuple(np.take(src, np.arange(k, k + n), axis=axis)
                 for k in range(3))


def _smooth121(a: np.ndarray, axis: int) -> np.ndarray:
    """cv2's [1, 2, 1] f32 pass along `axis` of an (H, W) array. The
    SIMD body sums (l + r) + 2c; the scalar loop after it takes the
    rest of a row's columns two at a time as (l + 2c) + r, and a last
    odd column in the body's order."""
    lo, c, hi = _three_taps(a, axis)
    w = a.shape[1]
    body = w - w % CV2_FILTER_LANES
    x = np.arange(w)
    pairs = (x >= body) & (x < body + (w - body) // 2 * 2)
    return np.where(pairs, (lo + c * np.float32(2)) + hi,
                    (lo + hi) + c * np.float32(2))


def sobel3(gray: np.ndarray, dx: int) -> np.ndarray:
    """`cv2.Sobel(gray, cv2.CV_32F, dx, 1 - dx, ksize=3)` of an f32
    (H, W) array, BORDER_REFLECT_101: cv2's separable filter, the row
    kernel first ([-1, 0, 1] for dx = 1, else [1, 2, 1]), then the
    column kernel, each in cv2's f32 order (`_smooth121`)."""
    g = np.asarray(gray, np.float32)
    if dx:
        lo, _, hi = _three_taps(g, 1)
        return _smooth121(hi - lo, 0)
    lo, _, hi = _three_taps(_smooth121(g, 1), 0)
    return hi - lo


def flood_fill_mask(img: np.ndarray, seed_x: int, seed_y: int,
                    tolerance: float) -> np.ndarray:
    """`cv2.floodFill(img, mask, (seed_x, seed_y), 0, loDiff=tolerance,
    upDiff=tolerance, flags=4 | cv2.FLOODFILL_MASK_ONLY)`'s filled mask
    (H, W) bool for an f32 (H, W) image. cv2 adds a 4-neighbour of a
    filled pixel when their f32 difference lies in [-tol, tol] (tol
    rounded to f32); with a symmetric range that relation is symmetric,
    so its scan-line fill is the connected component of the seed."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    img = np.asarray(img, np.float32)
    h, w = img.shape
    tol = np.float32(tolerance)
    idx = np.arange(h * w).reshape(h, w)
    step_x = np.abs(img[:, 1:] - img[:, :-1]) <= tol
    step_y = np.abs(img[1:] - img[:-1]) <= tol
    src = np.concatenate([idx[:, :-1][step_x], idx[:-1][step_y]])
    dst = np.concatenate([idx[:, 1:][step_x], idx[1:][step_y]])
    graph = coo_matrix((np.ones(len(src), np.int8), (src, dst)),
                       shape=(h * w, h * w)).tocsr()
    reached = breadth_first_order(graph, seed_y * w + seed_x,
                                  directed=False, return_predecessors=False)
    mask = np.zeros(h * w, bool)
    mask[reached] = True
    return mask.reshape(h, w)


def build_white_background_mask(img: np.ndarray,
                                tolerance: float = 1e-2) -> np.ndarray:
    """Mask of the white background: a gradient flood fill from each
    white corner not yet covered (the JAX package's cv2 Sobel and
    floodFill, in numpy).

    img: HWC float32 RGB in [0, 1]. Returns (H, W) bool, True =
    background."""
    img = np.asarray(img)
    gray = img[..., 0] * 0.2989 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    h, w = gray.shape
    gx = sobel3(gray, 1) / 8.0
    gy = sobel3(gray, 0) / 8.0
    grad = np.sqrt(gx**2 + gy**2)

    mask = np.zeros((h, w), bool)
    for x, y in [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1)]:
        if gray[y, x] < 1 - tolerance or mask[y, x]:
            continue
        mask |= flood_fill_mask(grad, x, y, tolerance)
    return mask


def get_perspective_transform(src, dst) -> np.ndarray:
    """`cv2.getPerspectiveTransform(src, dst)`: the (3, 3) f64 homography
    taking the 4 points `src` to `dst` ((4, 2) f32 each). As cv2 builds
    it: the 8x8 system with its products -x*u taken in f32, then
    Gaussian elimination with partial pivoting in f64 (cv2's LU), h33 = 1."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i, 0:3] = a[i + 4, 3:6] = (x, y, 1.0)
        a[i, 6:8] = (-(x * u), -(y * u))        # f32 products
        a[i + 4, 6:8] = (-(x * v), -(y * v))
        b[i], b[i + 4] = u, v
    for i in range(8):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if k != i:  # the first row of the largest magnitude, as cv2's
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, 8):
            alpha = a[j, i] * d
            a[j, i + 1:] += alpha * a[i, i + 1:]
            b[j] += alpha * b[i]
    for i in range(7, -1, -1):
        s = b[i]
        for k in range(i + 1, 8):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return np.append(b, 1.0).reshape(3, 3)


def _invert3(m: np.ndarray) -> np.ndarray:
    """cv2.invert of a 3x3 f64 matrix (DECOMP_LU): cofactors over the
    determinant, in cv2's order of operations."""
    m = np.asarray(m, np.float64)
    det = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
           - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
           + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    d = 1.0 / det
    return np.array([
        [(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
         (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
         (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d],
        [(m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
         (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
         (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d],
        [(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
         (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
         (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d]])


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add: the f64 product of two f32 values is
    exact, so one rounding of a * b + c to f32 (c f32) is the fused one
    except where the f64 sum itself rounds (a double rounding, which
    these magnitudes do not reach)."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_perspective(img: np.ndarray, m: np.ndarray, out_w: int,
                     out_h: int) -> np.ndarray:
    """`cv2.warpPerspective(img, m, (out_w, out_h), flags=INTER_LINEAR,
    borderMode=BORDER_REPLICATE)` for an f32 (H, W) or (H, W, C) image,
    following OpenCV 5's f32 path: the inverse map (cv2.invert in f64)
    cast to f32; per row, y * m[.,1] + m[.,2] in f32, then per pixel the
    source x, y = fma(x, m[0,0], .) / fma(x, m[2,0], .) and likewise in
    f32; bilinear weights are the fractions of the f32 coordinates (no
    1/32-pixel table, which OpenCV 4.10 and older used); interpolation
    is two fused lerps along x, then one along y; out-of-range neighbours
    clamp to the edge. Equal to cv2 wherever the row width is a multiple
    of its SIMD width (16 f32 lanes with AVX-512); cv2's scalar tail for
    the last columns of other widths rounds its coordinates in another
    order (within 1e-4 px)."""
    img = np.asarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    mi = _invert3(m).astype(np.float32)
    xs = np.arange(out_w, dtype=np.float32)[None, :]
    ys = np.arange(out_h, dtype=np.float32)[:, None]
    row_x = ys * mi[0, 1] + mi[0, 2]
    row_y = ys * mi[1, 1] + mi[1, 2]
    row_w = ys * mi[2, 1] + mi[2, 2]
    den = _fma32(xs, mi[2, 0], row_w)
    sx = _fma32(xs, mi[0, 0], row_x) / den
    sy = _fma32(xs, mi[1, 0], row_y) / den
    fx, fy = np.floor(sx), np.floor(sy)
    ax = (sx - fx)[..., None]
    ay = (sy - fy)[..., None]
    ix = np.clip(fx, -1, w).astype(np.int64)
    iy = np.clip(fy, -1, h).astype(np.int64)
    x0, x1 = np.clip(ix, 0, w - 1), np.clip(ix + 1, 0, w - 1)
    y0, y1 = np.clip(iy, 0, h - 1), np.clip(iy + 1, 0, h - 1)
    p00, p01 = img[y0, x0], img[y0, x1]
    p10, p11 = img[y1, x0], img[y1, x1]
    top = _fma32(ax, p01 - p00, p00)
    bottom = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, bottom - top, top)
    return out[..., 0] if squeeze else out
