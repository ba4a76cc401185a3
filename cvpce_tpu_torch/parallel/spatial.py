"""Width-sharded GLN inference over a process group; counterpart of
cvpce_tpu/parallel/spatial.py.

For shelf photos too wide for one card, each rank of the mesh
(parallel/mesh.py:DataParallelMesh, here "this rank holds strip `rank`
of `size` of the canvas width") runs the GLN on its strip. The JAX
package lets XLA's SPMD partitioner insert the halo exchanges; here they
are written out:

- Within `width_sharded(mesh)`, every zero-padded convolution
  (models/layers.py:Conv2d, models/quant.py:Int8Conv) and the -inf
  padded max-pool (models/layers.py:max_pool) reads its neighbours' edge
  columns where the unsharded op reads padding (`pad_strip`). For kernel
  k, stride s and padding p on a strip whose width is a multiple of s,
  the left halo is the left neighbour's last p columns and the right
  halo the right neighbour's first max(0, k - p - s); the ranks at the
  ends pad as the unsharded op does. In the GLN: the 7x7/2 stem 3 and 2
  columns, the 3x3/2 stem max-pool 1 and 0, every 3x3/1 conv 1 and 1,
  every 3x3/2 conv 1 and 0, the 1x1 convs none: 78 exchanges a forward
  (18 in the ResNet-50, 5 in the FPN, 50 in the head, 5 in the Gaussian
  branch).
- The rest of the forward needs no exchange once every pyramid level
  splits evenly (a canvas width that is a multiple of 128 x size):
  FrozenBN, the Gaussian branch's eval-mode BatchNorm, ReLU and the 1x1
  convs act on each column alone, and the nearest 2x upsample maps
  strip r of a level onto strip r of the level above.
- An exchange is one all-gather of every rank's (first, last) edge
  columns, from which each rank takes its neighbours'. That moves
  `size` edge pairs to each rank where sends to the two neighbours
  would move two, but it is a single collective in `dist.all_gather`'s
  list form, which gloo runs on CPU and CUDA tensors alike (several
  ranks on one card) and NCCL runs between cards; the edges are a few
  columns. No collective is caught.
- An Int8Conv pads in float before it quantizes: a static scale is
  elementwise, so the int32 accumulators are the unsharded ones; a
  dynamic scale takes the largest magnitude over every strip
  (`strip_max`, an all-reduce MAX).
- `make_spatial_infer`'s `run` gathers the head outputs along the width
  (each level's `cls_logits` and `bbox_regression` before their
  (y, x, anchor) flattening, and `gaussians`) and runs
  `postprocess_detections` on the whole canvas's anchors on every rank,
  so the detections are replicated, as in the JAX package, and K1 runs
  once a rank a call.

Inference only: no halo carries a gradient, as in the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops.anchors import LEVELS
from ..utils.profiling import annotate
from .mesh import DataParallelMesh, all_gather, data_parallel_mesh

# every pyramid level, down to P7 at stride 2**7, splits evenly
WIDTH_QUANTUM = 2 ** LEVELS[-1]

# the mesh of the width-sharded forward that is running
_STRIPS: List[DataParallelMesh] = []


@contextlib.contextmanager
def width_sharded(mesh: DataParallelMesh):
    """Within the block, every NCHW tensor that reaches a convolution
    or max-pool is this rank's strip of the width: `strip_mesh()`
    returns `mesh` where it has more than one rank."""
    _STRIPS.append(mesh)
    try:
        yield
    finally:
        _STRIPS.pop()


def strip_mesh() -> Optional[DataParallelMesh]:
    """The mesh of the enclosing `width_sharded` block if it spans more
    than one rank, else None (one rank's strip is the whole width)."""
    if _STRIPS and _STRIPS[-1].size > 1:
        return _STRIPS[-1]
    return None


def pad_strip(x: torch.Tensor, kernel: int, stride: int, padding: int,
              fill: float = 0.0) -> Tuple[torch.Tensor, int]:
    """(x, width padding left to the op) for a window op of `kernel`,
    `stride` and symmetric `padding` on an NCHW tensor. Outside a
    width-sharded block: (x, padding), unchanged. Inside: x with the
    left neighbour's last `padding` columns before it and the right
    neighbour's first max(0, kernel - padding - stride) after it (`fill`
    at the ends of the canvas), and 0."""
    mesh = strip_mesh()
    if mesh is None:
        return x, padding
    left, right = padding, max(0, kernel - padding - stride)
    if left or right:
        x = _exchange(x, mesh, left, right, fill)
    return x, 0


def _exchange(x: torch.Tensor, mesh: DataParallelMesh, left: int,
              right: int, fill: float) -> torch.Tensor:
    width = x.shape[-1]
    if width < max(left, right):
        raise ValueError(f"a strip of {width} columns cannot give halos "
                         f"of {left} and {right}")
    with annotate("spatial.halo"):
        # my first `right` columns are my left neighbour's right halo,
        # my last `left` columns my right neighbour's left halo
        edges = torch.cat([x[..., :right], x[..., width - left:]], dim=-1)
        every = all_gather(edges, mesh)
        r = mesh.rank
        lo = (every[r - 1][..., right:] if r > 0
              else x.new_full(x.shape[:-1] + (left,), fill))
        hi = (every[r + 1][..., :right] if r + 1 < mesh.size
              else x.new_full(x.shape[:-1] + (right,), fill))
        return torch.cat([lo, x, hi], dim=-1)


def strip_max(t: torch.Tensor) -> torch.Tensor:
    """`t` (a local maximum) maximised over every strip inside a
    width-sharded block; `t` itself elsewhere."""
    mesh = strip_mesh()
    if mesh is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def spatial_mesh(device="cuda", group=None) -> DataParallelMesh:
    """The mesh over `group` (the default group when None) for
    `make_spatial_infer`: rank r of size holds strip r of the canvas
    width. `device` is this rank's, as in `data_parallel_mesh`."""
    return data_parallel_mesh(device, group)


def _check_width(canvas_w: int, size: int) -> int:
    if canvas_w % (WIDTH_QUANTUM * size):
        raise ValueError(
            f"canvas width {canvas_w} is not a multiple of {WIDTH_QUANTUM} "
            f"x {size} ranks: the width must divide evenly by the mesh "
            f"size times {WIDTH_QUANTUM} so every pyramid level's strips "
            "stay aligned (cvpce_tpu/parallel/spatial.py)")
    return canvas_w // size


def _gather_width(outputs: Dict[str, torch.Tensor],
                  levels: Sequence[Tuple[int, int]], anchors_per_cell: int,
                  mesh: DataParallelMesh) -> Dict[str, torch.Tensor]:
    """Every rank's strip outputs joined along the width, in one
    all-gather: each level's head outputs (B, h * w * A, K) as
    (B, h, w, A * K), and gaussians (B, H/2, W/2, 1)."""
    heads = ("cls_logits", "bbox_regression")
    b = outputs["cls_logits"].shape[0]
    pieces, start = [], 0
    for gh, gw in levels:
        n = gh * gw * anchors_per_cell
        pieces += [outputs[k][:, start:start + n].reshape(b, gh, gw, -1)
                   for k in heads]
        start += n
    if "gaussians" in outputs:
        pieces.append(outputs["gaussians"])
    every = all_gather(torch.cat([p.reshape(-1) for p in pieces]), mesh)
    splits = [torch.split(buf, [p.numel() for p in pieces])
              for buf in every]
    whole = [torch.cat([parts[i].view(p.shape) for parts in splits], dim=2)
             for i, p in enumerate(pieces)]
    out = {k: torch.cat([whole[2 * lv + j].reshape(
               b, -1, outputs[k].shape[-1]) for lv in range(len(levels))], 1)
           for j, k in enumerate(heads)}
    if "gaussians" in outputs:
        out["gaussians"] = whole[-1]
    return out


def make_spatial_forward(state_dict_or_gln, config,
                         mesh: DataParallelMesh,
                         axis: str = "width") -> Callable:
    """The GLN forward with the canvas width sharded over `mesh`; returns
    `forward(images)`. Every rank calls it with the whole batch, images
    (B, canvas_h, canvas_w, 3); it takes this rank's strip, runs the GLN
    on it with the halo exchanges active and returns the whole canvas's
    outputs (`cls_logits`, `bbox_regression`, `gaussians` as GLN.forward
    gives them), gathered along the width, the same on every rank.

    `state_dict_or_gln`: a GLN state_dict for `config`, or a GLN (put on
    the mesh's device), which an int8='static' config needs, with its
    act scales loaded. The canvas width must divide evenly by the mesh
    size times 128 so every level's strips stay aligned; `axis` names
    the sharded axis and only "width" is one. int8='calibrate' is
    refused, as JAX's apply of immutable variables refuses to record the
    scales (flax's ModifyScopeVariableError)."""
    # models/ imports parallel.mesh, so the model comes in at call time
    from ..models.gln import GLN, RetinaNetHead

    if axis != "width":
        raise ValueError(f"the port shards the canvas width only, not "
                         f"{axis!r}")
    if config.int8 == "calibrate":
        raise ValueError("int8='calibrate' cannot record act scales in a "
                         "spatial run; calibrate the unsharded GLN")
    strip = _check_width(config.canvas_w, mesh.size)
    if isinstance(state_dict_or_gln, nn.Module):
        model = state_dict_or_gln
    elif config.int8 == "static":
        raise ValueError("int8='static' needs the act scales: pass a GLN "
                         "with them loaded")
    else:
        model = GLN(config)
        model.load_state_dict(state_dict_or_gln)
    model.to(mesh.device).eval()
    levels = [(-(-config.canvas_h // 2 ** lv), strip // 2 ** lv)
              for lv in LEVELS]
    canvas = (config.canvas_h, config.canvas_w)
    lo = mesh.rank * strip

    def forward(images) -> Dict[str, torch.Tensor]:
        x = (images if torch.is_tensor(images)
             else torch.from_numpy(np.asarray(images, np.float32)))
        if tuple(x.shape[1:3]) != canvas:
            raise ValueError(f"images of {tuple(x.shape[1:3])}, not the "
                             f"config's canvas {canvas}")
        x = x[:, :, lo:lo + strip].to(mesh.device)
        with torch.inference_mode():
            with width_sharded(mesh):
                local = model(x)
            with annotate("spatial.gather"):
                return _gather_width(local, levels,
                                     RetinaNetHead.NUM_ANCHORS, mesh)

    return forward


def make_spatial_infer(state_dict_or_gln, config, mesh: DataParallelMesh,
                       axis: str = "width") -> Callable:
    """GLN inference with the canvas width sharded over `mesh`; returns
    `run(images, image_sizes)`: `make_spatial_forward`'s gathered
    outputs of images (B, canvas_h, canvas_w, 3), then
    `postprocess_detections` on the whole canvas's anchors with content
    sizes (B, 2), the same on every rank. Arguments and refusals as
    `make_spatial_forward`'s."""
    from ..models.gln import postprocess_detections

    forward = make_spatial_forward(state_dict_or_gln, config, mesh, axis)
    anchors_np, counts = config.anchors()
    anchors = torch.from_numpy(anchors_np).to(mesh.device)

    def run(images, image_sizes) -> Dict[str, torch.Tensor]:
        outputs = forward(images)
        sizes = torch.as_tensor(image_sizes, dtype=torch.float32).to(
            mesh.device)
        with torch.inference_mode(), annotate("spatial.postprocess"):
            return postprocess_detections(outputs, anchors, counts, sizes,
                                          config)

    return run
