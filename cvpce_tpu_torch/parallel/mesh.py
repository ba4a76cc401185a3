"""Data parallelism over a torch.distributed process group; counterpart
of cvpce_tpu/parallel/mesh.py.

The JAX package shards the batch over a 1-D device mesh and lets XLA
insert the collectives. Here one process drives one device, and the
"mesh" is the process group: `data_parallel_mesh()` returns its group,
this process's rank, the group's size and this rank's device, and every
`mesh=` of the port takes that object. What XLA does implicitly is
written out:

- each rank holds its own slice of the global batch (`put_sharded`, or
  a loader sharded by `host_shard_info`), the state replicated from rank
  0 (`put_replicated`);
- inside a step wrapped by `make_dp_train_step`, the mesh is active
  (`active_mesh()`): the train-mode BatchNorms (models/resnet.py) take
  their statistics over the global batch, the Gaussian loss mines its
  hard negatives over the global batch (ops/losses.py), and before every
  optimizer update the gradients are averaged over the ranks in one
  all-reduce of the flattened gradients, in parameter order
  (`average_gradients`);
- the step's metrics come back averaged over the ranks, the same value
  on every rank.

An all-reduce inside a differentiated function goes through
`all_reduce_sum`, whose backward all-reduces the incoming gradient, so
each rank's input gradient is that of the sum of every rank's loss.
Gathers use `dist.all_gather`'s list form, which gloo runs on CPU and
CUDA tensors alike. No collective is caught or retried.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device


@dataclasses.dataclass(frozen=True)
class DataParallelMesh:
    """The process group, this process's rank in it, its size, and the
    device this rank computes on."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def data_parallel_mesh(device="cuda", group=None) -> DataParallelMesh:
    """The mesh over `group` (the default group when None), which
    `parallel.multihost.initialize_multihost` must have set up. `device`
    is this rank's: "cuda" means its current card, `cuda:LOCAL_RANK`
    after initialize_multihost."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.multihost.initialize_multihost first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DataParallelMesh(group, dist.get_rank(group),
                            dist.get_world_size(group), dev)


# the mesh of the data-parallel step that is running (make_dp_train_step)
_ACTIVE: List[DataParallelMesh] = []


@contextlib.contextmanager
def batch_sharded(mesh: DataParallelMesh):
    """Within the block, the batch of every train-mode computation is
    this rank's slice of the global batch: `active_mesh()` returns
    `mesh` where it has more than one rank."""
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[DataParallelMesh]:
    """The mesh of the enclosing `batch_sharded` block if it spans more
    than one rank, else None (one rank's batch is the global one)."""
    if _ACTIVE and _ACTIVE[-1].size > 1:
        return _ACTIVE[-1]
    return None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: DataParallelMesh) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: the backward pass
    sums the ranks' gradients of the result."""
    return _AllReduceSum.apply(x, mesh)


def all_gather(x: torch.Tensor, mesh: DataParallelMesh
               ) -> List[torch.Tensor]:
    """Every rank's `x` (same shape and dtype on each), in rank order.
    Booleans travel as uint8."""
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(out, send, group=mesh.group)
    return [t.to(torch.bool) for t in out] if x.dtype == torch.bool \
        else out


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Under an active mesh, replace each parameter's `.grad` by its mean
    over the ranks: one all-reduce of the gradients flattened in
    `params`' order (parameters without a gradient take no part). A
    no-op outside a data-parallel step."""
    mesh = active_mesh()
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_over_ranks(metrics: dict, mesh: DataParallelMesh) -> dict:
    """{name: tensor} averaged over the ranks in one all-reduce (f64),
    each returned in its own dtype and shape."""
    if not metrics:
        return metrics
    flat = torch.cat([v.detach().reshape(-1).to(mesh.device, torch.float64)
                      for v in metrics.values()])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    out, offset = {}, 0
    for name, v in metrics.items():
        n = v.numel()
        out[name] = flat[offset:offset + n].view(v.shape).to(v.dtype)
        offset += n
    return out


def replicate(mesh: DataParallelMesh) -> Callable:
    """The placement of a replicated tensor: overwrite it in place with
    rank 0's value (a tensor off the mesh's device travels through it)."""
    def place(t: torch.Tensor) -> torch.Tensor:
        if t.device == mesh.device:
            dist.broadcast(t, src=0, group=mesh.group)
        else:
            buf = t.to(mesh.device)
            dist.broadcast(buf, src=0, group=mesh.group)
            t.copy_(buf)
        return t
    return place


def shard_batch(mesh: DataParallelMesh, batch_axis: int = 0) -> Callable:
    """The placement of a batch-sharded array: this rank's slice of
    `batch_axis` (a global size divisible by the mesh), as a tensor on
    the mesh's device."""
    def place(x) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        n = t.shape[batch_axis]
        if n % mesh.size:
            raise ValueError(f"batch of {n} does not divide over "
                             f"{mesh.size} ranks")
        local = n // mesh.size
        return t.narrow(batch_axis, mesh.rank * local, local).to(
            mesh.device)
    return place


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tensor, a dict / list / tuple of them, or an
    object with `state_dict()` (a module, an optimizer, a train state),
    in a fixed order."""
    if torch.is_tensor(tree):
        return [tree]
    if hasattr(tree, "state_dict"):
        return _tensors(tree.state_dict())
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def put_replicated(tree, mesh: DataParallelMesh):
    """Every tensor of `tree` (as `_tensors` finds them; a module's and
    an optimizer's state_dict tensors are its own) overwritten in place
    with rank 0's, so every rank starts from one state. Returns
    `tree`."""
    place = replicate(mesh)
    with torch.no_grad():
        for t in _tensors(tree):
            place(t)
    return tree


def put_sharded(tree, mesh: DataParallelMesh, batch_axis: int = 0):
    """This rank's slice of every array in a list / tuple / dict (or of
    one array), on the mesh's device."""
    place = shard_batch(mesh, batch_axis)
    if isinstance(tree, dict):
        return {k: place(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v) for v in tree)
    return place(tree)


def make_dp_train_step(train_step: Callable, mesh: DataParallelMesh,
                       batch_axis: int = 0) -> Callable:
    """Wrap a (state, *batch) -> (state, metrics) step for data
    parallelism: each rank calls it with its own slice of the global
    batch (`batch_axis` 0 for a plain step, 1 for a
    train/gln.py:make_multi_step whose batches carry a leading steps
    axis) and a state replicated from rank 0 (`put_replicated`). The
    step runs under `batch_sharded(mesh)` and its metrics come back
    averaged over the ranks.

    The per-image losses are averaged over equal local batches, which is
    exact only where every rank's slice has the same size: the first
    call of each arity checks that the sizes along `batch_axis` agree,
    and raises where they do not."""
    checked = set()

    def step(state, *batch):
        if len(batch) not in checked:
            sizes = torch.tensor([np.shape(b)[batch_axis] for b in batch],
                                 device=mesh.device)
            every = all_gather(sizes, mesh)
            if any(not torch.equal(s, sizes) for s in every):
                raise ValueError(
                    f"local batch sizes differ across ranks: "
                    f"{[s.tolist() for s in every]}")
            checked.add(len(batch))
        with batch_sharded(mesh):
            state, metrics = train_step(state, *batch)
        return state, mean_over_ranks(metrics, mesh)

    return step


def host_local(x) -> np.ndarray:
    """numpy value of a tensor (replicated state and metrics hold the
    same value on every rank)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_local_tree(tree):
    if isinstance(tree, dict):
        return {k: host_local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_local_tree(v) for v in tree)
    return host_local(tree)
