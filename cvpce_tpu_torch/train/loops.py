"""Host training loops around the train steps; counterpart of
cvpce_tpu/train/loops.py: `train_proposal_generator` (GLN),
`pretrain_gan` and `train_dihe`.

The reference's loop semantics (cvpce/proposals_training.py:123-271,
cvpce/classification_training.py:257-541): loss logging every 50 steps,
rotating checkpoints every `checkpoint_interval` steps and at the end of
every epoch, an eval every `eval_interval` epochs and on the final one
keeping the best model, resume. The GLN loop also dumps per-epoch loss
stats (deleting the one two epochs back) and guards against exploded
losses (> 5000). At each checkpoint the loops draw sample pictures
with utils/viz.py as the JAX loops do: the GLN loop its detections on
`dataset[0]` (`{tag}_gt_05.png`) and its Gaussian heatmap
(`{tag}_gaussians.png`), the GAN loop the generator's input beside its
output (`{tag}.png`); the DIHE loop draws none, as JAX's draws none. A
failing render prints and training goes on. Where matplotlib is not
installed (the card's machine), every render is skipped before its
inference, with one line printed the first time, so the run spends no
kernel launch on a picture it cannot save.

Data parallelism (`use_mesh` inside a process group of several ranks,
parallel/multihost.py): each rank loads its own shard of the dataset
(`host_shard_info` into the loader's shard_index / num_shards) and
contributes batch_size / world_size rows of the global batch, the step
runs under parallel/mesh.py:make_dp_train_step, and every rank keeps
the same state. Logged losses and epoch evals are the ranks' common
values (the evals share each batch out over the ranks). Rank 0 alone
writes checkpoints and stats; a resumed run reads them on rank 0 and
broadcasts them, so the other ranks need not see rank 0's files.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from os import path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..cli.common import load_gln_state_dict
from ..data.loader import PrefetchLoader
from ..data.sku110k import collate_detection
from ..data.transforms import as_tensor, scale_to_tanh
from ..eval.classification import eval_dihe
from ..eval.proposals import evaluate_gln, make_variables_inference_fn
from ..models.embedders import EmbedFn, MACVGG
from ..models.gln import GLNConfig
from ..parallel import (data_parallel_mesh, make_dp_train_step,
                        put_replicated)
from ..parallel.multihost import host_shard_info
from ..pipeline.serving import load_gln_variables
from ..utils import resolve_device, viz
from . import gln as gln_train
from .checkpoint import BestKeeper, CheckpointManager, load_node
from .dihe import (DIHETrainConfig, GANPretrainConfig, hierarchy_similarity,
                   init_dihe_state, make_dihe_train_step,
                   make_gan_pretrain_step)

EXPLODED_LOSS = 5000.0  # cvpce/proposals_training.py:238


def _resume_position(meta: Dict, steps_per_epoch: int, loader):
    """(start_epoch, skip_batches) for a resumed run.

    Checkpoints record `epoch_step`, the last completed batch index
    within `epoch`. A loader with `iter_from` (an order that is a pure
    function of (seed, epoch, shard)) resumes inside the epoch on the
    exact next batch; otherwise the run restarts at the next epoch, the
    reference's semantics (cvpce/proposals_training.py:209-220)."""
    epoch = meta.get("epoch", -1)
    epoch_step = meta.get("epoch_step")
    if epoch_step is None or not hasattr(loader, "iter_from"):
        return epoch + 1, 0
    if epoch_step + 1 >= steps_per_epoch:
        return epoch + 1, 0
    return epoch, epoch_step + 1


def _epoch_iter(loader, epoch: int, start_epoch: int, skip_batches: int,
                steps_per_epoch: Optional[int] = None):
    """Iterate epoch `epoch`, skipping `skip_batches` on the resumed
    first epoch only, bounded to `steps_per_epoch` batches."""
    loader.set_epoch(epoch)
    skip = skip_batches if epoch == start_epoch else 0
    it = loader.iter_from(skip) if skip else iter(loader)
    if steps_per_epoch is None:
        return it
    return itertools.islice(it, max(steps_per_epoch - skip, 0))


def _host_sharding(use_mesh: bool, batch_size: int):
    """(shard_index, num_shards, local_batch): with `use_mesh` in a
    process group of several ranks, each rank loads a disjoint shard of
    the dataset and contributes batch_size / world_size rows of the
    global batch (DistributedSampler's place)."""
    if not use_mesh:
        return 0, 1, batch_size
    shard_index, num_shards = host_shard_info()
    if num_shards == 1:
        return 0, 1, batch_size
    assert batch_size % num_shards == 0, (
        f"global batch {batch_size} must divide over {num_shards} ranks")
    return shard_index, num_shards, batch_size // num_shards


def _resume_state(manager: CheckpointManager, state, mesh) -> Dict:
    """Load the checkpoint to resume from into `state` (an orbax train
    state of either package, or a `torch.save` file of the port's
    earlier runs: train/checkpoint.py); its meta, or {} where there is
    none. Under a mesh rank 0 reads both and broadcasts them."""
    if mesh is None:
        meta = manager.load_meta()
        if meta:
            manager.restore(state)
        return meta
    payload = [None]
    if mesh.rank == 0:
        meta = manager.load_meta()
        payload = [(meta, manager.read() if meta else None)]
    dist.broadcast_object_list(payload, src=0, group=mesh.group,
                               device=mesh.device)
    meta, node = payload[0]
    if meta:
        load_node(state, node)
    return meta


def train_proposal_generator(
    dataset, evalset, output_path: str,
    model_cfg: GLNConfig = GLNConfig(),
    train_cfg: Optional[gln_train.GLNTrainConfig] = None,
    batch_size: int = 1, epochs: int = 1,
    checkpoint_interval: int = 1000, eval_interval: int = 3,
    eval_threshold: float = 0.75,
    resume: bool = False, use_mesh: bool = True,
    load_torch: Optional[str] = None,
    load_orbax: Optional[str] = None,
    hyperopt_report=None, seed: int = 0,
    steps_per_call: int = 1,
    loader_cls: type = PrefetchLoader,
    device="cuda",
) -> Dict:
    """GLN training loop (cvpce/proposals_training.py:123-271) on
    `device`. Returns {"state": GLNTrainState, "best": keeper record}.

    `load_torch`: start from a reference GaussianLayerNetwork checkpoint
    or a port checkpoint file (cli/common.py:load_gln_state_dict, in f32
    whatever `model_cfg.compute_dtype`; the optimizer starts fresh). `load_orbax`: warm-start from the model of
    a serving export or training-run directory, of the port or of the
    JAX package (pipeline/serving.py:load_gln_variables, as JAX's loop
    does; the optimizer starts fresh, as the reference's --load,
    proposals_training.py:180-189).
    Otherwise the weights are a seeded random init from `seed`.

    `steps_per_call`: that many optimizer steps per call of
    train/gln.py:make_multi_step; logging and the exploded-loss guard
    stay per step, rotating checkpoints land at call boundaries.

    `loader_cls`: PrefetchLoader, or any loader with its constructor;
    one with `iter_from` (data/grain_loader.py:GrainLoader) makes
    `resume=True` continue inside a partially trained epoch on the
    exact next batch. At each checkpoint the detections on
    `dataset[0]` and their heatmap are drawn into `output_path`
    (skipped without matplotlib: module docstring).

    `use_mesh` in a process group of several ranks: data-parallel
    training over them (module docstring), `device` this rank's.

    `model_cfg.compute_dtype='bfloat16'` trains in bf16 on f32 master
    weights (train/gln.py); its checkpoints and exports hold f32
    tensors, and its epoch evals serve them on a bf16 GLN.
    """
    dev = resolve_device(device)
    state_dict = None
    if load_torch is not None:
        state_dict = load_gln_state_dict(load_torch, model_cfg,
                                         param_dtype=torch.float32)
    elif load_orbax is not None:
        state_dict = load_gln_variables(load_orbax)
    os.makedirs(output_path, exist_ok=True)
    shard_index, num_shards, local_bs = _host_sharding(use_mesh, batch_size)
    loader = loader_cls(dataset, local_bs, collate_detection,
                        shuffle=True, seed=seed,
                        shard_index=shard_index, num_shards=num_shards)
    steps_per_epoch = max(len(loader), 1)
    mesh = None
    if num_shards > 1:
        # one step count on every rank (shard sizes can differ by one)
        steps_per_epoch = max((len(dataset) // num_shards) // local_bs, 1)
        mesh = data_parallel_mesh(device=dev)
    cfg = train_cfg or gln_train.GLNTrainConfig()
    cfg = gln_train.GLNTrainConfig(**{
        **cfg.__dict__, "steps_per_epoch": steps_per_epoch})

    state = gln_train.init_train_state(model_cfg, cfg, seed,
                                       state_dict=state_dict, device=dev)
    anchors, _ = model_cfg.anchors()
    step_fn = gln_train.make_train_step(model_cfg, cfg, anchors)
    if steps_per_call > 1:
        step_fn = gln_train.make_multi_step(step_fn)
    if mesh is not None:
        step_fn = make_dp_train_step(
            step_fn, mesh, batch_axis=1 if steps_per_call > 1 else 0)
        state = put_replicated(state, mesh)

    manager = CheckpointManager(output_path,
                                writer=mesh is None or mesh.rank == 0)
    keeper = BestKeeper(manager, "ap")
    start_epoch = 0
    iteration = 0
    skip_batches = 0  # mid-epoch resume offset into start_epoch
    if resume:
        meta = _resume_state(manager, state, mesh)
        if meta:
            iteration = meta.get("iteration", -1) + 1
            keeper.best = meta.get("best", keeper.best)
            start_epoch, skip_batches = _resume_position(
                meta, steps_per_epoch, loader)

    # the checkpoint-time sample (proposals_training.py:91-101) is taken
    # where JAX's loop takes it, render or not, so the dataset's rng
    # draws stay in step with JAX's
    sample = dataset[0] if len(dataset) else None
    render = _SampleRender("train_proposal_generator", manager.writer)

    # one inference function for every epoch eval of the run: it takes
    # the weights as an argument and reloads them when the optimizer
    # has changed them in place
    infer_fn = make_variables_inference_fn(model_cfg, mesh, device=dev)
    # the mesh's inference is collective and the writer renders alone
    render_fn = infer_fn if mesh is None else None

    def save_sample_pictures(tag: str) -> None:
        nonlocal render_fn
        if sample is None or not render():
            return
        try:
            if render_fn is None:
                render_fn = make_variables_inference_fn(model_cfg,
                                                        device=dev)
            res = render_fn(state.model.state_dict(),
                            as_tensor(sample["image"])[None],
                            np.asarray(sample["image_size"],
                                       np.float32)[None])
            keep = (res["valid"][0] & (res["scores"][0] > 0.5)).cpu()
            viz.save_boxes(sample["image"], res["boxes"][0].cpu()[keep],
                           path.join(output_path, f"{tag}_gt_05.png"))
            viz.save_heatmap(res["gaussians"][0],
                             path.join(output_path, f"{tag}_gaussians.png"))
        except Exception as e:  # noqa: BLE001 - viz must not kill training
            print(f"sample render failed: {e}")

    losses_log = {"class_loss": [], "reg_loss": [], "gauss_loss": [],
                  "batch_times": []}
    end_epoch = start_epoch + epochs
    epoch_step = -1  # last completed batch index within the epoch

    def run_chunk(chunk, epoch):
        """len(chunk) optimizer steps (one multi-step call when
        steps_per_call > 1) with the per-step loop semantics."""
        nonlocal state, iteration, epoch_step
        t0 = time.time()
        if steps_per_call > 1:
            stacked = [np.stack([b[key] for b in chunk]) for key in
                       ("images", "boxes", "box_valid", "image_sizes")]
            state, metrics = step_fn(state, *stacked)
            per_step = {k: v.cpu().numpy() for k, v in metrics.items()}
        else:
            batch = chunk[0]
            state, metrics = step_fn(
                state, batch["images"], batch["boxes"],
                batch["box_valid"], batch["image_sizes"])
            per_step = {k: v.cpu().numpy()[None]
                        for k, v in metrics.items()}
        elapsed = (time.time() - t0) / len(chunk)
        pending_save = False
        for s in range(len(chunk)):
            total = float(per_step["total"][s])
            if total > EXPLODED_LOSS:
                msg = (f"!!! Exploded loss at iteration {iteration}: "
                       f"{ {k: float(v[s]) for k, v in per_step.items()} }")
                if hyperopt_report is not None:
                    raise RuntimeError(msg)
                print(msg)
            losses_log["class_loss"].append(
                float(per_step["classification"][s]))
            losses_log["reg_loss"].append(
                float(per_step["bbox_regression"][s]))
            losses_log["gauss_loss"].append(float(per_step["gaussian"][s]))
            losses_log["batch_times"].append(elapsed)
            if iteration % 50 == 0:
                print(f"batch:{iteration:05d}\t{elapsed:.4f}s"
                      f"\tclass:{losses_log['class_loss'][-1]:.4f}"
                      f"\treg:{losses_log['reg_loss'][-1]:.4f}"
                      f"\tgauss:{losses_log['gauss_loss'][-1]:.4f}")
            if iteration % checkpoint_interval == 0:
                pending_save = True
            iteration += 1
            epoch_step += 1
        if pending_save:
            save_sample_pictures(f"{iteration - 1:05d}")
            manager.save_rotating(state, {
                "epoch": epoch, "iteration": iteration - 1,
                "epoch_step": epoch_step, "best": keeper.best})

    for e in range(start_epoch, end_epoch):
        epoch_step = skip_batches - 1 if e == start_epoch else -1
        chunk = []
        for batch in _epoch_iter(loader, e, start_epoch, skip_batches,
                                 steps_per_epoch):
            chunk.append(batch)
            if len(chunk) == steps_per_call:
                run_chunk(chunk, e)
                chunk = []
        if chunk:
            run_chunk(chunk, e)

        # per-epoch stats dump with delete-older-than-2
        # (proposals_training.py:141-154)
        if manager.writer:
            old = path.join(output_path, f"stats_{e - 2}.json")
            if path.exists(old):
                os.remove(old)
            with open(path.join(output_path, f"stats_{e}.json"), "w") as f:
                json.dump(losses_log, f)

        # end-of-epoch rotating save, so resume=True continues from the
        # true epoch boundary
        manager.save_rotating(state, {
            "epoch": e, "iteration": iteration - 1,
            "epoch_step": epoch_step, "best": keeper.best})

        final = e == end_epoch - 1
        if e % eval_interval == 0 or final:
            print("Evaluating...")
            res = evaluate_gln(state.model.state_dict(), evalset, model_cfg,
                               thresholds=(eval_threshold,),
                               infer_fn=infer_fn, device=dev)
            stats = res[eval_threshold]
            print(f"epoch {e}: AP {stats['ap']:.4f} AR300 "
                  f"{stats['ar_300']:.4f} F1 {stats['f']:.4f}")
            keeper.update(state, e, stats["ap"], final=final)
            if hyperopt_report is not None:
                hyperopt_report(average_precision=stats["ap"], **{
                    k: v for k, v in stats.items() if k != "raw"})
    return {"state": state, "best": keeper.best}


class _SampleRender:
    """Whether a loop draws its checkpoint-time sample pictures: on the
    checkpoint writer, where matplotlib is installed. Elsewhere each
    render is skipped before its inference, and the writer prints one
    line the first time."""

    def __init__(self, loop: str, writer: bool):
        self.loop, self.writer = loop, writer
        self.on = writer and viz.available()
        self.noted = False

    def __call__(self) -> bool:
        if not self.on and self.writer and not self.noted:
            print(f"{self.loop}: sample pictures skipped (no matplotlib)")
            self.noted = True
        return self.on


def _save_generator_sample(generator: torch.nn.Module, gen_batch,
                           out: str) -> None:
    """The first generator input beside the generator's output in eval
    mode (JAX's save_gan_sample, classification_training.py:204-210);
    a failing render prints."""
    try:
        dev = next(generator.parameters()).device
        x = torch.as_tensor(np.asarray(gen_batch[:1]), dtype=torch.float32,
                            device=dev)
        generator.eval()
        try:
            with torch.no_grad():
                fake = generator(x)[0]
        finally:
            generator.train()
        src = (np.asarray(gen_batch[0])[..., :3] + 1) / 2
        viz.save_multiple([src, (fake + 1) / 2], out)
    except Exception as e:  # noqa: BLE001
        print(f"gan sample render failed: {e}")


def _discriminator_batch(discriminatorset, n: int, seed: int, stream: int,
                         epoch: int, step: int, shard_index: int = 0,
                         num_shards: int = 1) -> np.ndarray:
    """n target-domain crops in tanh scale, drawn from (seed, stream,
    epoch, step): a resumed run draws what an uninterrupted one would.
    With several shards, the `shard_index`-th slice of n of the step's
    n x num_shards draws."""
    idx = np.random.default_rng((seed, stream, epoch, step)).integers(
        0, len(discriminatorset), n * num_shards)
    idx = idx[shard_index * n:(shard_index + 1) * n]
    return scale_to_tanh(np.stack([discriminatorset[int(j)] for j in idx]))


def _log_metrics(iteration: int, metrics: Dict) -> None:
    if iteration % 50 == 0:
        print(f"batch:{iteration}\t" + "\t".join(
            f"{k}:{float(v):.4f}" for k, v in metrics.items()))


def pretrain_gan(dataset, discriminatorset, output_path: str,
                 epochs: int = 1, batch_size: int = 4,
                 checkpoint_interval: int = 200, masks: bool = False,
                 seed: int = 0, resume: bool = False,
                 train_cfg: Optional[GANPretrainConfig] = None,
                 loader_cls: type = PrefetchLoader,
                 device="cuda") -> Dict:
    """GAN pretraining loop (cvpce/classification_training.py:257-332)
    on `device`. Returns {"state": GANTrainState}.

    `dataset` items carry the generator's input at index 1 (tanh scale,
    3 channels, or 4 with `masks`); `discriminatorset` items are [0, 1]
    target-domain crops. The rotating `gan_checkpoint` holds both
    players and their Adam states; `resume` continues from it, inside
    the epoch with a loader that has `iter_from`. The discriminator's
    samples of each step come from (seed, 17, epoch, step)."""
    dev = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    cfg = train_cfg or GANPretrainConfig(masks=masks)
    init, step = make_gan_pretrain_step(cfg)
    state = init(seed, gen_channels=4 if cfg.masks else 3, device=dev)
    # JAX's pretrain_gan takes no mesh: in a process group every rank
    # trains the same players, and rank 0 alone writes them
    manager = CheckpointManager(output_path, name="gan_checkpoint",
                                writer=host_shard_info()[0] == 0)

    def collate(items):
        return (np.stack([it[1] for it in items]),)

    loader = loader_cls(dataset, batch_size, collate, shuffle=True,
                        seed=seed)
    steps_per_epoch = max(len(loader), 1)
    render = _SampleRender("pretrain_gan", manager.writer)

    start_epoch = 0
    iteration = 0
    skip_batches = 0
    if resume:
        meta = manager.load_meta()
        if meta:
            state = manager.restore(state)
            iteration = meta.get("iteration", -1) + 1
            start_epoch, skip_batches = _resume_position(
                meta, steps_per_epoch, loader)

    end_epoch = start_epoch + epochs
    for e in range(start_epoch, end_epoch):
        epoch_step = skip_batches - 1 if e == start_epoch else -1
        for (gen_batch,) in _epoch_iter(loader, e, start_epoch,
                                        skip_batches, steps_per_epoch):
            bstep = epoch_step + 1
            disc_batch = _discriminator_batch(discriminatorset,
                                              len(gen_batch), seed, 17, e,
                                              bstep)
            state, metrics = step(state, gen_batch, disc_batch)
            _log_metrics(iteration, metrics)
            if iteration % checkpoint_interval == 0:
                if render():
                    _save_generator_sample(
                        state.generator, gen_batch,
                        path.join(output_path, f"{iteration:05d}.png"))
                manager.save_rotating(state, {"epoch": e,
                                              "iteration": iteration,
                                              "epoch_step": bstep})
            iteration += 1
            epoch_step = bstep
        manager.save_rotating(state, {"epoch": e,
                                      "iteration": iteration - 1,
                                      "epoch_step": epoch_step})
    return {"state": state}


def _overlay_embedder(embedder: torch.nn.Module, update: Mapping) -> None:
    """Copy a partial MACVGG state_dict (utils/torch_import.py's
    vgg16(_bn) import) over `embedder`'s tensors in place; an unknown
    key or another shape raises."""
    own = embedder.state_dict()
    for k, v in update.items():
        if k not in own or tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(
                f"init_embedder entry {k}: shape {tuple(v.shape)} vs "
                f"{tuple(own[k].shape) if k in own else 'no such entry'}")
    with torch.no_grad():
        for k, v in update.items():
            own[k].copy_(torch.as_tensor(v))


def train_dihe(dataset, discriminatorset, evaldata, evalset,
               output_path: str, gan_state=None,
               epochs: int = 1, batch_size: int = 4,
               checkpoint_interval: int = 200, eval_interval: int = 1,
               train_cfg: Optional[DIHETrainConfig] = None, seed: int = 0,
               use_mesh: bool = True, hyperopt_report=None,
               resume: bool = False,
               init_embedder: Optional[Mapping] = None,
               loader_cls: type = PrefetchLoader,
               device="cuda") -> Dict:
    """DIHE training loop (cvpce/classification_training.py:334-541) on
    `device`. Returns {"state": DIHETrainState, "best": keeper record}.

    `dataset` items are (emb image, gen image, hierarchy, annotation) in
    tanh scale; a loader batch of 2 x `batch_size` splits into positives
    and negatives (classification_training.py:474-477).
    `discriminatorset` items are [0, 1] target-domain crops, drawn from
    (seed, 29, epoch, step). `gan_state`: a GANTrainState, or a dict
    of its generator's and discriminator's state_dicts
    (cli/dihe.py:load_gan_state), whose generator and
    discriminator replace the seeded ones (their optimizers start
    fresh). `init_embedder`: a partial MACVGG state_dict laid over the
    seeded embedder (utils/torch_import.py:import_vgg16_features).
    After every `eval_interval` epochs and the last, `eval_dihe` scores
    an eval-mode copy of the embedder against the gallery `evaldata` on
    `evalset`; `BestKeeper` keeps the best top-1 accuracy's epoch and the
    final one, and `hyperopt_report(accuracy=...)` gets each. The
    rotating `embedder_checkpoint` holds all three players and their
    Adam states; `resume` continues from it as the GLN loop does.

    `use_mesh` in a process group of several ranks, with batch_size at
    least the world size: data-parallel training (module docstring);
    each rank draws its slice of the step's global discriminator batch,
    so the ranks train together on what one process would.
    """
    dev = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)

    def collate(items):
        # first half positives, second half negatives
        embs = np.stack([it[0] for it in items])
        gens = np.stack([it[1] for it in items])
        hiers = [it[2] for it in items]
        return embs, gens, hiers

    shard_index, num_shards, local_bs = _host_sharding(use_mesh, batch_size)
    loader = loader_cls(dataset, local_bs * 2, collate, shuffle=True,
                        seed=seed, shard_index=shard_index,
                        num_shards=num_shards)
    steps_per_epoch = max(len(loader), 1)
    if num_shards > 1:
        steps_per_epoch = max(
            (len(dataset) // num_shards) // (local_bs * 2), 1)
    mesh = (data_parallel_mesh(device=dev)
            if num_shards > 1 and batch_size >= num_shards else None)
    cfg = train_cfg or DIHETrainConfig()
    cfg = DIHETrainConfig(**{**cfg.__dict__,
                             "steps_per_epoch": steps_per_epoch})

    state = init_dihe_state(cfg, seed, gen_channels=4 if cfg.masks else 3,
                            device=dev)
    if init_embedder is not None:
        _overlay_embedder(state.embedder, init_embedder)
    if gan_state is not None:
        sd = (gan_state.state_dict() if hasattr(gan_state, "state_dict")
              else gan_state)
        state.generator.load_state_dict(sd["generator"])
        state.discriminator.load_state_dict(sd["discriminator"])
    step = make_dihe_train_step(cfg)
    if mesh is not None:
        step = make_dp_train_step(step, mesh)
        state = put_replicated(state, mesh)

    manager = CheckpointManager(output_path, name="embedder_checkpoint",
                                writer=mesh is None or mesh.rank == 0)
    keeper = BestKeeper(manager, "accuracy")
    # the epoch evals' embedder: an eval-mode copy, reloaded each eval
    encode = EmbedFn(MACVGG(batch_norm=cfg.batchnorm), device=dev)

    start_epoch = 0
    iteration = 0
    skip_batches = 0
    if resume:
        meta = _resume_state(manager, state, mesh)
        if meta:
            iteration = meta.get("iteration", -1) + 1
            keeper.best = meta.get("best", keeper.best)
            start_epoch, skip_batches = _resume_position(
                meta, steps_per_epoch, loader)

    end_epoch = start_epoch + epochs
    for e in range(start_epoch, end_epoch):
        epoch_step = skip_batches - 1 if e == start_epoch else -1
        for embs, gens, hiers in _epoch_iter(loader, e, start_epoch,
                                             skip_batches,
                                             steps_per_epoch):
            block = len(embs) // 2
            if block == 0:
                continue
            sim = hierarchy_similarity(hiers[:block],
                                       hiers[block:2 * block])
            disc_batch = _discriminator_batch(discriminatorset, block, seed,
                                              29, e, epoch_step + 1,
                                              shard_index, num_shards)
            state, metrics = step(state, embs[:block],
                                  embs[block:2 * block], gens[:block],
                                  disc_batch, sim)
            _log_metrics(iteration, metrics)
            iteration += 1
            epoch_step += 1
            if (iteration - 1) % checkpoint_interval == 0:
                manager.save_rotating(state, {"epoch": e,
                                              "iteration": iteration - 1,
                                              "epoch_step": epoch_step,
                                              "best": keeper.best})

        manager.save_rotating(state, {"epoch": e,
                                      "iteration": iteration - 1,
                                      "epoch_step": epoch_step,
                                      "best": keeper.best})

        final = e == end_epoch - 1
        if e % eval_interval == 0 or final:
            encode.model.load_state_dict(state.embedder.state_dict())
            acc = eval_dihe(encode, MACVGG.embedding_size, evaldata,
                            evalset, batch_size=batch_size, k=(1,),
                            verbose=False, mesh=mesh, device=dev)
            accuracy = acc.get(1, 0.0)
            print(f"epoch {e}: top-1 accuracy {accuracy:.4f}")
            keeper.update(state, e, accuracy, final=final)
            if hyperopt_report is not None:
                hyperopt_report(accuracy=accuracy)
    return {"state": state, "best": keeper.best}
