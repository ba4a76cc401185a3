"""Host training loop around the GLN train step; counterpart of
cvpce_tpu/train/loops.py:train_proposal_generator.

The reference's loop semantics (cvpce/proposals_training.py:123-271):
loss logging every 50 steps, rotating checkpoints every
`checkpoint_interval` steps and at the end of every epoch, per-epoch
stats dumps deleting the one two epochs back, an eval every
`eval_interval` epochs and on the final one keeping the best-AP model,
the exploded-loss guard (> 5000), resume. One process on one device:
data-parallel training over several cards is ROADMAP.md Queue 1 item 5,
and the loop refuses to start where it would need it. The DIHE and GAN
loops come with the DIHE slice.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from os import path
from typing import Dict, Optional

import numpy as np
import torch

from ..cli.common import load_gln_state_dict
from ..data.loader import PrefetchLoader
from ..data.sku110k import collate_detection
from ..eval.proposals import evaluate_gln, make_variables_inference_fn
from ..models.gln import GLNConfig
from ..utils import resolve_device
from . import gln as gln_train
from .checkpoint import BestKeeper, CheckpointManager

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


def _host_sharding(use_mesh: bool, batch_size: int, device: torch.device):
    """(shard_index, num_shards, local_batch): one process loads the
    whole dataset. With `use_mesh` and more than one visible card this
    raises rather than train on one of them."""
    if use_mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"use_mesh with {torch.cuda.device_count()} visible cards: "
            "data-parallel training is not ported yet (ROADMAP.md, "
            "Queue 1 item 5); pass use_mesh=False or show one card")
    return 0, 1, batch_size


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
    (cli/common.py:load_gln_state_dict; the optimizer starts fresh).
    `load_orbax` raises: the JAX package's orbax exports cannot be read
    by the port (ROADMAP.md, Queue 1 item 7). Otherwise the weights are
    a seeded random init from `seed`.

    `steps_per_call`: that many optimizer steps per call of
    train/gln.py:make_multi_step; logging and the exploded-loss guard
    stay per step, rotating checkpoints land at call boundaries.

    `loader_cls`: PrefetchLoader, or any loader with its constructor;
    one with `iter_from` makes `resume=True` continue inside a
    partially trained epoch on the exact next batch. The JAX package's
    GrainLoader and the checkpoint-time sample pictures (utils/viz.py,
    matplotlib) are not ported (ROADMAP.md, Queue 1 item 6).
    """
    dev = resolve_device(device)
    if load_orbax is not None:
        raise ValueError(
            f"load_orbax={load_orbax!r}: orbax exports of the JAX package "
            "cannot be read by the port (ROADMAP.md, Queue 1 item 7)")
    os.makedirs(output_path, exist_ok=True)
    shard_index, num_shards, local_bs = _host_sharding(use_mesh, batch_size,
                                                       dev)
    loader = loader_cls(dataset, local_bs, collate_detection,
                        shuffle=True, seed=seed,
                        shard_index=shard_index, num_shards=num_shards)
    steps_per_epoch = max(len(loader), 1)
    cfg = train_cfg or gln_train.GLNTrainConfig()
    cfg = gln_train.GLNTrainConfig(**{
        **cfg.__dict__, "steps_per_epoch": steps_per_epoch})

    state_dict = None
    if load_torch is not None:
        state_dict = load_gln_state_dict(load_torch, model_cfg)
    state = gln_train.init_train_state(model_cfg, cfg, seed,
                                       state_dict=state_dict, device=dev)
    anchors, _ = model_cfg.anchors()
    step_fn = gln_train.make_train_step(model_cfg, cfg, anchors)
    if steps_per_call > 1:
        step_fn = gln_train.make_multi_step(step_fn)

    manager = CheckpointManager(output_path)
    keeper = BestKeeper(manager, "ap")
    start_epoch = 0
    iteration = 0
    skip_batches = 0  # mid-epoch resume offset into start_epoch
    if resume:
        meta = manager.load_meta()
        if meta:
            state = manager.restore(state)
            iteration = meta.get("iteration", -1) + 1
            keeper.best = meta.get("best", keeper.best)
            start_epoch, skip_batches = _resume_position(
                meta, steps_per_epoch, loader)

    # one inference function for every epoch eval of the run: it takes
    # the weights as an argument and reloads them when the optimizer
    # has changed them in place
    infer_fn = make_variables_inference_fn(model_cfg, device=dev)

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
