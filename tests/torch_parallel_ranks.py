"""What each rank of the data-parallel tests runs
(tests/torch_parallel_common.py starts them; tests/test_torch_parallel*.py
hold the results against the JAX package). Imports no JAX: every rank is
a torch process in a gloo group on the CPU. Arrays come in as numpy
global batches; each function takes its rank's slice and returns
picklable results (rank 0 the whole state where a test needs it, every
rank a digest of its state, to show the ranks stay identical)."""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from cvpce_tpu_torch.parallel import (data_parallel_mesh, host_local,
                                      host_local_tree, make_dp_train_step,
                                      put_replicated, put_sharded)
from cvpce_tpu_torch.parallel.mesh import batch_sharded


def _mesh():
    return data_parallel_mesh(device="cpu")


def digest(tensors: dict) -> str:
    """sha256 over a state_dict's tensors, in key order."""
    h = hashlib.sha256()
    for key in sorted(tensors):
        t = tensors[key]
        if torch.is_tensor(t):
            h.update(key.encode())
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


# ------------------------------------------------------ mesh, multihost

def mesh_helpers():
    """host_shard_info, the mesh object, put_sharded on both batch axes,
    put_replicated of a module and its optimizer, host_local(_tree),
    the DP step's averaged metrics and its refusal of unequal local
    batches."""
    from cvpce_tpu_torch.parallel.multihost import host_shard_info

    mesh = _mesh()
    out = {"shard_info": host_shard_info(),
           "mesh": (mesh.rank, mesh.size, str(mesh.device))}
    batch = (np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             np.arange(4, dtype=np.int64))
    out["sharded"] = host_local_tree(put_sharded(batch, mesh))
    stacked = np.arange(2 * 4, dtype=np.float32).reshape(2, 4)
    out["sharded_axis1"] = host_local(put_sharded(stacked, mesh,
                                                  batch_axis=1))

    torch.manual_seed(mesh.rank)  # every rank draws other weights
    module = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(module.parameters(), lr=0.1, momentum=0.9)
    module(torch.ones(1, 3)).sum().backward()
    opt.step()  # a momentum buffer to replicate too
    put_replicated(module, mesh)
    put_replicated(opt, mesh)
    out["replicated"] = {
        "weight": host_local(module.weight),
        "momentum": host_local(opt.state[module.weight]["momentum_buffer"])}

    def step(state, x):
        loss = (state.weight * x.sum()).sum()
        return state, {"loss": loss.detach(), "rank": torch.tensor(
            float(mesh.rank))}

    dp = make_dp_train_step(step, mesh)
    _, metrics = dp(module, put_sharded(np.ones((4, 3), np.float32), mesh))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    try:  # a fresh wrapper checks its first call's local batch sizes
        make_dp_train_step(step, mesh)(
            module, torch.ones((2 + mesh.rank, 3)))
    except ValueError as e:
        out["refused"] = str(e)
    return out


# ------------------------------------------------------------ BatchNorm

def batchnorm(x, weight, bias, running_mean, running_var, grad_out):
    """models/resnet.py:BatchNorm in train mode on this rank's slice of
    the NCHW batch `x` under the mesh: output, input gradient, the
    parameters' gradients (this rank's share) and the running
    statistics."""
    from cvpce_tpu_torch.models.resnet import BatchNorm

    mesh = _mesh()
    bn = BatchNorm(x.shape[1]).double()
    with torch.no_grad():
        for name, v in (("weight", weight), ("bias", bias),
                        ("running_mean", running_mean),
                        ("running_var", running_var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    bn.train()
    xs, gs = put_sharded((x, grad_out), mesh)
    xs.requires_grad_(True)
    with batch_sharded(mesh):
        y = bn(xs)
        y.backward(gs)
    return {"y": host_local(y), "x_grad": host_local(xs.grad),
            "weight_grad": host_local(bn.weight.grad),
            "bias_grad": host_local(bn.bias.grad),
            "running_mean": host_local(bn.running_mean),
            "running_var": host_local(bn.running_var)}


# ----------------------------------------------------- the Gaussian loss

def heatmap_loss(cases):
    """ops/losses.py:gaussian_heatmap_loss under the mesh on this rank's
    slice of each case's (predictions, targets, kwargs): the value and
    the gradient of this rank's loss by its predictions."""
    from cvpce_tpu_torch.ops.losses import gaussian_heatmap_loss

    mesh = _mesh()
    out = []
    for pred, tgt, kwargs in cases:
        p, t = put_sharded((pred, tgt), mesh)
        p.requires_grad_(True)
        with batch_sharded(mesh):
            loss = gaussian_heatmap_loss(p, t, **kwargs)
        loss.backward()
        out.append((float(loss), host_local(p.grad)))
    return out


# ------------------------------------------------------------- the kNN

def sharded_knn(cases, reuse):
    """ops/knn_sharded.py: each case (anchors, queries, k) through
    sharded_nearest_neighbors; then `reuse` = (anchors, [queries...], k)
    through one make_sharded_nn search over a resident gallery, which
    must take its block's preparation once."""
    from cvpce_tpu_torch.ops import knn_sharded as ks

    mesh = _mesh()
    out = {"cases": [host_local(ks.sharded_nearest_neighbors(
        a, q, k, mesh)) for a, q, k in cases]}
    anchors, queries, k = reuse
    padded, valid = ks.pad_gallery(anchors, mesh.size)
    place = ks.gallery_sharding(mesh)
    block, block_valid = place(padded), place(valid)
    search = ks.make_sharded_nn(mesh, k)
    results, preps = [], set()
    for q in queries:
        d, i = search(block, block_valid, torch.from_numpy(q))
        results.append((host_local(d), host_local(i)))
        preps.add(id(search._prep))
    out["reuse"] = results
    out["prepared_once"] = len(preps) == 1
    out["fused_block"] = search._prep[1]
    return out


def color_encoder(images) -> torch.Tensor:
    """(B, 256, 256, 3) -> (B, 48): the mean of each channel over a 4x4
    grid of 64-pixel cells."""
    x = torch.as_tensor(np.asarray(images), dtype=torch.float32)
    b = x.shape[0]
    return x.reshape(b, 4, 64, 4, 64, 3).mean(dim=(2, 4)).reshape(b, 48)


def classifier(gallery_items, queries, k):
    """pipeline/classifier.py:Classifier(mesh=) on a gallery of items
    (img, img, label, label): two classify calls on the resident
    gallery, and the same with the mesh's rows held by one process."""
    from cvpce_tpu_torch.pipeline.classifier import Classifier

    mesh = _mesh()
    clf = Classifier(color_encoder, 48, gallery_items, batch_size=4, k=k,
                     mesh=mesh, device="cpu")
    plain = Classifier(color_encoder, 48, gallery_items, batch_size=4, k=k,
                       device="cpu")
    return {"mesh": [clf.classify(q) for q in queries],
            "plain": [plain.classify(q) for q in queries],
            "block_rows": int(clf._anchors_dev.shape[0])}


# ----------------------------------------------------- serving and eval

def serving(checkpoint, config_kw, images, dataset, eval_kw):
    """ProposalGenerator(mesh=).detect_batch and evaluate_gln(mesh=) on
    `dataset` (a list of eval items), the weights a reference-layout
    checkpoint's, each beside the port's one-process
    result on the same rank, the latter's eval at the ranks' local
    batch."""
    from cvpce_tpu_torch.eval.proposals import evaluate_gln
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.pipeline.proposals import ProposalGenerator

    from cvpce_tpu_torch.cli.common import load_gln_state_dict

    mesh = _mesh()
    cfg = GLNConfig(**config_kw)
    state_dict = load_gln_state_dict(checkpoint, cfg)
    kw = dict(confidence_threshold=0.0, device="cpu")
    dp = ProposalGenerator(state_dict, cfg, mesh=mesh, **kw)
    single = ProposalGenerator(state_dict, cfg, **kw)
    return {
        "detect_mesh": dp.detect_batch(images),
        "detect_single": single.detect_batch(images),
        "eval_mesh": evaluate_gln(state_dict, dataset, cfg, mesh=mesh,
                                  device="cpu", **eval_kw),
        # one process at the ranks' local batch: the same convolutions
        "eval_single": evaluate_gln(
            state_dict, dataset, cfg, device="cpu",
            **{**eval_kw, "batch_size": eval_kw["batch_size"] // mesh.size})}


def dihe_eval(gallery_items, testset, k):
    """eval_dihe(mesh=) and without, on the same rank."""
    from cvpce_tpu_torch.eval.classification import eval_dihe

    mesh = _mesh()
    kw = dict(batch_size=4, k=k, verbose=False, device="cpu")
    return {"mesh": eval_dihe(color_encoder, 48, gallery_items, testset,
                              mesh=mesh, **kw),
            "single": eval_dihe(color_encoder, 48, gallery_items, testset,
                                **kw)}


# ------------------------------------------------------------ the steps

def gln_step(state_dict, batch, config_kw, train_kw):
    """One DP GLN train step from `state_dict` on this rank's slice of
    `batch` (images, boxes, box_valid, image_sizes); then a second on the
    batch reversed, against make_multi_step over both under
    make_dp_train_step(batch_axis=1) from `state_dict` again."""
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.train import gln as gln_train

    mesh = _mesh()
    cfg = GLNConfig(**config_kw)
    tcfg = gln_train.GLNTrainConfig(**train_kw)

    def fresh():
        return put_replicated(gln_train.init_train_state(
            cfg, tcfg, state_dict=state_dict, device="cpu"), mesh)

    one = gln_train.make_train_step(cfg, tcfg, cfg.anchors()[0])
    step = make_dp_train_step(one, mesh)
    state, metrics = step(fresh(), *put_sharded(batch, mesh))
    sd = state.model.state_dict()
    out = {"step": state.step,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "digest": digest(sd),
           "state": _cpu(sd) if mesh.rank == 0 else None}

    reverse = tuple(a[::-1].copy() for a in batch)
    state, second = step(state, *put_sharded(reverse, mesh))
    stacked = tuple(np.stack([a, r]) for a, r in zip(batch, reverse))
    multi = make_dp_train_step(gln_train.make_multi_step(one), mesh,
                               batch_axis=1)
    state_m, metrics_m = multi(fresh(), *put_sharded(stacked, mesh,
                                                     batch_axis=1))
    out["singles"] = ({k: [metrics[k].item(), second[k].item()]
                       for k in metrics}, digest(state.model.state_dict()))
    out["multi"] = ({k: v.tolist() for k, v in metrics_m.items()},
                    digest(state_m.model.state_dict()))
    return out


def _players(state, names):
    opts = {"embedder": "emb_opt", "generator": "gen_opt",
            "discriminator": "disc_opt"}
    out = {}
    for name in names:
        module, opt = getattr(state, name), getattr(state, opts[name])
        out[name] = (_cpu(module.state_dict()),
                     {n: opt.state[p]["exp_avg"].detach().clone()
                      for n, p in module.named_parameters()})
    return out


def _float64(*models):
    from cvpce_tpu_torch.models.embedders import MACVGG

    for m in models:
        m.double()
        if isinstance(m, MACVGG):
            m.dtype = torch.float64


def dihe_step(before, batch, cfg_kw):
    """One DP DIHE three-player step in float64 from `before` on this
    rank's slice of (positives, negatives, gen_batch, disc_batch,
    similarity)."""
    from cvpce_tpu_torch.train import dihe

    mesh = _mesh()
    cfg = dihe.DIHETrainConfig(**cfg_kw)
    state = dihe.init_dihe_state(
        cfg, state_dicts=before,
        gen_channels=before["generator"]["down_0.weight"].shape[1],
        device="cpu")
    _float64(state.embedder, state.generator, state.discriminator)
    put_replicated(state, mesh)
    step = make_dp_train_step(dihe.make_dihe_train_step(cfg), mesh)
    state, metrics = step(state, *put_sharded(batch, mesh))
    players = _players(state, ("embedder", "generator", "discriminator"))
    return {"step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "digest": digest({f"{p}.{k}": v for p, (sd, _) in
                              players.items() for k, v in sd.items()}),
            "players": players if mesh.rank == 0 else None}


def gan_step(before, batch, cfg_kw):
    """One DP GAN pretraining step in float64 from `before` on this
    rank's slice of (gen_batch, disc_batch)."""
    from cvpce_tpu_torch.train import dihe

    mesh = _mesh()
    init, step_fn = dihe.make_gan_pretrain_step(
        dihe.GANPretrainConfig(**cfg_kw))
    state = init(gen_channels=before["generator"]["down_0.weight"].shape[1],
                 device="cpu")
    state.generator.load_state_dict(before["generator"])
    state.discriminator.load_state_dict(before["discriminator"])
    _float64(state.generator, state.discriminator)
    put_replicated(state, mesh)
    step = make_dp_train_step(step_fn, mesh)
    state, metrics = step(state, *put_sharded(batch, mesh))
    players = _players(state, ("generator", "discriminator"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "digest": digest({f"{p}.{k}": v for p, (sd, _) in
                              players.items() for k, v in sd.items()}),
            "players": players if mesh.rank == 0 else None}


# ------------------------------------------------------------ the loops

def _files(out):
    return {name: open(os.path.join(out, name)).read()
            if name.endswith(".json") else None
            for name in os.listdir(out)}


def gln_loop(dataset, evalset, config_kw, train_kw, loop_kw):
    """train_proposal_generator(use_mesh=True) for one epoch, then a
    resume=True run of one more, each rank into its own directory (rank
    0 alone writes, and rank 1 resumes from what rank 0 broadcasts)."""
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.train import gln as gln_train
    from cvpce_tpu_torch.train.loops import train_proposal_generator

    mesh = _mesh()
    out = os.path.join(os.environ["OUT"], f"gln_rank{mesh.rank}")
    kw = dict(model_cfg=GLNConfig(**config_kw),
              train_cfg=gln_train.GLNTrainConfig(**train_kw),
              use_mesh=True, device="cpu", **loop_kw)
    first = train_proposal_generator(dataset, evalset, out, epochs=1, **kw)
    first_digest = digest(first["state"].model.state_dict())
    files = _files(out)
    resumed = train_proposal_generator(dataset, evalset, out, epochs=1,
                                       resume=True, **kw)
    return {"first": (first["state"].step, first["best"], first_digest),
            "resumed": (resumed["state"].step, resumed["best"],
                        digest(resumed["state"].model.state_dict())),
            "files": files, "files_after": _files(out)}


def dihe_loop(dataset, discriminatorset, evaldata, evalset, before, cfg_kw,
              loop_kw):
    """train_dihe(use_mesh=True) from `before` ({"embedder", "generator",
    "discriminator"} state_dicts), each rank into its own directory."""
    from cvpce_tpu_torch.train import dihe
    from cvpce_tpu_torch.train.loops import train_dihe

    mesh = _mesh()
    out = os.path.join(os.environ["OUT"], f"dihe_rank{mesh.rank}")
    reports = []
    got = train_dihe(
        dataset, discriminatorset, evaldata, evalset, out,
        train_cfg=dihe.DIHETrainConfig(**cfg_kw),
        gan_state={k: before[k] for k in ("generator", "discriminator")},
        init_embedder=before["embedder"], use_mesh=True, device="cpu",
        hyperopt_report=lambda **r: reports.append(r), **loop_kw)
    state = got["state"]
    players = _players(state, ("embedder", "generator", "discriminator"))
    return {"step": state.step, "best": got["best"], "reports": reports,
            "digest": digest({f"{p}.{k}": v for p, (sd, _) in
                              players.items() for k, v in sd.items()}),
            "players": players if mesh.rank == 0 else None,
            "files": _files(out)}
