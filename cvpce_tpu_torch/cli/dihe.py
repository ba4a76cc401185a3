"""`dihe` command group; counterpart of cvpce_tpu/cli/dihe.py.

Each command runs on the `device` that main() resolved from `--device`.
`--weights` takes a torchvision vgg16(_bn) or reference MACVGG file, the
port's DIHE training checkpoint (`<out>/embedder_checkpoint`,
`<out>/epoch_<e>`), or a directory: a DIHE training run (`<out>`) or a
serving export (pipeline/serving.py), of the port or of the JAX package
(its orbax directories, such as artifacts/dihe_r4), read by
cli/common.py:load_embedder. `--gan` is a `pretrain-gan` output
directory, of the port or of the JAX package, whose `gan_checkpoint`
starts the generator and discriminator.
"""
from __future__ import annotations

import json
import os
from os import path

import numpy as np
import torch

from ..data import defaults
from . import Multiple, command, existing_path
from .common import load_embedder

# hyperopt'd preset (cvpce/cli/dihe.py:159-162)
HYPEROPT_ENC_LR = 8e-7
HYPEROPT_ENC_MULTIPLIER = 0.9


def _gp_options(parser) -> None:
    parser.add_argument("--source", action=Multiple,
                        default=defaults.GP_TRAIN_FOLDERS)
    parser.add_argument("--imgs", default=defaults.SKU110K_IMG_DIR)
    parser.add_argument("--annotations",
                        default=defaults.SKU110K_ANNOTATION_FILE)


def _test_options(parser) -> None:
    parser.add_argument("--test-imgs", default=defaults.GP_TEST_DIR)
    parser.add_argument("--test-annotations", default=defaults.GP_ANN_DIR)


def _discset(imgs, annotations):
    from ..data.sku110k import TargetDomainDataset

    return TargetDomainDataset(imgs, annotations,
                               skip=defaults.SKU110K_SKIP)


def _validation_set(test_imgs, test_annotations):
    from ..data.grocery import GroceryProductsTestSet

    return GroceryProductsTestSet(
        test_imgs, test_annotations,
        only=defaults.GP_TEST_VALIDATION_SET_SIZE)


def pretrain_gan(source, imgs, annotations, out, epochs, batch_size, masks,
                 resume, device):
    """Pretrain the U-Net/PatchGAN domain adapter
    (cvpce/cli/dihe.py:31-75)."""
    from ..data.grocery import GroceryProductsDataset
    from ..train import loops

    dataset = GroceryProductsDataset(list(source), include_masks=masks)
    loops.pretrain_gan(dataset, _discset(imgs, annotations), out,
                       epochs=epochs, batch_size=batch_size, masks=masks,
                       resume=resume, device=device)


def load_gan_state(gan_path: str):
    """The generator's and discriminator's state_dicts of a
    `pretrain-gan` run's `gan_checkpoint`, for train_dihe to load into
    players it builds: an orbax node of either package (its gen_params /
    gen_stats / disc_params / disc_stats, bridged by
    utils/weights.py:gan_state_dict), or the `torch.save` file of the
    port's earlier runs."""
    from ..train.checkpoint import CheckpointManager
    from ..utils.weights import gan_state_dict

    node = CheckpointManager(gan_path, name="gan_checkpoint").read()
    if node.layout == "torch":
        return node.value
    tree = node.value
    return {"generator": gan_state_dict(tree["gen_params"],
                                        tree["gen_stats"]),
            "discriminator": gan_state_dict(tree["disc_params"],
                                            tree["disc_stats"])}


def train(source, source_type, only, eval_data, imgs, annotations,
          test_imgs, test_annotations, out, gan_path, epochs, batch_size,
          masks, no_batchnorm, hyperopt_params, grain, resume,
          imagenet_path, device):
    """Train DIHE (cvpce/cli/dihe.py:77-167)."""
    from ..data.grocery import GroceryProductsDataset, InternalTrainSet
    from ..train import loops
    from ..train.dihe import DIHETrainConfig

    if source_type == "gp":
        dataset = GroceryProductsDataset(list(source), include_masks=masks,
                                         include_annotations=True,
                                         only=list(only) or None)
    else:
        dataset = InternalTrainSet(source[0], include_masks=masks,
                                   include_annotations=True)
    evaldata = dataset
    if eval_data:
        evaldata = GroceryProductsDataset(list(eval_data),
                                          include_masks=masks,
                                          include_annotations=True,
                                          only=list(only) or None)
    discset = _discset(imgs, annotations)
    evalset = _validation_set(test_imgs, test_annotations)
    cfg = DIHETrainConfig(
        enc_lr=HYPEROPT_ENC_LR if hyperopt_params else 1e-6,
        enc_multiplier=HYPEROPT_ENC_MULTIPLIER if hyperopt_params else 1.0,
        batchnorm=not no_batchnorm, masks=masks)
    gan_state = load_gan_state(gan_path) if gan_path else None
    kwargs = {}
    if grain:
        from ..data.grain_loader import GrainLoader

        kwargs["loader_cls"] = GrainLoader
    if imagenet_path:
        from ..utils.torch_import import (import_vgg16_features,
                                          load_state_dict)

        kwargs["init_embedder"] = import_vgg16_features(
            load_state_dict(imagenet_path), batch_norm=not no_batchnorm)
    loops.train_dihe(dataset, discset, evaldata, evalset, out,
                     gan_state=gan_state, epochs=epochs,
                     batch_size=batch_size, train_cfg=cfg, resume=resume,
                     device=device, **kwargs)


def eval_cmd(source, imgs, annotations, test_imgs, test_annotations,
             weights, k, batch_size, encoder, resnet_layers, int8, index,
             only, validation, sharded_gallery, device):
    """Gallery-kNN classification accuracy (cvpce/cli/dihe.py:257-309).

    Prints {k: top-k accuracy} as JSON. --sharded-gallery holds the
    gallery row-sharded over the ranks of the process group: torchrun's,
    or one of this process alone that ends with the command."""
    from ..data.grocery import GroceryProductsDataset, GroceryProductsTestSet
    from ..eval.classification import eval_dihe
    from .eval import gallery_group

    encoder_fn, emb_size = load_embedder(weights, encoder=encoder,
                                         int8=int8,
                                         resnet_layers=tuple(resnet_layers),
                                         device=device)
    with gallery_group(sharded_gallery, device):
        mesh = None
        if sharded_gallery:
            from ..parallel.mesh import data_parallel_mesh

            mesh = data_parallel_mesh(device=device)
        sampleset = None if index else GroceryProductsDataset(
            list(source), random_crop=False, include_annotations=True)
        split = "val" if validation else only
        n = defaults.GP_TEST_VALIDATION_SET_SIZE
        testset = GroceryProductsTestSet(
            test_imgs, test_annotations,
            only=n if split == "val" else None,
            skip=n if split == "test" else None)
        accuracy = eval_dihe(encoder_fn, emb_size, sampleset, testset,
                             batch_size=batch_size, k=tuple(k),
                             load_index=index, mesh=mesh, device=device)
    print(json.dumps({str(kk): v for kk, v in accuracy.items()}))


def prebuild_index(source, datatype, imgs, annotations, weights, out,
                   batch_size, int8, device):
    """Embed the gallery once and save the classifier index
    (cvpce/cli/dihe.py:382-423)."""
    from ..data.grocery import GroceryProductsDataset, InternalTrainSet
    from ..pipeline.classifier import Classifier

    encoder_fn, emb_size = load_embedder(weights, int8=int8, device=device)
    if datatype == "gp":
        sampleset = GroceryProductsDataset(list(source), random_crop=False,
                                           include_annotations=True)
    else:
        sampleset = InternalTrainSet(source[0], random_crop=False,
                                     include_annotations=True)
    classifier = Classifier(encoder_fn, emb_size, sampleset,
                            batch_size=batch_size, verbose=True,
                            device=device)
    classifier.save_index(out)
    print(f"index with {len(classifier.annotations)} entries -> {out}")


def visualize_performance(index, weights, images, out, k, device):
    """kNN grid visualization (cvpce/cli/dihe.py:311-380).

    Draws with matplotlib, which is checked before the embedder is
    built."""
    from ..utils import viz
    from .gln import _require_matplotlib

    _require_matplotlib("visualize-performance")
    plt = viz._plt()

    from ..data import transforms as T
    from ..pipeline.classifier import Classifier

    encoder_fn, emb_size = load_embedder(weights, device=device)
    classifier = Classifier(encoder_fn, emb_size, load=index, k=k,
                            device=device)
    fig, axes = plt.subplots(len(images), 1,
                             figsize=(8, 3 * max(len(images), 1)))
    axes = np.atleast_1d(axes)
    for ax, img_path in zip(axes, images):
        img = T.scale_to_tanh(T.resize_for_classification(
            T.load_image(img_path)))
        anns = classifier.classify(img[None])[0]
        # JAX's transforms have no scale_from_tanh (cvpce_tpu/cli/
        # dihe.py:268), so its command draws (img + 1) / 2
        ax.imshow(((img + 1) / 2).cpu().numpy())
        ax.set_title(" | ".join(str(a) for a in anns), fontsize=8)
        ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    print(f"saved {out}")


def hyperopt(source, source_type, only, imgs, annotations, test_imgs,
             test_annotations, out, gan_path, trials, max_epochs, resume,
             batch_size, shared_state, host_id, device):
    """Hyperparameter search over the reference's DIHE space
    (cvpce/cli/dihe.py:224-228: batchnorm, enc_multiplier, enc_lr) with
    ASHA early stopping.

    One concurrent trial per card of this process (the CPU alone under
    --device cpu); the best config and metric go to
    <out>/hyperopt_result.json. --gan is accepted and unused, as in the
    JAX command."""
    from ..data.grocery import GroceryProductsDataset, InternalTrainSet
    from ..train import loops
    from ..train.dihe import DIHETrainConfig
    from ..train.hyperopt import (DIHE_SPACE, device_scope, run_search,
                                  run_search_multihost, trial_dir_allocator)

    os.makedirs(out, exist_ok=True)
    if source_type == "gp":
        dataset = GroceryProductsDataset(list(source),
                                         include_annotations=True,
                                         only=list(only) or None)
    else:
        dataset = InternalTrainSet(source[0], include_annotations=True)
    discset = _discset(imgs, annotations)
    evalset = _validation_set(test_imgs, test_annotations)
    new_trial_dir = trial_dir_allocator(out)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])

    def train_one_epoch(config, epoch, carry, device=None):
        cfg = DIHETrainConfig(enc_lr=config["enc_lr"],
                              enc_multiplier=config["enc_multiplier"],
                              batchnorm=config["batchnorm"])
        metrics = {}

        def report(**kw):
            metrics.update(kw)

        if carry is None:  # first epoch of this trial: own working dir
            carry = new_trial_dir()
        # one trial per card (cvpce/cli/dihe.py:243), no mesh inside;
        # each epoch resumes the trial's rotating checkpoint, so it
        # continues the same training run
        with device_scope(device if device.type == "cuda" else None):
            loops.train_dihe(dataset, discset, dataset, evalset, carry,
                             epochs=1, batch_size=batch_size, train_cfg=cfg,
                             use_mesh=False, hyperopt_report=report,
                             resume=epoch > 0, device=device)
        return metrics.get("accuracy", 0.0), carry

    if shared_state:
        result = run_search_multihost(
            train_one_epoch, DIHE_SPACE, state_path=shared_state,
            num_trials=trials, max_epochs=max_epochs, devices=devices,
            host_id=host_id)
    else:
        result = run_search(
            train_one_epoch, DIHE_SPACE, num_trials=trials,
            max_epochs=max_epochs, devices=devices,
            state_path=path.join(out, "search_state.json"), resume=resume)
    best = {"best_config": result["best_config"],
            "best_metric": result["best_metric"]}
    print(json.dumps(best, indent=2))
    with open(path.join(out, "hyperopt_result.json"), "w") as f:
        json.dump(best, f)


def register(commands) -> None:
    text = ("Domain-Invariant Hierarchical Embedding: product "
            "classification.")
    dihe = commands.add_parser("dihe", help=text, description=text)
    group = dihe.add_subparsers(dest="group_command", metavar="COMMAND",
                                required=True)

    p = command(group, "pretrain-gan", pretrain_gan)
    _gp_options(p)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--masks", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue from --out's rotating gan_checkpoint")

    p = command(group, "train", train)
    _gp_options(p)
    p.add_argument("--source-type", choices=["gp", "internal"], default="gp",
                   help="training gallery type (cvpce/cli/dihe.py:85)")
    p.add_argument("--only", action=Multiple, default=(),
                   help="only train with these top-level data groups "
                        "(cvpce/cli/dihe.py:87)")
    p.add_argument("--eval-data", action=Multiple, default=(),
                   help="separate eval gallery roots (used with internal "
                        "source, cvpce/cli/dihe.py:145)")
    _test_options(p)
    p.add_argument("--out", required=True)
    p.add_argument("--gan", dest="gan_path", default=None,
                   help="pretrain-gan output directory (its "
                        "gan_checkpoint); required for real runs")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--masks", action="store_true")
    p.add_argument("--no-batchnorm", action="store_true")
    p.add_argument("--hyperopt-params", action="store_true",
                   help="enc lr 8e-7, multiplier 0.9 (cli/dihe.py:159-162)")
    p.add_argument("--grain", action="store_true",
                   help="GrainLoader input pipeline (mid-epoch "
                        "resumable)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the rotating embedder_checkpoint "
                        "in --out (the reference's --load-enc, "
                        "cvpce/cli/dihe.py:132)")
    p.add_argument("--imagenet", dest="imagenet_path", default=None,
                   type=existing_path,
                   help="initialize the embedder from a torchvision "
                        "vgg16(_bn) ImageNet state_dict (the reference's "
                        "pretrained start, "
                        "cvpce/models/classification.py:97-109)")

    p = command(group, "eval", eval_cmd)
    _gp_options(p)
    _test_options(p)
    p.add_argument("--weights", default=None,
                   help="embedder weights (a vgg16_bn or MACVGG file, a "
                        "port DIHE checkpoint, run or serving export); "
                        "omit for a seeded random init")
    p.add_argument("--k", action=Multiple, type=int, default=(1, 5))
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--encoder", choices=["vgg16", "resnet50"],
                   default="vgg16")
    p.add_argument("--resnet-layers", action=Multiple, type=int,
                   default=(2, 3),
                   help="resnet50 descriptor layers (reference layer l = "
                        "stage c(l+1); cvpce/cli/dihe.py:278)")
    p.add_argument("--int8", action="store_true",
                   help="static int8 embedder in bf16")
    p.add_argument("--index", default=None,
                   help="prebuilt classifier index (skips gallery "
                        "embedding)")
    p.add_argument("--only", choices=["none", "test", "val"],
                   default="none",
                   help="all annotations, or only the test/validation "
                        "split (first 2 per image = val; "
                        "cvpce/cli/dihe.py:284-298)")
    p.add_argument("--validation", action="store_true",
                   help="alias for --only val (defaults.py:24-26)")
    p.add_argument("--sharded-gallery", action="store_true",
                   help="shard the gallery over the process group's ranks "
                        "(ops/knn_sharded.py)")

    p = command(group, "prebuild-index", prebuild_index)
    _gp_options(p)
    p.add_argument("--datatype", choices=["gp", "internal"], default="gp",
                   help="gallery dataset type (cvpce/cli/dihe.py:390)")
    p.add_argument("--weights", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--int8", action="store_true",
                   help="static int8 embedder in bf16")

    p = command(group, "visualize-performance", visualize_performance)
    p.add_argument("--index", required=True,
                   help="prebuilt classifier index")
    p.add_argument("--weights", default=None)
    p.add_argument("images", nargs="*", type=existing_path)
    p.add_argument("--out", required=True)
    p.add_argument("--k", type=int, default=5)

    p = command(group, "hyperopt", hyperopt)
    _gp_options(p)
    p.add_argument("--source-type", choices=["gp", "internal"], default="gp",
                   help="training gallery type (cvpce/cli/dihe.py:177)")
    p.add_argument("--only", action=Multiple, default=(),
                   help="only train with these top-level data groups "
                        "(cvpce/cli/dihe.py:179)")
    _test_options(p)
    p.add_argument("--out", required=True)
    p.add_argument("--gan", dest="gan_path", default=None)
    p.add_argument("--trials", type=int, default=16,
                   help="TOTAL trial budget (incl. restored on --resume)")
    p.add_argument("--max-epochs", type=int, default=6)
    p.add_argument("--resume", action="store_true",
                   help="restore search_state.json from --out and "
                        "continue (cvpce/cli/dihe.py:212-213)")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--shared-state", default=None,
                   help="multi-host search: claim trials from this "
                        "shared flock-backed store (the same command on "
                        "every host with a distinct --host-id)")
    p.add_argument("--host-id", type=int, default=0)
