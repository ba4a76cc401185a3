"""DIHE training: the three-player (embedder / discriminator / generator)
step and the GAN pretraining step; counterpart of
cvpce_tpu/train/dihe.py.

The reference's step (cvpce/classification_training.py:334-541): per
batch, three updates in turn, each taking gradients for its own player
only:
- encoder: the hierarchical triplet loss with a GAN-generated anchor
  (:479-489);
- discriminator: BCE on the generator's fakes (0) and target-domain
  crops (1) (:491-502);
- generator: adversarial BCE + negative ZNCC to its input + 0.1 x the
  negative cosine distance of its fakes' embeddings to the positives'
  (:504-517), through the discriminator and embedder as the two
  sub-steps before updated them.

Every forward runs in train mode, with batch statistics. The running
statistics move where the JAX step keeps them and nowhere else: the
generator in each sub-step (3 updates a step), the embedder by the
anchor, the positives and the negatives of the encoder sub-step (3),
the discriminator by the fakes, then the real crops (2); the generator
sub-step's embedder and discriminator forwards leave theirs alone
(models/resnet.py:frozen_statistics). GAN pretraining moves the
generator's twice and the discriminator's twice.

The optimizers are optax's `adam` (b1 0.9, b2 0.999, eps 1e-8) as
torch.optim.Adam, one per player; the encoder's LR is
`enc_lr * enc_multiplier ** (step // steps_per_epoch)`, set from the
number of steps taken before the update, as optax counts. A step works
in place on the state it is given and returns it.

Under parallel/mesh.py:make_dp_train_step every BatchNorm takes the
global batch's statistics and each player's gradients are averaged over
the ranks before its update; the losses are batch means over equal
local batches, so the averages are the global batch's. The ranks stay
in step without DistributedDataParallel, whose buffer broadcast and
one-forward-per-backward model the several forwards of each sub-step
do not fit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.embedders import MACVGG
from ..models.gan import AveragingPatchGAN, UNetGenerator
from ..models.resnet import frozen_statistics
from ..ops.knn import cosine_distance
from ..ops.losses import hierarchical_triplet_loss, masked_zncc, zncc
from ..parallel.mesh import average_gradients
from ..utils import resolve_device

# optax.adam's defaults (eps_root 0)
ADAM_KW = dict(betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass(frozen=True)
class DIHETrainConfig:
    # cvpce/classification_training.py:38-47 defaults
    min_margin: float = 0.05
    max_margin: float = 0.5
    enc_lr: float = 1e-6
    enc_multiplier: float = 1.0
    gan_lr: float = 1e-5  # "learning rates from the DIHE paper"
    batchnorm: bool = True
    masks: bool = False
    steps_per_epoch: int = 1000
    emb_weight: float = 0.1  # Tonioni weighting, line 513
    gen_downs: int = 8  # U-Net depth; 8 for 256px (tests shrink it)


@dataclasses.dataclass(frozen=True)
class GANPretrainConfig:
    lr: float = 1e-5  # Adam, both nets (classification_training.py:280-281)
    masks: bool = False
    gen_downs: int = 8  # U-Net depth; 8 for 256px (tests shrink it)


@dataclasses.dataclass
class DIHETrainState:
    """The three players (updated in place), their Adam optimizers and
    the number of steps taken."""
    embedder: MACVGG
    generator: UNetGenerator
    discriminator: AveragingPatchGAN
    emb_opt: torch.optim.Adam
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    step: int = 0

    _PARTS = ("embedder", "generator", "discriminator", "emb_opt",
              "gen_opt", "disc_opt")

    def state_dict(self) -> Dict:
        out = {k: getattr(self, k).state_dict() for k in self._PARTS}
        out["step"] = self.step
        return out

    def load_state_dict(self, sd: Mapping) -> None:
        for k in self._PARTS:
            getattr(self, k).load_state_dict(sd[k])
        self.step = int(sd["step"])


@dataclasses.dataclass
class GANTrainState:
    """Generator and discriminator with their Adam optimizers (the JAX
    pretraining state's six entries)."""
    generator: UNetGenerator
    discriminator: AveragingPatchGAN
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam

    _PARTS = ("generator", "discriminator", "gen_opt", "disc_opt")

    def state_dict(self) -> Dict:
        return {k: getattr(self, k).state_dict() for k in self._PARTS}

    def load_state_dict(self, sd: Mapping) -> None:
        for k in self._PARTS:
            getattr(self, k).load_state_dict(sd[k])


def hierarchy_similarity(positives: Sequence[Sequence[str]],
                         negatives: Sequence[Sequence[str]]) -> np.ndarray:
    """Fraction of the shared category-path prefix; 1.0 if the negative
    path is a prefix of the positive ("Tonioni Eq 2",
    classification_training.py:181-194). Host-side on string paths."""
    assert len(positives) == len(negatives)
    sim = np.empty(len(positives), np.float32)
    for i, (pos, neg) in enumerate(zip(positives, negatives)):
        for j, p in enumerate(pos):
            if j >= len(neg) or p != neg[j]:
                sim[i] = j / len(pos)
                break
        else:
            sim[i] = 1.0
    return sim


def _bce(pred: torch.Tensor, target: float,
         eps: float = 1e-7) -> torch.Tensor:
    """Binary cross-entropy on probabilities clipped to [eps, 1 - eps]
    (F.binary_cross_entropy clamps the log at -100 instead)."""
    p = pred.clamp(eps, 1 - eps)
    if target == 1.0:
        return -torch.log(p).mean()
    return -torch.log(1 - p).mean()


def build_models(cfg: DIHETrainConfig, gen_channels: int = 3,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[MACVGG, UNetGenerator, AveragingPatchGAN]:
    """Embedder, generator and discriminator in train mode, their
    weights drawn in that order from `generator`."""
    embedder = MACVGG(batch_norm=cfg.batchnorm, generator=generator)
    gen = UNetGenerator(num_downs=cfg.gen_downs, in_channels=gen_channels,
                        generator=generator)
    disc = AveragingPatchGAN(generator=generator)
    for m in (embedder, gen, disc):
        m.train()
    return embedder, gen, disc


def build_optimizers(cfg: DIHETrainConfig, models: Sequence[torch.nn.Module]
                     ) -> Tuple[torch.optim.Adam, ...]:
    """optax.adam for the embedder (its LR set before every step by
    `encoder_learning_rate`), the generator and the discriminator (both
    at `gan_lr`)."""
    embedder, gen, disc = models
    return (torch.optim.Adam(embedder.parameters(), lr=cfg.enc_lr,
                             **ADAM_KW),
            torch.optim.Adam(gen.parameters(), lr=cfg.gan_lr, **ADAM_KW),
            torch.optim.Adam(disc.parameters(), lr=cfg.gan_lr, **ADAM_KW))


def encoder_learning_rate(cfg: DIHETrainConfig, step: int) -> float:
    """The encoder's LR at optimizer step `step` (0-based): a
    multiplicative decay once an epoch."""
    return cfg.enc_lr * cfg.enc_multiplier ** (step // cfg.steps_per_epoch)


def init_dihe_state(cfg: DIHETrainConfig, seed: int = 0,
                    gen_channels: int = 3,
                    state_dicts: Optional[Mapping] = None,
                    device="cuda") -> DIHETrainState:
    """The three players on `device`, with seeded random weights (one
    torch.Generator seeded with `seed`) or `state_dicts` ({"embedder",
    "generator", "discriminator"}, e.g. utils/weights.py:dihe_state_dict),
    and fresh optimizers."""
    models = build_models(cfg, gen_channels,
                          torch.Generator().manual_seed(seed))
    dev = resolve_device(device)
    for name, m in zip(("embedder", "generator", "discriminator"), models):
        if state_dicts is not None:
            m.load_state_dict(state_dicts[name])
        m.to(dev)
    return DIHETrainState(*models, *build_optimizers(cfg, models))


def _inputs(module: torch.nn.Module, *arrays) -> Tuple[torch.Tensor, ...]:
    """Numpy arrays or tensors on `module`'s device in its parameters'
    dtype (f32, or f64 for a model that was made `.double()`)."""
    p = next(module.parameters())
    return tuple((a if torch.is_tensor(a) else torch.from_numpy(
        np.asarray(a))).to(device=p.device, dtype=p.dtype) for a in arrays)


def _update(opt: torch.optim.Adam, loss: torch.Tensor,
            lr: Optional[float] = None) -> None:
    """One Adam step of `opt`'s parameters on their gradient of `loss`;
    no other tensor gets a gradient. Inside a data-parallel step the
    gradients are first averaged over the ranks."""
    params = opt.param_groups[0]["params"]
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    average_gradients(params)
    if lr is not None:
        opt.param_groups[0]["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)


def _regulariser(fake: torch.Tensor, gen_batch: torch.Tensor,
                 masks: bool) -> torch.Tensor:
    """Negative ZNCC of the fakes to the generator's RGB input, over the
    pixels whose mask channel is 0 with `masks`."""
    rgb = gen_batch[..., :3]
    if masks:
        return -masked_zncc(fake, rgb, gen_batch[..., 3] == 0)
    return -zncc(fake, rgb)


def encoder_substep(state: DIHETrainState, cfg: DIHETrainConfig,
                    positives: torch.Tensor, negatives: torch.Tensor,
                    gen_batch: torch.Tensor,
                    similarity: torch.Tensor) -> torch.Tensor:
    """The embedder's update on the triplet loss, the generated image as
    the anchor (classification_training.py:479-489)."""
    with torch.no_grad():
        fake = state.generator(gen_batch)
    emb = state.embedder
    loss = hierarchical_triplet_loss(emb(fake), emb(positives),
                                     emb(negatives), similarity,
                                     cfg.min_margin, cfg.max_margin)
    _update(state.emb_opt, loss, encoder_learning_rate(cfg, state.step))
    return loss.detach()


def discriminator_substep(state, gen_batch: torch.Tensor,
                          disc_batch: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The discriminator's update on BCE over a fresh batch of fakes (0)
    and the real crops (1) (classification_training.py:491-502).
    `state` is a DIHETrainState or a GANTrainState."""
    with torch.no_grad():
        fake = state.generator(gen_batch)
    loss_fake = _bce(state.discriminator(fake), 0.0)
    loss_real = _bce(state.discriminator(disc_batch), 1.0)
    _update(state.disc_opt, loss_fake + loss_real)
    return loss_fake.detach(), loss_real.detach()


def generator_substep(state: DIHETrainState, cfg: DIHETrainConfig,
                      positives: torch.Tensor, gen_batch: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """The generator's update (classification_training.py:504-517):
    adversarial BCE through the updated discriminator, negative ZNCC to
    its input, and `emb_weight` x the negative cosine distance between
    its fakes' and the positives' embeddings under the updated embedder,
    both players' statistics left as they were."""
    fake = state.generator(gen_batch)
    with frozen_statistics(state.discriminator, state.embedder):
        pred_fake = state.discriminator(fake)
        with torch.no_grad():
            pos_emb = state.embedder(positives)
        fake_emb = state.embedder(fake)
    loss_adv = _bce(pred_fake, 1.0)
    loss_reg = _regulariser(fake, gen_batch, cfg.masks)
    loss_emb = -cosine_distance(fake_emb, pos_emb, axis=1).mean()
    _update(state.gen_opt, loss_adv + loss_reg + cfg.emb_weight * loss_emb)
    return loss_adv.detach(), loss_reg.detach(), loss_emb.detach()


def make_dihe_train_step(cfg: DIHETrainConfig) -> Callable:
    """(state, positives, negatives, gen_batch, disc_batch, similarity)
    -> (state, metrics): positives / negatives / disc_batch (B, H, W, 3)
    in tanh scale, gen_batch (B, H, W, 3 or 4), similarity (B,); numpy
    arrays or tensors. The metrics (dihe, disc_fake, disc_real, gen_adv,
    gen_reg, gen_emb) are 0-d tensors on the state's device."""

    def train_step(state: DIHETrainState, positives, negatives, gen_batch,
                   disc_batch, similarity):
        positives, negatives, gen_batch, disc_batch, similarity = _inputs(
            state.embedder, positives, negatives, gen_batch, disc_batch,
            similarity)
        for m in (state.embedder, state.generator, state.discriminator):
            m.train()
        metrics = {"dihe": encoder_substep(state, cfg, positives, negatives,
                                           gen_batch, similarity)}
        metrics["disc_fake"], metrics["disc_real"] = discriminator_substep(
            state, gen_batch, disc_batch)
        adv, reg, emb = generator_substep(state, cfg, positives, gen_batch)
        metrics.update(gen_adv=adv, gen_reg=reg, gen_emb=emb)
        state.step += 1
        return state, metrics

    return train_step


def make_gan_pretrain_step(cfg: GANPretrainConfig):
    """GAN pretraining (cvpce/classification_training.py:257-332): the
    discriminator on BCE real/fake, then the generator on adversarial
    BCE + negative ZNCC. Returns (init, step):

    - init(seed=0, gen_channels=3, device="cuda") -> GANTrainState with
      seeded weights and fresh Adam optimizers at `cfg.lr`;
    - step(state, gen_batch, disc_batch) -> (state, metrics {disc_real,
      disc_fake, gen_adv, gen_reg}), in place."""

    def init(seed: int = 0, gen_channels: int = 3,
             device="cuda") -> GANTrainState:
        g = torch.Generator().manual_seed(seed)
        gen = UNetGenerator(num_downs=cfg.gen_downs,
                            in_channels=gen_channels, generator=g)
        disc = AveragingPatchGAN(generator=g)
        dev = resolve_device(device)
        gen.to(dev).train()
        disc.to(dev).train()
        return GANTrainState(
            gen, disc,
            torch.optim.Adam(gen.parameters(), lr=cfg.lr, **ADAM_KW),
            torch.optim.Adam(disc.parameters(), lr=cfg.lr, **ADAM_KW))

    def step(state: GANTrainState, gen_batch, disc_batch):
        gen_batch, disc_batch = _inputs(state.generator, gen_batch,
                                        disc_batch)
        state.generator.train()
        state.discriminator.train()
        loss_fake, loss_real = discriminator_substep(state, gen_batch,
                                                     disc_batch)
        fake = state.generator(gen_batch)
        with frozen_statistics(state.discriminator):
            loss_adv = _bce(state.discriminator(fake), 1.0)
        loss_reg = _regulariser(fake, gen_batch, cfg.masks)
        _update(state.gen_opt, loss_adv + loss_reg)
        return state, {"disc_real": loss_real, "disc_fake": loss_fake,
                       "gen_adv": loss_adv.detach(),
                       "gen_reg": loss_reg.detach()}

    return init, step
