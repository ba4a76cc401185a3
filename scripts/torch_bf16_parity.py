#!/usr/bin/env python3
"""Measure how far the port's bf16-compute GLN lies from the JAX
package's on the CPU, on the inputs of tests/test_torch_train_gln_bf16.py
(64x64, tanh, PRNGKey(0) variables, `step_batch`'s images):

- the forward outputs (heatmap, class logits, box regression) of JAX's
  bf16 GLN in train mode, folded and unfolded up-convolution, of the
  port's training GLN (f32 master weights, `param_dtype=torch.float32`)
  and of the port's serving GLN (weights stored in bf16), each as the
  relative L2 distance from JAX's bf16 output beside JAX's own
  bf16-against-f32 distance. Both GLNs add the bf16 bias in f32 where
  the JAX module widens a conv's result at once, as XLA does. Beside
  them, JAX's bf16 GLN run op by op (`jax.disable_jit`, which rounds
  each of those bias sums to bf16) against its jitted run;
- one train step's losses and per-tensor update distances, as
  testing.train_step_bf16_check computes them, against JAX's bf16 step
  with the up-convolution folded and unfolded, and the median over the
  trained tensors of the relative L2 distance of the port's update from
  JAX's bf16 one beside that of JAX's bf16 update from its f32 one;
- with `--seeds N`, the spread that TRAIN_STEP_TOL_BF16 must cover on
  the card, measured on the CPU between two bf16 convolutions (oneDNN's
  own against the port's CPU path, the f32 convolution of the rounded
  operands) at chip_smoke.py's train.parity inputs (256x384, seeds 0 to
  N - 1): per seed, the loss distance over its bound and the worst
  tensor's distance over its bound, with and without `update_rel`.

Prints one JSON object:

    JAX_PLATFORMS=cpu python scripts/torch_bf16_parity.py [--seeds 24]
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main() -> dict:
    import jax
    import torch

    from cvpce_tpu.models.gln import GLN as JGLN
    from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
    from cvpce_tpu.train import gln as jtrain
    from cvpce_tpu_torch import testing
    from cvpce_tpu_torch.models.gln import GLN, GLNConfig
    from cvpce_tpu_torch.train import gln as ptrain
    from cvpce_tpu_torch.utils.weights import gln_state_dict
    from test_torch_train_gln import TRAIN_KW, H, W, step_batch

    torch.set_num_threads(2)
    batch = step_batch()
    tcfg = jtrain.GLNTrainConfig(**TRAIN_KW)

    def jcfg(dtype, fold=True):
        return JGLNConfig(canvas_h=H, canvas_w=W, tanh=True,
                          compute_dtype=dtype, fold_gaussian_upsample=fold)

    state, _ = jtrain.init_train_state(jcfg("float32"), tcfg,
                                       jax.random.PRNGKey(0))
    variables = jax.device_get({"params": state.params,
                                "frozen": state.frozen,
                                "batch_stats": state.batch_stats})
    before = gln_state_dict(variables)

    def jax_forward(dtype, fold=True, jit=True):
        model = JGLN(config=jcfg(dtype, fold), train=True)
        apply = (lambda v, x: model.apply(v, x, mutable=["batch_stats"]))
        if jit:
            out, _ = jax.jit(apply)(variables, batch[0])
        else:
            with jax.disable_jit():
                out, _ = apply(variables, batch[0])
        return {k: np.asarray(v, np.float32) for k, v in out.items()}

    def port_forward(param_dtype):
        cfg = GLNConfig(canvas_h=H, canvas_w=W, tanh=True,
                        compute_dtype="bfloat16")
        model = GLN(cfg, param_dtype=param_dtype)
        model.load_state_dict(before)
        model.train()
        with torch.no_grad():
            out = model(torch.from_numpy(batch[0]))
        return {k: v.float().numpy() for k, v in out.items()}

    j32 = jax_forward("float32")
    jax16 = {"folded": jax_forward("bfloat16"),
             "unfolded": jax_forward("bfloat16", False)}
    ports = {"training": port_forward(torch.float32),
             "serving": port_forward(None)}
    eager = jax_forward("bfloat16", jit=False)
    forward = {}
    for key in j32:
        row = {f"jax_{f}_vs_f32": rel_l2(o[key], j32[key])
               for f, o in jax16.items()}
        row["jax_eager_vs_jax_folded"] = rel_l2(eager[key],
                                                jax16["folded"][key])
        for name, out in ports.items():
            for f, o in jax16.items():
                row[f"port_{name}_vs_jax_{f}"] = rel_l2(out[key], o[key])
        forward[key] = row

    def jax_step(dtype, fold=True):
        s, opt = jtrain.init_train_state(jcfg(dtype, fold), tcfg,
                                         jax.random.PRNGKey(0))
        cfg = jcfg(dtype, fold)
        new, metrics = jax.jit(jtrain.make_train_step(
            cfg, tcfg, cfg.anchors()[0], opt))(s, *batch)
        new = jax.device_get({"params": new.params, "frozen": new.frozen,
                              "batch_stats": new.batch_stats})
        return ({k: float(v) for k, v in metrics.items()},
                gln_state_dict(new))

    pcfg = GLNConfig(canvas_h=H, canvas_w=W, tanh=True,
                     compute_dtype="bfloat16")
    pstate = ptrain.init_train_state(pcfg, ptrain.GLNTrainConfig(**TRAIN_KW),
                                     state_dict=before, device="cpu")
    pstate, pm = ptrain.make_train_step(
        pcfg, ptrain.GLNTrainConfig(**TRAIN_KW), pcfg.anchors()[0])(
            pstate, *batch)
    got = ({k: float(v) for k, v in pm.items()},
           {k: v.detach().clone() for k, v in
            pstate.model.state_dict().items()})
    ref = jax_step("float32")
    step = {}
    for fold in (True, False):
        want = jax_step("bfloat16", fold)
        res = testing.train_step_bf16_check(before, got, want, ref)
        step["folded" if fold else "unfolded"] = {
            "loss_rel": res["loss_rel"], "loss_bound": res["loss_bound"],
            "worst": res["worst"], "failures": len(res["failures"]),
            "tensors_held": res["n_held"],
            "median_update_rel_port_vs_jax": median_update_rel(
                before, got[1], want[1]),
            "median_update_rel_jax_vs_f32": median_update_rel(
                before, want[1], ref[1])}
    return {"forward": forward, "step": step}


def median_update_rel(before, a, b) -> float:
    """Median over the tensors that move in `b` of |update a - update
    b| / |update b| (L2)."""
    rel = []
    for key, old in before.items():
        if not old.is_floating_point():
            continue
        da, db = (x[key].double() - old.double() for x in (a, b))
        if db.norm() > 0:
            rel.append((da - db).norm().item() / db.norm().item())
    return float(np.median(rel))


def card_spread(seeds: int) -> list:
    """Per seed of chip_smoke.py's train.parity inputs: the port's CPU
    bf16 step with oneDNN's bf16 convolution held to the port's CPU bf16
    step beside the CPU f32 step, as train.parity.bf16 holds the card."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from cvpce_tpu_torch import testing
    from cvpce_tpu_torch.cli.common import load_gln_state_dict
    from cvpce_tpu_torch.data import synthetic
    from cvpce_tpu_torch.data.sku110k import collate_detection
    from cvpce_tpu_torch.models import layers

    port_path = layers.Conv2d._reduced

    def onednn(self, x, padding):
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                     padding, self.dilation, self.groups)
        if self.bias is None:
            return y
        bias = self.bias.to(x.dtype)
        if self.f32_out:
            return y.float() + bias.float()[None, :, None, None]
        return y + bias[None, :, None, None]

    no_rel = dict(testing.TRAIN_STEP_TOL_BF16, update_rel=0.0)
    rows = []
    for seed in range(seeds):
        h, w = cs.TRAIN_SMALL_HW
        f32, train_cfg = cs.train_configs(h, w, steps_per_epoch=1)
        bf16 = dataclasses.replace(f32, compute_dtype="bfloat16")
        state = load_gln_state_dict(cs.reference_gln_checkpoint(seed), f32)
        scenes = synthetic.SyntheticShelfDataset(cs.TRAIN_BATCH, h, w,
                                                 seed=seed + 500)
        b = collate_detection([scenes[i] for i in range(cs.TRAIN_BATCH)])
        batch = (b["images"], b["boxes"], b["box_valid"], b["image_sizes"])

        def step(config):
            return testing.train_step_on_devices(
                config, train_cfg, state, batch, devices=("cpu",))["cpu"]

        ref, want = step(f32), step(bf16)
        layers.Conv2d._reduced = onednn
        try:
            got = step(bf16)
        finally:
            layers.Conv2d._reduced = port_path
        row = {"seed": seed}
        for name, tol in (("with_update_rel", testing.TRAIN_STEP_TOL_BF16),
                          ("without_update_rel", no_rel)):
            res = testing.train_step_bf16_check(state, got, want, ref,
                                                tol=tol)
            row[name] = {"loss": res["loss_rel"] / res["loss_bound"],
                         "worst": res["worst"],
                         "failures": len(res["failures"])}
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=0,
                    help="also measure the card check's spread over this "
                         "many seeds (about 1 s a seed)")
    args = ap.parse_args()
    out = main()
    if args.seeds:
        out["card_spread"] = card_spread(args.seeds)
    print(json.dumps(out, indent=1))
