"""The port's width-sharded GLN inference (cvpce_tpu_torch/parallel/
spatial.py) on gloo ranks on the CPU, against the JAX package's
make_spatial_infer on a 2-device CPU mesh for the same flax variables
(tests/test_parallel_e2e.py:199-234 holds that against one device), and
against the port's own one-process forward.

Each group's ranks run in subprocesses (tests/torch_parallel_common.py;
what a rank runs is in tests/torch_parallel_ranks.py) while the test
computes the JAX reference. Tolerances, stated at each check: every
halo site (convolutions, the max-pool, int8 accumulators) on 4 strips
within 1e-6 of the op on the whole tensor in f32, the int8 accumulators
equal; f32 detections as JAX's own test holds them (keep sets equal,
scores within 1e-4, boxes within 1e-2 px), and equal on every rank; the
int8-static bf16 serving preset bit for bit the port's one-process
forward and, against the JAX GLN applied op by op (its f32-widened bias
adds as its jit computes them), at JAX's test bounds (the heatmap within
5e-2 of its largest magnitude)."""
import contextlib
import dataclasses
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLN as JGLN
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.models.gln import fold_gln_backbone as j_fold_gln
from cvpce_tpu.models.gln import postprocess_detections as j_postprocess
from cvpce_tpu.models.quant import calibrate_act_scales as j_cal
from cvpce_tpu.parallel.spatial import make_spatial_infer as j_spatial_infer
from cvpce_tpu.utils.torch_import import import_gln
from cvpce_tpu.parallel.spatial import spatial_mesh as j_spatial_mesh
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.models import layers
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.models.quant import Int8Conv
from cvpce_tpu_torch.ops.conv_fused import int8_conv_nhwc, quantize
from cvpce_tpu_torch.parallel import make_spatial_infer
from cvpce_tpu_torch.parallel import spatial
from cvpce_tpu_torch.parallel.mesh import DataParallelMesh
from cvpce_tpu_torch.parallel.spatial import (pad_strip, strip_mesh,
                                              strip_max, width_sharded)
from cvpce_tpu_torch.utils.weights import gln_state_dict
from torch_parallel_common import start_ranks
from torch_parallel_ranks import halo_site_ops

H = 64
# as tests/test_parallel_e2e.py's spatial test, with the heatmap
CFG = dict(canvas_h=H, max_nms_candidates=128, detections_per_img=64,
           with_gaussians=True)


def fake_mesh(size: int, rank: int = 0) -> DataParallelMesh:
    """A mesh object for the checks that run before any collective."""
    return DataParallelMesh(None, rank, size, torch.device("cpu"))


def scene(width: int, seed: int = 0):
    """Two seeded images on a (H, width) canvas, the second with a
    smaller content size, so the clip differs between them."""
    images = np.random.default_rng(seed).uniform(
        0, 1, (2, H, width, 3)).astype(np.float32)
    sizes = np.array([[H, width], [H - 16, width - 40]], np.float32)
    return images, sizes


@pytest.fixture(scope="module")
def variables():
    """Flax GLN variables from the seeded reference-layout checkpoint of
    tests/test_torch_parallel.py, through the JAX package's importer
    (what its load_gln_variables overlays on an init template; the
    template's structure and shapes are checked here instead). A
    PRNGKey(0) init, as JAX's own spatial test takes, scores every
    anchor at the focal prior 0.01, under score_thresh: no detection is
    valid there."""
    sd = testing.gln_reference_state_dict(np.random.default_rng(5))
    variables = import_gln({k: v.numpy() for k, v in sd.items()})
    template = jax.eval_shape(
        JGLN(config=JGLNConfig(canvas_w=256, **CFG), train=False).init,
        jax.random.PRNGKey(0), jnp.zeros((1, H, 256, 3), jnp.float32))
    assert jax.tree_util.tree_map(np.shape, variables) == \
        jax.tree_util.tree_map(lambda t: t.shape, template)
    return variables


def jax_spatial(variables, cfg: JGLNConfig, images, sizes) -> dict:
    """JAX's make_spatial_infer on a 2-device CPU mesh."""
    run = j_spatial_infer(variables, cfg, j_spatial_mesh(jax.devices()[:2]))
    return {k: np.asarray(v) for k, v in
            jax.device_get(run(images, sizes)).items()}


# the convs whose output the JAX GLN widens to f32 at once
# (tests/test_torch_serving_paths.py:F32_OUT_SITES)
WIDENED = ("cls_logits", "bbox_reg", "block1_conv", "block2_conv",
           "subnet_4")


def widened_bias_adds(next_fun, args, kwargs, context):
    """A flax method interceptor for an op-by-op apply: at the bf16
    convs whose output the JAX GLN widens to f32 at once, the bf16
    convolution with the bf16 bias added in f32, as jitted XLA computes
    it, where op by op the sum is rounded to bf16 first (the port follows
    the jit: models/layers.py:Conv2d `f32_out`)."""
    m = context.module
    if (context.method_name != "__call__" or not isinstance(m, fnn.Conv)
            or m.name not in WIDENED or m.dtype != jnp.bfloat16):
        return next_fun(*args, **kwargs)
    params = m.variables["params"]
    y = jax.lax.conv_general_dilated(
        args[0].astype(m.dtype), params["kernel"].astype(m.dtype), (1, 1),
        m.padding, dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return (y.astype(jnp.float32)
            + params["bias"].astype(m.dtype).astype(jnp.float32))


def assert_detections_close(got, want, score_atol, box_atol):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    keep = want["valid"]
    assert keep.any()
    np.testing.assert_allclose(got["scores"][keep], want["scores"][keep],
                               rtol=0, atol=score_atol)
    np.testing.assert_allclose(got["boxes"][keep], want["boxes"][keep],
                               rtol=0, atol=box_atol)


# ------------------------------------------------------------ halo sites

def test_every_halo_site_on_four_strips_matches_the_whole_tensor():
    """4 ranks, each a 16-column strip of a (2, 8, 12, 64) N(0, 1)
    tensor (negative values, so the max-pool's -inf ends show), against
    the same op on the whole tensor: ranks 1 and 2 take both halos from
    their neighbours, ranks 0 and 3 pad one end."""
    x = np.random.default_rng(3).standard_normal((2, 8, 12, 64)).astype(
        np.float32)
    ranks = start_ranks("halo_sites", 4, x=x)
    with torch.no_grad():
        want = {name: op(torch.from_numpy(x)).numpy()
                for name, op in halo_site_ops().items()}
    got = ranks.results()
    for name, whole in want.items():
        for r, (out, strip) in enumerate(zip(got, np.split(whole, 4, -1))):
            g = out[name]
            assert g.shape == strip.shape, (name, r)
            if whole.dtype == np.int32:
                np.testing.assert_array_equal(g, strip, err_msg=name)
            else:
                np.testing.assert_allclose(g, strip, rtol=0, atol=1e-6,
                                           err_msg=f"{name} rank {r}")


def test_outside_a_width_sharded_block_the_ops_are_unchanged():
    """Without the context, and under a one-rank mesh, every site is the
    unsharded op bit for bit: nn.Conv2d's forward, the bf16 conv with
    its bias added after, F.max_pool2d and the int8 accumulators with
    symmetric padding; pad_strip hands its tensor back."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 10, 12)).astype(
        np.float32))
    torch.manual_seed(1)
    conv = layers.conv(8, 8, 3, 2, bias=True)
    conv16 = layers.conv(8, 8, 3, bias=True).to(torch.bfloat16)
    q = Int8Conv(8, 8, 3, mode="dynamic")
    torch.nn.init.normal_(q.weight)
    a_scale = x.abs().amax() / 127.0
    kq, _ = q.quantized_weight()
    for mesh in (None, fake_mesh(1)):
        with torch.no_grad(), (width_sharded(mesh) if mesh
                               else contextlib.nullcontext()):
            assert strip_mesh() is None
            y, pad = pad_strip(x, 3, 1, 1)
            assert y is x and pad == 1
            assert strip_max(a_scale) is a_scale
            assert torch.equal(conv(x), torch.nn.Conv2d.forward(conv, x))
            x16 = x.to(torch.bfloat16)
            assert torch.equal(conv16(x16), torch.nn.functional.conv2d(
                x16, conv16.weight, None, 1, 1)
                + conv16.bias[None, :, None, None])
            assert torch.equal(layers.max_pool(x, 3, 2, padding=1),
                               torch.nn.functional.max_pool2d(x, 3, 2, 1))
            acc, scale = q.accumulate(x)
            assert torch.equal(scale, a_scale.clamp(min=1e-8))
            want = int8_conv_nhwc(quantize(x.permute(0, 2, 3, 1), a_scale),
                                  kq, 1, 1).permute(0, 3, 1, 2)
            assert torch.equal(acc, want)


def test_halo_exchange_keeps_the_channels_last_layout():
    """The int8 convolutions return channels-last tensors, and a CPU
    convolution picks its kernel, and so its order of summation, by its
    input's layout: a bf16 conv of a channels-last (2, 256, 16, 64)
    tensor on two strips gives the whole tensor's columns bit for bit
    only because the halo exchange hands the strip back channels-last
    (103 entries one bf16 step apart on an AMD EPYC host when the
    exchange returned it contiguous)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 256, 16, 64)).astype(
        np.float32)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    torch.manual_seed(2)
    conv16 = layers.conv(256, 128, 3, bias=True).to(torch.bfloat16)
    strips = x.tensor_split(2, -1)
    # a 3x3 conv of stride 1 takes one column from each neighbour
    edges = [torch.cat([s[..., :1], s[..., -1:]], -1) for s in strips]
    with torch.no_grad():
        whole = conv16(x)
        for r, strip in enumerate(strips):
            with width_sharded(fake_mesh(2, r)), mock.patch.object(
                    spatial, "all_gather", lambda t, mesh: edges):
                padded, _ = pad_strip(strip, 3, 1, 1)
                assert padded.is_contiguous(
                    memory_format=torch.channels_last)
                got = conv16(strip)
            assert torch.equal(got, whole.tensor_split(2, -1)[r]), r


# --------------------------------------------------- make_spatial_infer

@pytest.mark.parametrize("n_ranks,width", [(2, 256), (4, 512)])
def test_spatial_infer_matches_jax(variables, n_ranks, width):
    """f32, 2 ranks at 64x256 and 4 at 64x512, against JAX's
    make_spatial_infer on a 2-device mesh and the port's one-process
    forward: keep sets equal, scores within 1e-4 and boxes within 1e-2
    px of JAX (its own test's bounds; measured 6.6e-7 and 1.5e-4 px),
    the heatmap within 1e-5 (measured 1.2e-6); within 1e-5, 1e-3 px and
    1e-5 of the one-process forward (measured 8.9e-7, 4.6e-4 px,
    1.6e-6: the strips' f32 convolutions sum in another order); equal on
    every rank."""
    cfg_kw = dict(CFG, canvas_w=width)
    images, sizes = scene(width)
    ranks = start_ranks("spatial_infer", n_ranks,
                        state_dict=gln_state_dict(variables),
                        config_kw=cfg_kw, images=images, sizes=sizes)
    want = jax_spatial(variables, JGLNConfig(**cfg_kw), images, sizes)
    got = ranks.results()
    first = got[0]["spatial"]
    for out in got:
        assert out["spatial"].keys() == first.keys()
        for key, v in out["spatial"].items():
            np.testing.assert_array_equal(v, first[key], err_msg=key)
    assert first["boxes"].shape == (2, 64, 4)
    assert first["gaussians"].shape == (2, H // 2, width // 2, 1)
    assert_detections_close(first, want, 1e-4, 1e-2)
    np.testing.assert_allclose(first["gaussians"], want["gaussians"],
                               rtol=0, atol=1e-5)
    single = got[0]["single"]
    assert_detections_close(first, single, 1e-5, 1e-3)
    np.testing.assert_allclose(first["gaussians"], single["gaussians"],
                               rtol=0, atol=1e-5)
    # make_spatial_forward's gathered outputs, the same on every rank,
    # within 5e-5 of each output's largest magnitude of the one-process
    # forward's (measured up to 7.4e-6: f32 sums in another order)
    for out in got:
        for key, v in out["outputs"].items():
            np.testing.assert_array_equal(v, got[0]["outputs"][key])
    for key, v in got[0]["single_outputs"].items():
        g = got[0]["outputs"][key]
        assert g.shape == v.shape
        np.testing.assert_allclose(g, v, rtol=0,
                                   atol=5e-5 * np.abs(v).max(), err_msg=key)


def test_spatial_infer_int8_static_bf16_matches_jax(variables):
    """GLN(int8='static', compute_dtype='bfloat16', fold_backbone_fbn=
    True), the serving preset, on 2 ranks at 64x256 with act scales
    calibrated by the JAX package on the unfolded f32 GLN: equal on
    every rank and bit for bit the port's one-process forward (int8
    accumulators are exact, and the bf16 convolutions of a strip give
    the whole canvas's columns here). Against the JAX GLN's apply and
    postprocess op by op, as ROADMAP Queue 3 measures this config, with
    the bias adds of the convs whose result the GLN widens at once kept
    in f32 as its jit keeps them (`widened_bias_adds`; op by op they
    round the sum, and one detection of 123 then falls out): keep sets
    equal, scores within 1e-4 and boxes within 1e-2 px (measured 0.0 and
    1.5e-5), the heatmap within 5e-2 of its largest magnitude (measured
    2.7e-2; the Gaussian branch's BatchNorm in another order).
    JAX's make_spatial_infer is a jit, and XLA's fusion moves this
    config's int8 rounding: its 2-device run equals its 1-device jit bit
    for bit, but both sit 9.2e-2 of the largest logit off the op-by-op
    apply, with 112 detections kept against 122 (Queue 3)."""
    images, sizes = scene(256, seed=1)
    base = JGLNConfig(canvas_w=256, **CFG)
    scales = jax.device_get(j_cal(
        JGLN(config=dataclasses.replace(base, int8="calibrate")),
        variables, [images]))["act_scales"]
    cfg_kw = dict(CFG, canvas_w=256, int8="static",
                  compute_dtype="bfloat16", fold_backbone_fbn=True)
    folded = jax.device_get(j_fold_gln(variables))
    ranks = start_ranks("spatial_infer", 2,
                        state_dict=gln_state_dict(folded),
                        config_kw=cfg_kw, images=images, sizes=sizes,
                        act_scales=scales)
    jcfg = JGLNConfig(**cfg_kw)
    anchors, counts = jcfg.anchors()
    with fnn.intercept_methods(widened_bias_adds):
        outputs = JGLN(config=jcfg, train=False).apply(
            {**folded, "act_scales": scales}, jnp.asarray(images))
    want = jax.device_get(j_postprocess(
        outputs, jnp.asarray(anchors), counts, jnp.asarray(sizes), jcfg))
    got = ranks.results()
    first = got[0]["spatial"]
    for out in got[1:] + [{"spatial": got[0]["single"]}]:
        assert out["spatial"].keys() == first.keys()
        for key, v in out["spatial"].items():
            np.testing.assert_array_equal(v, first[key], err_msg=key)
    for key, v in got[0]["single_outputs"].items():
        np.testing.assert_array_equal(got[0]["outputs"][key], v,
                                      err_msg=key)
    assert_detections_close(first, want, 1e-4, 1e-2)
    np.testing.assert_allclose(
        first["gaussians"], want["gaussians"], rtol=0,
        atol=5e-2 * np.abs(want["gaussians"]).max())


def test_spatial_infer_on_one_rank_is_the_one_process_forward(variables):
    """A one-rank gloo group: no halo, one gather of one strip; the
    detections and heatmap equal the one-process forward bit for bit."""
    cfg_kw = dict(CFG, canvas_w=128)
    images, sizes = scene(128, seed=2)
    out, = start_ranks("spatial_infer", 1,
                       state_dict=gln_state_dict(variables),
                       config_kw=cfg_kw, images=images, sizes=sizes
                       ).results()
    assert out["spatial"].keys() == out["single"].keys()
    for key, v in out["spatial"].items():
        np.testing.assert_array_equal(v, out["single"][key], err_msg=key)
    assert out["outputs"].keys() == out["single_outputs"].keys()
    for key, v in out["outputs"].items():
        np.testing.assert_array_equal(v, out["single_outputs"][key],
                                      err_msg=key)


@pytest.mark.parametrize("width,size", [(192, 2), (320, 2), (256, 4),
                                        (640, 4)])
def test_width_that_is_not_a_multiple_of_128_per_rank_is_refused(
        variables, width, size):
    """JAX's docstring rule (cvpce_tpu/parallel/spatial.py:33-36). JAX
    itself pads such a width and returns the unsharded result (192 and
    320 on 2 devices: scores 0.0 and boxes 7.6e-6 px apart); the port
    refuses it (ROADMAP Queue 3, by design)."""
    with pytest.raises(ValueError, match="multiple of 128"):
        make_spatial_infer(gln_state_dict(variables),
                           GLNConfig(canvas_w=width, **CFG), fake_mesh(size))


def test_calibrate_other_axes_and_static_without_scales_are_refused(
        variables):
    """int8='calibrate' as JAX refuses it (its immutable apply raises
    flax's ModifyScopeVariableError); an axis but the width; and an
    int8='static' config from a bare state_dict, which holds no act
    scales."""
    sd = gln_state_dict(variables)
    mesh = fake_mesh(2)
    cfg = GLNConfig(canvas_w=256, **CFG)
    with pytest.raises(ValueError, match="calibrate"):
        make_spatial_infer(sd, dataclasses.replace(cfg, int8="calibrate"),
                           mesh)
    with pytest.raises(ValueError, match="width only"):
        make_spatial_infer(sd, cfg, mesh, axis="height")
    with pytest.raises(ValueError, match="act scales"):
        make_spatial_infer(sd, dataclasses.replace(cfg, int8="static"), mesh)
