"""The port's training loops on 2 gloo ranks on the CPU
(`use_mesh=True`, batch_size 2: one image or sample a rank) against the
JAX package's one-process loop on the same global batches, mirroring
tests/test_multihost.py:191,316: with one item a rank, rank r's loader
shard gives the r-th item of each global batch, so the two see the same
batches, and the DIHE loop's ranks draw their slices of the
one-process discriminator batch.

- train_proposal_generator: 1 epoch of 2 steps with an epoch eval, then
  a `resume=True` run of 1 more, against JAX's 2-epoch run from the same
  reference-layout checkpoint: the loss series within 1e-5 relative
  (tests/test_torch_train_gln.py's loop bound), the metas (but for the
  resumed rotating checkpoint's pre-eval `best`) and the keeper's AP
  equal, rank 0's file set JAX's (its sample pictures included),
  rank 1's directory empty (rank 0 alone writes; rank 1 resumes from
  what rank 0 broadcasts);
- train_dihe: 1 epoch of 2 steps and its eval from JAX's PRNGKey(0)
  weights, held as tests/test_torch_train_dihe_loops.py holds the
  one-process loop: per-player parameters and first moments in L2
  within 1e-1, running statistics within 1e-3, top-1 within one of the
  8 queries, the files and metas JAX's.

Both ranks end bit for bit alike (a sha256 of their state)."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.train import dihe as jdihe
from cvpce_tpu.train import gln as jtrain
from cvpce_tpu.train import loops as jloops
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.utils.weights import gan_state_dict, macvgg_state_dict
from test_torch_train_dihe_loops import (GEN_DOWNS, CropSet, GallerySet,
                                         QuerySet, adam_mu, hold_player,
                                         jax_init_weights)
from test_torch_train_gln import LOOP_CFG, LOOP_TRAIN, DetectionSet
from torch_parallel_common import start_ranks


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this process; each rank runs on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def run_dir(tmp_path):
    """The JAX run's directory (0.3 GB a GLN checkpoint), removed after
    the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _json(files, name):
    return json.loads(files[name])


def test_gln_loop_on_two_ranks_matches_jax(run_dir):
    ref = str(run_dir / "gln_reference.pth")
    torch.save({"model_state_dict": testing.gln_reference_state_dict(
        np.random.default_rng(5))}, ref)
    data, evalset = DetectionSet(n=4), DetectionSet(n=2)
    loop_kw = dict(batch_size=2, checkpoint_interval=2, eval_interval=1,
                   eval_threshold=0.5, load_torch=ref)
    ranks = start_ranks("gln_loop", dataset=data, evalset=evalset,
                        config_kw=LOOP_CFG, train_kw=LOOP_TRAIN,
                        loop_kw=loop_kw)
    jout = str(run_dir / "jax")
    want = jloops.train_proposal_generator(
        data, evalset, jout, model_cfg=JGLNConfig(**LOOP_CFG),
        train_cfg=jtrain.GLNTrainConfig(**LOOP_TRAIN), epochs=2,
        use_mesh=False, **loop_kw)
    # the sample pictures too: rank 0 draws them as JAX's loop does
    jfiles = {name: open(os.path.join(jout, name)).read()
              if name.endswith(".json") else None
              for name in os.listdir(jout)}
    got = ranks.results()

    rank0, rank1 = got
    assert rank0["first"] == rank1["first"] and rank0["first"][0] == 2
    assert rank0["resumed"] == rank1["resumed"]
    assert rank0["resumed"][0] == int(want["state"].step) == 4
    assert rank0["resumed"][1] == want["best"] and want["best"]["ap"] > 0
    assert rank1["files"] == rank1["files_after"] == {}
    files = rank0["files_after"]
    assert set(files) == set(jfiles)
    for name in ("epoch_0.meta.json", "epoch_1.meta.json"):
        assert _json(files, name) == _json(jfiles, name), name
    # a rotating checkpoint's `best` is the keeper's before that epoch's
    # eval, so a run resumed from epoch 0's carries the one from before
    # it, in both packages; the position is the uninterrupted run's
    got_meta = _json(files, "checkpoint.meta.json")
    want_meta = _json(jfiles, "checkpoint.meta.json")
    assert got_meta.pop("best") == {"epoch": -1, "ap": 0.0}
    want_meta.pop("best")
    assert got_meta == want_meta
    jstats = _json(jfiles, "stats_1.json")
    series = [_json(files, "stats_0.json"), _json(files, "stats_1.json")]
    for key in ("class_loss", "reg_loss", "gauss_loss"):
        np.testing.assert_allclose(series[0][key] + series[1][key],
                                   jstats[key], rtol=1e-5, err_msg=key)


def test_dihe_loop_on_two_ranks_matches_jax(run_dir):
    data, crops = GallerySet(), CropSet()
    queries = QuerySet(data)
    init_w = jax_init_weights()
    before = {"embedder": macvgg_state_dict(init_w.emb_params,
                                            init_w.emb_stats),
              "generator": gan_state_dict(init_w.gen_params,
                                          init_w.gen_stats),
              "discriminator": gan_state_dict(init_w.disc_params,
                                              init_w.disc_stats)}
    loop_kw = dict(epochs=1, batch_size=2, checkpoint_interval=1)
    ranks = start_ranks("dihe_loop", dataset=data, discriminatorset=crops,
                        evaldata=data, evalset=queries, before=before,
                        cfg_kw=dict(gen_downs=GEN_DOWNS), loop_kw=loop_kw)
    jreports = []
    jout = str(run_dir / "jax")
    want = jloops.train_dihe(
        data, crops, data, queries, jout,
        train_cfg=jdihe.DIHETrainConfig(gen_downs=GEN_DOWNS),
        gan_state={k: getattr(init_w, k) for k in (
            "gen_params", "gen_stats", "disc_params", "disc_stats")},
        init_embedder={"params": init_w.emb_params,
                       "batch_stats": init_w.emb_stats},
        hyperopt_report=lambda **kw: jreports.append(kw), use_mesh=False,
        **loop_kw)
    jstate = jax.device_get(want["state"])
    jfiles = {name: open(os.path.join(jout, name)).read()
              if name.endswith(".json") else None
              for name in os.listdir(jout) if not name.endswith(".png")}
    got = ranks.results()

    rank0, rank1 = got
    assert rank0["digest"] == rank1["digest"]
    assert rank0["reports"] == rank1["reports"]
    assert rank0["step"] == int(jstate.step) == 2
    assert rank1["files"] == {}
    assert rank0["files"] == jfiles
    bridges = {"embedder": (lambda t: macvgg_state_dict(t, {}), "emb"),
               "generator": (lambda t: gan_state_dict(t, {}), "gen"),
               "discriminator": (lambda t: gan_state_dict(t, {}), "disc")}
    for name, (bridge, short) in bridges.items():
        sd, mu = rank0["players"][name]
        want_sd = (macvgg_state_dict if name == "embedder"
                   else gan_state_dict)(getattr(jstate, f"{short}_params"),
                                        getattr(jstate, f"{short}_stats"))
        hold_player(before[name], sd, want_sd, mu,
                    adam_mu(getattr(jstate, f"{short}_opt"), bridge))
    assert len(jreports) == len(rank0["reports"]) == 1
    assert abs(jreports[0]["accuracy"]
               - rank0["reports"][0]["accuracy"]) <= 1 / 8
    assert rank0["best"]["epoch"] == want["best"]["epoch"] == 0
