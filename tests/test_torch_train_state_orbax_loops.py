"""train_proposal_generator runs that move between the packages: the
port's run directories hold the JAX package's orbax train-state nodes
(cvpce_tpu_torch/train/checkpoint.py), so

- a run the JAX package trained for an epoch, resumed by the port for
  a second, equals the JAX package's own resume of it;
- a run the port trained for an epoch, resumed by the JAX package,
  equals the port's own resume of it;

each as tests/test_torch_train_gln.py:test_training_loop_matches_jax
holds the two loops: the epoch's losses within 1e-5 relative, and the
`checkpoint` and `epoch_1` meta sidecars (`iteration`, `epoch_step`,
`best` with its AP) equal (the port's older `torch.save` run
directories: tests/test_torch_train_state_orbax_legacy.py)."""
import json
import os

import numpy as np

from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.train import gln as jtrain
from cvpce_tpu.train.loops import train_proposal_generator as jloop
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.train import gln as ptrain
from cvpce_tpu_torch.train import loops
from cvpce_tpu_torch.utils import orbax_read
from test_torch_train_gln import (LOOP_CFG, LOOP_TRAIN, DetectionSet,
                                  _losses, reference_checkpoint, run_dir)
from torch_train_state_common import copy_run

COMMON = dict(batch_size=1, epochs=1, checkpoint_interval=100,
              eval_interval=1, eval_threshold=0.5, use_mesh=False)


def jax_run(out, **kw):
    return jloop(DetectionSet(), DetectionSet(), str(out),
                 model_cfg=JGLNConfig(**LOOP_CFG),
                 train_cfg=jtrain.GLNTrainConfig(**LOOP_TRAIN),
                 **COMMON, **kw)


def port_run(out, **kw):
    return loops.train_proposal_generator(
        DetectionSet(), DetectionSet(), str(out),
        model_cfg=GLNConfig(**LOOP_CFG),
        train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN), device="cpu",
        **COMMON, **kw)


def metas(out):
    out_meta = {}
    for name in ("checkpoint", "epoch_1"):
        with open(os.path.join(out, name + ".meta.json")) as f:
            out_meta[name] = json.load(f)
    return out_meta


def assert_same_resume(got, want):
    """Two resumed epochs (run directories) alike: losses within 1e-5
    relative, the meta sidecars equal."""
    for g, w in zip(_losses(got, 1), _losses(want, 1)):
        assert len(g) == len(w) == 3
        np.testing.assert_allclose(g, w, rtol=1e-5)
    got_meta, want_meta = metas(got), metas(want)
    assert got_meta == want_meta
    assert want_meta["checkpoint"]["iteration"] == 5
    assert want_meta["checkpoint"]["epoch_step"] == 2
    assert want_meta["epoch_1"]["epoch"] == 1
    assert want_meta["epoch_1"]["best"]["ap"] > 0


def test_jax_run_resumes_in_the_port(run_dir, reference_checkpoint):
    first = run_dir / "jax_first"
    jax_run(first, load_torch=reference_checkpoint)
    assert orbax_read.is_checkpoint(str(first / "checkpoint"))
    mine, theirs = run_dir / "port", run_dir / "jax"
    copy_run(first, mine)
    copy_run(first, theirs)
    got = port_run(mine, resume=True)
    want = jax_run(theirs, resume=True)
    assert got["state"].step == int(want["state"].step) == 6
    assert_same_resume(mine, theirs)


def test_port_run_resumes_in_jax(run_dir, reference_checkpoint):
    first = run_dir / "port_first"
    port_run(first, load_torch=reference_checkpoint)
    mine, theirs = run_dir / "port", run_dir / "jax"
    copy_run(first, mine)
    copy_run(first, theirs)
    got = jax_run(theirs, resume=True)
    want = port_run(mine, resume=True)
    assert int(got["state"].step) == want["state"].step == 6
    assert_same_resume(theirs, mine)
