"""The port's run directories of `torch.save` nodes (PRs 9-24, before
the nodes became orbax train states, cvpce_tpu_torch/train/checkpoint.py)
still resume and load: a run whose `checkpoint` and `epoch_0` are
`torch.save` files resumes bit for bit as the same run of orbax nodes
does, its next save rotates the file aside, and both `epoch_0` layouts
load through the loader of `gln eval --weights`, every tensor bit for
bit."""
import shutil

import torch

from cvpce_tpu_torch.cli.common import load_gln_state_dict
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.train import gln as ptrain
from cvpce_tpu_torch.train import loops
from cvpce_tpu_torch.utils import orbax_read
from test_torch_train_gln import (LOOP_CFG, LOOP_TRAIN, DetectionSet,
                                  _assert_same_state, _losses,
                                  one_thread,  # noqa: F401
                                  reference_checkpoint, run_dir)
from torch_train_state_common import copy_run


def port_run(out, **kw):
    """tests/test_torch_train_state_orbax_loops.py's run: 3 steps an
    epoch at batch 1, an interval save every 2 steps, an epoch eval."""
    return loops.train_proposal_generator(
        DetectionSet(), DetectionSet(), str(out),
        model_cfg=GLNConfig(**LOOP_CFG),
        train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN), batch_size=1,
        epochs=1, checkpoint_interval=2, eval_interval=1,
        eval_threshold=0.5, use_mesh=False, device="cpu", **kw)


def _as_torch_save(run, state) -> None:
    """The run directory as the port wrote it before: `checkpoint` and
    `epoch_0` single `torch.save` files of the state's state_dict."""
    for name in ("checkpoint", "epoch_0"):
        shutil.rmtree(run / name)
        torch.save(state.state_dict(), run / name)
    shutil.rmtree(run / "previous_checkpoint")


def test_torch_save_run_directory_still_resumes(run_dir,
                                                reference_checkpoint,
                                                one_thread):  # noqa: F811
    """A run of torch.save nodes resumes as the same run of orbax nodes
    does, bit for bit; its next save rotates the file aside and writes
    an orbax node. The two `epoch_0` layouts load alike through the
    loader of `gln eval --weights`."""
    orbax_run, old = run_dir / "orbax", run_dir / "old"
    first = port_run(orbax_run, load_torch=reference_checkpoint)
    copy_run(orbax_run, old)
    _as_torch_save(old, first["state"])
    cfg = GLNConfig(**LOOP_CFG)
    want_sd = first["state"].model.state_dict()
    for weights in (orbax_run / "epoch_0", old / "epoch_0"):
        got_sd = load_gln_state_dict(str(weights), cfg)
        assert got_sd.keys() == want_sd.keys()
        for key, v in want_sd.items():
            assert torch.equal(got_sd[key], v), (weights, key)
    want = port_run(orbax_run, resume=True)
    got = port_run(old, resume=True)
    _assert_same_state(want["state"], got["state"])
    assert _losses(old, 1) == _losses(orbax_run, 1)
    # the interval save at iteration 4 rotated the file aside, the
    # epoch's end the orbax node that replaced it
    for name in ("checkpoint", "previous_checkpoint"):
        assert orbax_read.is_checkpoint(str(old / name)), name
