"""The port's hyperparameter search (train/hyperopt.py) against the JAX
package's: the same seed and observations give the same TPE samples,
ASHA takes the same stop decisions, and a whole search (one worker, and
the multi-host store) runs the same trials to the same result; then one
tiny search driving the port's `train_dihe` through `hyperopt_report`."""
import math
import os
import shutil

import numpy as np
import pytest
import torch

from cvpce_tpu.train import hyperopt as jh
from cvpce_tpu_torch.train import hyperopt as ph


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs several workers on the CPU's
    cores, where these models' many small parallel regions slowed ten
    times with a thread per core each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def space(mod):
    return {"x": mod.Uniform(0.0, 1.0), "lr": mod.LogUniform(1e-6, 1e-2),
            "flag": mod.Choice([True, False]),
            "opt": mod.Choice(["a", "b", "c"])}


def objective(cfg, rng):
    return (1 - abs(cfg["x"] - 0.7)
            - 0.3 * abs(math.log10(cfg["lr"]) + 4) / 4
            + (0.2 if cfg["flag"] else 0.0)
            + (0.1 if cfg["opt"] == "b" else 0.0)
            + 0.01 * rng.normal())


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_samples_equal_jax(seed):
    """30 rounds: each package's sampler, fed the same observations,
    proposes the same configuration (past the 8 random startup draws)."""
    js = jh.TPESampler(space(jh), seed=seed, n_startup=8)
    ps = ph.TPESampler(space(ph), seed=seed, n_startup=8)
    rng = np.random.default_rng(seed)
    obs = []
    for _ in range(30):
        want, got = js.sample(obs), ps.sample(obs)
        assert got == want
        obs.append((got, objective(got, rng)))
    obs.append((obs[0][0], float("nan")))
    assert ps.sample(obs) == js.sample(obs)


def test_domains_and_spaces_equal_jax():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for name in ("DIHE_SPACE", "GLN_SPACE"):
            jspace, pspace = getattr(jh, name), getattr(ph, name)
            assert list(jspace) == list(pspace)
            for key in jspace:
                assert pspace[key].sample(b) == jspace[key].sample(a)


def test_asha_decisions_equal_jax():
    rng = np.random.default_rng(5)
    for rf, grace, max_epochs in ((3, 1, 9), (2, 2, 8), (4, 1, 20)):
        js = jh.ASHA(max_epochs, grace, rf)
        ps = ph.ASHA(max_epochs, grace, rf)
        assert ps.rungs == js.rungs
        jtrials = [jh.Trial(i, {}) for i in range(7)]
        ptrials = [ph.Trial(i, {}) for i in range(7)]
        for _ in range(max_epochs):
            for jt, pt in zip(jtrials, ptrials):
                if jt.stopped:
                    continue
                r = float(rng.uniform())
                jt.results.append(r)
                pt.results.append(r)
                stop = js.should_stop(jt, jtrials)
                assert ps.should_stop(pt, ptrials) == stop
                jt.stopped = pt.stopped = stop


def _run(mod, **kw):
    def train_one_epoch(config, epoch, carry):
        if config["x"] > 0.95:
            raise RuntimeError("exploded loss")
        return 1 - abs(config["x"] - 0.31) + 0.01 * epoch, (carry or 0) + 1

    return mod.run_search(train_one_epoch, {"x": mod.Uniform(0, 1)},
                          num_trials=14, max_epochs=4, seed=2,
                          verbose=False, **kw)


def _trials(result):
    return [(t.trial_id, t.config, t.results, t.failed, t.stopped)
            for t in result["trials"]]


def test_run_search_equals_jax(tmp_path):
    """One worker: the same trials, results, ASHA stops and best; then
    the persisted state resumes to the same result."""
    want = _run(jh, state_path=str(tmp_path / "j.json"))
    got = _run(ph, state_path=str(tmp_path / "p.json"))
    assert _trials(got) == _trials(want)
    assert got["best_config"] == want["best_config"]
    assert got["best_metric"] == want["best_metric"]
    with open(tmp_path / "j.json") as a, open(tmp_path / "p.json") as b:
        assert a.read() == b.read()
    resumed = _run(ph, state_path=str(tmp_path / "p.json"), resume=True)
    assert _trials(resumed)[:14] == _trials(got)


def test_multihost_store_equals_jax(tmp_path):
    def train_one_epoch(config, epoch, carry, device=None):
        return config["x"] - 0.1 * epoch * config["x"], None

    kw = dict(num_trials=6, max_epochs=3, seed=1, verbose=False, host_id=1)
    want = jh.run_search_multihost(train_one_epoch, {"x": jh.Uniform(0, 1)},
                                   str(tmp_path / "j" / "s.json"), **kw)
    got = ph.run_search_multihost(train_one_epoch, {"x": ph.Uniform(0, 1)},
                                  str(tmp_path / "p" / "s.json"), **kw)
    assert _trials(got) == _trials(want)
    store = ph.FileTrialStore(str(tmp_path / "p" / "s.json"))
    assert store.claim(6, lambda trials: {"x": 0.5}) is None
    assert len(store.snapshot()) == 6


def test_trial_dirs_and_device_scope(tmp_path):
    os.makedirs(tmp_path / "trial_002")
    allocate = ph.trial_dir_allocator(str(tmp_path))
    assert [os.path.basename(allocate()) for _ in range(3)] == [
        "trial_001", "trial_003", "trial_004"]
    with ph.device_scope(None):
        pass


@pytest.fixture
def run_dir(tmp_path):
    """The trials' directories (each holds DIHE checkpoints of some 0.3
    GB), removed after the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_search_drives_train_dihe(run_dir):
    """Two trials of the DIHE space over two epochs each, every epoch one
    `train_dihe(epochs=1)` call resumed from the trial's own directory,
    its accuracy taken from `hyperopt_report` (the JAX CLI's wiring,
    cvpce_tpu/cli/dihe.py:337-357)."""
    from cvpce_tpu_torch.train.dihe import DIHETrainConfig
    from cvpce_tpu_torch.train.loops import train_dihe
    from test_torch_train_dihe_loops import (CropSet, GallerySet,
                                             QuerySet)

    data, crops = GallerySet(), CropSet()
    queries = QuerySet(data, n=1)
    new_dir = ph.trial_dir_allocator(str(run_dir))
    steps = []

    def train_one_epoch(config, epoch, carry, device=None):
        cfg = DIHETrainConfig(enc_lr=config["enc_lr"],
                              enc_multiplier=config["enc_multiplier"],
                              batchnorm=config["batchnorm"], gen_downs=4)
        metrics = {}
        carry = carry or new_dir()
        with ph.device_scope(device):
            out = train_dihe(data, crops, data, queries, carry, epochs=1,
                             batch_size=2, train_cfg=cfg, use_mesh=False,
                             hyperopt_report=lambda **kw: metrics.update(kw),
                             resume=epoch > 0, device="cpu")
        steps.append(out["state"].step)
        return metrics["accuracy"], carry

    result = ph.run_search(train_one_epoch, ph.DIHE_SPACE, num_trials=2,
                           max_epochs=2, seed=0, verbose=False)
    assert [len(t.results) for t in result["trials"]] == [2, 2]
    assert steps == [2, 4, 2, 4]
    assert all(0.0 <= r <= 1.0 for t in result["trials"] for r in t.results)
    assert sorted(os.listdir(run_dir)) == ["trial_001", "trial_002"]
    assert result["best_metric"] == max(r for t in result["trials"]
                                        for r in t.results)
