"""Hyperparameter search: TPE sampling + ASHA early stopping, trials
running concurrently one per device; counterpart of
cvpce_tpu/train/hyperopt.py (host numpy and threads, its own copy).

Re-design of the reference's Ray Tune usage (cvpce/hyperopt.py,
cvpce/cli/gln.py:135-228, cvpce/cli/dihe.py:169-255: HyperOptSearch (TPE)
+ ASHAScheduler, one GPU per trial, max_failures=2 for exploding-gradient
trials) without the Ray dependency:

- `TPESampler`: the tree-structured Parzen estimator rule HyperOptSearch
  implements — split observations into good/bad by metric quantile, model
  each dimension's good and bad densities (Gaussian mixtures over observed
  points for continuous domains, smoothed counts for categorical), draw
  candidates from the good density and keep the argmax of l(x)/g(x).
  Its draws come from numpy generators, so the same seed and the same
  observations give the JAX package's samples.
- `run_search(..., devices=[...])`: a thread pool with one worker per
  device (`torch.device`s); each trial's `train_one_epoch` receives its
  assigned device and runs its training there (`device_scope`, or
  `device=` to the loops). CUDA work releases the GIL, so per-card
  trials overlap — Ray's one-GPU-per-trial placement.
- ASHA promotion is asynchronous by construction: stop decisions use
  whatever peers have reached the rung so far.

Search spaces from the reference:
- GLN (cli/gln.py:171-200): tanh, lr multiplier, scale_class,
  scale_gaussian, gauss_loss_neg_thresh, gauss_loss_pos_thresh
- DIHE (cli/dihe.py:224-228): batchnorm, enc_multiplier, enc_lr
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class Domain:
    def sample(self, rng) -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


@dataclasses.dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(math.log(self.low),
                                        math.log(self.high))))


@dataclasses.dataclass
class Choice(Domain):
    options: Sequence

    def sample(self, rng):
        return self.options[int(rng.integers(len(self.options)))]


# reference search spaces
GLN_SPACE: Dict[str, Domain] = {
    "tanh": Choice([True, False]),
    "multiplier": Uniform(0.98, 1.0),
    "scale_class": LogUniform(0.1, 10.0),
    "scale_gaussian": LogUniform(0.1, 10.0),
    "gauss_loss_neg_thresh": Uniform(0.0, 0.5),
    "gauss_loss_pos_thresh": Uniform(0.1, 1.0),
}

DIHE_SPACE: Dict[str, Domain] = {
    "batchnorm": Choice([True, False]),
    "enc_multiplier": Uniform(0.9, 1.0),
    "enc_lr": LogUniform(1e-8, 1e-5),
}


@dataclasses.dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    results: List[float] = dataclasses.field(default_factory=list)
    failed: bool = False
    stopped: bool = False

    @property
    def best(self) -> float:
        return max(self.results) if self.results else float("-inf")


class ASHA:
    """Asynchronous Successive Halving promotion rule."""

    def __init__(self, max_epochs: int = 9, grace_period: int = 1,
                 reduction_factor: int = 3):
        self.max_epochs = max_epochs
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs = []
        r = grace_period
        while r < max_epochs:
            self.rungs.append(r)
            r *= reduction_factor

    def should_stop(self, trial: Trial, all_trials: List[Trial]) -> bool:
        epoch = len(trial.results)
        if epoch >= self.max_epochs:
            return True
        if epoch not in self.rungs:
            return False
        # among trials that reached this rung, keep the top 1/rf
        peers = [t.results[epoch - 1] for t in all_trials
                 if len(t.results) >= epoch and not t.failed]
        if len(peers) < self.rf:
            return False
        cutoff = np.quantile(peers, 1.0 - 1.0 / self.rf)
        return trial.results[epoch - 1] < cutoff


class TPESampler:
    """Tree-structured Parzen estimator over an independent per-dimension
    space (the rule behind HyperOptSearch, cvpce/cli/gln.py:205-207).

    Until `n_startup` observations exist, samples randomly. After that:
    observations are split at the `gamma` metric quantile; each dimension
    gets a good density l(x) and a bad density g(x) (Gaussian mixtures over
    observed points blended with a uniform prior; smoothed counts for
    Choice); `n_candidates` draws from l(x) are scored by l(x)/g(x) and the
    argmax wins.
    """

    def __init__(self, space: Dict[str, Domain], seed: int = 0,
                 n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates

    # -- continuous helpers ------------------------------------------------
    @staticmethod
    def _bounds(dom: Domain):
        if isinstance(dom, LogUniform):
            return math.log(dom.low), math.log(dom.high), True
        return dom.low, dom.high, False

    def _mixture_logpdf(self, z, points, lo, hi):
        """log pdf of (uniform prior + gaussians at points), all weighted
        equally — hyperopt's adaptive-Parzen shape, simplified."""
        span = hi - lo
        sigma = max(span / max(len(points), 1) , 1e-3 * span)
        comps = [np.full_like(z, -math.log(span))]  # uniform prior
        for p in points:
            comps.append(-0.5 * ((z - p) / sigma) ** 2
                         - math.log(sigma * math.sqrt(2 * math.pi)))
        stacked = np.stack(comps)
        m = stacked.max(axis=0)
        return m + np.log(np.exp(stacked - m).mean(axis=0))

    def _sample_continuous(self, dom, good_z, bad_z):
        lo, hi, is_log = self._bounds(dom)
        span = hi - lo
        sigma = max(span / max(len(good_z), 1), 1e-3 * span)
        # candidate draws from the good mixture (incl. the uniform prior)
        idx = self.rng.integers(-1, len(good_z), self.n_candidates)
        cands = np.where(
            idx < 0,
            self.rng.uniform(lo, hi, self.n_candidates),
            np.asarray([good_z[i] if i >= 0 else 0.0 for i in idx])
            + self.rng.normal(0, sigma, self.n_candidates))
        cands = np.clip(cands, lo, hi)
        score = (self._mixture_logpdf(cands, good_z, lo, hi)
                 - self._mixture_logpdf(cands, bad_z, lo, hi))
        z = float(cands[int(np.argmax(score))])
        return float(np.exp(z)) if is_log else z

    def _sample_choice(self, dom: Choice, good_vals, bad_vals):
        opts = list(dom.options)

        def probs(vals):
            counts = np.array([1.0 + sum(1 for v in vals if v == o)
                               for o in opts])
            return counts / counts.sum()
        pg, pb = probs(good_vals), probs(bad_vals)
        cand_idx = self.rng.choice(len(opts), self.n_candidates, p=pg)
        ratios = pg[cand_idx] / pb[cand_idx]
        return opts[int(cand_idx[int(np.argmax(ratios))])]

    def sample(self, observations: List[tuple]) -> Dict[str, Any]:
        """observations: [(config, metric)] for every trial with >=1 result."""
        obs = [(c, m) for c, m in observations if np.isfinite(m)]
        if len(obs) < self.n_startup:
            return {k: d.sample(self.rng) for k, d in self.space.items()}
        metrics = np.asarray([m for _, m in obs])
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        order = np.argsort(-metrics)
        good = [obs[i][0] for i in order[:n_good]]
        bad = [obs[i][0] for i in order[n_good:]] or good
        out = {}
        for k, dom in self.space.items():
            gv = [c[k] for c in good]
            bv = [c[k] for c in bad]
            if isinstance(dom, Choice):
                out[k] = self._sample_choice(dom, gv, bv)
            else:
                _, _, is_log = self._bounds(dom)
                gz = [math.log(v) if is_log else v for v in gv]
                bz = [math.log(v) if is_log else v for v in bv]
                out[k] = self._sample_continuous(dom, gz, bz)
        return out


def run_search(
    train_one_epoch: Callable[..., tuple],
    space: Dict[str, Domain],
    num_trials: int = 16,
    max_epochs: int = 9,
    grace_period: int = 1,
    reduction_factor: int = 3,
    max_failures: int = 2,
    seed: int = 0,
    verbose: bool = True,
    sampler: str = "tpe",
    devices: Optional[Sequence] = None,
    state_path: Optional[str] = None,
    resume: bool = False,
) -> Dict:
    """Run the search, one concurrent trial per device.

    Args:
      train_one_epoch: (config, epoch, carry) -> (metric, carry), or
        (config, epoch, carry, device) -> (metric, carry) to receive the
        trial's assigned device (detected by signature). `carry` holds live
        training state between epochs of the same trial (None on epoch 0).
        Raise to signal a failed trial (e.g. exploded loss,
        proposals_training.py:238-242).
      sampler: 'tpe' (HyperOptSearch-equivalent) or 'random'.
      devices: devices to parallelize over (e.g. one torch.device per
        card); one worker thread per device. None -> a single worker,
        no device pin.
      state_path: persist search state (every trial's config + per-epoch
        metrics) to this JSON after every result — the Ray Tune
        experiment-state analogue (cvpce/cli/gln.py:212-213 --load /
        --load-algo).
      resume: restore `state_path` first. Finished trials keep their
        results (and feed the TPE densities); trials interrupted
        mid-flight are retained as stopped (their live training state is
        gone). `num_trials` is the TOTAL budget including restored
        trials.

    Returns dict with 'best_config', 'best_metric', 'trials'.
    """
    import json
    import os

    scheduler = ASHA(max_epochs, grace_period, reduction_factor)
    trials: List[Trial] = []
    lock = threading.Lock()
    next_id = [0]
    if resume and state_path and os.path.exists(state_path):
        with open(state_path) as f:
            saved = json.load(f)
        for t in saved["trials"]:
            tr = Trial(t["trial_id"], t["config"], list(t["results"]),
                       t["failed"], t["stopped"])
            if not tr.failed and not tr.stopped \
                    and len(tr.results) < max_epochs:
                tr.stopped = True  # interrupted; results kept, not re-run
            trials.append(tr)
        next_id[0] = max((t.trial_id for t in trials), default=-1) + 1
        if verbose:
            print(f"resumed {len(trials)} trials from {state_path}")
    # offset the seed by restored trials so resumed startup sampling
    # doesn't replay the same random configs
    rng = np.random.default_rng(seed + next_id[0])
    tpe = TPESampler(space, seed=seed + next_id[0]) \
        if sampler == "tpe" else None
    wants_device = "device" in inspect.signature(train_one_epoch).parameters

    def save_state() -> None:
        # caller holds `lock`
        if not state_path:
            return
        payload = {"trials": [dataclasses.asdict(t) for t in trials]}
        tmp = state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, state_path)

    def sample_config():
        if tpe is None:
            return {k: d.sample(rng) for k, d in space.items()}
        observations = [(t.config, t.best) for t in trials
                        if t.results and not t.failed]
        return tpe.sample(observations)

    def run_trial(trial: Trial, device) -> None:
        carry = None
        failures = 0
        epoch = 0
        while epoch < max_epochs:
            try:
                if wants_device:
                    metric, carry = train_one_epoch(trial.config, epoch,
                                                    carry, device=device)
                else:
                    metric, carry = train_one_epoch(trial.config, epoch,
                                                    carry)
            except Exception as e:  # noqa: BLE001 — trial-level tolerance
                failures += 1
                if verbose:
                    print(f"[trial {trial.trial_id}] failure "
                          f"{failures}: {e}")
                if failures > max_failures:
                    with lock:
                        trial.failed = True
                        save_state()
                    break
                continue
            with lock:
                trial.results.append(float(metric))
                stop = scheduler.should_stop(trial, trials)
                if stop:
                    trial.stopped = True
                save_state()
            if verbose:
                print(f"[trial {trial.trial_id}] epoch {epoch}: "
                      f"{metric:.4f} config={trial.config}")
            if stop:
                break
            epoch += 1

    def worker(device) -> None:
        while True:
            with lock:
                if next_id[0] >= num_trials:
                    return
                tid = next_id[0]
                next_id[0] += 1
                trial = Trial(tid, sample_config())
                trials.append(trial)
            run_trial(trial, device)

    if devices is not None and len(devices) > 1:
        threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                   for d in devices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        worker(devices[0] if devices else None)

    ok = [t for t in trials if not t.failed and t.results]
    best = max(ok, key=lambda t: t.best) if ok else None
    return {
        "best_config": best.config if best else None,
        "best_metric": best.best if best else None,
        "trials": trials,
    }


class FileTrialStore:
    """flock-backed shared trial store for multi-host searches.

    The reference's Ray Tune head-node state, re-done as a file on a
    filesystem shared by the participating hosts (the standard cluster
    NFS layout): every claim/report takes an exclusive `fcntl.flock` on
    `<path>.lock`, reloads the JSON state, mutates, and atomically
    replaces it — so hosts coordinate with no server process. Trial ids
    are allocated under the lock (no duplicates); TPE sampling inside a
    claim sees every host's finished epochs.
    """

    def __init__(self, path: str):
        import os

        self.path = path
        self.lock_path = path + ".lock"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _load(self) -> List[Trial]:
        import json
        import os

        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            saved = json.load(f)
        return [Trial(t["trial_id"], t["config"], list(t["results"]),
                      t["failed"], t["stopped"]) for t in saved["trials"]]

    def _save(self, trials: List[Trial]) -> None:
        import json
        import os

        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"trials": [dataclasses.asdict(t) for t in trials]},
                      f)
        os.replace(tmp, self.path)

    def _locked(self):
        import fcntl
        from contextlib import contextmanager

        @contextmanager
        def cm():
            with open(self.lock_path, "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)

        return cm()

    def claim(self, num_trials: int,
              sample_config: Callable[[List[Trial]], Dict[str, Any]]
              ) -> Optional[Trial]:
        """Atomically allocate the next trial, or None if budget spent."""
        with self._locked():
            trials = self._load()
            if len(trials) >= num_trials:
                return None
            trial = Trial(len(trials), sample_config(trials))
            trials.append(trial)
            self._save(trials)
            return trial

    def report(self, trial_id: int, metric: Optional[float],
               scheduler: Optional["ASHA"] = None,
               failed: bool = False) -> bool:
        """Record an epoch result (or failure); returns ASHA's stop
        decision against the freshest cross-host state."""
        with self._locked():
            trials = self._load()
            trial = next(t for t in trials if t.trial_id == trial_id)
            if failed:
                trial.failed = True
                self._save(trials)
                return True
            trial.results.append(float(metric))
            stop = bool(scheduler and scheduler.should_stop(trial, trials))
            if stop:
                trial.stopped = True
            self._save(trials)
            return stop

    def snapshot(self) -> List[Trial]:
        with self._locked():
            return self._load()


def run_search_multihost(
    train_one_epoch: Callable[..., tuple],
    space: Dict[str, Domain],
    state_path: str,
    num_trials: int = 16,
    max_epochs: int = 9,
    grace_period: int = 1,
    reduction_factor: int = 3,
    max_failures: int = 2,
    seed: int = 0,
    verbose: bool = True,
    sampler: str = "tpe",
    devices: Optional[Sequence] = None,
    host_id: int = 0,
) -> Dict:
    """Multi-host `run_search`: trials claimed from a shared FileTrialStore.

    Launch the SAME call on every host (one process per host, its local
    `devices` as workers, distinct `host_id`); hosts coordinate purely
    through `state_path` on the shared filesystem — the Ray Tune
    multi-node analogue (cvpce/hyperopt.py head-node state) without a
    head node. Each host returns the final cross-host result; re-running
    with the same `state_path` resumes the search (remaining budget).
    """
    scheduler = ASHA(max_epochs, grace_period, reduction_factor)
    store = FileTrialStore(state_path)
    rng = np.random.default_rng(seed + 7919 * host_id)
    tpe = TPESampler(space, seed=seed + 7919 * host_id) \
        if sampler == "tpe" else None
    wants_device = "device" in inspect.signature(train_one_epoch).parameters

    def sample_config(trials: List[Trial]):
        if tpe is None:
            return {k: d.sample(rng) for k, d in space.items()}
        observations = [(t.config, t.best) for t in trials
                        if t.results and not t.failed]
        return tpe.sample(observations)

    def run_trial(trial: Trial, device) -> None:
        carry = None
        failures = 0
        epoch = 0
        while epoch < max_epochs:
            try:
                if wants_device:
                    metric, carry = train_one_epoch(trial.config, epoch,
                                                    carry, device=device)
                else:
                    metric, carry = train_one_epoch(trial.config, epoch,
                                                    carry)
            except Exception as e:  # noqa: BLE001 — trial-level tolerance
                failures += 1
                if verbose:
                    print(f"[host {host_id} trial {trial.trial_id}] "
                          f"failure {failures}: {e}")
                if failures > max_failures:
                    store.report(trial.trial_id, None, failed=True)
                    break
                continue
            stop = store.report(trial.trial_id, metric, scheduler)
            if verbose:
                print(f"[host {host_id} trial {trial.trial_id}] epoch "
                      f"{epoch}: {metric:.4f} config={trial.config}")
            if stop:
                break
            epoch += 1

    def worker(device) -> None:
        while True:
            trial = store.claim(num_trials, sample_config)
            if trial is None:
                return
            run_trial(trial, device)

    if devices is not None and len(devices) > 1:
        threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                   for d in devices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        worker(devices[0] if devices else None)

    trials = store.snapshot()
    ok = [t for t in trials if not t.failed and t.results]
    best = max(ok, key=lambda t: t.best) if ok else None
    return {
        "best_config": best.config if best else None,
        "best_metric": best.best if best else None,
        "trials": trials,
    }


def trial_dir_allocator(base_dir: str) -> Callable[[], str]:
    """Thread-safe trial working-directory allocator (trial_001, ...).

    Shared by the gln/dihe hyperopt CLIs — each trial's first epoch
    allocates a directory that then rides the ASHA `carry` so later
    epochs resume the same run. Existing directories are skipped so a
    resumed search never reuses a previous run's trial dir."""
    import itertools
    import os
    from os import path

    lock = threading.Lock()
    seq = itertools.count(1)

    def allocate() -> str:
        with lock:
            while True:
                cand = path.join(base_dir, f"trial_{next(seq):03d}")
                if not os.path.exists(cand):
                    return cand

    return allocate


def device_scope(device):
    """torch.cuda.device(device) when a device is assigned (one trial
    per card, the reference's one-GPU-per-trial placement), else a
    no-op context."""
    from contextlib import nullcontext

    if device is None:
        return nullcontext()
    import torch

    return torch.cuda.device(device)
