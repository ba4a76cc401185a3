"""Run a function of tests/torch_parallel_ranks.py on every rank of a
gloo process group on the CPU, each rank a subprocess, for the port's
data-parallel tests (tests/test_torch_parallel*.py).

`start_ranks(fn, n, **kwargs)` starts the ranks and returns at once, so
the caller can compute its JAX reference while they run; `.results()`
waits and returns each rank's return value, in rank order. Each group
rendezvouses on its own free port, initialises with a timeout (a rank
that never reaches a collective fails the others in PG_TIMEOUT
seconds), runs torch on one thread a rank (two for the pair), and is
destroyed at the end. A rank that fails ends the others at once; the
whole run has a time limit."""
from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PG_TIMEOUT = 120  # seconds
RUN_TIMEOUT = 600  # seconds, the whole group

RUNNER = r"""
import datetime, os, pickle, sys
sys.path[:0] = [os.environ["REPO_ROOT"], os.environ["TESTS_DIR"]]
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from cvpce_tpu_torch.parallel.multihost import initialize_multihost
import torch_parallel_ranks

initialize_multihost(device="cpu", timeout=datetime.timedelta(
    seconds=int(os.environ["PG_TIMEOUT"])))
with open(os.environ["ARGS"], "rb") as f:
    kwargs = pickle.load(f)
try:
    result = getattr(torch_parallel_ranks, os.environ["TARGET"])(**kwargs)
finally:
    dist.destroy_process_group()
with open(os.path.join(os.environ["OUT"], f"rank{os.environ['RANK']}.pkl"),
          "wb") as f:
    pickle.dump(result, f)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    def __init__(self, target: str, n: int, kwargs: dict):
        self.dir = tempfile.mkdtemp(prefix=f"ranks_{target}_")
        args = os.path.join(self.dir, "args.pkl")
        with open(args, "wb") as f:
            pickle.dump(kwargs, f)
        port = free_port()
        self.procs = []
        for rank in range(n):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("PYTHONPATH",)}
            env.update(REPO_ROOT=REPO, TESTS_DIR=TESTS, TARGET=target,
                       ARGS=args, OUT=self.dir, PG_TIMEOUT=str(PG_TIMEOUT),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(n), RANK=str(rank),
                       LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
            log = open(os.path.join(self.dir, f"rank{rank}.log"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", RUNNER], env=env, cwd=REPO,
                stdout=log, stderr=subprocess.STDOUT))
            log.close()

    def _log(self, rank: int) -> str:
        with open(os.path.join(self.dir, f"rank{rank}.log")) as f:
            return f.read()[-4000:]

    def results(self, timeout: float = RUN_TIMEOUT) -> list:
        end = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs)
                          if p.returncode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} failed:\n"
                                       + self._log(failed[0]))
                if time.monotonic() > end:
                    raise TimeoutError(f"ranks ran past {timeout} s:\n"
                                       + self._log(0))
                time.sleep(0.1)
            for r, p in enumerate(self.procs):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} failed:\n" + self._log(r))
            out = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.dir, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(self.dir, ignore_errors=True)


def start_ranks(target: str, n: int = 2, **kwargs) -> Ranks:
    """Start `torch_parallel_ranks.<target>(**kwargs)` on n gloo ranks."""
    return Ranks(target, n, kwargs)


def run_ranks(target: str, n: int = 2, **kwargs) -> list:
    return start_ranks(target, n, **kwargs).results()
