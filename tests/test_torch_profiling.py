"""cvpce_tpu_torch/utils/profiling.py against cvpce_tpu/utils/profiling.py:
StepTimer's summary on the same recorded times and print_time's marker
equal to the JAX package's; `trace` on the CPU writes a Chrome trace that
holds an `annotate` region, and without a card its default device
raises. JAX's own trace is not run (it needs no comparison: the trace
formats differ by design)."""
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from cvpce_tpu.utils import profiling as jprof
from cvpce_tpu_torch.utils import profiling


@pytest.mark.parametrize("times", [
    [],
    [0.25],
    list(np.random.default_rng(0).exponential(0.1, 37)),
])
def test_step_timer_summary_matches_jax(times):
    port, ref = profiling.StepTimer(), jprof.StepTimer()
    port.times, ref.times = list(times), list(times)
    assert port.summary() == ref.summary()
    if times:
        assert set(port.summary()) == {"mean_s", "p50_s", "p95_s", "steps"}


def test_step_timer_records_each_step():
    timer = profiling.StepTimer()
    with pytest.raises(RuntimeError, match="before start"):
        timer.stop()
    for _ in range(3):
        timer.start()
        elapsed = timer.stop()
        assert elapsed >= 0 and timer.times[-1] == elapsed
    assert timer.summary()["steps"] == 3


def test_print_time_prints_the_jax_marker(monkeypatch, capsys):
    fixed = time.localtime(1_700_000_000)
    monkeypatch.setattr(time, "localtime", lambda *a: fixed)
    profiling.print_time()
    port = capsys.readouterr().out
    jprof.print_time()
    assert port == capsys.readouterr().out == \
        f"-- {time.asctime(fixed)} --\n"


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("spatial.halo"):
            torch.ones(64).cumsum(0)
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "spatial.halo" for e in events)
    assert [e.count for e in prof.key_averages()
            if e.key == "spatial.halo"] == [1]


def test_trace_records_the_card_by_default(monkeypatch, tmp_path):
    """The default device is the card; without one it raises, as every
    entry point of the port does, rather than tracing the CPU alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace(str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)
