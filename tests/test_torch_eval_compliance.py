"""The port's compliance and DIHE evaluation against the JAX package's,
on the trained artifacts/gln_r5 + artifacts/dihe_r4 weights at 256x384
windows of synthetic planogram scenes: evaluate_planograms with and
without colour correction on domain-shifted windows (native graph
matching on both sides), and eval_dihe."""
import numpy as np
import pytest

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.eval import classification as j_classification
from cvpce_tpu.eval import compliance as j_compliance
from cvpce_tpu.pipeline.evaluator import PlanogramComparator as JComparator
from cvpce_tpu.pipeline.evaluator import PlanogramEvaluator as JEvaluator
from cvpce_tpu_torch.eval import classification, compliance
from cvpce_tpu_torch.pipeline.evaluator import (PlanogramComparator,
                                                PlanogramEvaluator)
from torch_eval_common import J_BATCH, WindowTestSet
from torch_eval_common import stack  # noqa: F401 (module-scoped fixture)


@pytest.mark.parametrize("color_correct", [False, True])
def test_evaluate_planograms_matches_jax(stack, color_correct):
    """Domain-shifted windows (the JAX shift, so both packages see the
    same pixels); native graph matching on both sides."""
    planoset = []
    for i, w in enumerate(stack["windows"][1:]):
        img = j_syn.apply_domain_shift(
            w["image"], np.random.default_rng((i, 41)), 0.5)
        planoset.append((img, dict(w["planogram"],
                                   actual_accuracy=w["intact"])))
    got = compliance.evaluate_planograms(
        PlanogramEvaluator(stack["t_pg"], stack["t_clf"],
                           PlanogramComparator(device="cpu"),
                           color_correct=color_correct),
        planoset, verbose=False)
    want = j_compliance.evaluate_planograms(
        JEvaluator(stack["j_pg"], stack["j_clf"], JComparator(),
                   color_correct=color_correct),
        planoset, verbose=False)
    assert got["per_image"] == want["per_image"]
    assert got == want


def test_eval_dihe_matches_jax(stack, tmp_path):
    """Accuracy within 1/total: the JAX package crops with its bf16
    einsum resampler, the port with the f32 gather."""
    ts = WindowTestSet(stack["windows"])
    total = sum(len(w["labels"]) for w in stack["windows"])
    want = j_classification.eval_dihe(stack["j_enc"], 1024,
                                      stack["gallery"], ts,
                                      batch_size=J_BATCH, k=(1, 2),
                                      verbose=False)
    got = classification.eval_dihe(stack["t_enc"], 1024, stack["gallery"],
                                   ts, k=(1, 2), verbose=False,
                                   device="cpu")
    assert list(got) == list(want) == [1, 2]
    for k in want:
        assert abs(got[k] - want[k]) <= 1 / total, k
    path = str(tmp_path / "index.npz")
    stack["t_clf"].save_index(path)
    loaded = classification.eval_dihe(stack["t_enc"], 1024, None, ts,
                                      k=(1, 2), load_index=path,
                                      verbose=False, device="cpu")
    assert loaded == got
