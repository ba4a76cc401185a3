"""make_variables_inference_fn applies the weights it is given on every
call, as the JAX function does (cvpce_tpu/eval/proposals.py): an update
made in place to the state_dict between two calls, as an optimizer step
makes, reaches the second call."""
import numpy as np
import torch

from cvpce_tpu_torch.eval.proposals import make_variables_inference_fn
from cvpce_tpu_torch.models.gln import GLN, GLNConfig

CONFIG = GLNConfig(canvas_h=128, canvas_w=192, with_gaussians=False)


def test_in_place_update_reaches_the_next_call():
    model = GLN(CONFIG, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()  # aliases the live parameters
    infer = make_variables_inference_fn(CONFIG, device="cpu")
    images = np.random.default_rng(0).uniform(
        0, 1, (1, 128, 192, 3)).astype(np.float32)
    sizes = np.array([[128, 192]], np.float32)
    first = infer(sd, images, sizes)["scores"].clone()
    # the same dict and tensors, unchanged: the same scores
    assert torch.equal(infer(sd, images, sizes)["scores"], first)
    with torch.no_grad():
        model.head.cls_logits.bias.add_(2.0)
    moved = infer(sd, images, sizes)["scores"]
    # the same tensors in a new dict give the updated weights' scores too
    fresh = infer(dict(sd), images, sizes)["scores"]
    assert torch.equal(moved, fresh)
    assert (moved - first).abs().max() > 0.05
    # and back: another in-place step is seen as well
    with torch.no_grad():
        model.head.cls_logits.bias.sub_(2.0)
    assert torch.equal(infer(sd, images, sizes)["scores"], first)
