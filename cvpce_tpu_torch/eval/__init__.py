"""Evaluation: proposal AP, classification accuracy, detection mAP,
planogram compliance; counterpart of cvpce_tpu/eval."""

from .classification import eval_dihe  # noqa: F401
from .compliance import evaluate_planograms  # noqa: F401
from .detection import evaluate_detections, mean_average_metrics  # noqa: F401
from .proposals import evaluate_gln, make_inference_fn  # noqa: F401
