"""Production pipeline: detection -> classification -> compliance."""

from .classifier import Classifier  # noqa: F401
from .evaluator import PlanogramComparator, PlanogramEvaluator  # noqa: F401
from .planograms import (  # noqa: F401
    build_graph,
    build_hypotheses,
    finalize_via_ransac,
    large_common_subgraph,
    tonioni_mcs,
)
from .proposals import ProposalGenerator  # noqa: F401
