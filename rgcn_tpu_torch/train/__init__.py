"""Training: ``optim.make_optimizer``, ``evaluate`` (accuracy, ranking
metrics), the node-classification trainer (``node_classification``) and
the link-prediction trainer (``link_prediction``, with ``samplers`` and
``negative``).

The helpers are re-exported here, as ``rgcn_tpu.train`` re-exports
them; the trainers stay in their modules, so importing a helper loads no
model."""

from rgcn_tpu_torch.train.optim import make_optimizer
from rgcn_tpu_torch.train.samplers import (
    edge_neighborhood,
    select_sampler,
    uniform_sampling,
)
from rgcn_tpu_torch.train.negative import corrupt_batch, negative_sampling
from rgcn_tpu_torch.train.evaluate import (
    RankingFilters,
    accuracy,
    build_filters,
    ranking_metrics,
    ranks_from_scores,
)

__all__ = [
    "make_optimizer",
    "uniform_sampling",
    "edge_neighborhood",
    "select_sampler",
    "negative_sampling",
    "corrupt_batch",
    "RankingFilters",
    "build_filters",
    "ranks_from_scores",
    "ranking_metrics",
    "accuracy",
]
