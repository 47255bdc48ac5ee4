from rgcn_tpu_torch.data.loaders import LinkPredictionData, NodeClassificationData
from rgcn_tpu_torch.data.synthetic import (
    aifb_like,
    am_like,
    fb_toy_like,
    synthetic_kg,
    synthetic_link_prediction,
    synthetic_lp_data,
    synthetic_nc_data,
    synthetic_node_classification,
    wn18_like,
)

__all__ = [
    "LinkPredictionData",
    "NodeClassificationData",
    "aifb_like",
    "am_like",
    "fb_toy_like",
    "synthetic_kg",
    "synthetic_link_prediction",
    "synthetic_lp_data",
    "synthetic_nc_data",
    "synthetic_node_classification",
    "wn18_like",
]
