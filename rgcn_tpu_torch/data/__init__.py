from rgcn_tpu_torch.data.dispatch import load_lp_data, load_nc_data
from rgcn_tpu_torch.data.loaders import (
    DATA_ROOT,
    LinkPredictionData,
    NodeClassificationData,
    load_link_prediction,
    load_node_classification,
)
from rgcn_tpu_torch.data.nt import iter_nt_file, parse_nt_line, read_nt_file
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
    "DATA_ROOT",
    "LinkPredictionData",
    "NodeClassificationData",
    "aifb_like",
    "am_like",
    "fb_toy_like",
    "iter_nt_file",
    "load_link_prediction",
    "load_lp_data",
    "load_nc_data",
    "load_node_classification",
    "parse_nt_line",
    "read_nt_file",
    "synthetic_kg",
    "synthetic_link_prediction",
    "synthetic_lp_data",
    "synthetic_nc_data",
    "synthetic_node_classification",
    "wn18_like",
]
