from rgcn_tpu_torch.models.link_prediction import LinkPredictor, build_lp_model
from rgcn_tpu_torch.models.node_classification import NodeClassifier, build_nc_model

__all__ = ["LinkPredictor", "NodeClassifier", "build_lp_model", "build_nc_model"]
