from rgcn_tpu_torch.models.link_prediction import (
    CompressionRelationPredictor,
    LinkPredictor,
    build_lp_model,
)
from rgcn_tpu_torch.models.node_classification import (
    EmbeddingNodeClassifier,
    NodeClassifier,
    build_nc_model,
)

__all__ = ["CompressionRelationPredictor", "EmbeddingNodeClassifier", "LinkPredictor",
           "NodeClassifier", "build_lp_model", "build_nc_model"]
