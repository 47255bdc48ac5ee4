from rgcn_tpu_torch.graph.augment import (
    augment_triples,
    inverse_triples,
    self_loop_triples,
)
from rgcn_tpu_torch.graph.structure import (
    EdgeSet,
    auto_nc_row_block,
    build_edge_set,
    edge_normalization,
)
from rgcn_tpu_torch.graph.dynamic import padded_size

__all__ = [
    "augment_triples",
    "inverse_triples",
    "self_loop_triples",
    "EdgeSet",
    "auto_nc_row_block",
    "build_edge_set",
    "edge_normalization",
    "padded_size",
]
