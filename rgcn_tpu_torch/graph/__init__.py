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
from rgcn_tpu_torch.graph.dynamic import (
    build_edge_set_dynamic,
    padded_size,
    self_loop_keep_mask,
)

__all__ = [
    "augment_triples",
    "inverse_triples",
    "self_loop_triples",
    "EdgeSet",
    "auto_nc_row_block",
    "build_edge_set",
    "edge_normalization",
    "build_edge_set_dynamic",
    "padded_size",
    "self_loop_keep_mask",
]
