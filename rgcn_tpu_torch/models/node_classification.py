"""Node-classification R-GCN and e-RGCN (counterparts of
``rgcn_tpu/models/node_classification.py::NodeClassifier`` and
``::EmbeddingNodeClassifier``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rgcn_tpu_torch.nn import init as rinit
from rgcn_tpu_torch.nn.layers import RGCNConv

__all__ = ["EmbeddingNodeClassifier", "NodeClassifier", "build_nc_model"]


class NodeClassifier(nn.Module):
    """Featureless 1-2 layer R-GCN returning logits for all nodes.

    Layer 1 is featureless (one-hot identity input), layer 2 featureful;
    both take ``decomposition`` with ``num_bases`` or ``num_blocks``.
    Parameters are drawn from ``torch.Generator().manual_seed(seed)``, layer
    by layer in the JAX order (bases then comps under basis decomposition).
    """

    def __init__(
        self,
        num_nodes: int,
        num_relations: int,  # original relation count R
        num_classes: int,
        hidden_size: int = 16,
        num_layers: int = 2,
        decomposition: Optional[str] = None,
        num_bases: int = 0,
        num_blocks: int = 0,
        seed: int = 0,
    ):
        super().__init__()
        if not 0 < num_layers < 3:
            raise ValueError("only 1 or 2 RGCN layers are supported")
        self.num_layers = num_layers
        self.decomposition = decomposition
        r_aug = 2 * num_relations + 1
        nhid = num_classes if num_layers == 1 else hidden_size
        gen = torch.Generator().manual_seed(seed)
        decomp = dict(decomposition=decomposition, num_bases=num_bases,
                      num_blocks=num_blocks, generator=gen)
        self.rgc1 = RGCNConv(num_nodes, r_aug, nhid, in_features=None, **decomp)
        if num_layers == 2:
            self.rgc2 = RGCNConv(num_nodes, r_aug, num_classes, in_features=nhid,
                                 **decomp)

    def forward(self, edges) -> torch.Tensor:
        x = self.rgc1(edges)
        if self.num_layers == 2:
            x = self.rgc2(edges, torch.relu(x))
        return x

    def layer1_l2(self) -> torch.Tensor:
        """Sum of squares of the first layer's weights, decomposition-aware
        (``bases`` and ``comps``, or ``blocks``, or ``weights``)."""
        p1 = self.rgc1
        if self.decomposition == "basis":
            return torch.sum(p1.bases ** 2) + torch.sum(p1.comps ** 2)
        if self.decomposition == "block":
            return torch.sum(p1.blocks ** 2)
        return torch.sum(p1.weights ** 2)


class EmbeddingNodeClassifier(nn.Module):
    """e-RGCN: learned node embeddings ``(N, emb_dim)`` (kaiming-normal,
    fan-in), a diagonal-weight R-GCN layer ``rgcn_no_hidden`` at width
    ``emb_dim`` (no bias), ReLU, then ``rgc1``, an R-GCN layer to the class
    logits (glorot-uniform with the relu gain, zero bias) that takes
    ``decomposition``. Parameters are drawn from
    ``torch.Generator().manual_seed(seed)`` in the order embeddings,
    ``rgcn_no_hidden``, ``rgc1``.
    """

    def __init__(
        self,
        num_nodes: int,
        num_relations: int,  # original relation count R
        num_classes: int,
        emb_dim: int = 32,
        decomposition: Optional[str] = None,
        num_bases: int = 0,
        num_blocks: int = 0,
        seed: int = 0,
    ):
        super().__init__()
        r_aug = 2 * num_relations + 1
        gen = torch.Generator().manual_seed(seed)
        self.node_embeddings = nn.Parameter(
            rinit.kaiming_normal_fan_in((num_nodes, emb_dim), gen))
        self.rgcn_no_hidden = RGCNConv(num_nodes, r_aug, emb_dim, in_features=emb_dim,
                                       diag=True, generator=gen)
        self.rgc1 = RGCNConv(num_nodes, r_aug, num_classes, in_features=emb_dim,
                             decomposition=decomposition, num_bases=num_bases,
                             num_blocks=num_blocks, generator=gen)

    def forward(self, edges) -> torch.Tensor:
        x = torch.relu(self.rgcn_no_hidden(edges, self.node_embeddings))
        return self.rgc1(edges, x)

    def embedding_l2(self) -> torch.Tensor:
        """Sum of squares of the node embeddings."""
        return torch.sum(self.node_embeddings ** 2)


def build_nc_model(cfg, data, seed: int = 0) -> nn.Module:
    """The model a NodeClassificationExperiment config describes: a
    :class:`NodeClassifier` (``rgcn``) or an
    :class:`EmbeddingNodeClassifier` (``e-rgcn``)."""
    rg = cfg.rgcn
    decomp = rg.decomposition
    common = dict(
        num_nodes=data.num_nodes,
        num_relations=data.num_relations,
        num_classes=data.num_classes,
        decomposition=decomp.type if decomp else None,
        num_bases=decomp.num_bases if decomp else 0,
        num_blocks=decomp.num_blocks if decomp else 0,
        seed=seed,
    )
    if rg.model == "rgcn":
        return NodeClassifier(hidden_size=rg.hidden_size, num_layers=rg.num_layers,
                              **common)
    if rg.model == "e-rgcn":
        return EmbeddingNodeClassifier(emb_dim=rg.node_embeddings, **common)
    raise NotImplementedError(f"{rg.model!r} model has not been implemented")
