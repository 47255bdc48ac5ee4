from rgcn_tpu_torch.nn.layers import DistMult, RGCNConv

__all__ = ["DistMult", "RGCNConv"]
