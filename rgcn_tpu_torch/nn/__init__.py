from rgcn_tpu_torch.nn.layers import DistMult, RGCNConv, TorchLinear

__all__ = ["DistMult", "RGCNConv", "TorchLinear"]
