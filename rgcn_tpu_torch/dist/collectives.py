"""Re-export of the manual-AD collectives (their home is
:mod:`rgcn_tpu_torch.ops.collectives`, under ``ops`` so the layers import
them without a ``dist`` → ``train`` → ``models`` cycle)."""

from rgcn_tpu_torch.ops.collectives import (  # noqa: F401
    all_reduce,
    fanout,
    maybe_all_reduce,
    maybe_fanout,
)

__all__ = ["all_reduce", "fanout", "maybe_all_reduce", "maybe_fanout"]
