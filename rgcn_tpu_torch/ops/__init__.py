"""Relational SpMM ops: ``aggregate`` (K1), ``fused`` (K2), ``rel_spmm``
(K3 and the forward dispatch), ``basis`` (K4, K5: the aggregation-first
basis path), ``diag`` (the diagonal layer on K1), ``spmm`` (plain
``index_add_`` oracles), ``distmult`` (scoring) and ``collectives`` (the
manual-AD all-reduce and fan-out of edge-sharded training).

Import from the submodules; this package re-exports nothing, so that
``ops.rel_spmm`` names the module and not ``ops.spmm.rel_spmm``.
"""
