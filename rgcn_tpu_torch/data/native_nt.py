"""ctypes binding of the port's native gzipped N-Triples parser
(counterpart of ``rgcn_tpu/data/native_nt.py``).

The parser is the port's copy of the JAX package's C++ parser
(``rgcn_tpu_torch/native/csrc/nt_parser.cc``, linked with zlib, built
with g++ at first use by :mod:`rgcn_tpu_torch.native`): streaming gz
decode, term scanning, interning and the sorted-vocabulary remap run in
C++, and Python receives the int32 triples and the sorted vocabularies.
Its terms are those of the Python scanner (:mod:`rgcn_tpu_torch.data.nt`,
``tests/test_torch_native.py``). Each parse adds one to
``rgcn_tpu_torch.native.CALLS["parse_nt"]``.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from rgcn_tpu_torch import native

__all__ = ["parse_nt_native"]


def parse_nt_native(path: str) -> Tuple[np.ndarray, List[str], List[str]]:
    """Parse an N-Triples file (gzipped or plain) natively.

    Returns ``(triples (T, 3) int64, node_vocab sorted, rel_vocab
    sorted)`` with ids into the sorted vocabularies. Raises
    ``FileNotFoundError`` for a file it cannot open and ``ValueError`` on a
    malformed line, as the Python scanner does.
    """
    lib = native.load("host_nt_parser")
    h = lib.rgcn_nt_parse(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        err = lib.rgcn_nt_error(h)
        if err:
            raise ValueError(err.decode("utf-8", "replace"))
        t = lib.rgcn_nt_num_triples(h)
        spo = np.empty((t, 3), dtype=np.int32)
        node_blob = ctypes.create_string_buffer(int(lib.rgcn_nt_vocab_bytes(h, 0)))
        rel_blob = ctypes.create_string_buffer(int(lib.rgcn_nt_vocab_bytes(h, 1)))
        lib.rgcn_nt_fill(h, spo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         node_blob, rel_blob)
    finally:
        lib.rgcn_nt_free(h)
    native.count("parse_nt")
    nodes = node_blob.raw.decode("utf-8").split("\n")[:-1]
    rels = rel_blob.raw.decode("utf-8").split("\n")[:-1]
    return spo.astype(np.int64), nodes, rels
