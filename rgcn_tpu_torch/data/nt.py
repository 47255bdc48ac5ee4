"""Minimal N-Triples parser (counterpart of ``rgcn_tpu/data/nt.py``, which
replaces the reference's rdflib dependency).

The reference parses gzipped N-Triples with rdflib and maps nodes to strings
with ``str(uri)`` for URI refs and ``.n3()`` for everything else
(the reference implementation's ``utils/data.py:14-24,132-138``). This parser reproduces
that string mapping directly from the serialized form:

* ``<http://...>``  → the URI without angle brackets (rdflib ``str(URIRef)``)
* ``_:b0``          → kept verbatim (rdflib ``BNode.n3()``)
* ``"lit"^^<dt>`` / ``"lit"@lang`` / ``"lit"`` → kept verbatim (``Literal.n3()``)

N-Triples is line-oriented (one triple per line, terminated by ``.``), so a
hand-rolled scanner is both simpler and faster than a full RDF stack; it
handles escaped quotes inside literals.
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Tuple

__all__ = ["iter_nt_file", "parse_nt_line", "read_nt_file"]


def _scan_term(line: str, i: int) -> Tuple[str, int]:
    """Scan one N-Triples term starting at index ``i``; return (term, next)."""
    n = len(line)
    while i < n and line[i] in " \t":
        i += 1
    if i >= n:
        raise ValueError(f"unexpected end of line: {line!r}")
    c = line[i]
    if c == "<":  # URI ref
        j = line.index(">", i)
        return line[i + 1 : j], j + 1
    if c == "_":  # blank node: up to whitespace
        j = i
        while j < n and line[j] not in " \t":
            j += 1
        return line[i:j], j
    if c == '"':  # literal, possibly with \" escapes, @lang or ^^<dtype>
        j = i + 1
        while j < n:
            if line[j] == "\\":
                j += 2
                continue
            if line[j] == '"':
                break
            j += 1
        j += 1  # past closing quote
        if j < n and line[j] == "@":
            while j < n and line[j] not in " \t":
                j += 1
        elif j + 1 < n and line[j : j + 2] == "^^":
            j += 2
            if j < n and line[j] == "<":
                j = line.index(">", j) + 1
        return line[i:j], j
    raise ValueError(f"cannot parse term at {line[i:i+30]!r}")


def parse_nt_line(line: str) -> Tuple[str, str, str] | None:
    """Parse one N-Triples line into reference-compatible (s, p, o) strings.

    Returns ``None`` for blank lines and comments.
    """
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    s, i = _scan_term(line, 0)
    p, i = _scan_term(line, i)
    o, i = _scan_term(line, i)
    return s, p, o


def iter_nt_file(path: str) -> Iterator[Tuple[str, str, str]]:
    """Yield (s, p, o) string triples from a .nt or .nt.gz file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            t = parse_nt_line(line)
            if t is not None:
                yield t


def read_nt_file(path: str) -> List[Tuple[str, str, str]]:
    """All (s, p, o) string triples of a .nt or .nt.gz file."""
    return list(iter_nt_file(path))
