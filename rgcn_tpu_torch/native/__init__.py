"""The port's host-side C++ builders, built with g++ at first use and bound
with ctypes, with call counters.

The sources under ``csrc/`` are the port's own copies of the JAX package's
``native/*.cc``. They build into two shared libraries under
``build/rgcn_tpu_torch/`` at the root of the checkout (or wherever
:func:`rgcn_tpu_torch.kernels.build.build_dir` puts the kernels: the
per-user cache where the package's directory is read-only), with the
flags of the JAX package's ``native/Makefile``:

* ``host_builders``: ``graph_builder.cc`` (the static edge set, OpenMP)
  and ``layout_builder.cc`` (the destination layout's counting sort and
  the (relation, destination) lexsort);
* ``host_nt_parser``: ``nt_parser.cc``, linked with zlib, so that a host
  without zlib loses only the parser.

Each library's name carries a hash of its sources, the flags, the
compiler's version and the host CPU's flags (``-march=native``), so an
edited source or another host rebuilds it; the compiler writes a temporary
file that ``os.replace`` moves into place, so concurrent first uses do not
collide. A failed build raises with the compiler's output. The port never
writes or loads the JAX package's ``native/librgcn_native.so``.

The bindings (:mod:`rgcn_tpu_torch.graph.native`,
:mod:`rgcn_tpu_torch.data.native_nt`) add one to a routine's count in
:data:`CALLS` for each call that ran it, and nowhere else, so a run that
resets the counts and reads them after shows which host builders it went
through. ctypes releases the GIL for the call, so a builder running in the
trainer's prefetch thread does not hold up the thread that drives the
card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

__all__ = ["CALLS", "LIBRARIES", "BUILD_DIR", "reset_calls", "count",
           "library_path", "build_all", "load"]

from rgcn_tpu_torch.kernels.build import build_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "native", "csrc")
BUILD_DIR = build_dir(_PKG)

CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
             "-Wall", "-shared"]

# library -> (sources under csrc/, libraries to link)
LIBRARIES = {
    "host_builders": (("graph_builder.cc", "layout_builder.cc"), ()),
    "host_nt_parser": (("nt_parser.cc",), ("-lz",)),
}

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_H = ctypes.c_void_p
# (restype, argtypes) of every exported function, as the sources declare them
SIGNATURES = {
    "host_builders": {
        "rgcn_build_edge_set": (_I64, [
            ctypes.POINTER(ctypes.c_int64), _I64, _I64, _I64, _I64,
            _I32P, _I32P, _I32P, ctypes.POINTER(ctypes.c_float), _I32P, _I64]),
        "rgcn_build_dst_layout": (_I64, [
            _I32P, _I64, _I64, _I64, _I64, _I64, _I32P, _I32P, _I32P, _I64]),
        "rgcn_lexsort_rel_dst": (_I64, [_I32P, _I32P, _I64, _I64, _I64, _I32P]),
    },
    "host_nt_parser": {
        "rgcn_nt_parse": (_H, [ctypes.c_char_p]),
        "rgcn_nt_error": (ctypes.c_char_p, [_H]),
        "rgcn_nt_num_triples": (_I64, [_H]),
        "rgcn_nt_vocab_bytes": (_I64, [_H, ctypes.c_int32]),
        "rgcn_nt_fill": (None, [_H, _I32P, ctypes.c_char_p, ctypes.c_char_p]),
        "rgcn_nt_free": (None, [_H]),
    },
}

CALLS: Dict[str, int] = {"build_edge_set": 0, "build_dst_layout": 0,
                         "lexsort_rel_dst": 0, "parse_nt": 0}
_CALLS_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_calls() -> None:
    with _CALLS_LOCK:
        for name in CALLS:
            CALLS[name] = 0


def count(name: str) -> None:
    """One more call of routine ``name`` (the prefetch thread counts too)."""
    with _CALLS_LOCK:
        CALLS[name] += 1


def _host_key() -> bytes:
    """The compiler's version and the CPU's flags: what -march=native
    compiles for."""
    try:
        version = subprocess.run([CXX, "--version"], capture_output=True,
                                 timeout=60).stdout
    except OSError as e:
        raise RuntimeError(f"C++ compiler {CXX!r} not found: the port's host "
                           f"builders need it ({e})") from e
    flags = b""
    if os.path.isfile("/proc/cpuinfo"):
        with open("/proc/cpuinfo", "rb") as f:
            flags = next((ln for ln in f if ln.startswith(b"flags")), b"")
    return version + flags


def library_path(name: str, host_key: Optional[bytes] = None) -> str:
    """Path of library ``name`` (may not exist yet)."""
    sources, libs = LIBRARIES[name]
    h = hashlib.sha256(host_key if host_key is not None else _host_key())
    h.update(" ".join(CXX_FLAGS + list(libs)).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named libraries (default: both), one g++ process each,
    started together. Returns ``{name: {"path", "seconds", "cached"}}``;
    raises ``RuntimeError`` with the compiler's output if a build fails."""
    names = list(LIBRARIES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    key = _host_key()
    result: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, key)
        if os.path.isfile(out):
            result[name] = {"path": out, "seconds": 0.0, "cached": True}
            continue
        sources, libs = LIBRARIES[name]
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [CXX, *CXX_FLAGS, "-o", tmp,
               *(os.path.join(CSRC, s) for s in sources), *libs]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} ({CXX} exit {proc.returncode})\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
        result[name] = {"path": out, "seconds": time.perf_counter() - t0,
                        "cached": False}
    if failures:
        raise RuntimeError("host builder build failed:\n" + "\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """Library ``name``, built at first use, with every function's
    ``restype`` and ``argtypes`` set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build_all([name])[name]["path"])
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
    return _LIBS[name]
