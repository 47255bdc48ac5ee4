"""Build the port's CUDA C++ kernels with nvcc into shared libraries.

Each source under ``csrc/`` has a plain C interface and compiles on its own
(one nvcc process per source, all started together) into
``<BUILD_DIR>/<name>-<hash>.so`` (:func:`build_dir`: ``build/rgcn_tpu_torch/``
at the root of the checkout), where
``<hash>`` is taken over the source and the local headers it includes, so
an edited source is rebuilt and an unchanged one is reused. Nothing is
built at import: the first launch of a kernel builds it, or call
:func:`build_all` first to build them all. :func:`build_variant` builds a
rejected design kept under ``csrc/variants/`` for the comparison scripts.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "build_dir", "build_variant",
           "library_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "kernels", "csrc")


def _writable(path: str) -> bool:
    """May this process create files in the directory ``path``? access()
    must grant it and the directory must carry a write bit (root's
    access() ignores the bits: a tree installed without them is read-only
    by intent)."""
    return os.access(path, os.W_OK | os.X_OK) and bool(os.stat(path).st_mode & 0o222)


def build_dir(package_dir: str = _PKG) -> str:
    """Where the port builds its kernels and host libraries:
    ``build/rgcn_tpu_torch`` beside the package (the root of a checkout, or
    the directory of an installed copy) while that can be written; else
    the per-user cache ``$XDG_CACHE_HOME/rgcn_tpu_torch``, by default
    ``~/.cache/rgcn_tpu_torch``."""
    local = os.path.join(os.path.dirname(package_dir), "build", "rgcn_tpu_torch")
    probe = local
    while not os.path.isdir(probe) and os.path.dirname(probe) != probe:
        probe = os.path.dirname(probe)
    if _writable(probe):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "rgcn_tpu_torch")


BUILD_DIR = build_dir()

# kernel name -> source file under csrc/
SOURCES = {
    "k1_aggregate": "k1_aggregate.cu",
    "k2_fused": "k2_fused.cu",
    "k3_messages": "k3_messages.cu",
    "k4_weighted_aggregate": "k4_weighted_aggregate.cu",
    "k5_weighted_aggregate_dedup": "k5_weighted_aggregate_dedup.cu",
    # the bf16 forms (bf16 tables, operands or messages; the edge stage's
    # compute dtype and the JAX kernels' own dtype options): their own entry
    # points, libraries and launch counts, built beside the f32 ones
    "k1_aggregate_bf16": "k1_aggregate_bf16.cu",
    "k2_fused_bf16": "k2_fused_bf16.cu",
    "k3_messages_bf16": "k3_messages_bf16.cu",
    "k4_weighted_aggregate_bf16": "k4_weighted_aggregate_bf16.cu",
    "k5_weighted_aggregate_dedup_bf16": "k5_weighted_aggregate_dedup_bf16.cu",
    # the bf16-weight forms (f32 x, bf16 W: the layers' param_dtype)
    "k2_fused_wbf16": "k2_fused_wbf16.cu",
    "k3_messages_wbf16": "k3_messages_wbf16.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA toolkit is needed to "
            "build the rgcn_tpu_torch kernels"
        )
    return path


def _local_includes(path: str, seen: list) -> None:
    """``path`` and, depth first, the local headers it includes (each once)."""
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for header in re.findall(rb'^#include "([^"]+)"', text, re.M):
        inc = os.path.normpath(os.path.join(os.path.dirname(path), header.decode()))
        if inc not in seen:
            _local_includes(inc, seen)


def library_path(name: str) -> str:
    """Path of the built library for kernel ``name`` (may not exist yet);
    the hash covers the source and the local headers it includes, and
    theirs."""
    files: list = []
    _local_includes(os.path.join(CSRC, SOURCES[name]), files)
    h = hashlib.sha256()
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _log_path(library: str) -> str:
    """nvcc's ptxas report kept beside a built library."""
    return os.path.splitext(library)[0] + ".ptxas.txt"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named kernels (default: all) in parallel.

    Returns ``{name: {"path", "seconds", "log", "cached"}}``; ``log`` holds
    nvcc's ptxas report (kept beside the library, so a cached build still
    reports it). Raises ``RuntimeError`` with nvcc's output if any
    build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    result: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            log = ""
            if os.path.isfile(_log_path(out)):
                with open(_log_path(out)) as f:
                    log = f.read()
            result[name] = {"path": out, "seconds": 0.0, "log": log,
                            "cached": True}
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        with open(_log_path(out), "w") as f:
            f.write(log)
        os.replace(tmp, out)
        result[name] = {"path": out, "seconds": time.perf_counter() - t0,
                        "log": log, "cached": False}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return result


def build_variant(source: str) -> tuple:
    """nvcc ``csrc/<source>`` (a design kept for comparison, under
    ``variants/``) afresh into :data:`BUILD_DIR`; returns
    ``(library path, nvcc's ptxas report)``. Always rebuilt: a variant may
    include a kernel's source or header."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, os.path.splitext(os.path.basename(source))[0] + ".so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed:\n{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr
