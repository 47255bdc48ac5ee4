"""An installed copy of the port holds everything it reads at run time.

``python setup.py build_py -d <dir>`` lays out the tree that ``pip install
.`` installs. That tree must hold every kernel source, the local headers
they include, the rejected designs under ``kernels/csrc/variants/`` and
the host builders' C++ sources; and with only that tree on ``sys.path``
(and JAX blocked) the port must hash its kernels as the checkout does,
build its host libraries with g++ into the copy's own ``build/``, and
build an edge set equal to the checkout's.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the child: only the built tree on sys.path (its cwd), JAX blocked
CHILD = r"""
import json, os, sys
sys.modules["jax"] = None
import numpy as np
import rgcn_tpu_torch
from rgcn_tpu_torch import native
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.kernels import build

site = os.path.abspath(os.getcwd())
assert os.path.abspath(rgcn_tpu_torch.__file__).startswith(site + os.sep), \
    rgcn_tpu_torch.__file__
assert not os.path.exists(native.BUILD_DIR), "the copy's build/ exists already"
libs = native.build_all()
edges = build_edge_set(np.load(sys.argv[1]), 60, 3, tile_size=16,
                       with_dst_layout=True)
np.savez(sys.argv[2], src=edges.src, dst=edges.dst, rel=edges.rel, val=edges.val,
         perm=edges.layout.perm, local_dst=edges.layout.local_dst,
         chunk_block=edges.layout.chunk_block)
print(json.dumps({
    "kernels": {n: build.library_path(n) for n in build.SOURCES},
    "native": {n: {"path": v["path"], "cached": v["cached"]} for n, v in libs.items()},
    "build_dir": native.BUILD_DIR,
    "jax": sorted(m for m in sys.modules if (m == "jax" or m.startswith("jax."))
                  and sys.modules[m] is not None),
}))
"""


def _local_includes(path):
    """The local files the source at ``path`` includes, recursively."""
    out = set()
    text = open(path).read()
    for header in re.findall(r'^#include "([^"]+)"', text, re.M):
        inc = os.path.normpath(os.path.join(os.path.dirname(path), header))
        if inc not in out:
            out.add(inc)
            out |= _local_includes(inc)
    return out


def _needed_files():
    """Every non-Python file of the checkout's port that it reads at run
    time, relative to the package."""
    from rgcn_tpu_torch import native
    from rgcn_tpu_torch.kernels import build

    files = set()
    for src in build.SOURCES.values():
        path = os.path.join(build.CSRC, src)
        files |= {path} | _local_includes(path)
    variants = os.path.join(build.CSRC, "variants")
    for name in os.listdir(variants):
        path = os.path.join(variants, name)
        files |= {path} | _local_includes(path)
    for sources, _ in native.LIBRARIES.values():
        for src in sources:
            path = os.path.join(native.CSRC, src)
            files |= {path} | _local_includes(path)
    pkg = os.path.join(ROOT, "rgcn_tpu_torch")
    return sorted(os.path.relpath(f, pkg) for f in files)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    site = tmp_path_factory.mktemp("installed") / "site"
    out = subprocess.run(
        [sys.executable, "setup.py", "build_py", "-d", str(site)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return site


def test_built_tree_holds_every_source(built):
    needed = _needed_files()
    assert "kernels/csrc/weighted_runs.cuh" in needed
    assert "native/csrc/graph_builder.cc" in needed
    assert any(f.startswith("kernels/csrc/variants/") for f in needed)
    missing = [f for f in needed if not (built / "rgcn_tpu_torch" / f).is_file()]
    assert not missing, f"the installed copy lacks {missing}"
    for f in needed:
        got = (built / "rgcn_tpu_torch" / f).read_bytes()
        assert got == open(os.path.join(ROOT, "rgcn_tpu_torch", f), "rb").read(), f


def test_installed_copy_builds_alone(built, tmp_path):
    from rgcn_tpu_torch import native
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.kernels import build

    rng = np.random.default_rng(5)
    triples = np.stack([rng.integers(0, 60, 300), rng.integers(0, 3, 300),
                        rng.integers(0, 60, 300)], axis=1)
    np.save(tmp_path / "triples.npy", triples)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp_path / "triples.npy"),
         str(tmp_path / "edges.npz")],
        cwd=built, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not got["jax"]

    # the kernels hash as the checkout's: the same sources and headers
    for name in build.SOURCES:
        assert os.path.basename(got["kernels"][name]) == \
            os.path.basename(build.library_path(name)), name
        assert got["kernels"][name].startswith(str(built) + os.sep)
    # g++ built both host libraries afresh, into the copy's own build/
    assert got["build_dir"] == str(built / "build" / "rgcn_tpu_torch")
    for name, lib in got["native"].items():
        assert not lib["cached"] and os.path.isfile(lib["path"])
        assert lib["path"].startswith(got["build_dir"] + os.sep)
        assert os.path.basename(lib["path"]) == \
            os.path.basename(native.library_path(name)), name
    assert set(got["native"]) == set(native.LIBRARIES)

    ref = build_edge_set(triples, 60, 3, tile_size=16, with_dst_layout=True)
    arrays = np.load(tmp_path / "edges.npz")
    for key, want in (("src", ref.src), ("dst", ref.dst), ("rel", ref.rel),
                      ("val", ref.val), ("perm", ref.layout.perm),
                      ("local_dst", ref.layout.local_dst),
                      ("chunk_block", ref.layout.chunk_block)):
        want = np.asarray(want)
        assert arrays[key].dtype == want.dtype, key
        np.testing.assert_array_equal(arrays[key], want, err_msg=key)
