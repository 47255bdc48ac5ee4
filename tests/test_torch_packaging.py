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


# the child of a read-only copy: the build goes to the per-user cache
READONLY_CHILD = r"""
import json, os, sys
sys.modules["jax"] = None
import numpy as np
from rgcn_tpu_torch import native
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.kernels import build

libs = native.build_all(["host_builders"])
edges = build_edge_set(np.load(sys.argv[1]), 60, 3, tile_size=16, with_dst_layout=True)
np.savez(sys.argv[2], src=edges.src, perm=edges.layout.perm)
print(json.dumps({"native": native.BUILD_DIR, "kernels": build.BUILD_DIR,
                  "lib": libs["host_builders"]["path"],
                  "cached": libs["host_builders"]["cached"]}))
"""


def _tree(root):
    """Every path under ``root`` with its size and mtime."""
    out = {}
    for d, dirs, files in os.walk(root):
        for f in dirs + files:
            p = os.path.join(d, f)
            st = os.lstat(p)
            out[os.path.relpath(p, root)] = (st.st_size, st.st_mtime_ns)
    return out


def _chmod_tree(root, writable: bool):
    for d, dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            os.chmod(p, 0o644 if writable else 0o444)
        os.chmod(d, 0o755 if writable else 0o555)


def test_read_only_copy_builds_into_the_user_cache(tmp_path):
    """A copy whose directory cannot be written builds its host library
    with g++ into ``$XDG_CACHE_HOME/rgcn_tpu_torch`` and writes nothing
    inside itself."""
    site = tmp_path / "site"
    out = subprocess.run([sys.executable, "setup.py", "build_py", "-d", str(site)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rng = np.random.default_rng(6)
    triples = np.stack([rng.integers(0, 60, 200), rng.integers(0, 3, 200),
                        rng.integers(0, 60, 200)], axis=1)
    np.save(tmp_path / "triples.npy", triples)
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(XDG_CACHE_HOME=str(cache), PYTHONDONTWRITEBYTECODE="1")
    _chmod_tree(site, writable=False)
    before = _tree(site)
    try:
        out = subprocess.run(
            [sys.executable, "-c", READONLY_CHILD, str(tmp_path / "triples.npy"),
             str(tmp_path / "edges.npz")],
            cwd=site, env=env, capture_output=True, text=True, timeout=300)
        after = _tree(site)
    finally:
        _chmod_tree(site, writable=True)
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want_dir = str(cache / "rgcn_tpu_torch")
    assert got["native"] == got["kernels"] == want_dir
    assert not got["cached"] and got["lib"].startswith(want_dir + os.sep)
    assert os.path.isfile(got["lib"])
    assert after == before, sorted(set(after) ^ set(before))
    from rgcn_tpu_torch.graph.structure import build_edge_set

    ref = build_edge_set(triples, 60, 3, tile_size=16, with_dst_layout=True)
    arrays = np.load(tmp_path / "edges.npz")
    np.testing.assert_array_equal(arrays["src"], ref.src)
    np.testing.assert_array_equal(arrays["perm"], ref.layout.perm)


@pytest.mark.parametrize("case", ["checkout", "writable_copy", "read_only", "no_xdg"])
def test_build_dir_rule(tmp_path, monkeypatch, case):
    """``build/rgcn_tpu_torch`` beside the package while it can be
    written (or created), else the per-user cache."""
    from rgcn_tpu_torch.kernels.build import BUILD_DIR, build_dir

    if case == "checkout":
        assert BUILD_DIR == os.path.join(ROOT, "build", "rgcn_tpu_torch")
        return
    pkg = tmp_path / "site" / "rgcn_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if case == "writable_copy":
        assert build_dir(str(pkg)) == str(tmp_path / "site" / "build" / "rgcn_tpu_torch")
        return
    os.chmod(tmp_path / "site", 0o555)
    try:
        if case == "no_xdg":
            monkeypatch.delenv("XDG_CACHE_HOME")
            want = tmp_path / "home" / ".cache" / "rgcn_tpu_torch"
        else:
            want = tmp_path / "xdg" / "rgcn_tpu_torch"
        assert build_dir(str(pkg)) == str(want)
    finally:
        os.chmod(tmp_path / "site", 0o755)


@pytest.mark.parametrize("tool,argv,flag", [
    ("profile_serve", [], "--nc-config"),
    ("profile_serve", ["--lp"], "--config"),
    ("profile_epoch", [], "--configs lp_wn18=PATH"),
    ("trace_train_gate", [], "--config"),
])
def test_tools_name_their_config_flag_in_an_installed_copy(built, tool, argv, flag):
    """The measuring tools default to config files under a checkout's
    configs/, which an installed copy does not hold: there they stop before
    any work with a usage error naming the flag and the missing path, and a
    config given by the flag gets past that check (to the card's check,
    here)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = [sys.executable, "-c", "import sys; sys.modules['jax'] = None; "
           f"from rgcn_tpu_torch import {tool}; {tool}.main(sys.argv[1:])"]
    out = subprocess.run(run + argv, cwd=built, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2, out.stdout + out.stderr
    assert flag in out.stderr and "not found" in out.stderr, out.stderr
    missing = re.search(r"config file (\S+) not found", out.stderr).group(1)
    assert missing.startswith(str(built) + os.sep) and not os.path.exists(missing)
    lp = "--lp" in argv or tool == "profile_epoch"
    given = os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml" if lp else "nc-AIFB.yaml")
    given_argv = ["--configs", f"lp_wn18={given}"] if tool == "profile_epoch" else \
        [flag, given]
    out = subprocess.run(run + argv + given_argv, cwd=built, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 2 and "not found (the default" not in out.stderr, out.stderr
