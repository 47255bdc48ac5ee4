"""Package installer (pip install -e .) — mirrors the reference's packaging
surface (``/root/reference/setup.py`` registers only its library package;
experiment runners and configs run from the repo root, as here)."""

from setuptools import find_packages, setup

setup(
    name="rgcn_tpu",
    version="0.1.0",
    description=(
        "TPU-native relational graph convolution framework "
        "(R-GCN / e-RGCN / c-RGCN) on JAX/XLA/Pallas"
    ),
    packages=find_packages(
        include=["rgcn_tpu", "rgcn_tpu.*", "rgcn_tpu_torch", "rgcn_tpu_torch.*"]
    ),
    # the PyTorch/CUDA port builds its CUDA kernels (with their headers and
    # the rejected designs the comparison scripts build) and its C++ host
    # builders from these sources at first use
    package_data={"rgcn_tpu_torch": [
        "kernels/csrc/*.cu",
        "kernels/csrc/*.cuh",
        "kernels/csrc/variants/*",
        "native/csrc/*.cc",
    ]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "pyyaml",
    ],
    extras_require={
        "data": ["pandas"],
        "ckpt": ["orbax-checkpoint"],
        "test": ["pytest"],
    },
)
