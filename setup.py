"""Build the optional native host extension.

    python setup.py build_ext --inplace

Pure-Python fallbacks exist for every native function, so the package
works without this build; the extension accelerates FASTA ingest and
`.cfrk` formatting (cfrk_tpu/io/native/fastaio.cpp).
"""

from setuptools import Extension, setup

setup(
    name="cfrk-tpu",
    version="0.1.0",
    packages=[
        "cfrk_tpu",
        "cfrk_tpu.io",
        "cfrk_tpu.io.native",
        "cfrk_tpu.ops",
        "cfrk_tpu.ops.pallas",
        "cfrk_tpu.parallel",
        "cfrk_tpu.pipeline",
        "cfrk_tpu.runtime",
        "cfrk_tpu_torch",
        "cfrk_tpu_torch.io",
        "cfrk_tpu_torch.io.native",
        "cfrk_tpu_torch.ops",
        "cfrk_tpu_torch.ops.cuda",
        "cfrk_tpu_torch.pipeline",
        "cfrk_tpu_torch.runtime",
        "cfrk_tpu_torch.tools",
    ],
    # The CUDA kernels and the host library of cfrk_tpu_torch are not
    # ext_modules: they build from csrc/ at first use, with nvcc and the
    # host C++ compiler (cfrk_tpu_torch/ops/cuda/build.py).
    package_data={"cfrk_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"]},
    ext_modules=[
        Extension(
            "cfrk_tpu.io.native._fastaio",
            sources=["cfrk_tpu/io/native/fastaio.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        )
    ],
    entry_points={
        "console_scripts": [
            "cfrk-tpu = cfrk_tpu.cli:main",
            "cfrk-tpu-torch = cfrk_tpu_torch.cli:main",
        ],
    },
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
)
