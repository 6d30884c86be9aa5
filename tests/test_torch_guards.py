"""Guards for the PyTorch port: no JAX inside it, no silent CPU fallback.

- An AST scan of every module under ``elasticsearch_tpu_torch/`` finds no
  import of ``jax`` or of the JAX package ``elasticsearch_tpu``.
- On a machine without a GPU, the default device (``cuda``) raises at
  every entry point instead of running on the CPU.
- The CUDA sources are present, and nothing builds them at import time.
"""

import ast
import os

import pytest
import torch

import elasticsearch_tpu_torch
from elasticsearch_tpu_torch.ops import cuda_kernels

PKG_DIR = os.path.dirname(elasticsearch_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "elasticsearch_tpu")


def _modules():
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_package_imports_neither_jax_nor_the_jax_package():
    mods = list(_modules())
    assert len(mods) > 20
    bad = [(os.path.relpath(p, PKG_DIR), root) for p in mods
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    from elasticsearch_tpu_torch.index.index_service import IndexService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.node import Node

    for make in (Node, lambda: Node(device="cuda"),
                 lambda: IndexService("i"), lambda: SegmentBuilder("s")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_kernel_sources_present_and_not_built_on_import():
    names = sorted(os.path.basename(p) for p in cuda_kernels.sources())
    assert names == ["segment_sum.cu", "tile_scoring.cu"]
    assert cuda_kernels._lib is None
    assert set(cuda_kernels.LAUNCHES) == {"tile_scoring", "segment_sum"}
    for src in cuda_kernels.sources():
        text = open(src).read()
        assert "Replaces:" in text and "bounds it" in text
