"""Guards for the PyTorch port: no JAX inside it, no silent CPU fallback.

- An AST scan of every module under ``elasticsearch_tpu_torch/`` finds no
  import of ``jax``, of the JAX package ``elasticsearch_tpu``, or of
  ``ml_dtypes`` (a JAX dependency, absent where the port runs).
- On a machine without a GPU, the default device (``cuda``) raises at
  every entry point instead of running on the CPU.
- The CUDA sources are present, and nothing builds them at import time.
- A kernel fault on the kNN rung of the mesh plane raises: no other rung
  answers in the kernel's place.
"""

import ast
import os

import numpy as np
import pytest
import torch

import elasticsearch_tpu_torch
from elasticsearch_tpu_torch.ops import cuda_kernels

PKG_DIR = os.path.dirname(elasticsearch_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "elasticsearch_tpu", "ml_dtypes")


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


def test_no_gpu_raises_with_mesh_plane_and_batcher_on():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService
    from elasticsearch_tpu_torch.node import Node

    on = {"search.batch.enabled": True, "search.batch.max_queries": 16,
          "index.search.mesh": True, "index.number_of_shards": 3}
    for make in (lambda: Node(Settings(on)),
                 lambda: IndexService("i", Settings(on))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # and the CPU index with both on serves from the mesh plane, not a
    # silent fallback of the default device
    svc = IndexService("i", Settings(on), device="cpu")
    try:
        assert svc.device.type == "cpu" and svc._batcher.enabled
    finally:
        svc.close()


def test_kernel_sources_present_and_not_built_on_import():
    names = sorted(os.path.basename(p) for p in cuda_kernels.sources())
    assert names == ["block_topk.cuh", "knn_scoring.cu", "launch.cuh",
                     "segment_sum.cu", "tile_scoring.cu"]
    assert cuda_kernels._lib is None
    assert set(cuda_kernels.LAUNCHES) == {
        "tile_scoring", "tile_scoring_batched", "tile_scoring_topk",
        "tile_scoring_topk_sel", "tile_scoring_packed",
        "tile_scoring_batched_packed", "tile_scoring_topk_packed",
        "tile_scoring_topk_sel_packed", "segment_sum", "segment_sum_combine",
        "knn_scoring"}
    assert "estpu_knn_score_tiles" in cuda_kernels._SIGNATURES
    assert {"estpu_segment_sum", "estpu_segment_sum_gathered",
            "estpu_segment_sum_combine"} <= set(cuda_kernels._SIGNATURES)
    for src in cuda_kernels.sources():
        text = open(src).read()
        if src.endswith(".cu"):
            assert "Replaces:" in text and "bounds it" in text
        assert "#include <torch" not in text


def _knn_index(n_shards=3):
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService

    rng = np.random.RandomState(1)
    # one segment a shard: no scheduled refresh during the ingest
    svc = IndexService("v", Settings({"index.number_of_shards": n_shards,
                                      "index.refresh_interval": -1}),
                       mapping={"properties": {"emb": {
                           "type": "dense_vector", "dims": 8}}},
                       device="cpu")
    for d in range(60):
        svc.index_doc(str(d), {"emb": rng.randn(8).tolist()})
    svc.refresh()
    return svc, [{"knn": {"field": "emb", "query_vector": rng.randn(8).tolist(),
                          "k": 5}} for _ in range(3)]


@pytest.mark.parametrize("how", ["serial", "batch"])
def test_knn_kernel_fault_raises_and_is_not_served_by_the_host(
        monkeypatch, how):
    from elasticsearch_tpu_torch.ops import knn_scoring
    from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError

    svc, bodies = _knn_index()
    try:
        assert svc.search(dict(bodies[0]))["_plane"] == "mesh_pallas"

        def broken(*args, **kwargs):
            raise KernelError(
                "knn_scoring kernel launch failed: CUDA error 700")

        monkeypatch.setattr(knn_scoring, "knn_score_tiles", broken)
        with pytest.raises(KernelError):
            if how == "serial":
                svc.search(dict(bodies[0]))
            else:
                svc.search_batch([dict(b) for b in bodies])
        planes = svc.search_stats()["planes"]
        assert planes["plane_failures_total"] == {"mesh_pallas": 0,
                                                  "mesh": 0}
        assert planes["plane_quarantined"] == []
        assert planes["host_query_total"] == 0
    finally:
        svc.close()
