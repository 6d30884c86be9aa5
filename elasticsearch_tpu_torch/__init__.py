"""elasticsearch_tpu_torch — the search engine on PyTorch and CUDA.

A port of ``elasticsearch_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. Module paths and class names follow the JAX package so each
module's counterpart is easy to find; the two Pallas kernel modules become
``ops/tile_scoring.py`` and ``ops/segment_sum.py``, whose kernels are
hand-written CUDA under ``csrc/``.

Entry points take an explicit ``device``. They run on ``cuda`` unless the
caller passes ``device="cpu"``; asking for ``cuda`` without a GPU raises.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
