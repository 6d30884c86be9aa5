"""Stacking segments to one shape for the mesh plane.

Counterpart of ``stack_shard_arrays`` in
``elasticsearch_tpu/parallel/distributed.py`` (the rest of that module,
the round-1 fixed disjunction kernel, is not on the port's path).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def stack_shard_arrays(segments: List, n_slots: int) -> Dict[str, np.ndarray]:
    """Stack one segment per slot into arrays with a leading [n_slots]
    axis, every slot padded to the largest segment's shape: block_docs
    (sentinel re-pointed to the stacked nd_pad), block_tfs, norms (columns
    past a segment's own docs stay 1) and live1. Returns host numpy
    arrays plus the stacked ``nd_pad``."""
    if len(segments) > n_slots:
        raise ValueError(f"{len(segments)} segments > {n_slots} slots")
    nd_pad = max(s.nd_pad for s in segments)
    n_blocks = max(s.block_docs.shape[0] for s in segments)
    n_norm = max(s.norms.shape[0] for s in segments)
    blk = segments[0].block_docs.shape[1]

    block_docs = np.full((n_slots, n_blocks, blk), nd_pad, dtype=np.int32)
    block_tfs = np.zeros((n_slots, n_blocks, blk), dtype=np.float32)
    norms = np.ones((n_slots, n_norm, nd_pad + 1), dtype=np.float32)
    live1 = np.zeros((n_slots, nd_pad + 1), dtype=bool)
    for i, seg in enumerate(segments):
        bd = seg.block_docs.copy()
        bd[bd == seg.nd_pad] = nd_pad  # re-point sentinel to stacked pad
        block_docs[i, : bd.shape[0]] = bd
        block_tfs[i, : seg.block_tfs.shape[0]] = seg.block_tfs
        norms[i, : seg.norms.shape[0], : seg.norms.shape[1] - 1] = \
            seg.norms[:, :-1]
        norms[i, :, nd_pad] = 1.0
        live1[i, : seg.live.shape[0]] = seg.live
    return {
        "block_docs": block_docs,
        "block_tfs": block_tfs,
        "norms": norms,
        "live1": live1,
        "nd_pad": nd_pad,
    }
