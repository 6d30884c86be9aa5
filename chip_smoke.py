"""Chip smoke: drive the PyTorch port's search path on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; builds the hand-written kernels from
``elasticsearch_tpu_torch/csrc`` into ``build/`` first. Exits non-zero, and
prints no result, when there is no GPU or any check fails. Phases:

1. Device: the card's name and power limit, torch version, kernel build.
2. Each kernel against its plain PyTorch version on the card, at bench
   shapes: a 1M-doc corpus (a copy of bench.py's generator: seed 7, 50k-term
   zipf vocabulary, lognormal lengths around 80, a 2000-value zipf keyword
   column), 3-term queries from ranks 50-1049, and one query holding a
   top-10 term (the geometry ladder shrinks its tile). Tile scoring must
   match bit for bit, scores and counts. Each is timed as a median over
   CUDA events with L2 flushed before every launch, beside its bound (the
   larger of its bytes over the memory rate and its float32 operations
   over the peak rate), its plain version and one PyTorch library call
   computing the same function (a spin kernel keeps the card busy while
   the host enqueues the call, so the events time device work, not the
   host's enqueue). The dense kernel's launch plan (band of S columns,
   group of G queries, block count) is logged beside each of its timings,
   must reach 264 blocks (two an SM) at the 2^20-doc geometry for Q = 1
   and 16, and torch.profiler reports its device time over 20 launches of
   1a (and of 1b in phase 2b), the kernel body alone. Then the dense kernel is
   held bit for bit against its plain version on ``band_edge_corpus``
   (postings on both sides of every band edge, at the packed cap of 2^20
   docs) on every rung of the ladder (sub 128 .. 1), Q 1, 2 and 16, with
   and without counts, raw and packed, and on the bench corpus at Q = 2.
   "[phase 2 segsum]" holds kernel 2 (segment sum) against its plain
   version on the card in six cases: the f32-mask form at the 1M bench
   geometry (the venue column's 2,000 zipf ordinals over queries[0]'s
   matched docs, year values times noise), count + sum and count only;
   the gather form (the main path's: flat_docs, flat_ords and the matched
   bytes, gathered inside the kernel) count only, and with sums over the
   f64 year column; 2^18 zipf ordinals over the same 1M docs (a keyword
   field of ids: the atomic path); and an ingest shard's 4,096 docs (one
   CTA). Counts
   bit-equal, sums within 1e-4 x sum |value| + 1e-3 of plain, and on the
   shared-memory path two launches give bit-equal sums; each case logs
   its plan (path, grid, threads, kernels) and says when it is not the
   main path's. The combine pass is held bit for bit alone, and
   torch.profiler counts the device kernels of one ``ordinal_counts``
   call (at most two, both the segment sum's).
   "[phase 2 select]" holds the fused top-k kernels' selection on
   tie-heavy inputs (``tie_corpus``: equal frac and weights;
   ``tie_vectors``: duplicated embedding rows, a dead tail) at every
   cluster size a plan can take there, k 1, 10, 16, 100 and W, Q 1, 2 and
   16: the top-k tile kernel raw and packed, all rows and sel mode with
   zeroed rows, and kernel 3 cosine and dot_product, each bit-equal to its
   plain version. Every fused top-k timing logs its plan (cluster size C,
   band docs, query group, CTAs).
3. The write path through ``Node(device="cuda")``: ``bulk`` ~20k zipfian
   docs into 5 shards, ``refresh``, ~50 requests (match or/and/
   minimum_should_match, bool with term + range filters, match_all, a
   terms aggregation), deletes, refresh, requests again.
4. Real size through ``Node(device="cuda")``: a 1-shard index whose engine
   adopts the phase-2 corpus as one ``Segment.from_arrays`` segment; the
   same kinds of requests, deletes, requests again.
5. Checks: every response of phases 3-4 against a ``Node(device="cpu")``
   over the same host arrays (ids exact up to ties within rtol 1e-5,
   totals and buckets exact, scores within rtol 1e-5); the 1M-doc match
   top-10 against ``reference_scores`` (recall@10 = 1.0); both kernels
   launched in each main-path phase (counts zeroed just before it), and
   every 1a launch of phases 3, 4 and 7 held bit for bit against its plain
   version on the inputs the path gave it, and every segment-sum call of
   their terms aggregations replayed through its plain version (counts
   equal); the device kernels of one phase-4 terms_agg request. Prints
   p50 latency per request kind and plane and the per-segment host copy of
   the dense scores and mask.
6. The kernel summary line, then the device line.

Run between phases 2 and 3, and after phase 4 (phase 10 after phase 9):

2b. Kernels 1b (dense, q_batch=16, with and without counts) and 1c (fused
    per-tile top-k, q_batch 1 and 16, k=16) on the 1M-doc corpus, for 16
    queries from ``query_draws`` and for the same batch with the top-10
    rank ladder query in it: bit-equal to their plain versions, each
    batched member bit-equal to its own q_batch=1 dense output; timed
    beside the bound (the union's rows read once), the plain version and
    the library call
    (one ``index_add_`` of w_q * frac into [Q, nd_pad + 1], plus
    ``torch.topk`` per tile for 1c).
7. The mesh plane at real size, configuration ``pmc-4x256k``: a 4-shard
   ``Node(device="cuda")`` index whose shards each adopt one 262,144-doc
   segment (the same generator, seeds 7-10): 4 slots on one card. Phase
   3's request kinds served serially; match, bool and
   minimum_should_match must report ``"_plane": "mesh_pallas"`` (match_all
   ``mesh``); every response equals a cpu node over the same arrays and
   the same card node's host rung (``index.search.mesh: false``);
   recall@10 = 1.0; deletes, refresh (the staging is rebuilt), again.
8. Bursts: ``IndexService.search_batch`` with 16 match bodies on pmc-4x256k
   (rung 1, mesh_pallas, kernel 1c) and on phase 3's 5-shard index (rung
   2, host, kernel 1b), every member equal to its serial response, and
   every 1b/1c launch of those bursts (the stacked 262k-doc slots, the
   ingest index's small segments) bit-equal to its plain version on the
   inputs the path gave it; then 16 threads at ``Node.search`` (three
   rounds) to show that the micro-batcher forms batches; zero plane
   faults on every index.

2c. Kernel 3 (kNN scoring, fused per-tile top-k) against its plain version
    on the card, bit for bit (scores and docs), in these cases: 1,048,576
    docs of 128 dims, cosine, Q = 1 and 16 (bench.py's knn_top10 shape);
    one 262,144-doc slot (the mesh rung's shape) at Q = 1 with k 10 (>= 256
    CTAs) and 100, and at Q = 16 with k 10 (one query group of 16);
    262,144 docs of 768 dims, dot_product, Q = 4; three slots of 262,144 /
    150,000 / 90,000 rows in one 262,144-doc geometry (rows beyond a
    slot's count are dead), cosine, Q = 4. The vectors are bench.py's
    generator (``RandomState(23)`` standard normal, bf16-rounded; here
    every 97th doc has none). Each is timed beside its bound, the plain
    version and the library call (``emb.float() @ q.T``, scale, mask and
    ``torch.topk`` per tile, TF32 off).
2d. Kernels 1d (packed codec) and 1e (tile subsets) on the phase-2 corpus,
    whose 2^20-doc space is exactly the packed word's doc cap (every doc at
    or above 2^19 sets its word's sign bit): 1d dense Q=1 with and without
    counts, dense Q=16, top-k Q=1 and 16; 1e raw and packed with an 8-tile
    probe set and a rest set with about half its rows zeroed, Q=1 and 16;
    the whole ``score_tiles_pruned`` orchestration (its plain form runs the
    same orchestration over the plain versions). Each bit-equal to its
    plain version, timed beside its byte bound (4 bytes a packed posting;
    only the scored tiles' rows for 1e), the plain version and the library
    call (the decode plus ``index_add_``, and ``torch.topk`` per tile for
    the top-k forms, over the scored tiles for 1e).
10. Packed postings and block-max pruning through ``Node(device="cuda")``
    on pmc-4x256k (phase 7's arrays as new segments; node settings
    ``search.pallas.postings_codec: packed``,
    ``search.pallas.pruning.enabled: true``,
    ``search.pallas.pruning.probe_tiles: 8``): serial match queries on
    ``mesh_pallas`` with ``_pruned``, hits and scores equal to a packed
    exhaustive index on the card and bit for bit to the cpu node,
    recall@10 = 1.0 against ``reference_scores`` over the dequantized frac
    (against the raw frac: reported); bool queries and the exhaustive
    fallbacks (terms agg, operator and, minimum_should_match, size 0,
    post_filter) exact and unmarked; the packed host rung (4 shards
    without the mesh, one shard, phase 3's 5-shard index re-staged packed);
    raw pruning on phase 7's own segments (kernel 1e raw); bursts (one
    ``search_batch`` of 16 each on the pruned, the packed exhaustive and
    the packed 5-shard index, then 16 threads at ``Node.search``, members
    equal to their serial responses, serial total <= member total <=
    exact total); deletes, then the match queries again. Every 1d / 1e
    launch of the phase is held bit for bit against its plain version on
    its real inputs, and the first 1e packed and 1e raw launches at Q = 1
    and at Q > 1 are timed on those inputs (plan, bound, plain version,
    library call; an 8-tile set at Q = 1 must launch >= 128 CTAs); every
    new launch name must have moved; zero plane faults. Prints the pruned
    tile fraction, the staged posting bytes packed and raw, and p50 for
    raw exhaustive, packed exhaustive and packed pruned matches.
9. kNN through ``Node(device="cuda")`` on pmc-4x256k with the phase-2c
   vectors as a ``dense_vector`` field ``emb`` (128 dims, cosine; 268 MB
   of bf16 on the card): serial pure kNN on ``mesh_pallas`` (k 10 and
   100, size/from), bit for bit equal to the cpu node; the same arrays on
   the host rung (``index.search.mesh: false``, and a 1-shard index) and
   filtered kNN, equal to the cpu node within the host rung's tolerance;
   hybrid RRF and convex (``_hybrid`` names both planes); a 16-thread
   burst and one ``search_batch`` of 16 (``knn_served_batched``, every
   kernel-3 launch held bit for bit against its plain version on its real
   inputs, every member equal to its serial response); deletes, then again
   (no deleted doc returned, totals drop); recall@10 = 1.0 against
   ``reference_knn_topk``; the mesh plane's kNN staging (the per-slot
   masks) beside the segments' own vector arrays.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time

import numpy as np

N_DOCS = 1_000_000
AVG_DOC_LEN = 80
VOCAB = 50_000
N_ORDS = 2000
BLOCK = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = 1e-5
INGEST_DOCS = 20_000
# pmc-4x256k: four shards of one 262,144-doc segment each (seeds 7-10)
MESH_SHARD_DOCS = 262_144
MESH_SEEDS = (7, 8, 9, 10)
BURST = 16
# the kernels each serial host-rung phase must launch
HOST_PATH_KERNELS = ("tile_scoring", "segment_sum")
# kNN vectors (bench.py's knn_top10 generator): 4 x 262,144 docs
KNN_DIMS = 128
KNN_SEED = 23
KNN_MISSING_EVERY = 97
# phase 2c's last case: three segments' rows in one 262,144-doc geometry
KNN_SLOT_ROWS = (MESH_SHARD_DOCS, 150_000, 90_000)

FAILS = []


def check(ok: bool, what: str) -> None:
    if not ok:
        FAILS.append(what)
        print(f"CHECK FAILED: {what}", flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float):
    """The least time in ms the card could take for a function that must
    move ``nbytes`` and do ``ops`` float32 operations: the larger of the
    two over the card's peak rates, and which one it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ----------------------------------------------------------------------
# Corpus (a copy of bench.py's build_synthetic_corpus / pack_postings)
# ----------------------------------------------------------------------


def pack_postings(term_ids, docs, tfs, vocab, nd_pad):
    term_start = np.searchsorted(term_ids, np.arange(vocab))
    term_end = np.searchsorted(term_ids, np.arange(vocab) + 1)
    term_df = (term_end - term_start).astype(np.int64)
    n_blocks_per_term = -(-term_df // BLOCK)
    total_blocks = max(int(n_blocks_per_term.sum()), 1)
    block_docs = np.full((total_blocks, BLOCK), nd_pad, dtype=np.int32)
    block_tfs = np.zeros((total_blocks, BLOCK), dtype=np.float32)
    term_block_start = np.concatenate(
        [[0], np.cumsum(n_blocks_per_term)[:-1]])
    within = np.arange(len(term_ids), dtype=np.int64) - term_start[term_ids]
    rows = term_block_start[term_ids] + within // BLOCK
    lanes = within % BLOCK
    block_docs[rows, lanes] = docs
    block_tfs[rows, lanes] = tfs.astype(np.float32)
    return (block_docs, block_tfs, term_block_start, n_blocks_per_term,
            term_df)


def build_synthetic_corpus(seed=7, n_docs=N_DOCS):
    rng = np.random.RandomState(seed)
    nd_pad = 1
    while nd_pad < n_docs:
        nd_pad *= 2
    doc_len = np.clip(
        rng.lognormal(np.log(AVG_DOC_LEN), 0.4, n_docs), 5, 500
    ).astype(np.int64)
    total_tokens = int(doc_len.sum())
    ranks = np.arange(1, VOCAB + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    tokens = rng.choice(VOCAB, total_tokens, p=probs).astype(np.int32)
    doc_of_token = np.repeat(np.arange(n_docs, dtype=np.int32), doc_len)
    keys = tokens.astype(np.int64) * n_docs + doc_of_token
    uniq, counts = np.unique(keys, return_counts=True)
    term_ids = (uniq // n_docs).astype(np.int32)
    docs = (uniq % n_docs).astype(np.int32)
    tfs = counts.astype(np.float32)
    (block_docs, block_tfs, term_block_start, n_blocks_per_term,
     term_df) = pack_postings(term_ids, docs, tfs, VOCAB, nd_pad)
    norms = np.ones((1, nd_pad + 1), dtype=np.float32)
    norms[0, :n_docs] = doc_len.astype(np.float32)
    kranks = np.arange(1, N_ORDS + 1)
    kprobs = (1.0 / kranks) / (1.0 / kranks).sum()
    keyword_ord = rng.choice(N_ORDS, n_docs, p=kprobs).astype(np.int32)
    year = (1990 + rng.randint(0, 35, n_docs)).astype(np.float64)
    return {"n_docs": n_docs,
        "block_docs": block_docs, "block_tfs": block_tfs, "norms": norms,
        "term_block_start": term_block_start,
        "n_blocks_per_term": n_blocks_per_term, "term_df": term_df,
        "nd_pad": nd_pad, "keyword_ord": keyword_ord, "year": year,
        "sum_ttf": total_tokens,
    }


def band_edge_corpus(nd_pad=1 << 20, seed=3):
    """Six terms whose postings sit where the dense kernel's bands meet:
    both sides of every 128-doc edge (every band edge of every plan, tile
    edges included), a uniform random term, the edges of 2048-doc bands
    only, the doc space's ends and its middle (2^19 at the packed cap: the
    first doc whose word has the sign bit set), a dense run across the
    middle, and mid-band docs. tf 1-3, lognormal doc lengths, 10 % of the
    docs deleted. Members (lanes as (term, weight)): the first has a dead
    (zero-weight) lane, the second shares terms with it, the 16 include an
    empty member and a repeat of the first. Returns a dict of the block
    arrays, the terms' row runs, the live mask and the members."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc

    rng = np.random.RandomState(seed)
    edges = np.arange(BLOCK, nd_pad, BLOCK)
    mid = nd_pad // 2
    run = min(3000, nd_pad // 8)
    terms = [np.union1d(edges - 1, edges),
             rng.choice(nd_pad, nd_pad // 40, replace=False),
             np.union1d(np.arange(0, nd_pad, 2048),
                        np.arange(2047, nd_pad, 2048)),
             np.array([0, 127, 128, mid - 1, mid, nd_pad - 2, nd_pad - 1]),
             np.arange(mid - run, mid + run),
             edges[::7] + 64]
    docs_rows, tf_rows, start, count = [], [], [], []
    for docs in terms:
        docs = np.unique(docs).astype(np.int32)
        n = -(-len(docs) // BLOCK)
        d = np.full((n, BLOCK), nd_pad, np.int32)
        tf = np.zeros((n, BLOCK), np.float32)
        d.reshape(-1)[: len(docs)] = docs
        tf.reshape(-1)[: len(docs)] = rng.randint(1, 4, len(docs))
        start.append(sum(len(x) for x in docs_rows))
        count.append(n)
        docs_rows.append(d)
        tf_rows.append(tf)
    block_docs = np.concatenate(docs_rows)
    block_tfs = np.concatenate(tf_rows)
    doc_len = np.clip(rng.lognormal(np.log(40), 0.5, nd_pad + 1), 3,
                      300).astype(np.float32)
    frac = tsc.compute_block_frac(block_docs, block_tfs, doc_len,
                                  float(doc_len.mean()))
    live = rng.rand(nd_pad) >= 0.1
    members = [[(0, 1.25), (1, 0.75), (3, 2.0), (4, 0.5), (5, 0.0)],
               [(2, 1.5), (4, 0.25), (1, 1.0)]]
    for q in range(2, BURST):
        if q == 7:
            members.append([])
        elif q == 11:
            members.append(list(members[0]))
        else:
            pick = rng.choice(len(terms), rng.randint(1, 5), replace=False)
            members.append([(int(t), float(np.float32(rng.uniform(0.2, 3.0))))
                            for t in pick])
    return {"block_docs": block_docs, "block_tfs": block_tfs, "frac": frac,
            "term_start": start, "term_rows": count, "nd_pad": nd_pad,
            "live": live, "members": members}


def band_edge_tables(tsc, corpus, sub, q_batch):
    """(geometry, row_lo, row_hi, weights, cb) of the first ``q_batch``
    members on the ``sub`` rung: a single query's table at Q = 1, the
    union's otherwise."""
    geom = tsc.tile_geometry(corpus["nd_pad"], sub)
    bmin, bmax = tsc.block_min_max(corpus["block_docs"], corpus["block_tfs"],
                                   corpus["nd_pad"])
    sets = [[tsc.QueryLane(corpus["term_start"][t], corpus["term_rows"][t], w)
             for t, w in m] for m in corpus["members"][:q_batch]]
    build = (tsc.build_tile_tables if q_batch == 1 else
             tsc.build_tile_tables_batched)
    return (geom, *build(sets[0] if q_batch == 1 else sets, bmin, bmax, geom))


def term_token(rank_index: int) -> str:
    return f"t{rank_index:05d}"


class _Sources:
    """Stored sources of the adopted corpus, made on demand."""

    def __init__(self, corpus):
        self._venue = corpus["keyword_ord"]
        self._year = corpus["year"]

    def __len__(self):
        return len(self._year)

    def __getitem__(self, d):
        return {"n": int(d), "venue": f"v{int(self._venue[d]):04d}",
                "year": int(self._year[d])}


def corpus_segment_arrays(corpus, id_prefix="p"):
    """The Segment.from_arrays fields for the corpus (one text field
    ``title``, keyword ``venue``, long ``year``)."""
    from elasticsearch_tpu_torch.index.segment import FIELD_SEP

    n = corpus["n_docs"]
    nd_pad = corpus["nd_pad"]
    cap = nd_pad  # next_pow2(n)
    flat_docs = np.full(cap, nd_pad, np.int32)
    flat_docs[:n] = np.arange(n, dtype=np.int32)
    flat_ords = np.zeros(cap, np.int32)
    flat_ords[:n] = corpus["keyword_ord"]
    first_ord = np.full(nd_pad, -1, np.int32)
    first_ord[:n] = corpus["keyword_ord"]
    exists = np.zeros(nd_pad, bool)
    exists[:n] = True
    vals = np.zeros(cap, np.float64)
    vals[:n] = corpus["year"]
    first_value = np.zeros(nd_pad, np.float64)
    first_value[:n] = corpus["year"]
    minv = np.full(nd_pad, np.inf)
    minv[:n] = corpus["year"]
    maxv = np.full(nd_pad, -np.inf)
    maxv[:n] = corpus["year"]
    live = np.zeros(nd_pad, bool)
    live[:n] = True
    return dict(
        term_keys=[f"title{FIELD_SEP}{term_token(i)}" for i in range(VOCAB)],
        term_block_start=corpus["term_block_start"],
        term_block_count=corpus["n_blocks_per_term"],
        term_doc_freq=corpus["term_df"],
        block_docs=corpus["block_docs"], block_tfs=corpus["block_tfs"],
        norms=corpus["norms"], live=live,
        field_stats={"title": {"doc_count": n,
                               "sum_ttf": corpus["sum_ttf"]}},
        field_norm_idx={"title": 0},
        doc_ids=[f"{id_prefix}{i}" for i in range(n)],
        sources=_Sources(corpus),
        numeric_columns={"year": dict(
            flat_values=vals, flat_docs=flat_docs, first_value=first_value,
            min_value=minv, max_value=maxv, exists=exists, count=n)},
        ordinal_columns={"venue": dict(
            terms=[f"v{o:04d}" for o in range(N_ORDS)], flat_ords=flat_ords,
            flat_docs=flat_docs, first_ord=first_ord, exists=exists,
            count=n)},
    )


# ----------------------------------------------------------------------
# Timing
# ----------------------------------------------------------------------


class Timer:
    """Median of CUDA-event timings, L2 flushed before each launch. A spin
    kernel of SPIN_CYCLES runs between the flush and the start event, so
    the card is still busy when the host has enqueued ``fn``: the events
    time the device work of ``fn``, not the host's time to enqueue it."""

    SPIN_CYCLES = 300_000  # about 0.17 ms at the H100's boost clock

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps=25, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))


def query_draws(seed=11, n=24):
    """3-term queries zipfian over ranks 50..1049 (bench.py:1091-1098)."""
    rng = np.random.RandomState(seed)
    qvocab = np.arange(50, 1050)
    ranks = np.arange(1, len(qvocab) + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    return [list(np.unique(rng.choice(qvocab, 3, p=probs))) for _ in range(n)]


# ----------------------------------------------------------------------
# Response comparison
# ----------------------------------------------------------------------


def same_response(gr, cr, what):
    """Totals and buckets exact, scores within RTOL, ids exact except
    among hits tied within RTOL (compared as sets)."""
    ok = gr["hits"]["total"] == cr["hits"]["total"]
    gh, ch = gr["hits"]["hits"], cr["hits"]["hits"]
    ok = ok and len(gh) == len(ch)
    if ok and gh:
        gs = np.array([h["_score"] for h in gh])
        cs = np.array([h["_score"] for h in ch])
        ok = bool(np.allclose(gs, cs, rtol=RTOL, atol=1e-7))
        i = 0
        while ok and i < len(ch):
            j = i + 1
            while j < len(ch) and abs(cs[j] - cs[i]) <= RTOL * abs(cs[i]) + 1e-7:
                j += 1
            ok = {h["_id"] for h in gh[i:j]} == {h["_id"] for h in ch[i:j]}
            i = j
    ok = ok and gr.get("aggregations") == cr.get("aggregations")
    check(ok, f"cuda response equals cpu response: {what}")


def requests_for(queries, top_rank_term, venue_term, year_lo):
    tok = term_token
    reqs = []
    for i, q in enumerate(queries):
        text = " ".join(tok(t) for t in q)
        kind = ("match_or", "match_and", "match_msm")[i % 3]
        if kind == "match_or":
            body = {"query": {"match": {"title": text}}}
        elif kind == "match_and":
            body = {"query": {"match": {"title": {"query": " ".join(
                tok(t) for t in q[:2]), "operator": "and"}}}}
        else:
            body = {"query": {"match": {"title": {
                "query": text, "minimum_should_match": 2}}}}
        reqs.append((kind, body, q if kind == "match_or" else None))
    for q in queries[:6]:
        reqs.append(("bool_filtered", {"query": {"bool": {
            "must": [{"match": {"title": " ".join(tok(t) for t in q)}}],
            "filter": [{"term": {"venue": venue_term}},
                       {"range": {"year": {"gte": year_lo}}}]}}}, None))
    ladder = [top_rank_term] + list(queries[0][:2])
    reqs.append(("match_ladder", {"query": {"match": {"title": " ".join(
        tok(t) for t in ladder)}}}, ladder))
    for _ in range(3):
        reqs.append(("match_all", {"query": {"match_all": {}}}, None))
    for q in queries[:5]:
        reqs.append(("terms_agg", {"size": 0, "query": {"match": {
            "title": " ".join(tok(t) for t in q)}},
            "aggs": {"venues": {"terms": {"field": "venue", "size": 10}}}},
            None))
    return reqs


def serve(gnode, cnode, index, reqs, label, lat, ref=None,
          plane_of=lambda kind: "host", also=None):
    """Serve each request on the cuda node (timed) and the cpu node,
    compare; check the plane each kind must be served by; ``also`` is a
    second (node, index) whose responses must equal too; ``ref(terms) ->
    (scores, index_of_id)`` checks recall@10."""
    import torch

    recalls = []
    planes = {}
    for kind, body, terms in reqs:
        t0 = time.perf_counter()
        gr = gnode.search(index, body)
        torch.cuda.synchronize()
        lat.setdefault(f"{label.split()[1]}/{kind}@{gr['_plane']}",
                       []).append((time.perf_counter() - t0) * 1000)
        cr = cnode.search(index, body)
        what = f"{label} {kind} {json.dumps(body)[:120]}"
        same_response(gr, cr, what)
        if also is not None:
            t0 = time.perf_counter()
            ar = also[0].search(also[1], body)
            torch.cuda.synchronize()
            lat.setdefault(
                f"{label.split()[1]}/{kind}@{ar['_plane']} ({also[1]})",
                []).append((time.perf_counter() - t0) * 1000)
            same_response(gr, ar, f"{what} (vs {also[1]})")
        planes.setdefault(kind, set()).add(gr["_plane"])
        check(gr["_plane"] == cr["_plane"] == plane_of(kind),
              f"{label} {kind}: plane {gr['_plane']} (cpu {cr['_plane']}), "
              f"want {plane_of(kind)}")
        if ref is not None and terms is not None:
            scores, index_of = ref(terms)
            k = min(10, int((scores > 0).sum()))
            if k:
                kth = np.sort(scores)[::-1][k - 1]
                got = [index_of(h["_id"]) for h in gr["hits"]["hits"][:10]]
                hit = sum(1 for d in got if scores[d] >= kth * (1 - 1e-6))
                recalls.append(hit / k)
    log(f"[{label}] planes per request kind: "
        f"{ {k: sorted(v) for k, v in planes.items()} }")
    return recalls


def node_with_mapping(Node, device, shards):
    n = Node(device=device)
    n.create_index("docs" if shards > 1 else "pmc", {
        "settings": {"number_of_shards": shards},
        "mappings": {"_doc": {"properties": {
            "title": {"type": "text"}, "venue": {"type": "keyword"},
            "year": {"type": "long"}}}}})
    return n


def host_copy_note(node, index, n_queries, label):
    svc = node.indices[index]
    secs = sum(s.searcher.host_copy_seconds for s in svc.shards.values())
    nseg = sum(s.searcher.host_copy_segments for s in svc.shards.values())
    nbytes = sum(s.searcher.host_copy_bytes for s in svc.shards.values())
    log(f"[{label}] host copy of dense scores+mask: {nseg} segment copies, "
        f"{nbytes / max(nseg, 1) / 1e6:.3f} MB and "
        f"{secs * 1000 / max(nseg, 1):.4f} ms per segment, "
        f"{secs * 1000 / max(n_queries, 1):.4f} ms per query")
    return {"ms_per_segment": secs * 1000 / max(nseg, 1),
            "ms_per_query": secs * 1000 / max(n_queries, 1),
            "mb_per_segment": nbytes / max(nseg, 1) / 1e6}


def zero_searcher_counters(node):
    for svc in node.indices.values():
        for s in svc.shards.values():
            s.searcher.host_copy_seconds = 0.0
            s.searcher.host_copy_bytes = 0
            s.searcher.host_copy_segments = 0


# ----------------------------------------------------------------------
# Kernels 1b and 1c at bench shapes
# ----------------------------------------------------------------------


def _batched_tables(tsc, seg, sets):
    """The union's tables on the geometry ladder (the walk of
    batched_segment_scores); returns (geometry, live key, tables)."""
    geom = seg.kernel_geom
    sub = geom.tile_sub
    while True:
        g = geom if sub == geom.tile_sub else tsc.tile_geometry(
            geom.nd_pad, sub)
        try:
            tables = tsc.build_tile_tables_batched(
                sets, seg.kernel_bmin, seg.kernel_bmax, g)
            break
        except ValueError:
            sub //= 2
    live_key = ("k_live_t" if g.tile_sub == geom.tile_sub
                else seg.kernel_live_t_for(g.tile_sub))
    return g, live_key, tables


def batch_kernels_phase(torch, dev, gseg, gdev, timer, queries,
                        top_rank_term):
    """Kernels 1b (dense, q_batch=16, with and without counts) and 1c
    (fused top-k, q_batch 1 and 16, kk=16) against their plain versions,
    each batched member against its own q_batch=1 dense output, and their
    times beside the byte bound, the plain version and a library call."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.search import query_dsl as Q

    def lanes_of(terms):
        arrs = Q.term_blocks_arrays(
            gseg, [("title", term_token(t), 1.0) for t in terms])
        return [tsc.QueryLane(s, c, w) for s, c, w, _ in arrs["lanes_meta"]]

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    draws = [lanes_of(q) for q in queries[:BURST]]
    batches = {"draws": draws,
               "ladder": [lanes_of([top_rank_term] + list(queries[0][:2]))]
               + draws[1:]}
    errs = {"tile_scoring_batched": 0.0, "tile_scoring_topk": 0.0}
    entries = {}
    kk = 16
    for name, sets in batches.items():
        g, live_key, (rl, rh, w, cb) = _batched_tables(tsc, gseg, sets)
        sub = g.tile_sub
        qn = len(sets)
        args = [gdev["k_docs"], gdev["k_frac"], gdev[live_key],
                on_dev(rl), on_dev(rh), on_dev(w)]
        kw = dict(t_pad=rl.shape[1], cb=cb, sub=sub)
        for wc in (False, True):
            k_out = tsc.score_tiles(*args, **kw, dense=True, with_counts=wc,
                                    q_batch=qn)
            p_out = tsc.score_tiles_plain(*args, sub=sub, with_counts=wc,
                                          q_batch=qn)
            torch.cuda.synchronize()
            errs["tile_scoring_batched"] = max(
                errs["tile_scoring_batched"], float(
                (k_out[0] - p_out[0]).abs().max()))
            check(torch.equal(k_out[0], p_out[0]),
                  f"1b scores bit-equal plain ({name}, counts={wc})")
            if wc:
                check(torch.equal(k_out[1], p_out[1]),
                      f"1b counts equal plain ({name})")
            for q in range(qn):
                r1, h1, w1, cb1 = tsc.build_tile_tables(
                    sets[q], gseg.kernel_bmin, gseg.kernel_bmax, g)
                one = tsc.score_tiles(
                    *args[:3], on_dev(r1), on_dev(h1), on_dev(w1),
                    t_pad=r1.shape[1], cb=cb1, sub=sub, dense=True,
                    with_counts=wc)
                same = torch.equal(one[0], k_out[0][q]) and (
                    not wc or torch.equal(one[1], k_out[1][q]))
                check(same, f"1b member {q} bit-equal its q_batch=1 dense "
                      f"output ({name}, counts={wc})")
        for qb in (1, qn):
            wq = args[5][:qb].contiguous()
            k_out = tsc.score_tiles(*args[:5], wq, **kw, k=kk, dense=False,
                                    q_batch=qb)
            p_out = tsc.score_tiles_topk_plain(*args[:5], wq, sub=sub, k=kk)
            torch.cuda.synchronize()
            fin = torch.isfinite(p_out[0])
            errs["tile_scoring_topk"] = max(errs["tile_scoring_topk"], float(
                (k_out[0][fin] - p_out[0][fin]).abs().max()))
            check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)),
                  f"1c scores, docs and hits equal plain ({name}, Q={qb})")
        # bytes each function must move: the union's posting rows once
        # (doc i32 + frac f32), the live mask, the tables, the outputs
        union, wmat = tsc.union_query_lanes(sets)
        rows = sum(ln.block_count for ln in union)
        n_tiles = rl.shape[0]
        nd_geom = n_tiles * sub * tsc.LANE
        tables = rl.nbytes + rh.nbytes + w.nbytes
        base = rows * tsc.LANE * 8 + nd_geom * 4 + tables
        rows1 = sum(ln.block_count for ln in sets[0])
        # operations: a multiply and an add per posting and query that
        # weights its lane (one more add with counts); the top-k selects
        # over every doc of each (tile, query): one compare a doc
        postings_q = sum(ln.block_count for lanes in sets
                         for ln in lanes) * tsc.LANE
        select_ops = n_tiles * sub * tsc.LANE * qn
        b_dense = bound(base + qn * nd_geom * 4, 2 * postings_q)
        b_dense_c = bound(base + 2 * qn * nd_geom * 4, 3 * postings_q)
        b_topk = bound(base + n_tiles * qn * (kk * 8 + 4),
                       2 * postings_q + select_ops)
        b_topk1 = bound(rows1 * tsc.LANE * 8 + nd_geom * 4 + rl.nbytes
                        + rh.nbytes + w[:1].nbytes + n_tiles * (kk * 8 + 4),
                        2 * rows1 * tsc.LANE + select_ops // qn)
        # the library yardstick: one index_add_ of w_q * frac into a
        # [Q, nd_pad + 1] buffer (and, for 1c, torch.topk per tile)
        nd1 = gseg.nd_pad + 1
        idx, val, q_parts = [], [], []
        for j, ln in enumerate(union):
            r = slice(ln.block_start, ln.block_start + ln.block_count)
            docs = gdev["k_docs"][r].reshape(-1).long()
            frac = gdev["k_frac"][r].reshape(-1)
            for q in range(qn):
                if wmat[q, j] > 0:
                    idx.append(docs + q * nd1)
                    val.append(frac * float(wmat[q, j]))
                    q_parts.append(q)
        idx_parts, val_parts = idx, val
        idx, val = torch.cat(idx), torch.cat(val)
        buf = torch.zeros(qn * nd1, device=dev)
        w_tile = sub * tsc.LANE

        def library_topk():
            dense = buf.index_add_(0, idx, val).reshape(qn, nd1)
            return torch.topk(dense[:, : n_tiles * w_tile].reshape(
                qn, n_tiles, w_tile), kk, dim=2)

        # the same for the first query alone (1c at Q=1)
        first = torch.cat([d for d, q in zip(idx_parts, q_parts) if q == 0])
        first_val = torch.cat([v for v, q in zip(val_parts, q_parts)
                               if q == 0])
        buf1 = torch.zeros(nd1, device=dev)

        def library_topk_q1():
            dense = buf1.index_add_(0, first, first_val)
            return torch.topk(dense[: n_tiles * w_tile].reshape(
                n_tiles, w_tile), kk, dim=1)

        e = {
            "sub": sub, "q_batch": qn, "t_pad": int(rl.shape[1]),
            "n_tiles": int(n_tiles), "union_lanes": len(union),
            "union_posting_rows": int(rows),
            "batched_ms": timer.ms(lambda: tsc.score_tiles(
                *args, **kw, dense=True, q_batch=qn)),
            "batched_ms_with_counts": timer.ms(lambda: tsc.score_tiles(
                *args, **kw, dense=True, with_counts=True, q_batch=qn)),
            "batched_plain_ms": timer.ms(lambda: tsc.score_tiles_plain(
                *args, sub=sub, q_batch=qn), reps=5, warmup=1),
            "batched_library_ms": timer.ms(
                lambda: buf.index_add_(0, idx, val)),
            "batched_bound_ms": b_dense[0], "batched_bound_by": b_dense[1],
            "batched_bound_ms_with_counts": b_dense_c[0],
            "topk_ms": timer.ms(lambda: tsc.score_tiles(
                *args, **kw, k=kk, dense=False, q_batch=qn)),
            "topk_q1_ms": timer.ms(lambda: tsc.score_tiles(
                *args[:5], args[5][:1].contiguous(), **kw, k=kk,
                dense=False, q_batch=1)),
            "topk_plain_ms": timer.ms(lambda: tsc.score_tiles_topk_plain(
                *args, sub=sub, k=kk), reps=5, warmup=1),
            "topk_library_ms": timer.ms(library_topk),
            "topk_q1_library_ms": timer.ms(library_topk_q1),
            "topk_bound_ms": b_topk[0], "topk_bound_by": b_topk[1],
            "topk_q1_bound_ms": b_topk1[0],
            "topk_plan": topk_plan(tsc, "tile", sub, qn, kk, n_tiles,
                                   rl.shape[1], False, dev),
            "topk_q1_plan": topk_plan(tsc, "tile", sub, 1, kk, n_tiles,
                                      rl.shape[1], False, dev),
            "batched_plan": dense_plan(tsc, sub, qn, False, rl.shape[1],
                                       n_tiles),
            "batched_plan_with_counts": dense_plan(tsc, sub, qn, True,
                                                   rl.shape[1], n_tiles),
        }
        if name == "draws":
            e["batched_profiler_ms"], e["batched_profiler_launches"] = \
                profiled_dense_ms(torch, timer, lambda: tsc.score_tiles(
                    *args, **kw, dense=True, q_batch=qn))
            for key in ("batched_plan", "batched_plan_with_counts"):
                check(nd_geom == 1 << 20 and e[key]["blocks"] >= 264,
                      f"1b at the 2^20-doc bench geometry launches >= 264 "
                      f"blocks ({key} {e[key]})")
        entries[name] = e
        log(f"[phase 2b] batch {name}: {json.dumps(e)}")
    return entries, errs


# ----------------------------------------------------------------------
# Kernel 2 (segment sum) in both forms, at the shapes the path gives it
# ----------------------------------------------------------------------

# a keyword field of ids: 2^18 ordinals, zipf s=1, over the 1M-doc column
HIGH_CARD_ORDS = 1 << 18
# an ingest shard's ordinal column (phase 3: ~4,000 docs a shard)
SMALL_DOCS = 4096
# the kernels ordinal_counts issued a call before this design, read from
# the code: the i32 -> i64 copy, the gather, the bool -> f32 convert, the
# zero-fill of the counts, the kernel
ORDINAL_COUNTS_KERNELS_BEFORE = 5


def zipf_ords(n, n_ords, seed):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n_ords + 1)
    return rng.choice(n_ords, n, p=p / p.sum()).astype(np.int32)


def plan_note(plan, main):
    """Which of the plan's choices differ from the main path's plan."""
    diff = [f"{k} {getattr(plan, k)} (main path {getattr(main, k)})"
            for k in ("path", "grid", "threads") if getattr(plan, k)
            != getattr(main, k)]
    return "the main path's plan" if not diff else \
        "plan differs from the main path's: " + ", ".join(diff)


def device_kernels(torch, fn):
    """Names of the device kernels, and of the copies and fills, that one
    call of ``fn`` issued, from torch.profiler (fn runs once before, so
    nothing builds or allocates for the first time inside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    return kernels, [n for n in names if n.startswith(("Memcpy", "Memset"))]


def segment_sum_phase(torch, dev, timer, gseg, matched):
    """[phase 2 segsum]: kernel 2 against its plain version on the card, in
    six cases (the f32-mask form at the 1M bench geometry, with and
    without sums; the gather form, the main path's, with and without sums;
    2^18 ordinals; an ingest shard's 4,096 docs), then the combine pass
    alone. Counts bit-equal to
    plain, sums within ``SUM_RTOL * sum |value| + SUM_ATOL``, and on the
    shared-memory path two launches give bit-equal sums. Returns (cases,
    combine entry, device kernels of one ordinal_counts call)."""
    from elasticsearch_tpu_torch.ops import aggs as agg_ops
    from elasticsearch_tpu_torch.ops import segment_sum as ssum

    t_phase = time.perf_counter()

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ocol = gseg.ordinal_columns["venue"]
    flat_docs = torch.from_numpy(ocol.flat_docs).to(dev)
    ords = torch.from_numpy(ocol.flat_ords).to(dev)
    nd, nd1 = ords.shape[0], matched.shape[0]
    main = ssum.segment_sum_plan(nd, N_ORDS, True, False, n_sm)
    contrib = matched[flat_docs.long()].float().contiguous()
    vals = torch.from_numpy(
        gseg.numeric_columns["year"].flat_values.astype(np.float32)).to(dev)
    vals = (vals * torch.randn(vals.shape[0], device=dev,
                               generator=torch.Generator(dev).manual_seed(3)))
    year_by_doc = torch.from_numpy(np.concatenate([
        gseg.numeric_columns["year"].first_value, [0.0]])).to(dev)
    check(year_by_doc.dtype == torch.float64 and year_by_doc.shape[0] == nd1,
          "the year column by doc is [nd1] float64")
    high = torch.from_numpy(zipf_ords(nd, HIGH_CARD_ORDS, 17)).to(dev)
    cases = []

    def run_case(name, form, args, n_ords, with_sum):
        nd_case = args[0].shape[0]
        p = ssum.segment_sum_plan(nd_case, n_ords, True, with_sum, n_sm)
        if form == "mask":
            o, m, v = args
            v = v if with_sum else None

            def kernel():
                return ssum.segment_counts_sums(o, m, v, n_ords=n_ords)

            def plain():
                return ssum.segment_sum_plain(o, m, v, n_ords=n_ords,
                                              with_count=True,
                                              with_sum=with_sum)
            c_mask, c_vals = m, v
            nbytes = nd_case * (8 + 4 * with_sum) + n_ords * (4 + 4 * with_sum)
        else:
            di, o, mt, vbd = args
            vbd = vbd if with_sum else None

            def kernel():
                return ssum.segment_counts_sums_gathered(
                    di, o, mt, vbd, n_ords=n_ords)

            def plain():
                return ssum.segment_sum_gathered_plain(di, o, mt, vbd,
                                                       n_ords=n_ords)
            inside = (di >= 0) & (di < mt.shape[0])
            j = torch.where(inside, di, 0).long()
            c_mask = (mt[j] & inside).float()
            c_vals = vbd[j].float() if with_sum else None
            # match and values are read only at the docs this call's
            # doc_index reaches inside [0, nd1)
            touched = int(torch.unique(di[inside]).numel())
            nbytes = (nd_case * 8 + touched * (1 + 8 * with_sum)
                      + n_ords * (4 + 8 * with_sum))
        weights = c_mask * c_vals if with_sum else c_mask

        def library():
            return torch.bincount(o, weights=weights, minlength=n_ords)

        note = plan_note(p, main)
        k1, k2, pl = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        check(torch.equal(k1[0], pl[0]),
              f"[phase 2 segsum] {name}: counts bit-equal plain ({note})")
        e = {"case": name, "form": form, "with_sum": with_sum, "nd": nd_case,
             "n_ords": n_ords, "plan": {**p._asdict(), "kernels": p.kernels},
             "max_count": int(k1[0].max()) if n_ords else 0}
        if with_sum:
            valid = (c_mask > 0) & (o >= 0) & (o < n_ords)
            abs_sum = torch.bincount(
                o[valid].long(), weights=ssum.sanitize_values(
                    c_vals)[valid].abs().double(), minlength=n_ords)
            got, want = k1[1].double(), pl[1].double()
            diff = (got - want).abs()
            ok = bool(((got == want) | (diff <= ssum.SUM_RTOL * abs_sum
                                        + ssum.SUM_ATOL)).all())
            check(ok, f"[phase 2 segsum] {name}: sums within "
                      f"{ssum.SUM_RTOL} x sum|value| + {ssum.SUM_ATOL} of "
                      f"plain ({note})")
            bits = torch.int64 if k1[1].dtype == torch.float64 \
                else torch.int32
            same = torch.equal(k1[1].view(bits), k2[1].view(bits))
            if p.path == "smem":
                check(same, f"[phase 2 segsum] {name}: two launches give "
                            f"bit-equal sums on the shared-memory path "
                            f"({note})")
            else:
                log(f"[phase 2 segsum] {name}: atomic path, sums "
                    f"{'bit-equal' if same else 'vary'} between two "
                    f"launches ({note})")
            fin = torch.isfinite(diff)
            e["max_abs_err"] = float(diff[fin].max()) if bool(fin.any()) \
                else 0.0
            e["deterministic"] = same
        else:
            e["max_abs_err"] = 0.0
        b = bound(nbytes, nd_case * (1 + with_sum))
        e.update({"ms": timer.ms(kernel), "plain_ms": timer.ms(plain, reps=10),
                  "library_ms": timer.ms(library), "bound_ms": b[0],
                  "bound_by": b[1], "plan_note": note})
        cases.append(e)
        log(f"[phase 2 segsum] {json.dumps(e)}")
        return e

    bench = run_case("bench_1m", "mask", (ords, contrib, vals), N_ORDS, True)
    run_case("bench_1m_count_only", "mask", (ords, contrib, vals), N_ORDS,
             False)
    gather = run_case("gather_count", "gather",
                      (flat_docs, ords, matched, year_by_doc), N_ORDS, False)
    gather["ordinal_counts_ms"] = timer.ms(
        lambda: agg_ops.ordinal_counts(flat_docs, ords, matched, N_ORDS))
    # the same counts with the gather outside the kernel, as ordinal_counts
    # ran them before: an i64 copy, a gather, an f32 convert, the f32-mask
    # form
    gather["outside_gather_ms"] = timer.ms(
        lambda: ssum.segment_counts_sums(
            ords, matched[flat_docs.long()].to(torch.float32), n_ords=N_ORDS))
    log(f"[phase 2 segsum] main-path form: ordinal_counts "
        f"{gather['ordinal_counts_ms']} ms, its kernels alone "
        f"{gather['ms']} ms, with the gather outside the kernel "
        f"{gather['outside_gather_ms']} ms")
    run_case("gather_sum_year", "gather",
             (flat_docs, ords, matched, year_by_doc), N_ORDS, True)
    run_case("high_card_2^18", "mask", (high, contrib, vals), HIGH_CARD_ORDS,
             True)
    run_case("small_4096", "gather",
             (flat_docs[:SMALL_DOCS].contiguous(),
              ords[:SMALL_DOCS].contiguous(), matched, year_by_doc), N_ORDS,
             True)
    check(bench["plan"]["path"] == "smem" and gather["plan"]["path"] == "smem"
          and cases[4]["plan"]["path"] == "global",
          "the 1M cases take the shared-memory path and 2^18 ordinals the "
          "atomic path")
    check(cases[5]["plan"]["grid"] == 1 and cases[5]["plan"]["kernels"] == 1,
          "an ingest shard's 4,096 docs run as one CTA and one kernel")

    # what the timer allows: one tiny kernel, and one PyTorch reduction
    # over the gather count form's 8 bytes a doc
    tiny = torch.zeros(N_ORDS, dtype=torch.int32, device=dev)
    stream = torch.cat([flat_docs, ords])
    floor = {"one_tiny_kernel_ms": timer.ms(tiny.zero_),
             "sum_of_8_bytes_a_doc_ms": timer.ms(stream.sum)}
    log(f"[phase 2 segsum] timer floor {json.dumps(floor)}")

    # the combine pass alone, at the partials of the 1M count + sum plan
    p1m = ssum.segment_sum_plan(nd, N_ORDS, True, True, n_sm)
    g = torch.Generator(dev).manual_seed(5)
    pc = torch.randint(0, 1 << 12, (p1m.grid, N_ORDS), generator=g,
                       device=dev, dtype=torch.int32)
    pt = torch.randn(p1m.grid, N_ORDS, generator=g, device=dev) * 1e4
    kc, kt = ssum.combine_partials(pc, pt)
    qc, qt = ssum.combine_partials_plain(pc, pt)
    torch.cuda.synchronize()
    check(torch.equal(kc, qc) and torch.equal(kt.view(torch.int32),
                                              qt.view(torch.int32)),
          f"[phase 2 segsum] combine pass bit-equal plain over "
          f"{p1m.grid} partials")
    cb = bound(p1m.grid * N_ORDS * 8 + N_ORDS * 8, 2 * p1m.grid * N_ORDS)
    combine = {"n_parts": p1m.grid, "n_ords": N_ORDS,
               "max_abs_err": float((kt - qt).abs().max()),
               "ms": timer.ms(lambda: ssum.combine_partials(pc, pt)),
               "plain_ms": timer.ms(lambda: ssum.combine_partials_plain(
                   pc, pt), reps=5),
               "library_ms": timer.ms(lambda: torch.sum(pt, 0)),
               "bound_ms": cb[0], "bound_by": cb[1]}
    log(f"[phase 2 segsum] combine {json.dumps(combine)}")

    # the device kernels one ordinal_counts call issues
    kernels, copies = device_kernels(
        torch, lambda: agg_ops.ordinal_counts(flat_docs, ords, matched,
                                              N_ORDS))
    profile = {"before": ORDINAL_COUNTS_KERNELS_BEFORE,
               "after": len(kernels), "kernels": kernels,
               "copies_and_fills": copies}
    log(f"[phase 2 segsum] device kernels of one ordinal_counts call: "
        f"{json.dumps(profile)}")
    check(1 <= len(kernels) <= 2 and not copies
          and all("segment_sum" in k for k in kernels),
          f"ordinal_counts issues at most two device kernels, both the "
          f"segment sum's, and no copy or fill ({kernels}, {copies})")
    profile["timer_floor"] = floor
    log(f"[phase 2 segsum] {time.perf_counter() - t_phase:.1f} s")
    return cases, combine, profile


@contextlib.contextmanager
def recording_segsum_calls(ssum):
    """While the block runs, keep (args, kwargs, outputs) of every gather-
    form segment-sum call on the card (``ordinal_counts`` and
    ``ordinal_sums``): one main pass each, so the count of calls is the
    ``segment_sum`` launch count."""
    orig = ssum.segment_counts_sums_gathered
    kept = []

    def recording(*args, **kw):
        out = orig(*args, **kw)
        if args[0].is_cuda:
            kept.append((args, kw, out))
        return out

    ssum.segment_counts_sums_gathered = recording
    try:
        yield kept
    finally:
        ssum.segment_counts_sums_gathered = orig


def check_kept_segsum(torch, ssum, kept, label):
    """Replay each kept main-path segment-sum call through the plain version
    on the same inputs: counts equal, sums within tolerance."""
    for n, (args, kw, out) in enumerate(kept):
        plain = ssum.segment_sum_gathered_plain(
            *args, n_ords=kw["n_ords"], with_count=kw.get("with_count", True))
        torch.cuda.synchronize()
        ok = out[0] is None or torch.equal(out[0], plain[0])
        if out[1] is not None:
            ok = ok and bool(torch.allclose(out[1], plain[1],
                                            rtol=ssum.SUM_RTOL,
                                            atol=ssum.SUM_ATOL))
        check(ok, f"{label} main-path segment_sum launch {n} (nd "
                  f"{args[0].shape[0]}, n_ords {kw['n_ords']}) equals plain")
    return len(kept)


# ----------------------------------------------------------------------
# The dense kernel's bands: plans, the profiler, the band-edge corpus
# ----------------------------------------------------------------------


def dense_plan(tsc, sub, q_batch, with_counts, t_pad, n_tiles):
    """The (S, G) plan the wrapper gives a dense launch, as a dict."""
    p = tsc.dense_band_plan(sub, q_batch, with_counts, t_pad,
                            n_tiles=n_tiles)
    return {"band_sub": p.band_sub, "band_docs": p.band_sub * tsc.LANE,
            "group": p.group, "blocks": p.blocks, "smem": p.smem}


def profiled_dense_ms(torch, timer, fn, reps=20):
    """The dense kernel's mean device time per launch over ``reps``
    launches of ``fn`` (L2 flushed before each), from torch.profiler's
    kernel records: the kernel body alone, beside the CUDA-event time of
    the whole call. (None, 0) when the profiler records no device time
    for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if "tile_scoring_dense_kernel" not in ev.key:
            continue
        total += float(ev.device_time_total)  # microseconds
        count += int(ev.count)
    if count == 0 or total <= 0.0:
        return None, count
    return total / count / 1000.0, count


def dense_band_phase(torch, dev, tsc, gseg, gdev, queries):
    """The dense kernel against its plain version, bit for bit, on
    band_edge_corpus at the packed cap (2^20 docs) on every rung of the
    ladder (sub 128 .. 1), Q 1, 2 and 16, with and without counts, raw and
    packed; and on the bench corpus at Q = 2, raw and packed. Logs each
    launch's plan; returns the largest difference."""
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t0 = time.perf_counter()
    corpus = band_edge_corpus()
    nd_pad = corpus["nd_pad"]
    dp, fp = tsc.pad_segment_blocks(corpus["block_docs"], corpus["frac"],
                                    nd_pad)
    words = tsc.pack_segment_blocks(corpus["block_docs"], corpus["frac"],
                                    nd_pad)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    arrays = {"raw": (on_dev(dp), on_dev(fp)), "packed": (on_dev(words), None)}
    err, plans, n_cases = 0.0, {}, 0

    def hold(args, kw, what):
        nonlocal err, n_cases
        got = tsc.score_tiles(*args, **kw, dense=True)
        want = tsc.score_tiles_plain(*args, sub=kw["sub"],
                                     with_counts=kw["with_counts"],
                                     q_batch=kw["q_batch"])
        torch.cuda.synchronize()
        err = max(err, float((got[0] - want[0]).abs().max()))
        n_cases += 1
        check(len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want)),
            f"dense kernel bit-equal plain ({what})")

    for sub in (128, 64, 32, 16, 8, 4, 2, 1):
        for qb in (1, 2, BURST):
            geom, rl, rh, w, cb = band_edge_tables(tsc, corpus, sub, qb)
            sub = geom.tile_sub  # the rung itself below 2^20 docs
            live = on_dev(tsc.build_live_t(corpus["live"], geom))
            tables = [on_dev(rl), on_dev(rh), on_dev(w)]
            for codec in ("raw", "packed"):
                for wc in (False, True):
                    kw = dict(t_pad=rl.shape[1], cb=cb, sub=sub, q_batch=qb,
                              codec=codec, with_counts=wc)
                    hold([*arrays[codec], live, *tables], kw,
                         f"band-edge corpus, sub {sub}, Q={qb}, {codec}, "
                         f"counts={wc}")
                    p = dense_plan(tsc, sub, qb, wc, rl.shape[1],
                                   geom.n_tiles)
                    plans[f"sub{sub}_q{qb}{'_counts' if wc else ''}"] = p
    del arrays
    # the bench corpus at Q = 2 (the first two draws), raw and packed
    sets = [[tsc.QueryLane(s_, c, w_) for s_, c, w_, _ in
             Q.term_blocks_arrays(gseg, [("title", term_token(t), 1.0)
                                         for t in q])["lanes_meta"]]
            for q in queries[:2]]
    g, live_key, (rl, rh, w, cb) = _batched_tables(tsc, gseg, sets)
    frac = gseg._block_frac()
    bench = {"raw": (gdev["k_docs"], gdev["k_frac"]),
             "packed": (on_dev(tsc.pack_segment_blocks(
                 gseg.block_docs, frac, gseg.nd_pad)), None)}
    tables = [gdev[live_key], on_dev(rl), on_dev(rh), on_dev(w)]
    for codec in ("raw", "packed"):
        for wc in (False, True):
            hold([*bench[codec], *tables],
                 dict(t_pad=rl.shape[1], cb=cb, sub=g.tile_sub, q_batch=2,
                      codec=codec, with_counts=wc),
                 f"bench corpus, Q=2, {codec}, counts={wc}")
    del bench
    torch.cuda.empty_cache()
    log(f"[phase 2 bands] {n_cases} dense launches bit-equal to plain "
        f"(max_abs_err {err}) in {time.perf_counter() - t0:.1f} s; plans "
        f"{json.dumps(plans)}")
    return err


# ----------------------------------------------------------------------
# Kernels 1d (packed codec) and 1e (tile subsets, pruning) at bench shapes
# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# The selection's edge cases: tie-heavy inputs at every cluster size
# ----------------------------------------------------------------------

SELECT_KS = (1, 10, 16, 100, None)  # None: k = W, the whole tile
SELECT_QS = (1, 2, 16)


def tie_corpus(nd_pad=1 << 16, seed=5):
    """Postings that tie on purpose: six terms (every other doc, every
    third, every fifth from 1, a random quarter, a dense run across the
    middle, every seventh), every posting's frac 1.0 and every member's
    weights 1.0 (one member 0.5), so a doc's score is the count of its
    matched terms and thousands of docs share each score; 5 % of the docs
    deleted. Returns the block arrays, the terms' row runs, the live mask
    and 16 members (lanes as (term, weight))."""
    rng = np.random.RandomState(seed)
    mid = nd_pad // 2
    terms = [np.arange(0, nd_pad, 2), np.arange(0, nd_pad, 3),
             np.arange(1, nd_pad, 5),
             rng.choice(nd_pad, nd_pad // 4, replace=False),
             np.arange(mid - 3000, mid + 3000), np.arange(0, nd_pad, 7)]
    docs_rows, frac_rows, start, count = [], [], [], []
    for docs in terms:
        docs = np.unique(docs).astype(np.int32)
        n = -(-len(docs) // BLOCK)
        d = np.full((n, BLOCK), nd_pad, np.int32)
        f = np.zeros((n, BLOCK), np.float32)
        d.reshape(-1)[: len(docs)] = docs
        f.reshape(-1)[: len(docs)] = 1.0
        start.append(sum(len(x) for x in docs_rows))
        count.append(n)
        docs_rows.append(d)
        frac_rows.append(f)
    members = [[(t, 1.0) for t in range(len(terms))], [(0, 1.0), (1, 0.5)]]
    for _ in range(2, BURST):
        pick = rng.choice(len(terms), rng.randint(1, 5), replace=False)
        members.append([(int(t), 1.0) for t in pick])
    return {"block_docs": np.concatenate(docs_rows),
            "frac": np.concatenate(frac_rows), "term_start": start,
            "term_rows": count, "nd_pad": nd_pad,
            "live": rng.rand(nd_pad) >= 0.05, "members": members}


def tie_vectors(n, dims=KNN_DIMS, distinct=512, seed=29):
    """Vectors that tie on purpose: each row is one of ``distinct`` bf16
    rows, so every score repeats about n / distinct times; every 31st row
    has no vector."""
    from elasticsearch_tpu_torch.ops.knn_scoring import bf16_round

    rng = np.random.RandomState(seed)
    base = bf16_round(rng.standard_normal((distinct, dims)).astype(np.float32))
    vecs = base[rng.randint(0, distinct, n)]
    exists = np.ones(n, bool)
    exists[::31] = False
    vecs[~exists] = 0.0
    return vecs, exists, rng


@contextlib.contextmanager
def forced_clusters(tsc, cluster):
    """While the block runs, every fused top-k launch plans with a cluster
    of exactly ``cluster`` bands (a KernelError where no plan has one)."""
    orig = tsc.topk_launch_plan

    def forced(*args, **kw):
        kw["clusters"] = (cluster,)
        return orig(*args, **kw)

    tsc.topk_launch_plan = forced
    try:
        yield
    finally:
        tsc.topk_launch_plan = orig


def topk_plan(tsc, kind, sub, q_batch, k, n_tiles, width, packed, dev):
    """The plan a fused top-k launch takes on the card, as a dict."""
    p = tsc.topk_launch_plan(kind, sub, q_batch, min(k, sub * tsc.LANE),
                             n_tiles, width, packed, dev)
    return {"cluster": p.cluster, "band_docs": p.band_docs,
            "group": p.group, "ctas": p.blocks, "smem": p.smem}


def select_phase(torch, dev):
    """[phase 2 select]: the top-k tile kernel (all rows and sel mode with
    half the rows zeroed, raw and packed) on ``tie_corpus`` and kernel 3
    (cosine and dot_product, rows past n_rows dead) on ``tie_vectors``, at
    Q 1, 2 and 16, k 1, 10, 16, 100 and W, each at every cluster size a
    plan can take there; each launch bit-equal to its plain version."""
    from elasticsearch_tpu_torch.ops import knn_scoring as knn
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError

    t0 = time.perf_counter()
    runs = {"tile": {}, "knn": {}}
    n_cases = 0
    err = 0.0

    def held(got, want, what, kind, c):
        nonlocal n_cases, err
        n_cases += 1
        runs[kind][c] = runs[kind].get(c, 0) + 1
        fin = torch.isfinite(want[0])
        if bool(fin.any()):
            err = max(err, float((got[0][fin] - want[0][fin]).abs().max()))
        check(len(got) == len(want)
              and all(torch.equal(a, b) for a, b in zip(got, want)),
              f"[phase 2 select] {what} C={c} bit-equal plain")

    def each_cluster(kind, launch, want, what):
        for c in tsc.TOPK_CLUSTERS:
            with forced_clusters(tsc, c):
                try:
                    got = launch()
                except KernelError as e:
                    if "no fused top-k plan" in str(e):
                        continue  # no plan takes this size here
                    raise
            torch.cuda.synchronize()
            held(got, want, what, kind, c)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    corpus = tie_corpus()
    nd = corpus["nd_pad"]
    geom = tsc.tile_geometry(nd, 32)  # 16 tiles of 4,096 docs
    sub, n_tiles = geom.tile_sub, geom.n_tiles
    w_tile = geom.tile_w
    block_tfs = (corpus["frac"] > 0).astype(np.float32)
    bmin, bmax = tsc.block_min_max(corpus["block_docs"], block_tfs, nd)
    docs_r, frac_r = tsc.pad_segment_blocks(corpus["block_docs"],
                                            corpus["frac"], nd)
    words = tsc.pack_segment_blocks(corpus["block_docs"], corpus["frac"], nd)
    postings = {"raw": (on_dev(docs_r), on_dev(frac_r)),
                "packed": (on_dev(words), None)}
    live_t = on_dev(tsc.build_live_t(corpus["live"], geom))
    rng = np.random.RandomState(41)
    for qb in SELECT_QS:
        sets = [[tsc.QueryLane(corpus["term_start"][t],
                               corpus["term_rows"][t], wt) for t, wt in m]
                for m in corpus["members"][:qb]]
        rl, rh, wts, cb = tsc.build_tile_tables_batched(sets, bmin, bmax,
                                                        geom)
        sel = rng.permutation(n_tiles).astype(np.int32)
        zero = np.arange(n_tiles) % 2 == 1
        rls = np.where(zero[:, None], 0, rl[sel])
        rhs = np.where(zero[:, None], 0, rh[sel])
        modes = {"all": (on_dev(rl), on_dev(rh), None),
                 "sel": (on_dev(rls), on_dev(rhs), on_dev(sel))}
        wt = on_dev(wts)
        for codec, (dk, fk) in postings.items():
            for k in SELECT_KS:
                k = w_tile if k is None else k
                for mode, (mrl, mrh, tid) in modes.items():
                    kw = dict(t_pad=rl.shape[1], cb=cb, sub=sub, k=k,
                              q_batch=qb, codec=codec, tile_ids=tid)
                    want = tsc.score_tiles_topk_plain(
                        dk, fk, live_t, mrl, mrh, wt, sub=sub, k=k,
                        tile_ids=tid)
                    each_cluster(
                        "tile",
                        lambda: tsc.score_tiles(dk, fk, live_t, mrl, mrh, wt,
                                                **kw),
                        want, f"tile top-k {codec} {mode} Q={qb} k={k}")
    del postings, live_t
    # kernel 3: 8 tiles of 8,192 docs, the last 1,000 rows dead
    vecs, exists, vrng = tie_vectors(nd)
    d_pad = knn.pad_dims(vecs.shape[1])
    kgeom = knn.knn_geometry(nd, d_pad)
    ksub = kgeom.tile_sub
    n_rows = nd - 1000
    emb = torch.zeros((nd, d_pad), dtype=torch.bfloat16, device=dev)
    emb[:, : vecs.shape[1]] = on_dev(vecs)
    mask = on_dev(exists.astype(np.float32))
    for metric in ("cosine", "dot_product"):
        scale = (on_dev(knn.vector_scale_column(vecs, metric)[:, 0])
                 if metric == "cosine" else None)
        for qb in SELECT_QS:
            qmat = on_dev(np.stack([knn.normalize_query(
                vecs[vrng.randint(nd)], metric, d_pad) for _ in range(qb)]))
            for k in SELECT_KS:
                k = kgeom.tile_w if k is None else k
                want = knn.knn_score_tiles_plain(emb, scale, mask, qmat,
                                                 sub=ksub, k=k, n_rows=n_rows)
                each_cluster(
                    "knn",
                    lambda: knn.knn_score_tiles(emb, scale, mask, qmat,
                                                sub=ksub, k=k, q_batch=qb,
                                                n_rows=n_rows),
                    want, f"knn {metric} Q={qb} k={k}")
    for kind, sizes in runs.items():
        check(sorted(sizes) == list(tsc.TOPK_CLUSTERS),
              f"[phase 2 select] {kind} ran every cluster size "
              f"(ran {sorted(sizes)})")
    log(f"[phase 2 select] {n_cases} launches bit-equal to plain; launches "
        f"by cluster size {json.dumps(runs)}; max_abs_err {err} "
        f"({time.perf_counter() - t0:.1f} s)")
    del emb
    torch.cuda.empty_cache()
    return {"cases": n_cases, "by_cluster": runs, "max_abs_err": err}


@contextlib.contextmanager
def plain_tile_kernels(tsc):
    """While the block runs, ``score_tiles`` on a card tensor runs the plain
    versions (the plain form of an orchestration built on it)."""
    orig = tsc.score_tiles

    def plain(docs, frac, live_t, rl, rh, w, **kw):
        k = min(kw.get("k", 10), kw["sub"] * tsc.LANE)
        if kw.get("dense", False):
            return tsc.score_tiles_plain(
                docs, frac, live_t, rl, rh, w, sub=kw["sub"],
                with_counts=kw.get("with_counts", False),
                q_batch=kw.get("q_batch", 1))
        tid = kw.get("tile_ids")
        return tsc.score_tiles_topk_plain(docs, frac, live_t, rl, rh, w,
                                          sub=kw["sub"], k=k, tile_ids=tid)

    tsc.score_tiles = plain
    try:
        yield
    finally:
        tsc.score_tiles = orig


def rows_read(tsc, rl, rh, codec, keep=None):
    """Bytes of the distinct posting rows a launch must read: the union of
    every kept table row's windows, 4 bytes a packed posting, 8 raw."""
    rl, rh = np.asarray(rl), np.asarray(rh)
    if keep is not None:
        rl, rh = rl[keep], rh[keep]
    hi = int(rh.max()) if rh.size else 0
    mark = np.zeros(hi + 1, bool)
    for lo_, hi_ in zip(rl.ravel(), rh.ravel()):
        if hi_ > lo_:
            mark[lo_:hi_] = True
    return int(mark.sum()) * tsc.LANE * (4 if codec == "packed" else 8)


def packed_kernels_phase(torch, dev, gseg, gdev, timer, corpus, queries):
    """Phase 2d: 1d (packed codec) dense Q=1 with and without counts, dense
    Q=16, top-k Q=1 and 16, and 1e (tile subsets) raw and packed with an
    8-tile probe set and a rest set with about half its rows zeroed, and
    the whole score_tiles_pruned orchestration, on the 1M-doc corpus
    (nd_pad = 2^20, the packed word's doc cap: half its docs set the
    word's sign bit). Each against its plain version bit for bit, timed
    beside its byte bound, the plain version and a library call."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t0 = time.perf_counter()
    frac = gseg._block_frac()
    fq = tsc.quantize_frac(frac)
    words = torch.from_numpy(tsc.pack_segment_blocks(
        corpus["block_docs"], frac, gseg.nd_pad, q=fq)).to(dev)
    bf = {"raw": tsc.block_frac_max(frac),
          "packed": tsc.block_frac_max(tsc.dequantize_frac(fq))}
    del frac, fq
    log(f"[phase 2d] packed words {tuple(words.shape)} staged in "
        f"{time.perf_counter() - t0:.1f} s; {words.numel() * 4 / 1e9:.3f} GB "
        f"against raw {(gdev['k_docs'].numel() * 8) / 1e9:.3f} GB")
    corp = {"raw": (gdev["k_docs"], gdev["k_frac"]), "packed": (words, None)}

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def lanes_of(terms):
        arrs = Q.term_blocks_arrays(
            gseg, [("title", term_token(t), 1.0) for t in terms])
        return [tsc.QueryLane(s_, c, w) for s_, c, w, _ in arrs["lanes_meta"]]

    sets = [lanes_of(q) for q in queries[:BURST]]
    g, live_key, (rl16, rh16, w16, cb) = _batched_tables(tsc, gseg, sets)
    sub, n_tiles = g.tile_sub, g.n_tiles
    w_tile = sub * tsc.LANE
    live = gdev[live_key]
    r1, h1, w1, cb1 = tsc.build_tile_tables(sets[0], gseg.kernel_bmin,
                                            gseg.kernel_bmax, g)
    nd_geom = n_tiles * w_tile
    kk = 16
    errs = {}
    out = {}

    def equal(a, b, what, key):
        ok = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        fin = torch.isfinite(b[0])
        errs[key] = max(errs.get(key, 0.0), float(
            (a[0][fin] - b[0][fin]).abs().max()) if bool(fin.any()) else 0.0)
        check(ok, f"{what} bit-equal plain")

    # the single query's and the burst's tables as launch arguments
    cases = {1: (r1, h1, w1, cb1), len(sets): (rl16, rh16, w16, cb)}
    # ---- 1d dense, Q = 1 and 16, with and without counts
    for qb, (rl, rh, w, cbq) in cases.items():
        name = "tile_scoring_packed" if qb == 1 else \
            "tile_scoring_batched_packed"
        args = [words, None, live, on_dev(rl), on_dev(rh), on_dev(w)]
        kw = dict(t_pad=rl.shape[1], cb=cbq, sub=sub, codec="packed",
                  q_batch=qb)
        for wc in (False, True):
            equal(tsc.score_tiles(*args, **kw, dense=True, with_counts=wc),
                  tsc.score_tiles_plain(*args, sub=sub, with_counts=wc,
                                        q_batch=qb),
                  f"1d dense Q={qb} counts={wc}", name)
        rows = rows_read(tsc, rl, rh, "packed")
        post = posting_count(tsc, rl, rh, w, np.ones(n_tiles, bool))
        tables = rl.nbytes + rh.nbytes + w.nbytes
        # operations: the decode's multiply, then a multiply and an add per
        # posting and query (one more add with counts)
        b = bound(rows + nd_geom * 4 + tables + qb * nd_geom * 4, 3 * post)
        bc = bound(rows + nd_geom * 4 + tables + 2 * qb * nd_geom * 4,
                   4 * post)
        lib = _yardstick(torch, tsc, corp["packed"], range(n_tiles), rl, rh,
                         w, gseg.nd_pad, sub, kk, dev, topk=False)
        out[name] = {
            "q_batch": qb, "sub": sub, "n_tiles": n_tiles,
            "posting_rows": rows // 4 // tsc.LANE,
            "ms": timer.ms(lambda a=args, k_=kw: tsc.score_tiles(
                *a, **k_, dense=True)),
            "ms_with_counts": timer.ms(lambda a=args, k_=kw: tsc.score_tiles(
                *a, **k_, dense=True, with_counts=True)),
            "plain_ms": timer.ms(lambda a=args, qb=qb: tsc.score_tiles_plain(
                *a, sub=sub, q_batch=qb), reps=3, warmup=1),
            "library_ms": timer.ms(lib),
            "bound_ms": b[0], "bound_by": b[1], "bound_ms_with_counts": bc[0],
            "plan": dense_plan(tsc, sub, qb, False, rl.shape[1], n_tiles),
            "plan_with_counts": dense_plan(tsc, sub, qb, True, rl.shape[1],
                                           n_tiles)}
        # ---- 1d top-k
        equal(tsc.score_tiles(*args, **kw, k=kk),
              tsc.score_tiles_topk_plain(*args, sub=sub, k=kk),
              f"1d top-k Q={qb}", "tile_scoring_topk_packed")
        b = bound(rows + nd_geom * 4 + tables + n_tiles * qb * (kk * 8 + 4),
                  3 * post + nd_geom * qb)
        lib = _yardstick(torch, tsc, corp["packed"], range(n_tiles), rl, rh,
                         w, gseg.nd_pad, sub, kk, dev, topk=True)
        out[f"tile_scoring_topk_packed_q{qb}"] = {
            "q_batch": qb, "k": kk,
            "plan": topk_plan(tsc, "tile", sub, qb, kk, n_tiles, rl.shape[1],
                              True, dev),
            "ms": timer.ms(lambda a=args, k_=kw: tsc.score_tiles(
                *a, **k_, k=kk)),
            "plain_ms": timer.ms(lambda a=args: tsc.score_tiles_topk_plain(
                *a, sub=sub, k=kk), reps=3, warmup=1),
            "library_ms": timer.ms(lib),
            "bound_ms": b[0], "bound_by": b[1]}
    # ---- 1e: an 8-tile probe set, and a rest set with about half its rows
    # zeroed (the lower-bound half, what the gate drops), raw and packed;
    # then the whole orchestration
    keys = ("rl_probe", "rh_probe", "tid_probe", "rl_rest", "rh_rest",
            "tid_rest", "bounds_rest")
    for codec in ("raw", "packed"):
        name = "tile_scoring_topk_sel" + ("_packed" if codec == "packed"
                                          else "")
        for qb, (rl, rh, w, cbq) in cases.items():
            plan = tsc.plan_pruned_tiles(rl, rh, w, bf[codec], 8)
            n_rest = len(plan["tid_rest"])
            keep = np.arange(n_rest) < (n_rest + 1) // 2
            parts = {
                "probe": (plan["rl_probe"], plan["rh_probe"],
                          plan["tid_probe"], np.ones(8, bool)),
                "rest": (np.where(keep[:, None], plan["rl_rest"], 0),
                         np.where(keep[:, None], plan["rh_rest"], 0),
                         np.where(keep, plan["tid_rest"], 0), keep)}
            wt = on_dev(w)
            kq = dict(t_pad=rl.shape[1], cb=cbq, sub=sub, codec=codec,
                      q_batch=qb, k=kk)
            for part, (prl, prh, ptid, kept) in parts.items():
                tid = on_dev(ptid.astype(np.int32))
                args = [*corp[codec], live, on_dev(prl.astype(np.int32)),
                        on_dev(prh.astype(np.int32)), wt]
                equal(tsc.score_tiles(*args, **kq, tile_ids=tid),
                      tsc.score_tiles_topk_plain(*args, sub=sub, k=kk,
                                                 tile_ids=tid),
                      f"1e {codec} {part} Q={qb}", name)
                scored = ptid[kept]
                on = np.zeros(n_tiles, bool)
                on[scored] = True
                rows = rows_read(tsc, rl, rh, codec, on)
                post = posting_count(tsc, rl, rh, w, on)
                b = bound(rows + len(scored) * w_tile * 4
                          + len(ptid) * qb * (kk * 8 + 4),
                          (3 if codec == "packed" else 2) * post
                          + len(scored) * w_tile * qb)
                lib = _yardstick(torch, tsc, corp[codec], scored, rl, rh, w,
                                 gseg.nd_pad, sub, kk, dev, topk=True)
                tplan = topk_plan(tsc, "tile", sub, qb, kk, len(ptid),
                                  rl.shape[1], codec == "packed", dev)
                if qb == 1 and len(ptid) == 8:
                    check(tplan["ctas"] >= 128,
                          f"1e {codec} {part}: an 8-tile set at Q=1 launches "
                          f">= 128 CTAs ({tplan})")
                out[f"{name}_{part}_q{qb}"] = {
                    "q_batch": qb, "k": kk, "rows_in_set": len(ptid),
                    "plan": tplan,
                    "tiles_scored": int(len(scored)),
                    "ms": timer.ms(lambda a=args, t=tid: tsc.score_tiles(
                        *a, **kq, tile_ids=t)),
                    "plain_ms": timer.ms(
                        lambda a=args, t=tid: tsc.score_tiles_topk_plain(
                            *a, sub=sub, k=kk, tile_ids=t), reps=3, warmup=1),
                    "library_ms": timer.ms(lib),
                    "bound_ms": b[0], "bound_by": b[1]}
            # the orchestration: probe pass, threshold, gate, rest pass
            pa = [on_dev(plan[x]) for x in keys]
            okw = dict(t_pad=rl.shape[1], cb=cbq, sub=sub, k=kk, q_batch=qb,
                       codec=codec)
            got = tsc.score_tiles_pruned(*corp[codec], live, *pa, wt, **okw)
            with plain_tile_kernels(tsc):
                want = tsc.score_tiles_pruned(*corp[codec], live, *pa, wt,
                                              **okw)
            equal(got, want, f"score_tiles_pruned {codec} Q={qb}", name)
            ex = tsc.merge_tile_topk_batched(*tsc.score_tiles(
                *corp[codec], live, on_dev(rl), on_dev(rh), wt, t_pad=rl.shape[1],
                cb=cbq, sub=sub, k=kk, q_batch=qb, codec=codec), kk)
            check(torch.equal(got[0], ex[0]) and bool((got[2] <= ex[2]).all()),
                  f"score_tiles_pruned {codec} Q={qb}: the exhaustive top-k "
                  f"scores, totals at most the exact ones")
            # the tiles it scored: the same threshold and gate, read back
            ts1 = tsc.score_tiles(*corp[codec], live, pa[0], pa[1], wt,
                                  tile_ids=pa[2], **okw)[0]
            theta = tsc.probe_threshold([ts1], kk, qb, qb)
            surv = (pa[6] >= theta[None, :]).any(dim=1).cpu().numpy()
            scored = np.concatenate([plan["tid_probe"],
                                     plan["tid_rest"][surv]])
            check(int(got[3]) == len(scored),
                  f"score_tiles_pruned {codec} Q={qb} scored the gate's tiles")
            on = np.zeros(n_tiles, bool)
            on[scored] = True
            post = posting_count(tsc, rl, rh, w, on)
            b = bound(rows_read(tsc, rl, rh, codec, on)
                      + len(scored) * w_tile * 4 + n_tiles * qb * (kk * 8 + 4),
                      (3 if codec == "packed" else 2) * post
                      + len(scored) * w_tile * qb)
            lib = _yardstick(torch, tsc, corp[codec], scored, rl, rh, w,
                             gseg.nd_pad, sub, kk, dev, topk=True)

            def plain_run(pa=pa, wt=wt, okw=okw, codec=codec):
                with plain_tile_kernels(tsc):
                    return tsc.score_tiles_pruned(*corp[codec], live, *pa, wt,
                                                  **okw)

            out[f"score_tiles_pruned_{codec}_q{qb}"] = {
                "q_batch": qb, "k": kk, "tiles_scored": int(got[3]),
                "n_tiles": n_tiles,
                "ms": timer.ms(lambda pa=pa, wt=wt, okw=okw, codec=codec:
                               tsc.score_tiles_pruned(*corp[codec], live, *pa,
                                                      wt, **okw)),
                "plain_ms": timer.ms(plain_run, reps=3, warmup=1),
                "library_ms": timer.ms(lib),
                "bound_ms": b[0], "bound_by": b[1]}
    for key, e in out.items():
        log(f"[phase 2d] {key} {json.dumps(e)}")
    log(f"[phase 2d] max_abs_err {json.dumps(errs)} "
        f"({time.perf_counter() - t0:.1f} s)")
    del words, corp
    torch.cuda.empty_cache()
    return out, errs


def posting_count(tsc, rl, rh, w, on):
    """Postings times the queries that weight their lane, over the kept
    tiles' windows (the multiply-adds a launch must make)."""
    win = (np.asarray(rh) - np.asarray(rl)).clip(0)[on]  # [tiles, t_pad]
    live_q = (np.asarray(w) > 0).sum(axis=0)  # queries per lane
    return int((win * live_q[None, :]).sum()) * tsc.LANE


def _yardstick(torch, tsc, corpus, tiles, rl, rh, w, nd_pad, sub, kk, dev,
               topk):
    """The library call beside 1d / 1e: the postings of the given tiles'
    windows (decoded when packed), one index_add_ of w_q * frac into a
    [Q, nd_pad + 1] accumulator, and, for a top-k form, torch.topk per
    tile."""
    tiles = np.asarray(list(tiles), np.int64)
    qb = w.shape[0]
    w_tile = sub * tsc.LANE
    nd1 = nd_pad + 1
    docs_t, frac_t = corpus
    parts_r, parts_q, parts_w = [], [], []
    for j in range(rl.shape[1]):
        mark = np.zeros(int(rh.max()) + 1, bool)
        for t in tiles:
            mark[rl[t, j]: rh[t, j]] = True
        rows = np.nonzero(mark)[0]
        for q in range(qb):
            if len(rows) and w[q, j] > 0:
                parts_r.append(rows)
                parts_q.append(np.full(len(rows) * tsc.LANE, q * nd1))
                parts_w.append(np.full(len(rows) * tsc.LANE, w[q, j],
                                       np.float32))
    rows = torch.from_numpy(np.concatenate(parts_r)).to(dev)
    qoff = torch.from_numpy(np.concatenate(parts_q)).to(dev)
    wts = torch.from_numpy(np.concatenate(parts_w)).to(dev)
    gathered = [docs_t[rows].reshape(-1)]
    if frac_t is not None:
        gathered.append(frac_t[rows].reshape(-1))
    buf = torch.zeros(qb * nd1, device=dev)
    tile_docs = (torch.from_numpy(tiles).to(dev)[:, None] * w_tile
                 + torch.arange(w_tile, device=dev)[None, :]).reshape(-1)
    scale = float(np.float32(tsc.PACK_FRAC_SCALE))

    def library():
        if frac_t is None:
            wd = gathered[0]
            d = ((wd.long() & 0xFFFFFFFF) >> 12) + qoff
            f = (wd & 0xFFF).float() * scale * wts
        else:
            d = gathered[0].long() + qoff
            f = gathered[1] * wts
        dense = buf.index_add_(0, d, f)
        if not topk:
            return dense
        sel = dense.reshape(qb, nd1)[:, tile_docs]
        return torch.topk(sel.reshape(qb, len(tiles), w_tile), kk, dim=2)

    return library


def time_kept_topk(torch, tsc, kept, names):
    """For each launch name, the first kept main-path launch at Q = 1 and
    the first at Q > 1, re-run on the very inputs the path gave it: its
    plan (logged), its time beside its byte bound, the plain version and
    the library call (the decode, index_add_ over the scored tiles'
    windows and torch.topk per tile). Returns {name: {"q1": ..., "qN":
    ...}}."""
    timer = Timer(torch, kept[0][0][0].device) if kept else None
    out = {}
    for name in names:
        picks = {}
        for args, kw, _out in kept:
            qb = kw.get("q_batch", 1)
            key = "q1" if qb == 1 else "qN"
            if launch_name(kw) == name and key not in picks:
                picks[key] = (args, kw)
        for key, (args, kw) in picks.items():
            docs, frac, live_t, rl, rh, w = args
            sub, qb = kw["sub"], kw.get("q_batch", 1)
            k = min(kw["k"], sub * tsc.LANE)
            w_tile = sub * tsc.LANE
            tid = kw["tile_ids"].cpu().numpy().astype(np.int64)
            rl_n, rh_n, w_n = (x.cpu().numpy() for x in (rl, rh, w))
            scored_rows = (rh_n > rl_n).any(axis=1)
            n_geom = live_t.shape[0] // tsc.LANE
            # the tables by tile id, as the exhaustive launch would see them
            rl_f = np.zeros((n_geom, rl_n.shape[1]), np.int32)
            rh_f = np.zeros_like(rl_f)
            rl_f[tid[scored_rows]] = rl_n[scored_rows]
            rh_f[tid[scored_rows]] = rh_n[scored_rows]
            on = np.zeros(n_geom, bool)
            on[tid[scored_rows]] = True
            codec = kw.get("codec", "raw")
            post = posting_count(tsc, rl_f, rh_f, w_n, on)
            b = bound(rows_read(tsc, rl_f, rh_f, codec, on)
                      + int(on.sum()) * w_tile * 4
                      + len(tid) * qb * (k * 8 + 4),
                      (3 if codec == "packed" else 2) * post
                      + int(on.sum()) * w_tile * qb)
            lib = _yardstick(torch, tsc, (docs, frac), np.nonzero(on)[0],
                             rl_f, rh_f, w_n, n_geom * w_tile, sub, k,
                             docs.device, topk=True)
            plan = topk_plan(tsc, "tile", sub, qb, k, len(tid), rl_n.shape[1],
                             codec == "packed", docs.device)
            e = {"q_batch": qb, "k": k, "sub": sub, "rows_in_set": len(tid),
                 "tiles_scored": int(on.sum()), "plan": plan,
                 "ms": timer.ms(lambda a=args, k_=kw: tsc.score_tiles(
                     *a, **k_)),
                 "plain_ms": timer.ms(
                     lambda a=args, k_=kw: tsc.score_tiles_topk_plain(
                         *a, sub=k_["sub"], k=min(k_["k"], w_tile),
                         tile_ids=k_["tile_ids"]), reps=3, warmup=1),
                 "library_ms": timer.ms(lib),
                 "bound_ms": b[0], "bound_by": b[1]}
            if qb == 1 and len(tid) == 8:
                check(plan["ctas"] >= 128,
                      f"phase 10 {name}: an 8-tile set at Q=1 launches >= "
                      f"128 CTAs ({plan})")
            out.setdefault(name, {})[key] = e
            log(f"[phase 10] main-path {name} {key} {json.dumps(e)}")
    if timer is not None:
        del timer
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# The mesh plane at real size (pmc-4x256k) and the bursts
# ----------------------------------------------------------------------


def _routing_for_shards(n_shards):
    """A routing value per shard (docs adopted into a shard are deleted
    through it)."""
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for

    out, i = {}, 0
    while len(out) < n_shards:
        out.setdefault(shard_id_for(f"r{i}", n_shards), f"r{i}")
        i += 1
    return out


def plane_failures(*svcs):
    return [f for svc in svcs for f in svc.search_stats()["planes"][
        "plane_failures_total"].values()]


def mesh_phase(torch, Node, Segment, cuda_kernels, queries, top_rank_term,
               lat, launches, vecs, exists, errs):
    """pmc-4x256k: a 4-shard index whose shards each adopt one 262,144-doc
    segment (with the kNN vectors ``vecs`` as its ``emb`` column); served
    by the one-device mesh plane, checked against a cpu node over the same
    arrays, against the same card node's host rung (index.search.mesh:
    false), and for recall@10 against reference_scores; then deletes,
    refresh (the staging is rebuilt) and again; every 1a launch held
    against its plain version (errs takes the largest difference). Returns
    (gnode, cpu node,
    the card's segments, the cpu node's segments, each shard's
    Segment.from_arrays fields without the vectors)."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t0 = time.perf_counter()
    corpora = [build_synthetic_corpus(seed, MESH_SHARD_DOCS)
               for seed in MESH_SEEDS]
    log(f"[phase 7] pmc-4x256k corpora: {[c['block_docs'].shape[0] for c in corpora]} "
        f"posting blocks ({time.perf_counter() - t0:.1f} s)")
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"},
        "emb": {"type": "dense_vector", "dims": KNN_DIMS,
                "similarity": "cosine"}}}}
    gnode, cnode = Node(device="cuda"), Node(device="cpu")
    for node in (gnode, cnode):
        node.create_index("pmc4", {"settings": {"number_of_shards": 4},
                                   "mappings": mapping})
        node.create_index("pmc4h", {"settings": {
            "number_of_shards": 4, "search": {"mesh": False}},
            "mappings": mapping})
    gsegs, csegs, shard_arrays = [], [], []
    for sh, corpus in enumerate(corpora):
        arrays = corpus_segment_arrays(corpus, id_prefix=f"s{sh}p")
        shard_arrays.append(dict(arrays))
        rows = slice(sh * MESH_SHARD_DOCS, (sh + 1) * MESH_SHARD_DOCS)
        arrays["vector_columns"] = {"emb": dict(
            vectors=vecs[rows], exists=exists[rows], dims=KNN_DIMS,
            count=int(exists[rows].sum()))}
        gs = Segment.from_arrays(f"pmc4_{sh}_seg_1", device="cuda", **arrays)
        cs = Segment.from_arrays(f"pmc4_{sh}_seg_1", device="cpu", **arrays)
        for index in ("pmc4", "pmc4h"):
            gnode.indices[index].shards[sh].engine.adopt_segment(gs)
            cnode.indices[index].shards[sh].engine.adopt_segment(cs)
        gsegs.append(gs)
        csegs.append(cs)
    fracs = [seg._block_frac() for seg in gsegs]

    def ref(terms):
        parts = []
        for sh, seg in enumerate(gsegs):
            lanes = [tsc.QueryLane(s, c, w) for s, c, w, _ in
                     Q.term_blocks_arrays(seg, [
                         ("title", term_token(t), 1.0) for t in terms])
                     ["lanes_meta"]]
            sc = tsc.reference_scores(corpora[sh]["block_docs"], fracs[sh],
                                      lanes, seg.nd_pad)
            sc[~seg.live] = 0.0
            parts.append(sc)

        def index_of(doc_id):
            sh, d = doc_id[1:].split("p")
            return int(sh) * MESH_SHARD_DOCS + int(d)

        return np.concatenate(parts), index_of

    def plane_of(kind):
        return "mesh" if kind == "match_all" else "mesh_pallas"

    reqs = requests_for(queries[:12], top_rank_term, "v0001", 2000)
    svc = gnode.indices["pmc4"]
    zero_searcher_counters(gnode)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    held = {"tile_scoring": 0}
    rec = serve_held(torch, tsc, errs, held, gnode, cnode, "pmc4", reqs,
                     "phase 7", lat, ref=ref, plane_of=plane_of,
                     also=(gnode, "pmc4h"))
    ktab = sum(t.numel() * t.element_size() for seg in gsegs
               for t in seg.kernel_tables().values())
    log(f"[phase 7] served {len(reqs)} requests in "
        f"{time.perf_counter() - t0:.1f} s; mesh staging "
        f"{svc._mesh_search._executor.staged_bytes() / 1e9:.3f} GB "
        f"over {svc._mesh_search._executor.n_slots} slots, beside the "
        f"segments' own kernel tables {ktab / 1e9:.3f} GB")
    routing = _routing_for_shards(4)
    restaged = svc._mesh_search.restage_total
    for sh in range(4):
        for i in range(0, MESH_SHARD_DOCS, 997):
            for node, index in ((gnode, "pmc4"), (gnode, "pmc4h"),
                                (cnode, "pmc4"), (cnode, "pmc4h")):
                node.delete_doc(index, f"s{sh}p{i}", routing=routing[sh])
    for node, index in ((gnode, "pmc4"), (gnode, "pmc4h"), (cnode, "pmc4"),
                        (cnode, "pmc4h")):
        node.refresh(index)
    check(not gnode.get_doc("pmc4", "s2p997", routing=routing[2])["found"],
          "pmc4 deleted doc gone")
    rec += serve_held(torch, tsc, errs, held, gnode, cnode, "pmc4", reqs,
                      "phase 7 after deletes", lat, ref=ref,
                      plane_of=plane_of, also=(gnode, "pmc4h"))
    check(svc._mesh_search.restage_total == restaged + 1,
          "pmc4 staging rebuilt once after the deletes")
    torch.cuda.synchronize()
    p7 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 7] kernel launches: {p7}")
    for k in HOST_PATH_KERNELS:
        check(p7[k] > 0, f"phase 7 launched {k}")
    check(held["tile_scoring"] == p7["tile_scoring"],
          f"every 1a launch of phase 7 held against plain ({held})")
    check(held["segment_sum"] == p7["segment_sum"]
          and p7["segment_sum_combine"] > 0,
          f"every segment_sum launch of phase 7 held against plain, and the "
          f"combine pass ran ({held}, {p7['segment_sum_combine']})")
    for k, v in p7.items():
        launches[k] += v
    check(len(rec) > 0 and min(rec) == 1.0,
          f"pmc4 recall@10 = 1.0 against reference_scores ({len(rec)} queries)")
    log(f"[phase 7] recall@10 over {len(rec)} match queries: min {min(rec)}")
    host_copy_note(gnode, "pmc4", 2 * len(reqs), "phase 7 mesh plane")
    host_copy_note(gnode, "pmc4h", 2 * len(reqs), "phase 7 host rung")
    log(f"[phase 7] planes: {json.dumps(svc.search_stats()['planes'])}")
    return gnode, cnode, gsegs, csegs, shard_arrays, held["segment_sum"]


def _same_exact(got, want):
    return (isinstance(got, dict) and got["hits"]["total"]
            == want["hits"]["total"]
            and got["hits"]["max_score"] == want["hits"]["max_score"]
            and [(h["_id"], h["_score"]) for h in got["hits"]["hits"]]
            == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])


@contextlib.contextmanager
def recording_tile_launches(tsc, keep):
    """While the block runs, keep (args, kwargs, outputs) of every
    ``score_tiles`` call on the card for which ``keep(kwargs)`` holds; the
    wrapper calls the kernel once per call, so the launch counts stay the
    path's own."""
    orig = tsc.score_tiles
    kept = []

    def recording(*args, **kw):
        out = orig(*args, **kw)
        if args[0].is_cuda and keep(kw):
            kept.append((args, kw, out))
        return out

    tsc.score_tiles = recording
    try:
        yield kept
    finally:
        tsc.score_tiles = orig


def launch_name(kw):
    """The launch counter a score_tiles call adds to."""
    if kw.get("dense", False):
        base = "tile_scoring" if kw.get("q_batch", 1) == 1 \
            else "tile_scoring_batched"
    else:
        base = "tile_scoring_topk" + ("_sel" if kw.get("tile_ids") is not None
                                      else "")
    return base + ("_packed" if kw.get("codec", "raw") == "packed" else "")


def check_kept_launches(torch, tsc, kept, errs, label):
    """Hold each kept main-path launch against its plain version on the
    very inputs the path gave it, bit for bit; errs[launch name] takes the
    largest difference. Returns the launches held, by name."""
    by_name = {}
    for n, (args, kw, out) in enumerate(kept):
        name = launch_name(kw)
        by_name[name] = by_name.get(name, 0) + 1
        sub, qb = kw["sub"], kw.get("q_batch", 1)
        if kw.get("dense", False):
            plain = tsc.score_tiles_plain(
                *args, sub=sub, with_counts=kw.get("with_counts", False),
                q_batch=qb)
        else:
            plain = tsc.score_tiles_topk_plain(
                *args, sub=sub, k=min(kw["k"], sub * tsc.LANE),
                tile_ids=kw.get("tile_ids"))
        torch.cuda.synchronize()
        fin = torch.isfinite(plain[0])
        if bool(fin.any()):
            errs[name] = max(errs.get(name, 0.0), float(
                (out[0][fin] - plain[0][fin]).abs().max()))
        check(len(out) == len(plain) and all(
            torch.equal(a, b) for a, b in zip(out, plain)),
            f"{label} main-path {name} launch {n} (rows {args[0].shape[0]}, "
            f"table rows {args[3].shape[0]}, sub {sub}, Q {qb}) equals plain")
    log(f"[{label}] {len(kept)} main-path launches held against plain: "
        f"{by_name}")
    return by_name


def serve_held(torch, tsc, errs, held, gnode, cnode, index, reqs, label,
               lat, **kw):
    """serve(), then every 1a launch (``tile_scoring``) it made held bit
    for bit against its plain version on the very inputs it was given,
    right away (a delete would change them), and every segment-sum call
    (the terms aggregations) replayed through its plain version. ``held``
    counts the launches held, by launch name."""
    from elasticsearch_tpu_torch.ops import segment_sum as ssum

    with recording_tile_launches(
            tsc, lambda k: launch_name(k) == "tile_scoring") as kept, \
            recording_segsum_calls(ssum) as kept_seg:
        out = serve(gnode, cnode, index, reqs, label, lat, **kw)
    torch.cuda.synchronize()
    held["tile_scoring"] += check_kept_launches(
        torch, tsc, kept, errs, label).get("tile_scoring", 0)
    n_seg = check_kept_segsum(torch, ssum, kept_seg, label)
    held["segment_sum"] = held.get("segment_sum", 0) + n_seg
    log(f"[{label}] {n_seg} main-path segment_sum launches held against "
        f"plain")
    return out


def burst_phase(torch, cuda_kernels, tsc, queries, lat, launches, targets,
                errs):
    """16 match bodies through IndexService.search_batch on each target
    (node, index, plane): rung 1 (mesh_pallas, kernel 1c) on pmc4 and
    rung 2 (host, kernel 1b) on the 5-shard ingest index; every member
    must equal its serial response, and every 1b/1c launch of the run
    equals its plain version on the same inputs. Then 16 threads at
    Node.search."""
    import threading

    bodies = [{"query": {"match": {"title": " ".join(
        term_token(t) for t in q)}}, "size": 10} for q in queries[:BURST]]
    serial = {index: [node.search(index, dict(b)) for b in bodies]
              for node, index, _plane in targets}
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    outs = {}
    with recording_tile_launches(
            tsc, lambda kw: launch_name(kw) in (
                "tile_scoring_batched", "tile_scoring_topk")) as kept:
        for node, index, plane in targets:
            t0 = time.perf_counter()
            outs[index] = node.indices[index].search_batch(
                [dict(b) for b in bodies])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000
            lat.setdefault(f"8/search_batch[{BURST}]@{plane}", []).append(ms)
            log(f"[phase 8] search_batch of {BURST} on {index}: {ms:.3f} ms")
    torch.cuda.synchronize()
    p8 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 8] kernel launches: {p8}")
    for k in ("tile_scoring_topk", "tile_scoring_batched"):
        check(p8[k] > 0, f"phase 8 launched {k}")
    for k, v in p8.items():
        launches[k] += v
    held = check_kept_launches(torch, tsc, kept, errs, "phase 8")
    check(held.get("tile_scoring_topk", 0) == p8["tile_scoring_topk"]
          and held.get("tile_scoring_batched", 0)
          == p8["tile_scoring_batched"],
          "every 1b/1c launch of the bursts was kept for the plain check")
    for node, index, plane in targets:
        for i, (got, want) in enumerate(zip(outs[index], serial[index])):
            check(isinstance(got, dict) and got["_plane"] == plane,
                  f"burst member {i} on {index} served by {plane}")
            check(_same_exact(got, want),
                  f"burst member {i} on {index} equals its serial response")
        log(f"[phase 8] {index} batch stats "
            f"{json.dumps(node.indices[index].batch_stats.as_dict())}")
    # threads at Node.search: the micro-batcher forms the batches
    node, index, plane = targets[0]
    svc = node.indices[index]
    before = svc.batch_stats.as_dict()["batched_query_total"]
    for _round in range(3):
        got = {}
        start = threading.Barrier(BURST)

        def worker(i):
            start.wait()
            t0 = time.perf_counter()
            got[i] = node.search(index, dict(bodies[i]))
            torch.cuda.synchronize()
            lat.setdefault(f"8/threaded@{got[i]['_plane']}", []).append(
                (time.perf_counter() - t0) * 1000)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
            check(not t.is_alive(), "threaded search finished")
        for i in range(BURST):
            check(_same_exact(got.get(i), serial[index][i]),
                  f"threaded member {i} equals its serial response")
    stats = svc.batch_stats.as_dict()
    log(f"[phase 8] threaded bursts on {index}: batch stats "
        f"{json.dumps(stats)}")
    check(stats["batched_query_total"] > before,
          "the micro-batcher formed batches from concurrent Node.search")


# ----------------------------------------------------------------------
# Kernel 3 (kNN) and the dense-vector path
# ----------------------------------------------------------------------


def knn_vectors(n, dims=KNN_DIMS, seed=KNN_SEED):
    """bench.py's knn_top10 vectors: standard normal in 100k-row chunks,
    rounded to bf16; every 97th doc has none (zero row, exists False).
    Returns (vectors [n, dims] f32, exists [n] bool, the generator, which
    goes on to draw the queries as bench.py's does)."""
    from elasticsearch_tpu_torch.ops.knn_scoring import bf16_round

    rng = np.random.RandomState(seed)
    vecs = np.empty((n, dims), np.float32)
    for lo in range(0, n, 100_000):
        hi = min(lo + 100_000, n)
        vecs[lo:hi] = bf16_round(
            rng.standard_normal((hi - lo, dims)).astype(np.float32))
    exists = np.ones(n, bool)
    exists[::KNN_MISSING_EVERY] = False
    vecs[~exists] = 0.0
    return vecs, exists, rng


def draw_qvec(rng, vecs):
    """bench.py's draw_qvec: a random doc's vector plus 0.25 x noise."""
    base = vecs[rng.randint(len(vecs))]
    return base + 0.25 * rng.standard_normal(vecs.shape[1]).astype(np.float32)


def knn_case(torch, dev, timer, name, slots, nd_geom, metric, qraw, k):
    """Kernel 3 against its plain version on the card for one case.
    ``slots``: [(vectors f32 [n_rows, dims], exists [n_rows] bool)], each a
    segment's rows in one ``nd_geom``-doc geometry. Checks scores and docs
    bit for bit; returns the case's entry (times, bound, max_abs_err)."""
    from elasticsearch_tpu_torch.ops import knn_scoring as knn
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc

    dims = slots[0][0].shape[1]
    d_pad = knn.pad_dims(dims)
    geom = knn.knn_geometry(nd_geom, d_pad)
    sub, w, n_tiles = geom.tile_sub, geom.tile_w, geom.n_tiles
    qmat = torch.from_numpy(np.stack([
        knn.normalize_query(q, metric, d_pad) for q in qraw])).to(dev)
    q_batch = qmat.shape[0]
    args = []
    live_rows = 0
    for vecs, exists in slots:
        n_rows = vecs.shape[0]
        emb = torch.zeros((n_rows, d_pad), dtype=torch.bfloat16, device=dev)
        emb[:, :dims] = torch.from_numpy(vecs).to(dev)
        scale = (torch.from_numpy(knn.vector_scale_column(vecs, metric)[:, 0])
                 .to(dev) if metric == "cosine" else None)
        mask = torch.zeros(nd_geom, dtype=torch.float32, device=dev)
        mask[:n_rows] = torch.from_numpy(exists.astype(np.float32)).to(dev)
        live_rows += int(exists.sum())
        args.append((emb, scale, mask, n_rows))

    def kernel():
        return [knn.knn_score_tiles(e, sc, m, qmat, sub=sub, k=k,
                                    q_batch=q_batch, n_rows=n)
                for e, sc, m, n in args]

    def plain():
        return [knn.knn_score_tiles_plain(e, sc, m, qmat, sub=sub, k=k,
                                          n_rows=n)
                for e, sc, m, n in args]

    def library():
        out = []
        for e, sc, m, n in args:
            s = e.float() @ qmat.t()
            if sc is not None:
                s = s * sc[:n, None]
            s = s * 0.5 + 0.5
            full = torch.full((nd_geom, q_batch), float("-inf"),
                              device=dev)
            full[:n] = torch.where(m[:n, None] > 0, s,
                                   torch.full_like(s, float("-inf")))
            out.append(torch.topk(full.t().reshape(q_batch, n_tiles, w),
                                  min(k, w), dim=2))
        return out

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for (ks, kd), (ps, pd) in zip(got, want):
        fin = torch.isfinite(ps)
        if bool(fin.any()):
            err = max(err, float((ks[fin] - ps[fin]).abs().max()))
        check(torch.equal(ks, ps) and torch.equal(kd, pd),
              f"knn_scoring bit-equal plain ({name}, Q={q_batch})")
    # bytes each function must move: the embeddings (and inverse norms)
    # of the rows it scores, each slot's mask, the queries, the
    # candidates; operations: a multiply and an add per scored doc,
    # dimension and query, and one compare per doc and query to select
    nbytes = (live_rows * d_pad * 2 + (live_rows * 4 if metric == "cosine"
                                       else 0)
              + len(slots) * nd_geom * 4 + q_batch * d_pad * 4
              + len(slots) * n_tiles * q_batch * min(k, w) * 8)
    ops = 2 * live_rows * d_pad * q_batch + len(slots) * nd_geom * q_batch
    b = bound(nbytes, ops)
    plan = topk_plan(tsc, "knn", sub, q_batch, min(k, w), n_tiles, d_pad,
                     False, dev)
    entry = {"case": name, "docs": nd_geom, "slots": len(slots), "plan": plan,
             "rows": [a[3] for a in args], "live_rows": live_rows,
             "dims": dims, "d_pad": d_pad, "metric": metric,
             "q_batch": q_batch, "k": min(k, w), "sub": sub,
             "n_tiles": n_tiles, "max_abs_err": err,
             "ms": timer.ms(kernel),
             "plain_ms": timer.ms(plain, reps=3, warmup=1),
             "library_ms": timer.ms(library, reps=10),
             "bound_ms": b[0], "bound_by": b[1],
             "bound_bytes": nbytes, "bound_ops": ops}
    log(f"[phase 2c] knn_scoring {json.dumps(entry)}")
    return entry


def knn_kernel_phase(torch, dev, timer, vecs, exists, qrng):
    """Phase 2c: kernel 3 against its plain version: 1M docs at Q 1 and
    16, one 262,144-doc slot (the mesh rung's shape) at Q 1 (k 10 and 100)
    and 16, 768 dims, and three slots with rows short of the geometry."""
    from elasticsearch_tpu_torch.ops.knn_scoring import bf16_round

    entries = []
    n = vecs.shape[0]
    for q_batch in (1, 16):
        qraw = [draw_qvec(qrng, vecs) for _ in range(q_batch)]
        entries.append(knn_case(torch, dev, timer, "1M-d128-cosine",
                                [(vecs, exists)], n, "cosine", qraw, 16))
    # the mesh rung's own shape: one 262,144-doc slot (32 tiles of 8,192)
    slot = [(vecs[:MESH_SHARD_DOCS], exists[:MESH_SHARD_DOCS])]
    for q_batch, k in ((1, 10), (1, 100), (16, 10)):
        qraw = [draw_qvec(qrng, vecs) for _ in range(q_batch)]
        e = knn_case(torch, dev, timer, f"262k-slot-d128-cosine-k{k}", slot,
                     MESH_SHARD_DOCS, "cosine", qraw, k)
        entries.append(e)
        if q_batch == 1 and k == 10:
            check(e["plan"]["ctas"] >= 256,
                  f"kernel 3 on a 262,144-doc slot at Q=1 launches >= 256 "
                  f"CTAs ({e['plan']})")
        if q_batch == 16:
            check(e["plan"]["group"] == 16,
                  f"kernel 3 at Q=16 reads each row once for all 16 queries "
                  f"({e['plan']})")
    rng = np.random.RandomState(KNN_SEED + 1)
    wide = bf16_round(
        rng.standard_normal((MESH_SHARD_DOCS, 768)).astype(np.float32))
    wide_exists = exists[:MESH_SHARD_DOCS].copy()
    wide[~wide_exists] = 0.0
    qraw = [draw_qvec(rng, wide) for _ in range(4)]
    entries.append(knn_case(torch, dev, timer, "262k-d768-dot_product",
                            [(wide, wide_exists)], MESH_SHARD_DOCS,
                            "dot_product", qraw, 16))
    del wide
    slots = []
    for i, rows in enumerate(KNN_SLOT_ROWS):
        lo = i * MESH_SHARD_DOCS
        slots.append((vecs[lo: lo + rows], exists[lo: lo + rows]))
    qraw = [draw_qvec(qrng, vecs) for _ in range(4)]
    entries.append(knn_case(torch, dev, timer, "3-slots-n_rows-lt-geometry",
                            slots, MESH_SHARD_DOCS, "cosine", qraw, 16))
    torch.cuda.empty_cache()
    return entries


@contextlib.contextmanager
def recording_knn_launches(knn):
    """While the block runs, keep (args, kwargs, outputs) of every
    ``knn_score_tiles`` call that launches kernel 3."""
    orig = knn.knn_score_tiles
    kept = []

    def recording(*args, **kw):
        out = orig(*args, **kw)
        kept.append((args, kw, out))
        return out

    knn.knn_score_tiles = recording
    try:
        yield kept
    finally:
        knn.knn_score_tiles = orig


def same_knn_response(gr, cr, tol, what):
    """Totals exact, scores within ``tol`` (absolute), ids exact except
    among hits whose scores tie within ``tol`` (the host rung sums in
    cuBLAS's order on the card and BLAS's on the host)."""
    ok = gr["hits"]["total"] == cr["hits"]["total"]
    gh, ch = gr["hits"]["hits"], cr["hits"]["hits"]
    ok = ok and len(gh) == len(ch)
    if ok and gh:
        gs = np.array([h["_score"] for h in gh])
        cs = np.array([h["_score"] for h in ch])
        ok = bool(np.all(np.abs(gs - cs) <= tol))
        i = 0
        while ok and i < len(ch):
            j = i + 1
            while j < len(ch) and abs(cs[j] - cs[i]) <= tol:
                j += 1
            ok = {h["_id"] for h in gh[i:j]} == {h["_id"] for h in ch[i:j]}
            i = j
    check(ok, f"cuda response equals cpu response within {tol}: {what}")


def knn_phase(torch, cuda_kernels, gnode, cnode, gsegs, csegs, vecs, exists,
              qrng, lat, launches, errs):
    """Phase 9: kNN and hybrid through Node on pmc-4x256k + ``emb`` (the
    nodes and segments of phase 7, with a 1-shard index over shard 0's
    segment added); returns the kNN staging bytes."""
    import threading

    from elasticsearch_tpu_torch.ops import knn_scoring as knn

    # cosine scores: |error| <= 1e-6 + 1e-6 * sum_j |x_j q_j| / |x| <= 2e-6
    tol = 2e-6
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"},
        "emb": {"type": "dense_vector", "dims": KNN_DIMS,
                "similarity": "cosine"}}}}
    for node, segs in ((gnode, gsegs), (cnode, csegs)):
        node.create_index("pmc1", {"settings": {"number_of_shards": 1},
                                   "mappings": mapping})
        node.indices["pmc1"].shards[0].engine.adopt_segment(segs[0])
    svc = gnode.indices["pmc4"]
    routing = _routing_for_shards(4)

    def index_of(doc_id):
        sh, d = doc_id[1:].split("p")
        return int(sh) * MESH_SHARD_DOCS + int(d)

    def live_mask():
        return np.concatenate([seg.live[: seg.num_docs] for seg in gsegs])

    qs = [draw_qvec(qrng, vecs) for _ in range(6 + BURST)]

    def spec(i, k=10, **kw):
        return {"field": "emb", "query_vector": qs[i].tolist(), "k": k, **kw}

    serial = [
        ("knn_k10", {"knn": spec(0)}, 0),
        ("knn_k100", {"knn": spec(1, k=100)}, 1),
        ("knn_size_from", {"knn": spec(2), "size": 5, "from": 3}, None),
        ("knn_clause", {"query": {"knn": spec(3)}, "size": 10}, 3),
    ]
    filtered = [("knn_filtered", {"knn": spec(
        4, filter={"range": {"year": {"gte": 2000}}})}, None)]
    hybrid = [
        ("hybrid_rrf", {"query": {"match": {"title": "t00050 t00051"}},
                        "knn": spec(5), "size": 10,
                        "rank": {"rrf": {"rank_constant": 60,
                                         "window_size": 50}}}),
        ("hybrid_convex", {"query": {"match": {"title": "t00052 t00060"}},
                           "knn": spec(5, boost=2.0), "size": 10}),
    ]
    recalls = []

    def timed(node, index, body, label, reps=3):
        for _ in range(reps):
            t0 = time.perf_counter()
            r = node.search(index, dict(body))
            torch.cuda.synchronize()
            lat.setdefault(f"9/{label}@{r['_plane']}", []).append(
                (time.perf_counter() - t0) * 1000)
        return r

    def serve_all(tag):
        # the first kNN query after a (re)staging pays it: timed apart
        t_first = time.perf_counter()
        gnode.search("pmc4", {"knn": spec(0)})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_first) * 1000
        lat.setdefault("9/knn_first_query_after_staging@mesh_pallas",
                       []).append(ms)
        log(f"[phase 9{tag}] first kNN query (mesh staging, and the "
            f"segments' vector staging on the first) {ms:.1f} ms")
        out = {}
        for kind, body, qi in serial:
            gr = timed(gnode, "pmc4", body, kind)
            cr = cnode.search("pmc4", dict(body))
            check(gr["_plane"] == cr["_plane"] == "mesh_pallas",
                  f"phase 9{tag} {kind} on mesh_pallas (got {gr['_plane']}, "
                  f"cpu {cr['_plane']})")
            check(_same_exact(gr, cr),
                  f"phase 9{tag} {kind}: mesh_pallas equals the cpu node "
                  f"bit for bit")
            for index, plane in (("pmc4h", "host"), ("pmc1", "host")):
                ga = timed(gnode, index, body, f"{kind} ({index})")
                ca = cnode.search(index, dict(body))
                check(ga["_plane"] == ca["_plane"] == plane,
                      f"phase 9{tag} {kind} on {index}: plane "
                      f"{ga['_plane']}, want {plane}")
                same_knn_response(ga, ca, tol, f"phase 9{tag} {kind} "
                                  f"{index}")
            same_knn_response(gr, gnode.search("pmc4h", dict(body)), tol,
                              f"phase 9{tag} {kind}: mesh vs host rung")
            if qi is not None:
                ref_s, ref_i = knn.reference_knn_topk(
                    vecs, exists & live_mask(), qs[qi], 10, "cosine")
                got = [index_of(h["_id"]) for h in gr["hits"]["hits"][:10]]
                ref = knn.reference_knn_scores(vecs, qs[qi], "cosine")
                hit = sum(1 for d in got if ref[d] >= ref_s[-1] - tol)
                recalls.append(hit / len(ref_i))
            out[kind] = gr
        for kind, body, _ in filtered:
            gr = timed(gnode, "pmc4", body, kind)
            cr = cnode.search("pmc4", dict(body))
            check(gr["_plane"] == cr["_plane"] == "host",
                  f"phase 9{tag} {kind} on host (got {gr['_plane']})")
            same_knn_response(gr, cr, tol, f"phase 9{tag} {kind}")
        for kind, body in hybrid:
            gr = timed(gnode, "pmc4", body, kind)
            cr = cnode.search("pmc4", dict(body))
            want = {"lexical_plane": "mesh_pallas",
                    "knn_plane": "mesh_pallas",
                    "fusion": "rrf" if "rank" in body else "convex"}
            check(gr.get("_hybrid") == cr.get("_hybrid") == want,
                  f"phase 9{tag} {kind}: _hybrid {gr.get('_hybrid')}")
            same_response(gr, cr, f"phase 9{tag} {kind}")
        return out

    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    before = serve_all("")
    # the mesh plane's kNN staging: per-slot masks only, the embeddings
    # are the segments' own
    executor = svc._mesh_search._executor
    knn_entry = executor._knn.get("emb")
    check(isinstance(knn_entry, dict), "pmc4 kNN plane staged")
    mask_bytes = knn_entry["mask"].numel() * knn_entry["mask"].element_size()
    own = 0
    for i, seg in enumerate(executor.segments):
        dev = seg.device_arrays()
        check(knn_entry["slots"][i]["emb"] is dev["k_vec_emb"],
              f"slot {i} reads its segment's own embeddings")
        own += sum(dev[k].numel() * dev[k].element_size() for k in
                   ("k_vec_emb", "k_vecnorm_emb", "k_vecexists_emb"))
    check(mask_bytes <= 4 * MESH_SHARD_DOCS * 4 + 1024,
          f"mesh kNN staging is the per-slot masks only ({mask_bytes} B)")
    log(f"[phase 9] mesh kNN staging {mask_bytes / 1e6:.3f} MB (per-slot "
        f"masks) beside the segments' own vector arrays {own / 1e6:.3f} MB; "
        f"whole mesh staging {executor.staged_bytes() / 1e9:.3f} GB")

    # bursts: one search_batch of 16 and 16 threads at Node.search
    bodies = [{"knn": spec(6 + i)} for i in range(BURST)]
    solo = [gnode.search("pmc4", dict(b)) for b in bodies]
    dec = svc._mesh_search.decisions
    served_before = dec.get("mesh_pallas.knn_served_batched", 0)
    torch.cuda.synchronize()
    launched_before = cuda_kernels.LAUNCHES["knn_scoring"]
    with recording_knn_launches(knn) as kept:
        t1 = time.perf_counter()
        outs = svc.search_batch([dict(b) for b in bodies])
        torch.cuda.synchronize()
        lat.setdefault(f"9/search_batch[{BURST}]@knn", []).append(
            (time.perf_counter() - t1) * 1000)
        for i, (got, want) in enumerate(zip(outs, solo)):
            check(isinstance(got, dict) and got["_plane"] == "mesh_pallas",
                  f"kNN burst member {i} on mesh_pallas")
            check(_same_exact(got, want),
                  f"kNN burst member {i} equals its serial response")
        for _round in range(3):
            got = {}
            start = threading.Barrier(BURST)

            def worker(i):
                start.wait()
                t2 = time.perf_counter()
                got[i] = gnode.search("pmc4", dict(bodies[i]))
                torch.cuda.synchronize()
                lat.setdefault(f"9/knn_threaded@{got[i]['_plane']}",
                               []).append((time.perf_counter() - t2) * 1000)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(BURST)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300.0)
                check(not t.is_alive(), "threaded kNN search finished")
            for i in range(BURST):
                check(_same_exact(got.get(i), solo[i]),
                      f"threaded kNN member {i} equals its serial response")
    torch.cuda.synchronize()
    check(len(kept) == cuda_kernels.LAUNCHES["knn_scoring"] - launched_before,
          "every kernel-3 launch of the kNN bursts was kept for the plain "
          "check")
    served = dec.get("mesh_pallas.knn_served_batched", 0) - served_before
    check(served >= BURST, f"kNN bursts served batched ({served} members)")
    log(f"[phase 9] kNN bursts: {served} members knn_served_batched, "
        f"{len(kept)} kernel-3 launches kept")
    for n, (args, kw, out) in enumerate(kept):
        plain = knn.knn_score_tiles_plain(
            args[0], args[1], args[2], args[3], sub=kw["sub"],
            k=min(kw["k"], kw["sub"] * knn.LANE), n_rows=kw["n_rows"])
        torch.cuda.synchronize()
        fin = torch.isfinite(plain[0])
        if bool(fin.any()):
            errs["knn"] = max(errs["knn"], float(
                (out[0][fin] - plain[0][fin]).abs().max()))
        check(torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1]),
              f"main-path kNN launch {n} (rows {kw['n_rows']}, Q "
              f"{args[3].shape[0]}, k {kw['k']}) equals plain")

    # deletes, then again
    n_deleted = n_vec_deleted = 0
    for sh in range(4):
        for i in range(991, MESH_SHARD_DOCS, 991):
            doc_id = f"s{sh}p{i}"
            hosts = [(gnode, "pmc4"), (gnode, "pmc4h"), (cnode, "pmc4"),
                     (cnode, "pmc4h")]
            if sh == 0:
                hosts += [(gnode, "pmc1"), (cnode, "pmc1")]
            res = [node.delete_doc(index, doc_id, routing=routing[sh])
                   for node, index in hosts]
            if res[0]["result"] == "deleted":
                n_deleted += 1
                n_vec_deleted += int(exists[sh * MESH_SHARD_DOCS + i])
    for node in (gnode, cnode):
        for index in ("pmc4", "pmc4h", "pmc1"):
            node.refresh(index)
    after = serve_all(" after deletes")
    check(after["knn_k10"]["hits"]["total"]
          == before["knn_k10"]["hits"]["total"] - n_vec_deleted,
          f"kNN total drops by the {n_vec_deleted} deleted vector docs")
    for kind, r in after.items():
        ids = {h["_id"] for h in r["hits"]["hits"]}
        check(not any(int(x.split("p")[1]) % 991 == 0
                      and int(x.split("p")[1]) > 0 for x in ids),
              f"phase 9 {kind}: no deleted doc returned")
    torch.cuda.synchronize()
    p9 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 9] {time.perf_counter() - t0:.1f} s; deleted {n_deleted} "
        f"docs ({n_vec_deleted} with a vector); kernel launches: {p9}")
    check(p9["knn_scoring"] > 0, "phase 9 launched knn_scoring")
    for k, v in p9.items():
        launches[k] += v
    check(len(recalls) > 0 and min(recalls) == 1.0,
          f"kNN recall@10 = 1.0 against reference_knn_topk "
          f"({len(recalls)} queries)")
    log(f"[phase 9] recall@10 over {len(recalls)} queries: min "
        f"{min(recalls) if recalls else None}")
    fails = plane_failures(*(node.indices[i] for node in (gnode, cnode)
                             for i in ("pmc4", "pmc4h", "pmc1")))
    check(not any(fails), f"phase 9 zero plane faults (got {fails})")
    log(f"[phase 9] planes: {json.dumps(svc.search_stats()['planes'])}")
    return {"mesh_knn_staging_bytes": mask_bytes,
            "segment_vector_bytes": own}


# ----------------------------------------------------------------------
# Packed postings and block-max pruning through Node (pmc-4x256k)
# ----------------------------------------------------------------------


def same_ranked(gr, wr, what):
    """Hits and scores equal where the two rankings may order exact ties
    differently (a pruned pool merges its probe tiles first): scores equal
    exactly, ids equal per group of equal scores, except that the last
    group may be cut at the window."""
    gh, wh = gr["hits"]["hits"], wr["hits"]["hits"]
    ok = len(gh) == len(wh) and [h["_score"] for h in gh] == [
        h["_score"] for h in wh]
    i = 0
    while ok and i < len(wh):
        j = i + 1
        while j < len(wh) and wh[j]["_score"] == wh[i]["_score"]:
            j += 1
        if j < len(wh):
            ok = {h["_id"] for h in gh[i:j]} == {h["_id"] for h in wh[i:j]}
        i = j
    check(ok, f"hits and scores equal: {what}")


def pruned_phase(torch, Node, Segment, cuda_kernels, tsc, queries, lat,
                 launches, errs, shard_arrays, raw_node, ingest_node):
    """Phase 10: packed postings and block-max pruning through Node on
    pmc-4x256k (phase 7's arrays, as new segments staged packed):

    - serial match queries on ``mesh_pallas`` with ``_pruned``, hits and
      scores equal to the packed exhaustive index on the card and bit for
      bit to the cpu node; recall@10 against reference_scores over the
      dequantized frac (gated) and the raw frac (reported); bool queries
      and the exhaustive fallbacks (terms agg, operator and,
      minimum_should_match, size 0, post_filter) exact, with no marker;
    - the packed host rung: 4 shards with index.search.mesh false, one
      shard, and phase 3's 5-shard ingest index re-staged packed;
    - raw pruning (the raw sel kernel) on phase 7's own segments, equal to
      phase 7's exhaustive index;
    - bursts: one search_batch of 16 on the pruned index, one on the
      packed exhaustive index, one on the packed ingest index (host
      batched rung), and 16 threads at Node.search;
    - deletes, then the match queries again.
    Every 1d / 1e launch of the phase is held bit for bit against its
    plain version on the inputs the path gave it. Returns the report."""
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t_phase = time.perf_counter()
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}}}}
    pruning = {"search.pallas.pruning.enabled": True,
               "search.pallas.pruning.probe_tiles": 8}
    packed = {"search.pallas.postings_codec": "packed"}
    gP = Node(Settings({**packed, **pruning}), device="cuda")
    cP = Node(Settings({**packed, **pruning}), device="cpu")
    gX = Node(Settings(packed), device="cuda")  # packed, exhaustive
    gR = Node(Settings(pruning), device="cuda")  # raw, pruned

    def make(node, index, shards, mesh=True):
        settings = {"number_of_shards": shards}
        if not mesh:
            settings["search"] = {"mesh": False}
        node.create_index(index, {"settings": settings, "mappings": mapping})
        return node.indices[index]

    t0 = time.perf_counter()
    gsegs = [Segment.from_arrays(f"pmc4p_{sh}_seg_1", device="cuda", **a)
             for sh, a in enumerate(shard_arrays)]
    csegs = [Segment.from_arrays(f"pmc4p_{sh}_seg_1", device="cpu", **a)
             for sh, a in enumerate(shard_arrays)]
    for node, index, segs, shards, mesh in (
            (gP, "pmc4p", gsegs, 4, True), (gP, "pmc4ph", gsegs, 4, False),
            (gP, "pmc1p", gsegs[:1], 1, True), (gX, "pmc4x", gsegs, 4, True),
            (cP, "pmc4p", csegs, 4, True), (cP, "pmc1p", csegs[:1], 1, True),
            (gR, "pmc4r", raw_node[2], 4, True)):
        svc = make(node, index, shards, mesh)
        for sh, seg in enumerate(segs):
            svc.shards[sh].engine.adopt_segment(seg)
    # phase 3's 5-shard ingest index, its sealed segments re-staged packed
    for node, device in ((gP, "cuda"), (cP, "cpu")):
        make(node, "docs5p", 5)
        _adopt_copies(ingest_node, node, "docs", Segment, device=device,
                      index_to="docs5p")
    log(f"[phase 10] indices built in {time.perf_counter() - t0:.1f} s")
    svc = gP.indices["pmc4p"]
    tok = term_token
    matches = [{"query": {"match": {"title": " ".join(tok(t) for t in q)}},
                "size": 10} for q in queries[:8]]
    bools = [{"query": {"bool": {"must": [{"match": {"title": " ".join(
        tok(t) for t in q)}}], "filter": [{"range": {"year": {
            "gte": 2000}}}]}}, "size": 10} for q in queries[8:10]]
    fallbacks = [
        ("terms_agg", {"size": 0, "query": {"match": {"title": " ".join(
            tok(t) for t in queries[10])}}, "aggs": {"venues": {
                "terms": {"field": "venue", "size": 10}}}}),
        ("match_and", {"query": {"match": {"title": {"query": " ".join(
            tok(t) for t in queries[11][:2]), "operator": "and"}}}}),
        ("match_msm", {"query": {"match": {"title": {"query": " ".join(
            tok(t) for t in queries[12]), "minimum_should_match": 2}}}}),
        ("size_0", {"size": 0, "query": {"match": {"title": " ".join(
            tok(t) for t in queries[13])}}}),
        ("post_filter", {"query": {"match": {"title": " ".join(
            tok(t) for t in queries[14])}}, "post_filter": {
                "term": {"venue": "v0001"}}})]
    fracs = {}  # (shard, dequantized) -> the frac the oracle adds

    def ref(terms, dequantized):
        parts = []
        for sh, seg in enumerate(gsegs):
            if (sh, dequantized) not in fracs:
                f = seg._block_frac()
                fracs[(sh, False)] = f
                fracs[(sh, True)] = tsc.dequantize_frac(tsc.quantize_frac(f))
            f = fracs[(sh, dequantized)]
            lanes = [tsc.QueryLane(s_, c, w) for s_, c, w, _ in
                     Q.term_blocks_arrays(seg, [
                         ("title", tok(t), 1.0) for t in terms])["lanes_meta"]]
            sc = tsc.reference_scores(shard_arrays[sh]["block_docs"], f,
                                      lanes, seg.nd_pad)
            sc[~seg.live] = 0.0
            parts.append(sc)
        return np.concatenate(parts)

    def recall(gr, scores):
        k = min(10, int((scores > 0).sum()))
        if not k:
            return None
        kth = np.sort(scores)[::-1][k - 1]
        got = []
        for h in gr["hits"]["hits"][:10]:
            sh, d = h["_id"][1:].split("p")
            got.append(int(sh) * MESH_SHARD_DOCS + int(d))
        return sum(1 for d in got if scores[d] >= kth * (1 - 1e-6)) / k

    def timed(node, index, body, label):
        t1 = time.perf_counter()
        r = node.search(index, dict(body))
        torch.cuda.synchronize()
        lat.setdefault(f"10/{label}@{r['_plane']}", []).append(
            (time.perf_counter() - t1) * 1000)
        return r

    rec_dq, rec_raw = [], []

    def serve_all(tag, full=True):
        for n, body in enumerate(matches):
            terms = queries[n]
            gr = timed(gP, "pmc4p", body, "match packed pruned")
            xr = timed(gX, "pmc4x", body, "match packed exhaustive")
            rr = timed(raw_node[0], "pmc4", body, "match raw exhaustive")
            cr = cP.search("pmc4p", dict(body))
            check(gr["_plane"] == cr["_plane"] == "mesh_pallas"
                  and "_pruned" in gr,
                  f"phase 10{tag} match {n} pruned on mesh_pallas "
                  f"({gr['_plane']}, {gr.get('_pruned')})")
            check(_same_exact(gr, cr) and gr.get("_pruned") == cr.get(
                "_pruned"), f"phase 10{tag} match {n}: the cpu node bit for "
                f"bit, _pruned {gr.get('_pruned')} / {cr.get('_pruned')}")
            same_ranked(gr, xr, f"phase 10{tag} match {n} pruned vs packed "
                        f"exhaustive")
            check("_pruned" not in xr and gr["hits"]["total"]
                  <= xr["hits"]["total"],
                  f"phase 10{tag} match {n}: total {gr['hits']['total']} <= "
                  f"the exact {xr['hits']['total']}")
            r = recall(gr, ref(terms, True))
            if r is not None:
                rec_dq.append(r)
            r = recall(gr, ref(terms, False))
            if r is not None:
                rec_raw.append(r)
            # raw pruning on phase 7's segments (the raw sel kernel)
            pr = timed(gR, "pmc4r", body, "match raw pruned")
            check("_pruned" in pr, f"phase 10{tag} match {n} raw pruned")
            same_ranked(pr, rr, f"phase 10{tag} match {n} raw pruned vs raw "
                        f"exhaustive")
        if not full:
            return
        for n, body in enumerate(bools):
            gr = timed(gP, "pmc4p", body, "bool packed")
            xr = gX.search("pmc4x", dict(body))
            cr = cP.search("pmc4p", dict(body))
            # a bool query is no single kernel-scored disjunction: it runs
            # exhaustively in both packages
            check(gr["_plane"] == "mesh_pallas" and "_pruned" not in gr,
                  f"phase 10{tag} bool {n} exhaustive on mesh_pallas")
            same_response(gr, cr, f"phase 10{tag} bool {n}")
            same_response(gr, xr, f"phase 10{tag} bool {n} vs pmc4x")
        for kind, body in fallbacks:
            gr = timed(gP, "pmc4p", body, kind)
            cr = cP.search("pmc4p", dict(body))
            xr = gX.search("pmc4x", dict(body))
            check(gr["_plane"] == "mesh_pallas" and "_pruned" not in gr
                  and "_pruned" not in cr,
                  f"phase 10{tag} {kind}: exhaustive, no marker")
            same_response(gr, cr, f"phase 10{tag} {kind}")
            same_response(gr, xr, f"phase 10{tag} {kind} vs pmc4x")
        # the packed host rung: 4 shards without the mesh, one shard, and
        # the 5-shard ingest index (minimum_should_match: with counts)
        host = [("pmc4ph", matches[0], None), ("pmc4ph", fallbacks[2][1],
                                               None),
                ("pmc1p", matches[1], "pmc1p"),
                ("pmc1p", fallbacks[2][1], "pmc1p")]
        for body in requests_for(queries[:3], 3, "v0001", 2000)[:3]:
            host.append(("docs5p", body[1], "docs5p"))
        for index, body, cpu_index in host:
            gr = timed(gP, index, body, f"host packed ({index})")
            check(gr["_plane"] == "host" and "_pruned" not in gr,
                  f"phase 10{tag} {index} on the host rung "
                  f"({gr['_plane']})")
            if cpu_index is not None:
                same_response(gr, cP.search(cpu_index, dict(body)),
                              f"phase 10{tag} {index} host")
            else:
                same_response(gr, gX.search("pmc4x", dict(body)),
                              f"phase 10{tag} {index} host vs pmc4x")

    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()

    def one_d_or_e(kw):
        return kw.get("codec") == "packed" or kw.get("tile_ids") is not None

    with recording_tile_launches(tsc, one_d_or_e) as kept:
        t0 = time.perf_counter()
        serve_all("")
        log(f"[phase 10] serial requests served in "
            f"{time.perf_counter() - t0:.1f} s")
        # bursts of 16
        bodies = [{"query": {"match": {"title": " ".join(
            tok(t) for t in q)}}, "size": 10} for q in queries[:BURST]]
        solo = [gP.search("pmc4p", dict(b)) for b in bodies]
        exact = [gX.search("pmc4x", dict(b)) for b in bodies]
        for node, index, plane in ((gP, "pmc4p", "mesh_pallas"),
                                   (gX, "pmc4x", "mesh_pallas"),
                                   (gP, "docs5p", "host")):
            t1 = time.perf_counter()
            outs = node.indices[index].search_batch([dict(b) for b in bodies])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1000
            lat.setdefault(f"10/search_batch[{BURST}]@{plane} ({index})",
                           []).append(ms)
            log(f"[phase 10] search_batch of {BURST} on {index}: {ms:.3f} ms")
            for i, got in enumerate(outs):
                check(isinstance(got, dict) and got["_plane"] == plane,
                      f"phase 10 burst member {i} on {index} served by "
                      f"{plane}")
            if index == "pmc4p":
                for i, got in enumerate(outs):
                    check("_pruned" in got, f"burst member {i} pruned")
                    same_ranked(got, solo[i], f"pruned burst member {i} vs "
                                f"its serial response")
                    check(solo[i]["hits"]["total"] <= got["hits"]["total"]
                          <= exact[i]["hits"]["total"],
                          f"pruned burst member {i}: serial total "
                          f"{solo[i]['hits']['total']} <= member "
                          f"{got['hits']['total']} <= exact "
                          f"{exact[i]['hits']['total']}")
            elif index == "pmc4x":
                for i, got in enumerate(outs):
                    check(_same_exact(got, exact[i]),
                          f"packed burst member {i} equals its serial "
                          f"response")
        for _round in range(2):
            got = {}
            start = threading.Barrier(BURST)

            def worker(i):
                start.wait()
                t2 = time.perf_counter()
                got[i] = gP.search("pmc4p", dict(bodies[i]))
                torch.cuda.synchronize()
                lat.setdefault(f"10/threaded@{got[i]['_plane']} (pmc4p)",
                               []).append((time.perf_counter() - t2) * 1000)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(BURST)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300.0)
                check(not t.is_alive(), "threaded search finished")
            for i in range(BURST):
                r = got.get(i)
                check(isinstance(r, dict) and "_pruned" in r,
                      f"threaded member {i} pruned")
                if isinstance(r, dict):
                    same_ranked(r, solo[i], f"threaded member {i}")
                    check(solo[i]["hits"]["total"] <= r["hits"]["total"]
                          <= exact[i]["hits"]["total"],
                          f"threaded member {i}: the totals relation")
        # deletes, then again
        routing = _routing_for_shards(4)
        restaged = svc._mesh_search.restage_total
        for sh in range(4):
            for i in range(0, MESH_SHARD_DOCS, 1009):
                for node, index in ((gP, "pmc4p"), (gP, "pmc4ph"),
                                    (gX, "pmc4x"), (cP, "pmc4p")):
                    node.delete_doc(index, f"s{sh}p{i}", routing=routing[sh])
        for node, index in ((gP, "pmc4p"), (gP, "pmc4ph"), (gX, "pmc4x"),
                            (cP, "pmc4p")):
            node.refresh(index)
        n_del = len(range(0, MESH_SHARD_DOCS, 1009))
        check(gsegs[1].live_doc_count == MESH_SHARD_DOCS - n_del,
              "phase 10 deletes applied")
        serve_all(" after deletes", full=False)
        check(svc._mesh_search.restage_total == restaged + 1,
              "pmc4p staging rebuilt once after the deletes")
        for body in matches:
            ids = [h["_id"] for h in gP.search("pmc4p", dict(body))[
                "hits"]["hits"]]
            check(not any(int(x.split("p")[1]) % 1009 == 0 for x in ids),
                  "phase 10: no deleted doc returned")
    torch.cuda.synchronize()
    p10 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 10] kernel launches: {p10}")
    for k, v in p10.items():
        launches[k] += v
    for name in ("tile_scoring_packed", "tile_scoring_batched_packed",
                 "tile_scoring_topk_packed", "tile_scoring_topk_sel",
                 "tile_scoring_topk_sel_packed"):
        check(p10[name] > 0, f"phase 10 launched {name}")
    by_name = check_kept_launches(torch, tsc, kept, errs, "phase 10")
    main_path = time_kept_topk(torch, tsc, kept, (
        "tile_scoring_topk_sel_packed", "tile_scoring_topk_sel"))
    check(all(by_name.get(n, 0) == p10[n] for n in p10
              if "packed" in n or "_sel" in n),
          f"every 1d/1e launch of phase 10 was kept for the plain check "
          f"({by_name})")
    check(len(rec_dq) > 0 and min(rec_dq) == 1.0,
          f"phase 10 recall@10 = 1.0 against reference_scores over the "
          f"dequantized frac ({len(rec_dq)} queries)")
    planes = svc.search_stats()["planes"]
    fails = plane_failures(*(node.indices[i] for node, i in (
        (gP, "pmc4p"), (gP, "pmc4ph"), (gP, "pmc1p"), (gP, "docs5p"),
        (gX, "pmc4x"), (gR, "pmc4r"), (cP, "pmc4p"), (cP, "pmc1p"),
        (cP, "docs5p"))))
    check(not any(fails), f"phase 10 zero plane faults (got {fails})")
    raw_bytes = raw_node[0].indices["pmc4"].search_stats()["planes"][
        "postings_bytes_staged"]
    scored, pruned = planes["tiles_scored_total"], planes["tiles_pruned_total"]
    report = {
        "pruned_query_total": planes["pruned_query_total"],
        "tiles_scored_total": scored, "tiles_pruned_total": pruned,
        "tiles_pruned_fraction": pruned / max(scored + pruned, 1),
        "postings_codec": planes["postings_codec"],
        "postings_bytes_staged_packed": planes["postings_bytes_staged"],
        "postings_bytes_staged_raw": raw_bytes,
        "recall_at_10_dequantized_min": min(rec_dq) if rec_dq else None,
        "recall_at_10_raw_oracle_min": min(rec_raw) if rec_raw else None,
        "recall_at_10_raw_oracle_mean": (float(np.mean(rec_raw))
                                         if rec_raw else None),
        "seconds": time.perf_counter() - t_phase, "main_path": main_path}
    for label in ("match raw exhaustive", "match packed exhaustive",
                  "match packed pruned", "match raw pruned"):
        xs = [v for k, vs in lat.items() if k.startswith(f"10/{label}@")
              for v in vs]
        report[f"p50_ms {label}"] = float(np.median(xs)) if xs else None
    log(f"[phase 10] report {json.dumps(report)}")
    log(f"[phase 10] planes: {json.dumps(planes)}")
    return report


# ----------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from elasticsearch_tpu_torch.index.segment import Segment
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import cuda_kernels
    from elasticsearch_tpu_torch.ops import segment_sum as ssum
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # full float32 products everywhere (the kNN host rung refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---------------- phase 1: device ----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_kernels.library()
    log(f"[phase 1] kernel build + load {time.perf_counter() - t0:.2f} s")
    for line in cuda_kernels.build_log:
        for ln in line.splitlines():
            if "registers" in ln or ln.startswith("=="):
                log(f"[phase 1] {ln.strip()}")

    # ---------------- phase 2: kernels vs plain at bench shapes ----------
    t0 = time.perf_counter()
    corpus = build_synthetic_corpus(7)
    arrays = corpus_segment_arrays(corpus)
    log(f"[phase 2] corpus: {N_DOCS} docs, {corpus['block_docs'].shape[0]} "
        f"posting blocks, {int(corpus['term_df'].sum())} postings "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    gseg = Segment.from_arrays("pmc_0_seg_1", device="cuda", **arrays)
    gdev = gseg.device_arrays()
    torch.cuda.synchronize()
    log(f"[phase 2] staged on the card: {gseg.staged_bytes() / 1e9:.3f} GB "
        f"in {time.perf_counter() - t0:.1f} s")
    timer = Timer(torch, dev)
    queries = query_draws()
    top_rank_term = 3  # a top-10 rank: dense, forces the geometry ladder

    def kernel_node(terms):
        arrs = Q.term_blocks_arrays(
            gseg, [("title", term_token(t), 1.0) for t in terms])
        return Q._pallas_score_terms_node(gseg, arrs, 1), arrs

    tile_err = 0.0
    tile_entries = []
    for qi, terms in enumerate([queries[0], queries[1], queries[2],
                                [top_rank_term] + queries[0][:2]]):
        node, arrs = kernel_node(terms)
        check(node is not None, f"kernel node for query {terms}")
        args = [gdev["k_docs"], gdev["k_frac"], gdev[node.live_key]] + [
            torch.from_numpy(x).to(dev) for x in
            (node.row_lo, node.row_hi, node.kweights)]
        kw = dict(t_pad=node.t_pad, cb=node.cb, sub=node.sub)
        for wc in (False, True):
            k_out = tsc.score_tiles(*args, **kw, dense=True, with_counts=wc)
            p_out = tsc.score_tiles_plain(*args, sub=node.sub, with_counts=wc)
            torch.cuda.synchronize()
            err = float((k_out[0] - p_out[0]).abs().max())
            tile_err = max(tile_err, err)
            check(torch.equal(k_out[0], p_out[0]),
                  f"tile scores bit-equal plain, query {terms}, counts={wc}")
            if wc:
                check(torch.equal(k_out[1], p_out[1]),
                      f"tile counts vs plain, query {terms}")
        # bytes the function must move: each lane's posting rows once
        # (doc i32 + frac f32), the live mask, the row tables and weights,
        # the scores written (and the counts)
        rows = sum(c for _s, c, w, _ok in arrs["lanes_meta"] if w > 0)
        nd_geom = node.n_tiles * node.sub * tsc.LANE
        tables = node.row_lo.nbytes * 2 + node.kweights.nbytes
        bytes_plain = rows * tsc.LANE * 8 + nd_geom * 4 + tables + nd_geom * 4
        ms = timer.ms(lambda: tsc.score_tiles(*args, **kw, dense=True))
        ms_c = timer.ms(lambda: tsc.score_tiles(*args, **kw, dense=True,
                                                with_counts=True))
        plain_ms = timer.ms(lambda: tsc.score_tiles_plain(*args, sub=node.sub),
                            reps=10)
        # the library yardstick: one index_add_ of w*frac over the lanes'
        # postings into a dense accumulator
        lane_rows = torch.cat([torch.arange(s, s + c, device=dev)
                               for s, c, w, _ in arrs["lanes_meta"]])
        lane_w = torch.cat([torch.full((c,), w, device=dev)
                            for s, c, w, _ in arrs["lanes_meta"]])
        pd = gdev["k_docs"][lane_rows].reshape(-1).long()
        pf = (gdev["k_frac"][lane_rows] * lane_w[:, None]).reshape(-1)
        acc = torch.zeros(gseg.nd_pad + 1, device=dev)
        library_ms = timer.ms(lambda: acc.index_add_(0, pd, pf))
        # operations: a multiply and an add per posting (one more add for
        # the count)
        b1 = bound(bytes_plain, 2 * rows * tsc.LANE)
        b1c = bound(bytes_plain + nd_geom * 4, 3 * rows * tsc.LANE)
        entry = {"query": [int(t) for t in terms], "sub": node.sub,
                 "n_tiles": node.n_tiles, "posting_rows": rows, "ms": ms,
                 "ms_with_counts": ms_c, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": b1[0],
                 "bound_by": b1[1], "bound_ms_with_counts": b1c[0],
                 "plan": dense_plan(tsc, node.sub, 1, False, node.t_pad,
                                    node.n_tiles),
                 "plan_with_counts": dense_plan(tsc, node.sub, 1, True,
                                                node.t_pad, node.n_tiles)}
        if qi == 0:
            entry["profiler_ms"], entry["profiler_launches"] = \
                profiled_dense_ms(torch, timer, lambda: tsc.score_tiles(
                    *args, **kw, dense=True))
            check(nd_geom == 1 << 20 and entry["plan"]["blocks"] >= 264,
                  f"1a at the 2^20-doc bench geometry launches >= 264 "
                  f"blocks ({entry['plan']})")
        tile_entries.append(entry)
        log(f"[phase 2] tile_scoring {json.dumps(entry)}")

    # segment sum: the venue ordinal column over a match query's matched
    # mask, with the year values for the sums
    mnode, _ = kernel_node(queries[0])
    from elasticsearch_tpu_torch.search import plan as P

    _, matched = P.execute(gdev, mnode)
    seg_cases, seg_combine, seg_profile = segment_sum_phase(
        torch, dev, timer, gseg, matched)
    tile_err = max(tile_err, dense_band_phase(torch, dev, tsc, gseg, gdev,
                                              queries))
    select_report = select_phase(torch, dev)

    batch_entries, batch_errs = batch_kernels_phase(
        torch, dev, gseg, gdev, timer, queries, top_rank_term)

    # ---------------- phase 2d: kernels 1d and 1e vs plain ----------------
    packed_entries, packed_errs = packed_kernels_phase(
        torch, dev, gseg, gdev, timer, corpus, queries)
    batch_errs.update(packed_errs)

    # ---------------- phase 2c: kernel 3 vs plain --------------------------
    t0 = time.perf_counter()
    knn_vecs, knn_exists, knn_rng = knn_vectors(4 * MESH_SHARD_DOCS)
    log(f"[phase 2c] {knn_vecs.shape[0]} x {KNN_DIMS} bf16-grid vectors "
        f"({int(knn_exists.sum())} docs with one) in "
        f"{time.perf_counter() - t0:.1f} s")
    knn_entries = knn_kernel_phase(torch, dev, timer, knn_vecs, knn_exists,
                                   knn_rng)
    batch_errs["knn"] = max(e["max_abs_err"] for e in knn_entries)

    lat = {}
    launches = {k: 0 for k in cuda_kernels.LAUNCHES}

    # ---------------- phase 3: write path through Node(device="cuda") ----
    rng = np.random.RandomState(21)
    ranks = np.arange(1, VOCAB + 1)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    lens = np.clip(rng.lognormal(np.log(AVG_DOC_LEN), 0.4, INGEST_DOCS),
                   5, 500).astype(np.int64)
    toks = rng.choice(VOCAB, int(lens.sum()), p=probs)
    vord = rng.choice(N_ORDS, INGEST_DOCS, p=(1.0 / ranks[:N_ORDS])
                      / (1.0 / ranks[:N_ORDS]).sum())
    years = 1990 + rng.randint(0, 35, INGEST_DOCS)
    words = [term_token(i) for i in range(VOCAB)]
    ops, pos = [], 0
    for i in range(INGEST_DOCS):
        title = " ".join(words[t] for t in toks[pos: pos + lens[i]])
        pos += lens[i]
        ops.append(("index", {"_index": "docs", "_id": f"d{i}"},
                    {"title": title, "venue": f"v{int(vord[i]):04d}",
                     "year": int(years[i])}))
    gnode = node_with_mapping(Node, "cuda", 5)
    cnode = node_with_mapping(Node, "cpu", 5)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = gnode.bulk(ops)
    gnode.refresh("docs")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    check(not r["errors"], "bulk without errors")
    log(f"[phase 3] bulk {INGEST_DOCS} docs + refresh in {ingest_s:.1f} s: "
        f"{INGEST_DOCS / ingest_s:.0f} docs/s")
    # the cpu node holds the same host arrays (each sealed segment adopted)
    _adopt_copies(gnode, cnode, "docs", Segment)
    reqs = requests_for(queries[:12], top_rank_term, "v0001", 2000)
    held = {"tile_scoring": 0}
    serve_held(torch, tsc, batch_errs, held, gnode, cnode, "docs", reqs,
               "phase 3", lat)
    del_ids = [f"d{i}" for i in range(0, INGEST_DOCS, 97)]
    for d in del_ids:
        check(gnode.delete_doc("docs", d)["result"] == "deleted", f"delete {d}")
        cnode.delete_doc("docs", d)
    gnode.refresh("docs")
    cnode.refresh("docs")
    check(not gnode.get_doc("docs", del_ids[0])["found"], "deleted doc gone")
    check(gnode.get_doc("docs", "d1")["found"], "kept doc found")
    serve_held(torch, tsc, batch_errs, held, gnode, cnode, "docs", reqs,
               "phase 3 after deletes", lat)
    n3 = 2 * len(reqs)
    torch.cuda.synchronize()
    p3 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 3] kernel launches: {p3}")
    for k in HOST_PATH_KERNELS:
        check(p3[k] > 0, f"phase 3 launched {k}")
    check(held["tile_scoring"] == p3["tile_scoring"],
          f"every 1a launch of phase 3 held against plain ({held})")
    check(held["segment_sum"] == p3["segment_sum"],
          f"every segment_sum launch of phase 3 held against plain ({held})")
    seg_held = {"phase 3": held["segment_sum"]}
    for k, v in p3.items():
        launches[k] += v
    copy3 = host_copy_note(gnode, "docs", n3, "phase 3")

    # ---------------- phase 4: the 1M-doc segment through Node -----------
    g4 = node_with_mapping(Node, "cuda", 1)
    c4 = node_with_mapping(Node, "cpu", 1)
    cseg = Segment.from_arrays("pmc_0_seg_1", device="cpu", **arrays)
    t0 = time.perf_counter()
    g4.indices["pmc"].shards[0].engine.adopt_segment(gseg)
    c4.indices["pmc"].shards[0].engine.adopt_segment(cseg)
    log(f"[phase 4] adopted the 1M-doc segment ({time.perf_counter() - t0:.1f} s); "
        f"bytes staged on the card: {gseg.staged_bytes()} "
        f"(postings+norms+masks+kernel tables+doc-value columns)")
    frac_host = gseg._block_frac()

    def ref(terms):
        lanes = [tsc.QueryLane(int(corpus["term_block_start"][t]),
                               int(corpus["n_blocks_per_term"][t]), w)
                 for t, (_s, _c, w, _ok) in zip(
                     terms, Q.term_blocks_arrays(gseg, [
                         ("title", term_token(t), 1.0) for t in terms])
                     ["lanes_meta"])]
        s = tsc.reference_scores(corpus["block_docs"], frac_host, lanes,
                                 gseg.nd_pad)
        s[~gseg.live] = 0.0
        return s, lambda doc_id: int(doc_id[1:])

    reqs4 = requests_for(queries[12:24], top_rank_term, "v0000", 2005)
    zero_searcher_counters(g4)
    cuda_kernels.reset_launch_counts()
    held = {"tile_scoring": 0}
    rec = serve_held(torch, tsc, batch_errs, held, g4, c4, "pmc", reqs4,
                     "phase 4", lat, ref=ref)
    dels = [f"p{i}" for i in range(0, N_DOCS, 997)]
    for d in dels:
        g4.delete_doc("pmc", d)
        c4.delete_doc("pmc", d)
    g4.refresh("pmc")
    c4.refresh("pmc")
    check(gseg.live_doc_count == N_DOCS - len(dels), "1M deletes applied")
    rec += serve_held(torch, tsc, batch_errs, held, g4, c4, "pmc", reqs4,
                      "phase 4 after deletes", lat, ref=ref)
    torch.cuda.synchronize()
    p4 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 4] kernel launches: {p4}")
    for k in HOST_PATH_KERNELS:
        check(p4[k] > 0, f"phase 4 launched {k}")
    check(held["tile_scoring"] == p4["tile_scoring"],
          f"every 1a launch of phase 4 held against plain ({held})")
    check(held["segment_sum"] == p4["segment_sum"]
          and p4["segment_sum_combine"] > 0,
          f"every segment_sum launch of phase 4 held against plain, and the "
          f"combine pass ran ({held}, {p4['segment_sum_combine']})")
    seg_held["phase 4"] = held["segment_sum"]
    for k, v in p4.items():
        launches[k] += v
    check(len(rec) > 0 and min(rec) == 1.0,
          f"recall@10 = 1.0 against reference_scores ({len(rec)} queries)")
    log(f"[phase 4] recall@10 over {len(rec)} match queries: min {min(rec)}")
    copy4 = host_copy_note(g4, "pmc", 2 * len(reqs4), "phase 4")
    # the device kernels of one terms aggregation request on the 1M-doc
    # segment (one segment: its segment-sum kernels are the per-segment
    # count)
    agg_body = next(b for k, b, _t in reqs4 if k == "terms_agg")
    req_kernels, req_copies = device_kernels(
        torch, lambda: g4.search("pmc", agg_body))
    by_name = {}
    for k in req_kernels:
        by_name[k] = by_name.get(k, 0) + 1
    seg_profile["terms_agg_request"] = {
        "segments": len(g4.indices["pmc"].shards[0].engine.segments),
        "segment_sum_kernels": sum("segment_sum" in k for k in req_kernels),
        "kernels": len(req_kernels), "copies_and_fills": len(req_copies),
        "by_name": by_name}
    log(f"[phase 4] device kernels of one terms_agg request: "
        f"{json.dumps(seg_profile['terms_agg_request'])}")

    # ---------------- phase 7: the mesh plane at real size ---------------
    g7, c7, g7segs, c7segs, shard_arrays, seg_held["phase 7"] = mesh_phase(
        torch, Node, Segment, cuda_kernels, queries, top_rank_term, lat,
        launches, knn_vecs, knn_exists, batch_errs)

    # ---------------- phase 8: bursts on both batched rungs --------------
    burst_phase(torch, cuda_kernels, tsc, queries, lat, launches,
                [(g7, "pmc4", "mesh_pallas"), (gnode, "docs", "host")],
                batch_errs)
    fails = plane_failures(g7.indices["pmc4"], g7.indices["pmc4h"],
                           c7.indices["pmc4"], gnode.indices["docs"])
    check(not any(fails), f"zero plane faults (got {fails})")

    # ---------------- phase 9: kNN and hybrid through Node ---------------
    knn_staging = knn_phase(torch, cuda_kernels, g7, c7, g7segs, c7segs,
                            knn_vecs, knn_exists, knn_rng, lat, launches,
                            batch_errs)

    # ---------------- phase 10: packed + pruning through Node ------------
    pruned_report = pruned_phase(
        torch, Node, Segment, cuda_kernels, tsc, queries, lat, launches,
        batch_errs, shard_arrays, (g7, c7, g7segs), gnode)

    # ---------------- phase 5: latency summary ---------------------------
    for kind, xs in sorted(lat.items()):
        log(f"[phase 5] p50 phase {kind}: {float(np.median(xs)):.3f} ms over "
            f"{len(xs)} requests ({smi})")
    log(f"[phase 5] terms_agg p50 beside the other kinds: " + json.dumps({
        kind: float(np.median(xs)) for kind, xs in sorted(lat.items())
        if "terms_agg" in kind or "match_or" in kind}))
    log(f"[phase 5] host copy: phase 3 {json.dumps(copy3)}, "
        f"phase 4 {json.dumps(copy4)}")

    # ---------------- phase 6: kernel summary ----------------------------
    rep = tile_entries[0]
    bat = batch_entries["draws"]
    summary = {"kernels": [
        {"name": "tile_scoring_dense", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_scoring.py:871",
         "launches": launches["tile_scoring"],
         "max_abs_err": max(tile_err, batch_errs.get("tile_scoring", 0.0)),
         "ms": rep["ms"], "plain_ms": rep["plain_ms"],
         "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
         "library_ms": rep["library_ms"],
         "with_counts": {"ms": rep["ms_with_counts"],
                         "bound_ms": rep["bound_ms_with_counts"],
                         "plan": rep["plan_with_counts"]},
         "plan": rep["plan"], "profiler_ms": rep["profiler_ms"],
         "ladder_query": tile_entries[-1]},
        {"name": "segment_sum", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/segment_sum.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_aggs.py:128",
         "launches": launches["segment_sum"],
         "max_abs_err": max(e["max_abs_err"] for e in seg_cases),
         **{k: seg_cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "plan",
                                         "deterministic")},
         "gather_ms": seg_cases[2]["ms"],
         "ordinal_counts_ms": seg_cases[2]["ordinal_counts_ms"],
         "outside_gather_ms": seg_cases[2]["outside_gather_ms"],
         "main_path_held": seg_held, "device_kernels": seg_profile,
         "cases": [{k: e[k] for k in (
             "case", "form", "with_sum", "nd", "n_ords", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "max_abs_err")}
             | {"plan": {k: e["plan"][k] for k in (
                 "path", "grid", "threads", "kernels")},
                "deterministic": e.get("deterministic")}
             for e in seg_cases]},
        {"name": "segment_sum_combine", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/segment_sum.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_aggs.py:213",
         "launches": launches["segment_sum_combine"], **seg_combine},
        {"name": "tile_scoring_batched", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_scoring.py:871",
         "launches": launches["tile_scoring_batched"],
         "max_abs_err": batch_errs["tile_scoring_batched"],
         "ms": bat["batched_ms"], "plain_ms": bat["batched_plain_ms"],
         "bound_ms": bat["batched_bound_ms"],
         "bound_by": bat["batched_bound_by"],
         "library_ms": bat["batched_library_ms"],
         "q_batch": bat["q_batch"],
         "with_counts": {"ms": bat["batched_ms_with_counts"],
                         "bound_ms": bat["batched_bound_ms_with_counts"],
                         "plan": bat["batched_plan_with_counts"]},
         "plan": bat["batched_plan"],
         "profiler_ms": bat["batched_profiler_ms"],
         "ladder_batch": {k: v for k, v in batch_entries["ladder"].items()
                          if k.startswith(("batched", "sub", "union"))}},
        {"name": "tile_scoring_topk", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_scoring.py:871",
         "launches": launches["tile_scoring_topk"],
         "max_abs_err": batch_errs["tile_scoring_topk"],
         "ms": bat["topk_ms"], "plain_ms": bat["topk_plain_ms"],
         "bound_ms": bat["topk_bound_ms"], "bound_by": bat["topk_bound_by"],
         "library_ms": bat["topk_library_ms"], "q_batch": bat["q_batch"],
         "k": 16, "plan": bat["topk_plan"],
         "q1": {"ms": bat["topk_q1_ms"], "bound_ms": bat["topk_q1_bound_ms"],
                "library_ms": bat["topk_q1_library_ms"],
                "plan": bat["topk_q1_plan"]},
         "select_phase": select_report,
         "ladder_batch": {k: v for k, v in batch_entries["ladder"].items()
                          if k.startswith(("topk", "sub", "union"))}},
        {"name": "knn_scoring", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/knn_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_knn.py:204",
         "launches": launches["knn_scoring"],
         "max_abs_err": batch_errs["knn"],
         "ms": knn_entries[0]["ms"], "plain_ms": knn_entries[0]["plain_ms"],
         "bound_ms": knn_entries[0]["bound_ms"],
         "bound_by": knn_entries[0]["bound_by"],
         "library_ms": knn_entries[0]["library_ms"],
         "q_batch": knn_entries[0]["q_batch"], "k": knn_entries[0]["k"],
         "plan": knn_entries[0]["plan"],
         "cases": [{key: e[key] for key in (
             "case", "q_batch", "k", "rows", "d_pad", "metric", "plan", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")}
             for e in knn_entries],
         **knn_staging},
    ]}
    for name, key, replaces, extra in (
            ("tile_scoring_packed", "tile_scoring_packed", 656,
             ("ms_with_counts", "bound_ms_with_counts", "plan")),
            ("tile_scoring_batched_packed", "tile_scoring_batched_packed",
             656, ("q_batch", "ms_with_counts", "plan")),
            ("tile_scoring_topk_packed", "tile_scoring_topk_packed_q1", 656,
             ("q_batch", "k", "plan")),
            ("tile_scoring_topk_sel", "tile_scoring_topk_sel_rest_q1", 770,
             ("q_batch", "k", "rows_in_set", "tiles_scored", "plan")),
            ("tile_scoring_topk_sel_packed",
             "tile_scoring_topk_sel_packed_rest_q1", 770,
             ("q_batch", "k", "rows_in_set", "tiles_scored", "plan"))):
        e = packed_entries[key]
        entry = {"name": name, "route": "cuda",
                 "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
                 "replaces": f"elasticsearch_tpu/ops/pallas_scoring.py:"
                             f"{replaces}",
                 "launches": launches[name],
                 "max_abs_err": batch_errs.get(name, 0.0),
                 **{k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
                 **{k: e[k] for k in extra}}
        # the other shapes of the same launch name
        entry["cases"] = {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
                          for k, v in packed_entries.items()
                          if k != key and (k.startswith(name + "_q")
                                           or k.startswith(name + "_probe")
                                           or k.startswith(name + "_rest"))}
        if name.startswith("tile_scoring_topk_sel"):
            entry["main_path"] = pruned_report["main_path"].get(name, {})
            codec = "packed" if name.endswith("packed") else "raw"
            entry["score_tiles_pruned"] = {
                k: packed_entries[f"score_tiles_pruned_{codec}_q{q}"]
                for k, q in (("q1", 1), (f"q{BURST}", BURST))}
        summary["kernels"].append(entry)
    log(f"[phase 6] total {time.perf_counter() - t_start:.1f} s")
    if FAILS:
        print(f"chip_smoke: {len(FAILS)} checks failed", file=sys.stderr)
        for f in FAILS:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _adopt_copies(gnode, cnode, index, Segment, device="cpu",
                  index_to=None):
    """Give another node (the cpu node by default) the cuda node's sealed
    segments as new segments over the same host arrays, on ``device``, in
    index ``index_to`` (the same name by default)."""
    for sid, shard in gnode.indices[index].shards.items():
        engine = cnode.indices[index_to or index].shards[sid].engine
        for seg in shard.engine.segments:
            copy = Segment.from_arrays(
                seg.name, term_keys=seg.term_keys,
                term_block_start=seg.term_block_start,
                term_block_count=seg.term_block_count,
                term_doc_freq=seg.term_doc_freq, block_docs=seg.block_docs,
                block_tfs=seg.block_tfs, norms=seg.norms, live=seg.live,
                field_stats=seg.field_stats, field_norm_idx=seg.field_norm_idx,
                doc_ids=seg.doc_ids, sources=seg.sources,
                numeric_columns={f: vars(c) for f, c in seg.numeric_columns.items()},
                ordinal_columns={f: vars(c) for f, c in seg.ordinal_columns.items()},
                seqnos=seg.seqnos, versions=seg.versions, device=device)
            engine.adopt_segment(copy)
        engine.mapper_service.merge(shard.engine.mapper_service.mapping_dict())


if __name__ == "__main__":
    sys.exit(main())
