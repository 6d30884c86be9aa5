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
   match bit for bit (checked at rtol 1e-6) and counts exactly; segment-sum
   counts exactly and sums within 1e-4 of each bucket's sum of |value|
   (f32 atomics change the order of the adds from run to run). Each is
   timed as a median over CUDA events with L2 flushed before every launch,
   beside its bound (the larger of its bytes over the memory rate and its
   float32 operations over the peak rate), its plain version and one
   PyTorch library call computing the same function.
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
   launched in each main-path phase (counts zeroed just before it). Prints
   p50 latency per request kind and plane and the per-segment host copy of
   the dense scores and mask.
6. The kernel summary line, then the device line.

Run between phases 2 and 3, and after phase 4:

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
    on the card, bit for bit (scores and docs), in three cases: 1,048,576
    docs of 128 dims, cosine, Q = 1 and 16 (bench.py's knn_top10 shape);
    262,144 docs of 768 dims, dot_product, Q = 4; three slots of 262,144 /
    150,000 / 90,000 rows in one 262,144-doc geometry (rows beyond a
    slot's count are dead), cosine, Q = 4. The vectors are bench.py's
    generator (``RandomState(23)`` standard normal, bf16-rounded; here
    every 97th doc has none). Each is timed beside its bound, the plain
    version and the library call (``emb.float() @ q.T``, scale, mask and
    ``torch.topk`` per tile, TF32 off).
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
    """Median of CUDA-event timings, L2 flushed before each launch."""

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
    errs = {"batched": 0.0, "topk": 0.0}
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
            errs["batched"] = max(errs["batched"], float(
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
            errs["topk"] = max(errs["topk"], float(
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
        idx, val = [], []
        for j, ln in enumerate(union):
            r = slice(ln.block_start, ln.block_start + ln.block_count)
            docs = gdev["k_docs"][r].reshape(-1).long()
            frac = gdev["k_frac"][r].reshape(-1)
            for q in range(qn):
                if wmat[q, j] > 0:
                    idx.append(docs + q * nd1)
                    val.append(frac * float(wmat[q, j]))
        idx, val = torch.cat(idx), torch.cat(val)
        buf = torch.zeros(qn * nd1, device=dev)
        w_tile = sub * tsc.LANE

        def library_topk():
            dense = buf.index_add_(0, idx, val).reshape(qn, nd1)
            return torch.topk(dense[:, : n_tiles * w_tile].reshape(
                qn, n_tiles, w_tile), kk, dim=2)

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
            "topk_bound_ms": b_topk[0], "topk_bound_by": b_topk[1],
            "topk_q1_bound_ms": b_topk1[0],
        }
        entries[name] = e
        log(f"[phase 2b] batch {name}: {json.dumps(e)}")
    return entries, errs


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
               lat, launches, vecs, exists):
    """pmc-4x256k: a 4-shard index whose shards each adopt one 262,144-doc
    segment (with the kNN vectors ``vecs`` as its ``emb`` column); served
    by the one-device mesh plane, checked against a cpu node over the same
    arrays, against the same card node's host rung (index.search.mesh:
    false), and for recall@10 against reference_scores; then deletes,
    refresh (the staging is rebuilt) and again. Returns (gnode, cpu node,
    the card's segments, the cpu node's segments)."""
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
    gsegs, csegs = [], []
    for sh, corpus in enumerate(corpora):
        arrays = corpus_segment_arrays(corpus, id_prefix=f"s{sh}p")
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
    rec = serve(gnode, cnode, "pmc4", reqs, "phase 7", lat, ref, plane_of,
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
    rec += serve(gnode, cnode, "pmc4", reqs, "phase 7 after deletes", lat,
                 ref, plane_of, also=(gnode, "pmc4h"))
    check(svc._mesh_search.restage_total == restaged + 1,
          "pmc4 staging rebuilt once after the deletes")
    torch.cuda.synchronize()
    p7 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 7] kernel launches: {p7}")
    for k in HOST_PATH_KERNELS:
        check(p7[k] > 0, f"phase 7 launched {k}")
    for k, v in p7.items():
        launches[k] += v
    check(len(rec) > 0 and min(rec) == 1.0,
          f"pmc4 recall@10 = 1.0 against reference_scores ({len(rec)} queries)")
    log(f"[phase 7] recall@10 over {len(rec)} match queries: min {min(rec)}")
    host_copy_note(gnode, "pmc4", 2 * len(reqs), "phase 7 mesh plane")
    host_copy_note(gnode, "pmc4h", 2 * len(reqs), "phase 7 host rung")
    log(f"[phase 7] planes: {json.dumps(svc.search_stats()['planes'])}")
    return gnode, cnode, gsegs, csegs


def _same_exact(got, want):
    return (isinstance(got, dict) and got["hits"]["total"]
            == want["hits"]["total"]
            and got["hits"]["max_score"] == want["hits"]["max_score"]
            and [(h["_id"], h["_score"]) for h in got["hits"]["hits"]]
            == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]])


@contextlib.contextmanager
def recording_batched_launches(tsc):
    """While the block runs, keep (args, kwargs, outputs) of every
    ``score_tiles`` call that launches kernel 1b (dense, q_batch > 1) or
    1c (fused top-k), under "batched" / "topk". The wrapper calls the
    kernel once per call, so the launch counts stay the path's own."""
    orig = tsc.score_tiles
    kept = {"batched": [], "topk": []}

    def recording(*args, **kw):
        out = orig(*args, **kw)
        if not kw.get("dense", True):
            kept["topk"].append((args, kw, out))
        elif kw.get("q_batch", 1) > 1:
            kept["batched"].append((args, kw, out))
        return out

    tsc.score_tiles = recording
    try:
        yield kept
    finally:
        tsc.score_tiles = orig


def check_kept_launches(torch, tsc, kept, errs):
    """Hold each kept main-path launch of 1b and 1c against its plain
    version on the very inputs the path gave it, bit for bit."""
    for kind, calls in kept.items():
        for n, (args, kw, out) in enumerate(calls):
            sub, qb = kw["sub"], kw.get("q_batch", 1)
            if kind == "batched":
                plain = tsc.score_tiles_plain(
                    *args, sub=sub, with_counts=kw.get("with_counts", False),
                    q_batch=qb)
            else:
                plain = tsc.score_tiles_topk_plain(
                    *args, sub=sub, k=min(kw["k"], sub * tsc.LANE))
            torch.cuda.synchronize()
            fin = torch.isfinite(plain[0])
            errs[kind] = max(errs[kind], float(
                (out[0][fin] - plain[0][fin]).abs().max()))
            check(len(out) == len(plain) and all(
                torch.equal(a, b) for a, b in zip(out, plain)),
                f"main-path {kind} launch {n} (rows {args[0].shape[0]}, "
                f"tiles {args[3].shape[0]}, sub {sub}, Q {qb}) equals plain")
        log(f"[phase 8] {len(calls)} main-path {kind} launches held "
            f"against plain (rows per launch "
            f"{sorted({a[0].shape[0] for a, _k, _o in calls})})")


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
    with recording_batched_launches(tsc) as kept:
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
    check(len(kept["topk"]) == p8["tile_scoring_topk"]
          and len(kept["batched"]) == p8["tile_scoring_batched"],
          "every 1b/1c launch of the bursts was kept for the plain check")
    check_kept_launches(torch, tsc, kept, errs)
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
    entry = {"case": name, "docs": nd_geom, "slots": len(slots),
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
    """Phase 2c: kernel 3 against its plain version in three cases."""
    from elasticsearch_tpu_torch.ops.knn_scoring import bf16_round

    entries = []
    n = vecs.shape[0]
    for q_batch in (1, 16):
        qraw = [draw_qvec(qrng, vecs) for _ in range(q_batch)]
        entries.append(knn_case(torch, dev, timer, "1M-d128-cosine",
                                [(vecs, exists)], n, "cosine", qraw, 16))
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
            k_out = tsc.score_tiles(*args, **kw, with_counts=wc)
            p_out = tsc.score_tiles_plain(*args, sub=node.sub, with_counts=wc)
            torch.cuda.synchronize()
            err = float((k_out[0] - p_out[0]).abs().max())
            tile_err = max(tile_err, err)
            check(torch.allclose(k_out[0], p_out[0], rtol=1e-6, atol=0),
                  f"tile scores vs plain, query {terms}, counts={wc}")
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
        ms = timer.ms(lambda: tsc.score_tiles(*args, **kw))
        ms_c = timer.ms(lambda: tsc.score_tiles(*args, **kw, with_counts=True))
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
                 "bound_by": b1[1], "bound_ms_with_counts": b1c[0]}
        tile_entries.append(entry)
        log(f"[phase 2] tile_scoring {json.dumps(entry)}")

    # segment sum at bench shape: the venue ordinal column over a match
    # query's matched mask, with the year values for the sums
    mnode, _ = kernel_node(queries[0])
    from elasticsearch_tpu_torch.search import plan as P

    _, matched = P.execute(gdev, mnode)
    ocol = gseg.ordinal_columns["venue"]
    flat_docs = torch.from_numpy(ocol.flat_docs).to(dev)
    ords = torch.from_numpy(ocol.flat_ords).to(dev)
    contrib = matched[flat_docs.long()].float().contiguous()
    vals = torch.from_numpy(
        gseg.numeric_columns["year"].flat_values.astype(np.float32)).to(dev)
    vals = (vals * torch.randn(vals.shape[0], device=dev,
                               generator=torch.Generator(dev).manual_seed(3)))
    k_cnt, k_tot = ssum.segment_counts_sums(ords, contrib, vals, n_ords=N_ORDS)
    p_cnt, p_tot = ssum.segment_sum_plain(ords, contrib, vals, n_ords=N_ORDS,
                                          with_count=True, with_sum=True)
    abs_sum = torch.bincount(ords.long(), weights=(contrib * vals.abs()).double(),
                             minlength=N_ORDS).float()
    torch.cuda.synchronize()
    seg_err = float((k_tot - p_tot).abs().max())
    check(torch.equal(k_cnt, p_cnt), "segment_sum counts vs plain")
    check(bool(((k_tot - p_tot).abs() <= 1e-4 * abs_sum + 1e-3).all()),
          "segment_sum sums vs plain within 1e-4 of sum |value|")
    nd_seg = ords.shape[0]
    weighted = contrib * vals
    seg_bytes = nd_seg * 12 + N_ORDS * 8
    # operations: per entry a multiply and two adds (count and sum)
    seg_bound = bound(seg_bytes, 3 * nd_seg)
    seg_entry = {
        "nd": nd_seg, "n_ords": N_ORDS,
        "ms": timer.ms(lambda: ssum.segment_counts_sums(ords, contrib, vals,
                                                        n_ords=N_ORDS)),
        "ms_count_only": timer.ms(lambda: ssum.segment_counts_sums(
            ords, contrib, n_ords=N_ORDS)),
        "plain_ms": timer.ms(lambda: ssum.segment_sum_plain(
            ords, contrib, vals, n_ords=N_ORDS, with_count=True,
            with_sum=True)),
        "library_ms": timer.ms(lambda: torch.bincount(
            ords, weights=weighted, minlength=N_ORDS)),
        "bound_ms": seg_bound[0], "bound_by": seg_bound[1],
        "max_count": int(k_cnt.max()),
    }
    log(f"[phase 2] segment_sum {json.dumps(seg_entry)} max_abs_err {seg_err}")

    batch_entries, batch_errs = batch_kernels_phase(
        torch, dev, gseg, gdev, timer, queries, top_rank_term)

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
    serve(gnode, cnode, "docs", reqs, "phase 3", lat)
    del_ids = [f"d{i}" for i in range(0, INGEST_DOCS, 97)]
    for d in del_ids:
        check(gnode.delete_doc("docs", d)["result"] == "deleted", f"delete {d}")
        cnode.delete_doc("docs", d)
    gnode.refresh("docs")
    cnode.refresh("docs")
    check(not gnode.get_doc("docs", del_ids[0])["found"], "deleted doc gone")
    check(gnode.get_doc("docs", "d1")["found"], "kept doc found")
    serve(gnode, cnode, "docs", reqs, "phase 3 after deletes", lat)
    n3 = 2 * len(reqs)
    torch.cuda.synchronize()
    p3 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 3] kernel launches: {p3}")
    for k in HOST_PATH_KERNELS:
        check(p3[k] > 0, f"phase 3 launched {k}")
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
    rec = serve(g4, c4, "pmc", reqs4, "phase 4", lat, ref)
    dels = [f"p{i}" for i in range(0, N_DOCS, 997)]
    for d in dels:
        g4.delete_doc("pmc", d)
        c4.delete_doc("pmc", d)
    g4.refresh("pmc")
    c4.refresh("pmc")
    check(gseg.live_doc_count == N_DOCS - len(dels), "1M deletes applied")
    rec += serve(g4, c4, "pmc", reqs4, "phase 4 after deletes", lat, ref)
    torch.cuda.synchronize()
    p4 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 4] kernel launches: {p4}")
    for k in HOST_PATH_KERNELS:
        check(p4[k] > 0, f"phase 4 launched {k}")
    for k, v in p4.items():
        launches[k] += v
    check(len(rec) > 0 and min(rec) == 1.0,
          f"recall@10 = 1.0 against reference_scores ({len(rec)} queries)")
    log(f"[phase 4] recall@10 over {len(rec)} match queries: min {min(rec)}")
    copy4 = host_copy_note(g4, "pmc", 2 * len(reqs4), "phase 4")

    # ---------------- phase 7: the mesh plane at real size ---------------
    g7, c7, g7segs, c7segs = mesh_phase(
        torch, Node, Segment, cuda_kernels, queries, top_rank_term, lat,
        launches, knn_vecs, knn_exists)

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

    # ---------------- phase 5: latency summary ---------------------------
    for kind, xs in sorted(lat.items()):
        log(f"[phase 5] p50 phase {kind}: {float(np.median(xs)):.3f} ms over "
            f"{len(xs)} requests ({smi})")
    log(f"[phase 5] host copy: phase 3 {json.dumps(copy3)}, "
        f"phase 4 {json.dumps(copy4)}")

    # ---------------- phase 6: kernel summary ----------------------------
    rep = tile_entries[0]
    bat = batch_entries["draws"]
    summary = {"kernels": [
        {"name": "tile_scoring_dense", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_scoring.py:871",
         "launches": launches["tile_scoring"], "max_abs_err": tile_err,
         "ms": rep["ms"], "plain_ms": rep["plain_ms"],
         "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
         "library_ms": rep["library_ms"],
         "with_counts": {"ms": rep["ms_with_counts"],
                         "bound_ms": rep["bound_ms_with_counts"]},
         "ladder_query": tile_entries[-1]},
        {"name": "segment_sum", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/segment_sum.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_aggs.py:128",
         "launches": launches["segment_sum"], "max_abs_err": seg_err,
         "ms": seg_entry["ms"], "plain_ms": seg_entry["plain_ms"],
         "bound_ms": seg_entry["bound_ms"],
         "bound_by": seg_entry["bound_by"],
         "library_ms": seg_entry["library_ms"]},
        {"name": "tile_scoring_batched", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_scoring.py:871",
         "launches": launches["tile_scoring_batched"],
         "max_abs_err": batch_errs["batched"],
         "ms": bat["batched_ms"], "plain_ms": bat["batched_plain_ms"],
         "bound_ms": bat["batched_bound_ms"],
         "bound_by": bat["batched_bound_by"],
         "library_ms": bat["batched_library_ms"],
         "q_batch": bat["q_batch"],
         "with_counts": {"ms": bat["batched_ms_with_counts"],
                         "bound_ms": bat["batched_bound_ms_with_counts"]},
         "ladder_batch": {k: v for k, v in batch_entries["ladder"].items()
                          if k.startswith(("batched", "sub", "union"))}},
        {"name": "tile_scoring_topk", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_scoring.py:871",
         "launches": launches["tile_scoring_topk"],
         "max_abs_err": batch_errs["topk"],
         "ms": bat["topk_ms"], "plain_ms": bat["topk_plain_ms"],
         "bound_ms": bat["topk_bound_ms"], "bound_by": bat["topk_bound_by"],
         "library_ms": bat["topk_library_ms"], "q_batch": bat["q_batch"],
         "k": 16, "q1": {"ms": bat["topk_q1_ms"],
                         "bound_ms": bat["topk_q1_bound_ms"]},
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
         "cases": [{key: e[key] for key in (
             "case", "q_batch", "rows", "d_pad", "metric", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")} for e in knn_entries],
         **knn_staging},
    ]}
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


def _adopt_copies(gnode, cnode, index, Segment):
    """Give the cpu node the cuda node's sealed segments, as host arrays."""
    for sid, shard in gnode.indices[index].shards.items():
        engine = cnode.indices[index].shards[sid].engine
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
                seqnos=seg.seqnos, versions=seg.versions, device="cpu")
            engine.adopt_segment(copy)
        engine.mapper_service.merge(shard.engine.mapper_service.mapping_dict())


if __name__ == "__main__":
    sys.exit(main())
