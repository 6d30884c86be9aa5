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
   beside its byte bound, its plain version and one PyTorch library call
   computing the same function.
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
   p50 latency per request kind and the per-segment host copy of the dense
   scores and mask.
6. The kernel summary line, then the device line.
"""

from __future__ import annotations

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
RTOL = 1e-5
INGEST_DOCS = 20_000

FAILS = []


def check(ok: bool, what: str) -> None:
    if not ok:
        FAILS.append(what)
        print(f"CHECK FAILED: {what}", flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def build_synthetic_corpus(seed=7):
    rng = np.random.RandomState(seed)
    nd_pad = 1
    while nd_pad < N_DOCS:
        nd_pad *= 2
    doc_len = np.clip(
        rng.lognormal(np.log(AVG_DOC_LEN), 0.4, N_DOCS), 5, 500
    ).astype(np.int64)
    total_tokens = int(doc_len.sum())
    ranks = np.arange(1, VOCAB + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    tokens = rng.choice(VOCAB, total_tokens, p=probs).astype(np.int32)
    doc_of_token = np.repeat(np.arange(N_DOCS, dtype=np.int32), doc_len)
    keys = tokens.astype(np.int64) * N_DOCS + doc_of_token
    uniq, counts = np.unique(keys, return_counts=True)
    term_ids = (uniq // N_DOCS).astype(np.int32)
    docs = (uniq % N_DOCS).astype(np.int32)
    tfs = counts.astype(np.float32)
    (block_docs, block_tfs, term_block_start, n_blocks_per_term,
     term_df) = pack_postings(term_ids, docs, tfs, VOCAB, nd_pad)
    norms = np.ones((1, nd_pad + 1), dtype=np.float32)
    norms[0, :N_DOCS] = doc_len.astype(np.float32)
    kranks = np.arange(1, N_ORDS + 1)
    kprobs = (1.0 / kranks) / (1.0 / kranks).sum()
    keyword_ord = rng.choice(N_ORDS, N_DOCS, p=kprobs).astype(np.int32)
    year = (1990 + rng.randint(0, 35, N_DOCS)).astype(np.float64)
    return {
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
        return N_DOCS

    def __getitem__(self, d):
        return {"n": int(d), "venue": f"v{int(self._venue[d]):04d}",
                "year": int(self._year[d])}


def corpus_segment_arrays(corpus):
    """The Segment.from_arrays fields for the corpus (one text field
    ``title``, keyword ``venue``, long ``year``)."""
    from elasticsearch_tpu_torch.index.segment import FIELD_SEP

    nd_pad = corpus["nd_pad"]
    cap = nd_pad  # next_pow2(N_DOCS)
    flat_docs = np.full(cap, nd_pad, np.int32)
    flat_docs[:N_DOCS] = np.arange(N_DOCS, dtype=np.int32)
    flat_ords = np.zeros(cap, np.int32)
    flat_ords[:N_DOCS] = corpus["keyword_ord"]
    first_ord = np.full(nd_pad, -1, np.int32)
    first_ord[:N_DOCS] = corpus["keyword_ord"]
    exists = np.zeros(nd_pad, bool)
    exists[:N_DOCS] = True
    vals = np.zeros(cap, np.float64)
    vals[:N_DOCS] = corpus["year"]
    first_value = np.zeros(nd_pad, np.float64)
    first_value[:N_DOCS] = corpus["year"]
    minv = np.full(nd_pad, np.inf)
    minv[:N_DOCS] = corpus["year"]
    maxv = np.full(nd_pad, -np.inf)
    maxv[:N_DOCS] = corpus["year"]
    live = np.zeros(nd_pad, bool)
    live[:N_DOCS] = True
    return dict(
        term_keys=[f"title{FIELD_SEP}{term_token(i)}" for i in range(VOCAB)],
        term_block_start=corpus["term_block_start"],
        term_block_count=corpus["n_blocks_per_term"],
        term_doc_freq=corpus["term_df"],
        block_docs=corpus["block_docs"], block_tfs=corpus["block_tfs"],
        norms=corpus["norms"], live=live,
        field_stats={"title": {"doc_count": N_DOCS,
                               "sum_ttf": corpus["sum_ttf"]}},
        field_norm_idx={"title": 0},
        doc_ids=[f"p{i}" for i in range(N_DOCS)],
        sources=_Sources(corpus),
        numeric_columns={"year": dict(
            flat_values=vals, flat_docs=flat_docs, first_value=first_value,
            min_value=minv, max_value=maxv, exists=exists, count=N_DOCS)},
        ordinal_columns={"venue": dict(
            terms=[f"v{o:04d}" for o in range(N_ORDS)], flat_ords=flat_ords,
            flat_docs=flat_docs, first_ord=first_ord, exists=exists,
            count=N_DOCS)},
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


def serve(gnode, cnode, index, reqs, label, lat, ref=None):
    """Serve each request on the cuda node (timed) and the cpu node,
    compare; ``ref(terms) -> (scores, live)`` checks recall@10."""
    import torch

    recalls = []
    for kind, body, terms in reqs:
        t0 = time.perf_counter()
        gr = gnode.search(index, body)
        torch.cuda.synchronize()
        lat.setdefault(f"{label.split()[1]}/{kind}", []).append(
            (time.perf_counter() - t0) * 1000)
        cr = cnode.search(index, body)
        same_response(gr, cr, f"{label} {kind} {json.dumps(body)[:120]}")
        check(gr["_plane"] == "host", f"{label} host plane")
        if ref is not None and terms is not None:
            scores = ref(terms)
            k = min(10, int((scores > 0).sum()))
            if k:
                kth = np.sort(scores)[::-1][k - 1]
                got = [int(h["_id"][1:]) for h in gr["hits"]["hits"][:10]]
                hit = sum(1 for d in got if scores[d] >= kth * (1 - 1e-6))
                recalls.append(hit / k)
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
        entry = {"query": [int(t) for t in terms], "sub": node.sub,
                 "n_tiles": node.n_tiles, "posting_rows": rows, "ms": ms,
                 "ms_with_counts": ms_c, "plain_ms": plain_ms,
                 "library_ms": library_ms,
                 "bound_ms": bytes_plain / HBM_BYTES_PER_S * 1e3,
                 "bound_ms_with_counts":
                     (bytes_plain + nd_geom * 4) / HBM_BYTES_PER_S * 1e3}
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
        "bound_ms": seg_bytes / HBM_BYTES_PER_S * 1e3,
        "max_count": int(k_cnt.max()),
    }
    log(f"[phase 2] segment_sum {json.dumps(seg_entry)} max_abs_err {seg_err}")

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
    for k, v in p3.items():
        check(v > 0, f"phase 3 launched {k}")
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
        return s

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
    for k, v in p4.items():
        check(v > 0, f"phase 4 launched {k}")
        launches[k] += v
    check(len(rec) > 0 and min(rec) == 1.0,
          f"recall@10 = 1.0 against reference_scores ({len(rec)} queries)")
    log(f"[phase 4] recall@10 over {len(rec)} match queries: min {min(rec)}")
    copy4 = host_copy_note(g4, "pmc", 2 * len(reqs4), "phase 4")

    # ---------------- phase 5: latency summary ---------------------------
    for kind, xs in sorted(lat.items()):
        log(f"[phase 5] p50 phase {kind}: {float(np.median(xs)):.3f} ms over "
            f"{len(xs)} requests ({smi})")
    log(f"[phase 5] host copy: phase 3 {json.dumps(copy3)}, "
        f"phase 4 {json.dumps(copy4)}")

    # ---------------- phase 6: kernel summary ----------------------------
    rep = tile_entries[0]
    summary = {"kernels": [
        {"name": "tile_scoring_dense", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/tile_scoring.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_scoring.py:871",
         "launches": launches["tile_scoring"], "max_abs_err": tile_err,
         "ms": rep["ms"], "plain_ms": rep["plain_ms"],
         "bound_ms": rep["bound_ms"], "bound_by": "bytes",
         "library_ms": rep["library_ms"],
         "with_counts": {"ms": rep["ms_with_counts"],
                         "bound_ms": rep["bound_ms_with_counts"]},
         "ladder_query": tile_entries[-1]},
        {"name": "segment_sum", "route": "cuda",
         "source": "elasticsearch_tpu_torch/csrc/segment_sum.cu",
         "replaces": "elasticsearch_tpu/ops/pallas_aggs.py:128",
         "launches": launches["segment_sum"], "max_abs_err": seg_err,
         "ms": seg_entry["ms"], "plain_ms": seg_entry["plain_ms"],
         "bound_ms": seg_entry["bound_ms"], "bound_by": "bytes",
         "library_ms": seg_entry["library_ms"]},
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
