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
6. The kernel summary line (with phase 11's ``rest`` entry, phase 12's
   ``aggs`` entry, phase 13's ``durability`` entry, phase 14's
   ``staging`` entry, phase 15's ``query_dsl`` entry, phase 16's
   ``sort_paging`` entry, phase 17's ``field_types`` entry, phase 18's
   ``nested`` entry, phase 19's ``search_request`` entry and phase 20's
   ``scripting`` entry), then the device line.

Run between phases 2 and 3, and after phase 4 (phase 10 after phase 9,
then phases 11, 12, 19, 20, 21, 22, 24, 13, 14, 15, 23, 16, 17 and 18):

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
11. REST on the card, after phase 10: the port's ``HttpServer`` on
    127.0.0.1 (ephemeral ports) and an ``http.client`` client. 11a: a
    fresh ``Node(device="cuda")`` takes phase 3's first 2,000 docs (cut
    from 20,000 as phase 22 joined) as NDJSON
    ``_bulk`` bodies of 1,000 (docs/s beside phase 3's in-process rate),
    ``_cat/count`` and a document GET; 11b: phase 3's requests on that
    index (host rung), phase 7's on pmc4 through ``HttpServer(g7)``
    (mesh_pallas), phase 9's kNN and hybrid bodies and one pruned match on
    phase 10's index, each equal to the in-process response of the same
    node (hybrid and pruned totals as ``{"value", "relation": "gte"}``);
    11c: 16 concurrent HTTP clients coalesced by the micro-batcher through
    the ``search`` pool, then ``_msearch``; 11d: ``DELETE`` returns
    ``memory_allocated`` to its level before the index; 11e: p50 in
    process, through the controller without a socket, and over HTTP, per
    request kind. The launch counters of tile_scoring*, segment_sum and
    knn_scoring must move; the summary line's ``rest`` entry holds the
    numbers.
12. Aggregations on the card, after phase 11 (``aggs_phase``): phase 7's
    pmc-4x256k arrays as new segments with two more doc-value columns
    (``ts``, a date over one year; ``citations``, a long missing on 3% of
    docs; drawn from RandomState(seed + 100)), in three indices of one
    ``Node(device="cuda")``: agg4 (the mesh plane, fused aggregations),
    agg4h (``search.aggs.fused: false``, the host reduce) and agg4x
    (``search.mesh: false``, the host rung), and a cpu node. A fused
    dashboard (terms, date_histogram 1d, histogram, stats, avg,
    value_count) under a time filter and under match queries equals the
    host reduce byte for byte; aggregations outside the fused envelope
    (sub-aggregations, calendar intervals, a sum past 2^53, 8,760 hourly
    buckets, range, date_range, filters, missing, global, cardinality,
    percentiles past the sampling threshold, extended_stats, top_hits,
    pipelines) are counted under the JAX package's reason names; every
    response equals the cpu node's; a 16-member ``search_batch`` of
    agg-carrying bodies runs as one dense 1b launch a slot (1d on a
    packed-codec index over the same segments) and 16 threads at
    ``Node.search`` form batches, each member equal to its serial
    response; deletes, then again; one request of each kind over HTTP.
    Every kernel-2 call (mask form and gather form) is replayed through
    its plain version and every 1b launch held bit for bit; prints p50
    per kind on the three indices, the host reduce's copied bytes, the
    staged doc_values bytes, the fused launches' kernel-2 plans (and one
    launch over the four slots timed against one launch a slot) and
    host-clock spans of fused requests and bursts; the summary line's
    ``aggs`` entry holds them.
13. Durability on the card, after phase 12 (``durability_phase``), every
    data path under a fresh ``tempfile.mkdtemp()`` removed at the end.
    13a: a ``Node(data_path=..., device="cuda")`` takes phase 3's first
    1,000 docs (cut from 5,000 as phase 22 joined) under
    ``index.translog.durability: async`` and 400
    under ``request`` (docs/s beside phase 3's), ``_flush``, every 100th
    doc deleted,
    ``close()``; reopened, phase 3's requests answer byte for byte as
    before on the host rung (1a, kernel 2 and its combine held against
    plain), seqnos
    continue, deletes stay, ``_forcemerge`` keeps totals and buckets and
    equals a cpu node over the same path. 13b: a child ``python3`` on the
    card is killed with SIGKILL mid-bulk under ``request`` durability
    (bulks of 400 docs, cut from 1,000 to pay for phase 21);
    reopened, every acknowledged doc is found (GET, ``terms`` on its id),
    none twice, totals equal an in-memory node over the recovered docs.
    13c: pmc-4x256k at full width (``ts``, ``citations``, ``emb``) in one
    durable index: phase 7's, 9's and 12's bodies and two bursts
    recorded, synced flush, close (``memory_allocated`` back to its
    level), reopen timed as load, staging and first answer (host clock
    with spans; the device split from a second, profiled answer after
    the mesh staging is dropped), every response bit for bit as before
    with ``_plane`` unchanged, every 1a, 1b, 1c, kernel-2 (and combine)
    and kernel-3 launch held against plain; bytes on disk. The summary line's ``durability``
    entry holds the numbers.
14. The staging lifecycle on the card, after phase 13 (``staging_phase``):
    pmc-4x256k at full width (phase 12's columns, phase 9's ``emb``) in
    three indices, delta staging on (``stg4``), off (``stg4f``, every
    change a rebuild) and on the cpu (``stg4c``), with
    ``index.search.mesh.max_slots_per_device: 8`` and pruning on. 14a the
    initial staging: the device-memory ledger equals the staged tensors'
    bytes and the allocator's requested bytes. 14b 4,096 docs a shard
    appended (one segment each): the next answer timed with its spans
    against the rebuild's, bytes restaged, amplification, reasons; every
    request kind of phases 7, 9 and 12 and three bursts (pruned, exact,
    aggs) equal byte for byte on both indices. 14c 1% of one shard
    deleted: only that slot's live rows restaged (reason ``tombstone``),
    timed against the rebuild. 14d the HBM budget: LRU eviction, the host
    rung with reason ``hbm_budget``, then a ``probe`` restage. 14e a
    transient staging fault retried, a deterministic one benched (reason
    ``staging_fault``), the ledger exact, the probe after the cooldown.
    14f compaction at a smaller depth (10,000 indexed docs: the adopted
    corpus keeps no text to re-analyze). Every launch of 14a-14f held
    against its plain version; the serial kinds equal the cpu node's;
    14g ``memory_allocated`` back to its level before the indices and the
    ledger at 0 bytes for them.
15. The query DSL beyond ``match`` on the card, after phase 14
    (``query_dsl_phase``). 15a: pmcq, pmc-4x256k's title (phase 7's
    corpora and token streams) beside an ``abstract`` from the same
    generator (seeds 17-20, a median of 40 tokens, empty on 3% of docs)
    under an LM-Dirichlet similarity (mu 2000), both with positions as
    flat columns, venue,
    year and emb as phase 7's, in three twins: ``pmcq`` on the card node
    (the mesh plane), ``pmcqh`` on it with ``search.mesh: false`` (the host
    rung) and ``pmcq`` on a cpu node. multi_match (best_fields over
    ``title^2, abstract`` with tie_breaker 0.3, most_fields), dis_max,
    prefix, wildcard, regexp, fuzzy, exists, ids, function_score
    (field_value_factor with log1p, random_score), match_phrase (at slop 0
    and 2), match_phrase_prefix, query_string, a terms aggregation under
    the multi_match (the fused plane) and more_like_this answer equally on
    the three (ids, totals, buckets exact; scores rtol 1e-5), with the
    plane each took; ``?q=`` over HTTP on ``_search`` and ``_count``;
    totals held against references of their own (exists, ids, the
    bigram count of the token streams). Every 1a launch held bit for bit
    and every kernel-2 call (with its combine) replayed through its plain
    version; then p50 per kind on pmcq and pmcqh over two runs, each
    phrase kind's host intersection ms apart from the rest, and each
    multi-term kind's expanded lanes. 15b: phase 3's first 1,000 docs
    into an
    index with a custom analyzer (html_strip, standard, lowercase, stop,
    stemmer) on ``title`` and ``english`` on ``title.en`` (docs/s beside
    phase 3's); match, match_phrase and query_string equal on the cpu
    node. The summary line's ``query_dsl`` entry holds the numbers.
16. Sort and paging on the card, after phase 15 (``sort_paging_phase``):
    pmc-4x256k's doc-values form (phase 12's ``ts`` and ``citations``,
    ``venue``, the title text rebuilt for highlighting) in ``srt4`` (the
    mesh plane) and ``srt4h`` (the host rung), each against a cpu node's
    twin. 16a every sort kind (field, missing policy, keyword by global
    ordinals, ``_doc``; ``ts`` and two fields on the host rung), its p50
    and plane, and the tie case's top-k candidates; 16b 20 search_after
    pages of 100 on the mesh and the host rung against one request; 16c
    slices of 2, 4 and 8; 16d rescore in each mode, terminate_after,
    collapse with inner_hits, highlight over HTTP; 16e a 1,000-hit scroll
    on ingest-20k's segments with deletes, appends, a refresh and a force
    merge between its pages, a sliced scroll over HTTP, and the memory
    ``clear_scroll`` and a reaped expiry return. Every 1a launch and
    kernel-2 call of its main path held against plain; the summary line's
    ``sort_paging`` entry holds the numbers.
17. Field types and text fielddata on the card, after phase 16
    (``geo_fields_phase``): two of pmc-4x256k's shards in their
    doc-values form with ``loc``
    (geo_point: one point for 93% of docs, two for 5%, none for 2%,
    around 500 zipf-weighted centres over the land masses, Rally
    geonames' shape), ``clientip`` (ip: 50,000 zipf-weighted addresses,
    10% IPv6, Rally http_logs' shape), ``active`` (a date_range of 1-90
    days in ``ts``'s year), ``title.length`` (token_count) and text
    fielddata on ``title``, in ``geo4`` (the mesh plane) and ``geo4h``
    (the host rung), each against a cpu node's twin. 17a geo_distance
    (50 km, 1,000 km), geo_bounding_box (one across the antimeridian) and
    geo_polygon under a match: p50, plane, the tile form's launches, the
    float64 boundary band left out of the comparison and counted; 17b
    ``_geo_distance`` sorts (host rung, ``sort_ineligible``) and 10
    search_after pages against one request; 17c geo_bounds, geo_centroid
    and geohash_grid (3, 5), and the vectorized geohash against the
    scalar loop; 17d ``active``'s relations, ip term / CIDR / range
    against a numpy oracle (ROADMAP C12), ip terms, ``title.length``;
    17e ``terms`` on ``title``: each segment's fielddata build and its
    breaker bytes, the kernel-2 gather plans over about 50,000
    ordinals, ``field_ineligible`` on the fused plane, and after
    ``DELETE`` the fielddata breaker and ``memory_allocated`` back to
    their levels; 17f ingest-20k's first 1,000 docs over ``bulk`` with
    every new type in each accepted form and one malformed value of each
    kind (a 400 with the JAX package's message), a flush and a restart
    through ``Node(data_path=...)`` answering as before. Every 1a (and
    mesh tile-form) launch and kernel-2 call held against plain; the
    summary line's ``field_types`` entry holds the numbers.
18. Nested documents and the parent-join field on the card, after phase
    17 (``nested_phase``): sonested-2x256k, the shape of Rally's
    ``nested`` track (two of pmc-4x256k's shards' titles as StackOverflow
    questions with ``qid``, ``user``, 1-5 zipf ``tag``s and
    ``creationDate``; 0-8
    ``answers`` as nested objects, about 0.89M, each with a zipf
    ``answers.user`` of 200,000 and an ``answers.date``), in ``sonested``
    (the mesh plane) and ``sonestedh`` (the host rung), and its join form
    (the same questions as ``question`` parents and a segment a shard of
    ``answer`` children routed by qid, about 1.4M docs) in ``sojoin`` /
    ``sojoinh``, each request against a cpu node's twin. 18a nested
    queries alone and under a match, every score_mode, inner_hits; 18b
    nested sorts (host rung, ``sort_ineligible``) and 10 search_after
    pages against one request; 18c nested date_histogram and nested
    terms -> reverse_nested -> terms (``unsupported_agg``), the kernel-2
    plans over the users' ordinals; 18d has_child, has_parent, parent_id,
    inner_hits, children -> terms, ROADMAP C13 on both indices, the
    join's own host ms; 18e deletes, a 4 x 4,096-question append and
    ``memory_allocated`` and the ledger after ``DELETE``; 18f bulk ingest
    of the nested, join and legacy ``_parent`` forms with one malformed
    doc of each kind, a force merge, a restart and ``stored_fields=
    _parent``. Every 1a, kernel-2 and kernel-3 launch held against plain;
    the summary line's ``nested`` entry holds the numbers.
19. The rest of the search request on the card, right after phase 12
    (``search_request_phase``), over indices phases 7, 10 and 12 built:
    19a Kibana 6.x Discover's body through ``_msearch`` on ``logs-*``
    (two index names over phase 12's segments, 2,097,152 docs, the host
    fan-out), equal to the cpu twin and to the single-index answers
    merged, and on the mesh index ``agg4``; 19b ``timeout`` with a
    ``SearchDelayScheme`` (a subset of the full answer, the
    ``allow_partial_search_results: false`` error), and a deadline that
    expires inside the mesh plane before its launch (``memory_allocated``
    and the ledger unchanged); 19c one failing shard (``_shards.failed``
    1, a ``runtime_error``) and every shard failing ("all shards
    failed"); 19d ``profile`` on ``mesh_pallas``, the host rung and kNN
    (the plane and the hits of the unprofiled request); 19e ``_explain``
    of a match's top 10 (the value the ``_score`` bit for bit), a miss,
    ``_validate/query``; 19f ``track_total_hits`` on the packed + pruned
    form (an exact total, ``eq``, beside the pruned ``gte``). Each item's
    p50, plane and launches; every launch held against plain; the
    summary line's ``search_request`` entry holds the numbers.
20. Scripting, the update API and mget on the card, right after phase 19
    (``scripting_phase``), over phase 12's doc-values segments (scr4, a
    mesh index with slot headroom; agg4x, the host rung; the cpu twin)
    and phase 3's ingest-20k: 20a the script query (a threshold on
    ``citations`` under a match and alone, ``.length``, a division by an
    absent field, a constant), totals equal to numpy counts; 20b
    ``script_fields`` (an expression with ``_score``, a painless string);
    20c ``scripted_metric`` with and without a reduce, exactly twice the
    sum of citations; 20d a painless script query's ms per 1,000 docs;
    20e 2,000 bulk updates over HTTP at ``async`` durability beside the
    bulk index rate, 200 single ``_update``s at ``request`` durability, a
    reopen replaying them, and a 1% update of scr4 whose first answer
    takes the delta append; 20f ``mget`` of 100 ids over two indices, the
    gets merged. Each item's p50 and plane; every launch held against
    plain; the summary line's ``scripting`` entry.
21. Cluster metadata on the card, right after phase 20
    (``cluster_metadata_phase``), over REST through an ``HttpServer`` on
    phase 7's node: 21a an index template with an alias, the log pattern
    (logs-a and logs-b over phase 12's doc-values segments, logs-c made
    through the template), ``_aliases``, a match with a ``terms`` through
    an alias, a pattern and the names (the same hits and buckets), an
    alias to one mesh index on ``mesh_pallas``, a filtered alias as
    ROADMAP C19 says, ``_cat/aliases`` and ``_cat/templates``; 21b a
    stored mustache template by id and inline, ``_render/template``; 21c
    transient cluster settings set and cleared: pruning (1e packed on a
    packed index over phase 10's segments), fused aggregations (kernel 2's
    gather form, then its mask form), kNN (the host rung, then kernel 3)
    and the HBM budget (the host rung, ``_nodes/stats``, then the mesh
    again); 21d ``refresh=wait_for`` writes at a 1 s interval (the delta
    append) and at -1, ``_close`` / ``_open``, ``PUT _mapping``,
    ``_stats``, ``_segments``, ``_cat/shards`` and ``_cat/segments``; 21e
    a small durable node whose template, persistent settings, stored
    script and alias survive a restart, pruning after it. Each item's
    p50, plane and launches; the ms from a ``PUT _cluster/settings`` to
    the changed answer; every launch held against plain; the summary
    line's ``cluster_metadata`` entry.
22. Data movement on the card, right after phase 21
    (``data_movement_phase``), over REST on phase 7's node: dm4, a new
    mesh index over pmc-4x256k's arrays (ids routed by their own hash,
    sources with the title, slot headroom); 22a ``_reindex`` of a match
    selecting about 5,000 docs (the scan's four 1a launches, its ms apart
    from the bulk, docs/s, the destination's count and ids, the task's
    status while it runs); 22b ``_update_by_query`` (painless) over about
    1% and the first answer through the delta append,
    ``_delete_by_query`` over another 1% held to the numpy postings count
    while a writer thread indexes into dm4 (point in time); 22c searches
    held on
    the host rung and on the mesh plane, listed by ``_tasks`` and
    cancelled (ms to the 400, no launch after, memory back); 22d 2,000
    ingest-20k docs as access-log lines through an nginx-shaped pipeline
    (``_bulk?pipeline=`` beside plain, ``_simulate`` equal to what is
    indexed); 22f rollover, shrink, ``_field_caps`` and ``_termvectors``
    p50s. 22e (``snapshot_restore_phase``) runs inside 13c on its
    recovered pmc-4x256k: snapshot and incremental snapshot (seconds,
    bytes), restore with ``rename_pattern`` (seconds, staging, first
    answer), 40 requests equal byte for byte, a corrupt blob failing its
    index alone. ``memory_allocated`` back after each by-query call and
    each cancel; every launch held against plain; the summary line's
    ``data_movement`` entry.
23. The field-type and query remainder on the card, right after phase 15
    (``remainder_phase``), over pmcq (which it closes) and phase 12's
    doc-values segments: 23a geo4, 4 x 65,536 docs with 262,144 shapes
    in Rally geoshape's mix, each relation alone on the host rung and
    beside a match on ``mesh_pallas``, totals equal to a numpy oracle,
    the prefilter's device ms apart from the host relation's; 23b
    logs-sorted (phase 12's arrays in ``ts`` desc by
    ``index_sorted_fields``): Discover terminates early with logs-a's
    hits; 23c the request cache on logs-a
    (a miss launches kernel 2, a hit nothing, a write misses again,
    ``_stats`` and ``_cache/clear``); 23d 1,000 stored queries, 20
    candidates percolated against a plain evaluation; 23e term and
    phrase suggest on pmcq, completion with contexts on 5,000 bulked
    docs; 23f each span kind alone and beside a match with its host
    enumeration ms, ``type``, ``_size``. Every launch held against
    plain; the summary line's ``remainder`` entry. A faster store load
    (13c's reopen and 22e's restore parse ``sources.jsonl`` in one pass)
    pays for part of its time.
24. The device-side infrastructure on the card, right after phase 22
    (``infrastructure_phase``), on phase 7's pmc-4x256k over REST, every
    answer equal to the cpu node's: 24a telemetry (``search.phases`` in
    ``_stats`` and ``_nodes/stats`` counts every request, a slowlog line
    a request with its X-Opaque-Id, ``hot_threads``); 24b admission (a
    24-client burst of two tenants against a queue of 6: admitted,
    rejected and pool-rejected partition what was sent, 429s carry
    ``Retry-After``; the brownout forces the pruned kernel 1e and sheds
    aggregations; the widened window batches an aggregation burst, 1b);
    24c the drain (in-flight searches finish, new ones get 503 with
    ``Retry-After``, a compaction aborts, undrain answers as before); 24e
    the fault schemes (a plane fault served by the next rung; a 1a and a
    kernel-3 launch fault answering 500 with nothing benched; an eviction
    storm: the answers equal, the kernel serving the next request); 24f the scrubber over pmc4h's staged tables (drift 0,
    then one flipped byte on the card: drift 1, restaged with the
    ``scrub`` reason). 24d runs in 13c: its durable index reopened with
    ``search.compile.warm_on_start``, the warm replay joined, the first
    answer beside 13c's cold one, every answer as before the close. The
    other phases' reopens are cold (``cold_reopen``). Every launch held
    against plain; the summary line's ``infrastructure`` entry.

Every index a phase builds pins ``index.refresh_interval: -1`` (the
port's scheduled refresh runs every second by default): its segment
layout, and the ingest rates and restage counts the checks read, stay
those of one explicit refresh. Only 21d runs the schedule. Beside it
each pins ``index.requests.cache.enable: false`` (the shard request
cache is on by default and would answer a repeated ``size: 0`` body
from memory): every request a phase repeats runs the query path and
its launches are held. Only 23c's logs-a keeps the cache on.

Every answer any phase gets from ``Node.search`` (``msearch`` and REST
through it), ``IndexService.search`` or ``search_batch`` must show
``_shards.failed == 0`` and ``timed_out: false`` unless the phase injects
a fault (``install_soundness_guard``): the per-shard failure isolation
must not hide a kernel fault behind a 200 answer.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import select
import shutil
import signal
import subprocess
import sys
import tempfile
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
# 11a's bulk over HTTP: phase 3's first docs (cut from 20,000 as phase 22
# joined; its rate needs no more)
HTTP_INGEST_DOCS = 2_000
# 13a's request-durability index: the first of phase 3's docs, one fsync
# pair an op (its rate needs no more; cut from 1,000 as phase 21 joined)
REQUEST_DURABLE_DOCS = 400
# 13a's async ingest, 15b's analyzed ingest and 17f's ingest with the
# field types: phase 3's first docs (cut from 20,000 to 10,000 as phase
# 17 joined, to 5,000 as phase 18 joined, 15b's and 17f's to 2,500 as
# phase 21 joined, and all three to 1,000 as phase 22 joined, to keep
# the script's time)
ASYNC_DURABLE_DOCS = 1_000
ANALYZED_DOCS = 1_000
GEO_INGEST_DOCS = 1_000
# phase 17's geo4 / geo4h: two of pmc-4x256k's shards (cut from four: a
# depth cut, the coverage is a multi-shard mesh's)
GEO_SHARDS = 2
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


def unique_counts(keys):
    """``np.unique(keys, return_counts=True)`` of an int64 array, sorted on
    the card (tens of millions of keys a corpus)."""
    import torch

    u, c = torch.unique(torch.from_numpy(keys).to("cuda"), sorted=True,
                        return_counts=True)
    return u.cpu().numpy(), c.cpu().numpy()


def draw_tokens(rng, n, probs, threads=8):
    """``rng.choice(len(probs), n, p=probs)`` drawn the way RandomState
    draws it (one ``random_sample(n)`` against the cumulated
    probabilities, so the values and the generator's state after it are
    the same), with the search over the cdf split across threads (numpy
    releases the GIL there): tens of millions of tokens a corpus."""
    from concurrent.futures import ThreadPoolExecutor

    cdf = probs.cumsum()
    cdf /= cdf[-1]
    uniform = rng.random_sample(n)
    with ThreadPoolExecutor(threads) as pool:
        parts = list(pool.map(lambda u: cdf.searchsorted(u, side="right"),
                              np.array_split(uniform, threads)))
    return np.concatenate(parts)


def build_synthetic_corpus(seed=7, n_docs=N_DOCS, empty_share=0.0,
                           keep_stream=False, avg_len=AVG_DOC_LEN):
    """``empty_share``: the share of docs drawn empty (no token: the field
    is missing there). ``keep_stream``: also return the token stream
    (``tokens``, in doc order) and ``doc_len``, the positions' source.
    ``avg_len``: the docs' median token count."""
    rng = np.random.RandomState(seed)
    nd_pad = 1
    while nd_pad < n_docs:
        nd_pad *= 2
    doc_len = np.clip(
        rng.lognormal(np.log(avg_len), 0.4, n_docs), 5, 500
    ).astype(np.int64)
    if empty_share:
        doc_len[rng.rand(n_docs) < empty_share] = 0
    total_tokens = int(doc_len.sum())
    ranks = np.arange(1, VOCAB + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    tokens = draw_tokens(rng, total_tokens, probs).astype(np.int32)
    doc_of_token = np.repeat(np.arange(n_docs, dtype=np.int32), doc_len)
    keys = tokens.astype(np.int64) * n_docs + doc_of_token
    uniq, counts = unique_counts(keys)
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
    stream = {"tokens": tokens, "doc_len": doc_len} if keep_stream else {}
    return {"n_docs": n_docs, **stream,
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


def same_response(gr, cr, what, claim="cuda response equals cpu response"):
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
    check(ok, f"{claim}: {what}")


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
        "settings": {"number_of_shards": shards, "refresh_interval": "-1",
                     "requests.cache.enable": False},
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
    names = []
    # a trace that caught no device event at all is a failed capture (the
    # tracer, not fn): take it again, at most three times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if getattr(e, "device_type", None) == DeviceType.CUDA]
        if names:
            break
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


def note_segsum_held(torch, ssum, nd, kw, out, plain, errs, held):
    """One segment-sum call replayed against plain: each kernel its plan
    launched (the main pass, and the combine pass that wrote or zeroed
    the outputs) is held through the call's outputs; ``held[name]``
    counts it, ``errs[name]`` takes the call's largest difference."""
    n_ords = kw["n_ords"]
    if n_ords == 0:
        return
    p = ssum.segment_sum_plan(nd, n_ords, kw.get("with_count", True),
                              out[1] is not None,
                              torch.cuda.get_device_properties(
                                  0).multi_processor_count)
    err = 0.0
    for a, b in zip(out, plain):
        if a is not None:
            err = max(err, float((a.double() - b.double()).abs().max()))
    for name in ("segment_sum", "segment_sum_combine")[: p.kernels]:
        held[name] = held.get(name, 0) + 1
        errs[name] = max(errs.get(name, 0.0), err)


def check_kept_segsum(torch, ssum, kept, label, errs=None, held=None):
    """Replay each kept main-path segment-sum call through the plain version
    on the same inputs: counts equal, sums within tolerance. With ``errs``
    and ``held``, note each call's kernels (note_segsum_held)."""
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
        if held is not None:
            note_segsum_held(torch, ssum, args[0].shape[0], kw, out, plain,
                             errs, held)
    return len(kept)


@contextlib.contextmanager
def recording_mask_segsum(ssum):
    """While the block runs, keep (args, kwargs, outputs) of every f32-mask
    segment-sum call on the card (the fused bucket counts, the histogram
    ops)."""
    orig = ssum.segment_counts_sums
    kept = []

    def recording(*args, **kw):
        out = orig(*args, **kw)
        if args[0].is_cuda:
            kept.append((args, kw, out))
        return out

    ssum.segment_counts_sums = recording
    try:
        yield kept
    finally:
        ssum.segment_counts_sums = orig


def check_kept_mask_segsum(torch, ssum, kept, label, errs=None,
                           held=None):
    """Replay each kept f32-mask call through the plain version: counts
    equal, sums within SUM_RTOL / SUM_ATOL of each bucket's sum of |v|.
    With ``errs`` and ``held``, note each call's kernels
    (note_segsum_held)."""
    plans = {}
    for n, (args, kw, out) in enumerate(kept):
        ords, mask = args[0], args[1]
        values = args[2] if len(args) > 2 else kw.get("values")
        plain = ssum.segment_sum_plain(
            ords, mask, values, n_ords=kw["n_ords"],
            with_count=kw.get("with_count", True),
            with_sum=values is not None)
        torch.cuda.synchronize()
        ok = out[0] is None or torch.equal(out[0], plain[0])
        if out[1] is not None:
            valid = (mask > 0) & (ords >= 0) & (ords < kw["n_ords"])
            absum = torch.bincount(
                ords[valid].long(), weights=ssum.sanitize_values(
                    values)[valid].abs().double(),
                minlength=kw["n_ords"]).float()
            ok = ok and bool(((out[1] - plain[1]).abs()
                              <= ssum.SUM_RTOL * absum + ssum.SUM_ATOL).all())
        check(ok, f"{label} segment_sum mask-form launch {n} (nd "
                  f"{ords.shape[0]}, n_ords {kw['n_ords']}) equals plain")
        if held is not None:
            note_segsum_held(torch, ssum, ords.shape[0], kw, out, plain,
                             errs, held)
        p = ssum.segment_sum_plan(ords.shape[0], kw["n_ords"],
                                  kw.get("with_count", True),
                                  values is not None,
                                  torch.cuda.get_device_properties(
                                      0).multi_processor_count)
        key = f"nd {ords.shape[0]} n_ords {kw['n_ords']}"
        plans[key] = {"path": p.path, "grid": p.grid, "threads": p.threads,
                      "kernels": p.kernels, "launches":
                      plans.get(key, {}).get("launches", 0) + 1}
    return plans


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
    Segment.from_arrays fields without the vectors, the held segment-sum
    launches, each shard's title token stream and doc lengths)."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(MESH_SEEDS)) as pool:
        corpora = list(pool.map(lambda seed: build_synthetic_corpus(
            seed, MESH_SHARD_DOCS, keep_stream=True), MESH_SEEDS))
    log(f"[phase 7] pmc-4x256k corpora: {[c['block_docs'].shape[0] for c in corpora]} "
        f"posting blocks ({time.perf_counter() - t0:.1f} s)")
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"},
        "emb": {"type": "dense_vector", "dims": KNN_DIMS,
                "similarity": "cosine"}}}}
    gnode, cnode = Node(device="cuda"), Node(device="cpu")
    for node in (gnode, cnode):
        node.create_index("pmc4", {"settings": {
            "number_of_shards": 4, "refresh_interval": "-1",
            "requests.cache.enable": False}, "mappings": mapping})
        node.create_index("pmc4h", {"settings": {
            "number_of_shards": 4, "refresh_interval": "-1",
            "requests.cache.enable": False,
            "search": {"mesh": False}},
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
    tombstoned = svc._mesh_search.tombstone_update_total
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
    check(svc._mesh_search.tombstone_update_total == tombstoned + 1
          and svc._mesh_search.restage_total == restaged,
          "pmc4 deletes reached the staging once, as a tombstone of the "
          "slots' live rows (no rebuild)")
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
    streams = [(c["tokens"], c["doc_len"]) for c in corpora]
    return (gnode, cnode, gsegs, csegs, shard_arrays, held["segment_sum"],
            streams)


def cold_reopen(Node, path, device, settings=None):
    """A durable node reopened without the warm replay
    (``search.compile.warm_on_start: false``): the cold reopen the
    recovery phases time and hold their launches on; phase 24d reopens
    warm."""
    from elasticsearch_tpu_torch.common.settings import Settings

    return Node(Settings({**(settings or {}),
                          "search.compile.warm_on_start": False}),
                data_path=path, device=device)


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
    (the terms aggregations: the gather form of the host reduce, the mask
    form of the fused plane) replayed through its plain version. ``held``
    counts the launches held, by launch name."""
    from elasticsearch_tpu_torch.ops import segment_sum as ssum

    with recording_tile_launches(
            tsc, lambda k: launch_name(k) == "tile_scoring") as kept, \
            recording_segsum_calls(ssum) as kept_seg, \
            recording_mask_segsum(ssum) as kept_mask:
        out = serve(gnode, cnode, index, reqs, label, lat, **kw)
    torch.cuda.synchronize()
    held["tile_scoring"] += check_kept_launches(
        torch, tsc, kept, errs, label).get("tile_scoring", 0)
    n_seg = check_kept_segsum(torch, ssum, kept_seg, label)
    check_kept_mask_segsum(torch, ssum, kept_mask, label)
    held["segment_sum"] = (held.get("segment_sum", 0) + n_seg
                           + len(kept_mask))
    log(f"[{label}] {n_seg} gather-form and {len(kept_mask)} mask-form "
        f"(fused bucket counts) main-path segment_sum launches held "
        f"against plain")
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
        if args[0].is_cuda:
            kept.append((args, kw, out))
        return out

    knn.knn_score_tiles = recording
    try:
        yield kept
    finally:
        knn.knn_score_tiles = orig


def same_knn_response(gr, cr, tol, what,
                      claim="cuda response equals cpu response"):
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
    check(ok, f"{claim} within {tol}: {what}")


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
        node.create_index("pmc1", {"settings": {
            "number_of_shards": 1, "refresh_interval": "-1",
            "requests.cache.enable": False}, "mappings": mapping})
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
    rest_bodies = [(kind, body) for kind, body, _i in serial[:1]] + hybrid
    return {"mesh_knn_staging_bytes": mask_bytes,
            "segment_vector_bytes": own}, rest_bodies


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
    plain version on the inputs the path gave it. Returns the report, the
    card node and its cpu twin."""
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
        settings["refresh_interval"] = "-1"
        settings["requests.cache.enable"] = False
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
    # four match queries (cut from eight: a depth cut, each kind is kept)
    matches = [{"query": {"match": {"title": " ".join(tok(t) for t in q)}},
                "size": 10} for q in queries[:4]]
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
        tombstoned = svc._mesh_search.tombstone_update_total
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
        check(svc._mesh_search.tombstone_update_total == tombstoned + 1
              and svc._mesh_search.restage_total == restaged,
              "pmc4p deletes reached the staging once, as a tombstone of "
              "the slots' live rows (no rebuild)")
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
    return report, gP, cP


# ----------------------------------------------------------------------
# Phase 11: REST on the card
# ----------------------------------------------------------------------


class HttpClient:
    """One keep-alive HTTP/1.1 connection (a client thread's own), with
    TCP_NODELAY as the Elasticsearch clients set it (urllib3's default;
    ``nodelay=False`` keeps http.client's own socket): http.client sends
    a request's headers and body in two writes."""

    def __init__(self, port, nodelay=True):
        import http.client
        import socket

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        self.conn.connect()
        if nodelay:
            self.conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                      1)

    def call(self, method, path, body=None, ctype="application/json"):
        """-> (status, decoded body); the body is JSON or NDJSON bytes."""
        status, _headers, out = self.request(method, path, body, ctype)
        return status, out

    def request(self, method, path, body=None, ctype="application/json",
                headers=None):
        """-> (status, response headers, body): JSON decoded, text as a
        string; ``headers`` go with the request (an X-Opaque-Id)."""
        if body is not None and not isinstance(body, bytes):
            body = json.dumps(body).encode()
        hdrs = dict(headers or {})
        if body is not None:
            hdrs["Content-Type"] = ctype
        self.conn.request(method, path, body=body, headers=hdrs)
        resp = self.conn.getresponse()
        raw = resp.read()
        got = {k: v for k, v in resp.getheaders()}
        if not raw:
            return resp.status, got, None
        if (resp.getheader("Content-Type") or "").startswith("text/"):
            return resp.status, got, raw.decode()
        return resp.status, got, json.loads(raw)

    def close(self):
        self.conn.close()


def _as_json(resp):
    """What a response looks like after the wire: a JSON round trip."""
    return json.loads(json.dumps(resp))


def _same_but_took(a, b):
    a = {k: v for k, v in a.items() if k != "took"}
    b = {k: v for k, v in b.items() if k != "took"}
    return a == b


def rest_phase(torch, Node, cuda_kernels, ops, inproc_rate, reqs, g7, c7, gP,
               queries, top_rank_term, knn_bodies, launches):
    """Phase 11: the port's HttpServer on 127.0.0.1 (ephemeral ports), a
    plain http.client client.

    11a. A fresh Node(device="cuda"): PUT /docs_http (phase 3's mapping, 5
         shards), phase 3's 20,000 docs as NDJSON _bulk bodies of 1,000,
         _refresh; _cat/count says 20,000; GET /docs_http/_doc/d1 equals
         node.get_doc. Docs/s over HTTP beside phase 3's in-process rate.
    11b. Requests over HTTP, each equal to json.loads(json.dumps(
         node.search(...))) of the same body on the same node (took
         aside; hybrid and pruned totals as the REST layer renders them):
         phase 3's requests on docs_http (host rung, 1a, kernel 2); phase
         7's on pmc4 through HttpServer(g7) (mesh_pallas, 1c, kernel 2),
         also equal to the cpu node c7; phase 9's pure-kNN and hybrid
         bodies (kernel 3); one pruned match on phase 10's pmc4p, whose
         total renders {"value", "relation": "gte"}.
    11c. 16 client threads POST different match bodies to /pmc4/_search at
         once: every response equals its serial one and the micro-batcher
         forms a batch of >= 2 (through the search pool); then one
         _msearch of the same 16 bodies equals them.
    11d. torch.cuda.memory_allocated() before 11a's PUT, after its first
         search, after DELETE /docs_http: the third within 1 MB of the
         first; then GET /docs_http/_search is a 404.
    11e. p50 over 20 runs (after 3 warm-ups) in process, through the
         controller without a socket, and over HTTP, for match_or and
         terms_agg on pmc4 (mesh_pallas), kNN k 10 on pmc4, and match_or
         on docs_http (host rung); and the fixed cost of a request whose
         handler does no search (GET /_cluster/health).
    The launch counters of tile_scoring*, segment_sum and knn_scoring
    must move during the phase. Returns the report."""
    import threading

    from elasticsearch_tpu_torch.common.xcontent import JSON, serialize
    from elasticsearch_tpu_torch.rest.handlers import _render_total_hits
    from elasticsearch_tpu_torch.rest.http_server import HttpServer

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    report = {}
    inproc_ms, dispatch_ms, http_ms, nagle_ms = {}, {}, {}, {}

    def timed_pair(node, srv, client, index, body, label, reps=20, warm=3):
        """In process, through the controller with no socket (the pool
        hop, the handler and the response's json.dumps), over HTTP, and
        over HTTP from a client without TCP_NODELAY."""
        raw = json.dumps(body).encode()
        plain = HttpClient(srv.port, nodelay=False)
        for i in range(warm + reps):
            t0 = time.perf_counter()
            node.search(index, dict(body))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, payload = srv.controller.dispatch(
                "POST", f"/{index}/_search", {}, raw, "application/json")
            serialize(payload, JSON)
            t2 = time.perf_counter()
            st2, _ = client.call("POST", f"/{index}/_search", body)
            t3 = time.perf_counter()
            st3, _ = plain.call("POST", f"/{index}/_search", body)
            t4 = time.perf_counter()
            check(st == st2 == st3 == 200, f"phase 11e {label}: 200")
            if i >= warm:
                inproc_ms.setdefault(label, []).append((t1 - t0) * 1000)
                dispatch_ms.setdefault(label, []).append((t2 - t1) * 1000)
                http_ms.setdefault(label, []).append((t3 - t2) * 1000)
                nagle_ms.setdefault(label, []).append((t4 - t3) * 1000)
        plain.close()

    def timed_fixed(srv, client, reps=20, warm=3):
        """The HTTP layer's fixed cost: GET /_cluster/health, whose
        handler does no search."""
        for i in range(warm + reps):
            t0 = time.perf_counter()
            srv.controller.dispatch("GET", "/_cluster/health", {}, b"")
            t1 = time.perf_counter()
            st, _ = client.call("GET", "/_cluster/health")
            t2 = time.perf_counter()
            check(st == 200, "phase 11e GET /_cluster/health: 200")
            if i >= warm:
                dispatch_ms.setdefault("health", []).append((t1 - t0) * 1000)
                http_ms.setdefault("health", []).append((t2 - t1) * 1000)

    def held(node, client, index, body, what, also=None):
        """One body over HTTP against the same node in process."""
        st, got = client.call("POST", f"/{index}/_search", body)
        want = _as_json(node.search(index, dict(body)))
        _render_total_hits(want, body)
        check(st == 200 and _same_but_took(got, want),
              f"phase 11b {what}: HTTP response equals the in-process one")
        if also is not None:
            same_response(got, _as_json(also.search(index, dict(body))),
                          f"phase 11b {what} (vs the cpu node)")
        return got

    # ---- 11a: the write path over HTTP ----
    ops = ops[:HTTP_INGEST_DOCS]
    mem0 = torch.cuda.memory_allocated()
    gH = Node(device="cuda")
    srv = HttpServer(gH, port=0)
    srv.start()
    client = HttpClient(srv.port)
    try:
        t0 = time.perf_counter()
        st, r = client.call("PUT", "/docs_http", {
            "settings": {"number_of_shards": 5, "refresh_interval": "-1",
                         "requests.cache.enable": False},
            "mappings": {"_doc": {"properties": {
                "title": {"type": "text"}, "venue": {"type": "keyword"},
                "year": {"type": "long"}}}}})
        check(st == 200 and r["acknowledged"], "phase 11a PUT /docs_http")
        errors = False
        for lo in range(0, len(ops), 1000):
            lines = []
            for _action, meta, src in ops[lo: lo + 1000]:
                lines.append(json.dumps(
                    {"index": {"_index": "docs_http", "_id": meta["_id"]}}))
                lines.append(json.dumps(src))
            st, r = client.call("POST", "/_bulk",
                                ("\n".join(lines) + "\n").encode(),
                                "application/x-ndjson")
            errors = errors or st != 200 or r["errors"]
        st, _ = client.call("POST", "/docs_http/_refresh")
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        check(not errors and st == 200, "phase 11a bulk over HTTP")
        report["ingest_docs_per_s_http"] = len(ops) / ingest_s
        report["ingest_docs_per_s_inprocess"] = inproc_rate
        log(f"[phase 11a] bulk {len(ops)} docs over HTTP + refresh in "
            f"{ingest_s:.2f} s: {len(ops) / ingest_s:.0f} docs/s (phase 3 "
            f"in process: {inproc_rate:.0f} docs/s)")
        st, r = client.call("GET", "/_cat/count/docs_http?format=json")
        check(st == 200 and r[0]["count"] == len(ops),
              f"phase 11a _cat/count = {len(ops)} (got {r})")
        st, r = client.call("GET", "/docs_http/_doc/d1")
        check(st == 200 and r == _as_json(gH.get_doc("docs_http", "d1")),
              "phase 11a GET /docs_http/_doc/d1 equals node.get_doc")
        st, _ = client.call("POST", "/docs_http/_search", reqs[0][1])
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        # ---- 11b on the host rung ----
        for kind, body, _t in reqs:
            got = held(gH, client, "docs_http", body, f"docs_http {kind}")
            check(got.get("_plane") == "host",
                  f"phase 11b docs_http {kind} on the host rung")
        # ---- 11e on the host rung ----
        timed_pair(gH, srv, client, "docs_http", reqs[0][1],
                   "match_or docs_http")
        # ---- 11d: delete ----
        st, r = client.call("DELETE", "/docs_http")
        check(st == 200 and r == {"acknowledged": True},
              "phase 11d DELETE /docs_http")
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
        st, r = client.call("GET", "/docs_http/_search")
        check(st == 404 and r["error"]["type"] == "index_not_found_exception",
              f"phase 11d deleted index answers 404 ({st}, {r})")
    finally:
        client.close()
        srv.stop()
        gH.close()
    report["memory_allocated"] = {"before_put": mem0,
                                  "after_first_search": mem1,
                                  "after_delete": mem2}
    check(abs(mem2 - mem0) <= 1 << 20,
          f"phase 11d DELETE returned device memory to within 1 MB "
          f"({mem0} -> {mem1} -> {mem2} bytes)")
    log(f"[phase 11d] memory_allocated before PUT {mem0}, after the first "
        f"search {mem1} (+{(mem1 - mem0) / 1e6:.3f} MB), after DELETE {mem2} "
        f"({(mem2 - mem0) / 1e6:+.6f} MB)")

    # ---- 11b on pmc4 (mesh_pallas, kNN, hybrid) and pmc4p (pruned) ----
    s7, sP = HttpServer(g7, port=0), HttpServer(gP, port=0)
    s7.start()
    sP.start()
    c7c, cPc = HttpClient(s7.port), HttpClient(sP.port)
    try:
        for kind, body, _t in requests_for(queries[:12], top_rank_term,
                                           "v0001", 2000):
            got = held(g7, c7c, "pmc4", body, f"pmc4 {kind}", also=c7)
            check(got.get("_plane") == ("mesh" if kind == "match_all"
                                        else "mesh_pallas"),
                  f"phase 11b pmc4 {kind} plane ({got.get('_plane')})")
        for kind, body in knn_bodies:
            got = held(g7, c7c, "pmc4", body, f"pmc4 {kind}")
            if kind.startswith("hybrid"):
                check(got["hits"]["total"].get("relation") == "gte",
                      f"phase 11b {kind}: total renders as gte "
                      f"({got['hits']['total']})")
        pruned_body = {"query": {"match": {"title": " ".join(
            term_token(t) for t in queries[0])}}, "size": 10}
        got = held(gP, cPc, "pmc4p", pruned_body, "pmc4p pruned match")
        total = got["hits"]["total"]
        check("_pruned" in got and isinstance(total, dict)
              and set(total) == {"value", "relation"}
              and total["relation"] == "gte",
              f"phase 11b pruned total renders {{value, relation: gte}} "
              f"({total})")

        # ---- 11c: concurrency through the search pool ----
        bodies = [{"query": {"match": {"title": " ".join(
            term_token(t) for t in q)}}, "size": 10} for q in queries[:BURST]]
        serial = [_as_json(g7.search("pmc4", dict(b))) for b in bodies]
        svc = g7.indices["pmc4"]
        hist0 = dict(svc.batch_stats.batch_size_histogram)
        clients = [HttpClient(s7.port) for _ in range(BURST)]
        rounds = 0
        try:
            for rounds in range(1, 4):
                got = {}
                start = threading.Barrier(BURST)

                def worker(i):
                    start.wait()
                    got[i] = clients[i].call("POST", "/pmc4/_search",
                                             bodies[i])

                threads = [threading.Thread(target=worker, args=(i,))
                           for i in range(BURST)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300.0)
                    check(not t.is_alive(), "phase 11c client finished")
                for i in range(BURST):
                    st, r = got.get(i, (None, None))
                    check(st == 200 and _same_exact(r, serial[i]),
                          f"phase 11c member {i} equals its serial response")
                hist = svc.batch_stats.batch_size_histogram
                if any(int(n) >= 2 and hist.get(n, 0) > hist0.get(n, 0)
                       for n in hist):
                    break
        finally:
            for c in clients:
                c.close()
        hist = dict(svc.batch_stats.batch_size_histogram)
        gained = {n: hist[n] - hist0.get(n, 0) for n in hist
                  if hist[n] > hist0.get(n, 0)}
        check(any(int(n) >= 2 for n in gained),
              f"phase 11c HTTP concurrency formed a batch of >= 2 "
              f"(histogram gained {gained})")
        pool = g7.thread_pool.executor("search")
        report["burst"] = {"clients": BURST, "rounds": rounds,
                           "histogram_gained": gained,
                           "search_pool_threads": pool.threads,
                           "search_pool_queue": pool.queue_size}
        log(f"[phase 11c] {BURST} HTTP clients, {rounds} round(s): batch "
            f"sizes gained {gained}; search pool {pool.threads} threads, "
            f"queue {pool.queue_size}")
        lines = []
        for b in bodies:
            lines += [json.dumps({"index": "pmc4"}), json.dumps(b)]
        st, r = c7c.call("POST", "/_msearch", ("\n".join(lines) + "\n"
                                               ).encode(),
                         "application/x-ndjson")
        check(st == 200 and len(r["responses"]) == BURST
              and all(_same_exact(x, serial[i])
                      for i, x in enumerate(r["responses"])),
              "phase 11c _msearch of the 16 bodies equals their serial "
              "responses")

        # ---- 11e: latency over HTTP and in process ----
        agg_body = next(b for k, b, _t in reqs if k == "terms_agg")
        timed_pair(g7, s7, c7c, "pmc4", bodies[0], "match_or pmc4")
        timed_pair(g7, s7, c7c, "pmc4", agg_body, "terms_agg pmc4")
        timed_pair(g7, s7, c7c, "pmc4", knn_bodies[0][1], "knn_k10 pmc4")
        timed_fixed(s7, c7c)
    finally:
        c7c.close()
        cPc.close()
        s7.stop()
        sP.stop()
    overhead = {}
    for label in http_ms:
        a = (float(np.median(inproc_ms[label])) if label in inproc_ms
             else 0.0)
        d = float(np.median(dispatch_ms[label]))
        b = float(np.median(http_ms[label]))
        overhead[label] = {"inprocess_p50_ms": a, "dispatch_p50_ms": d,
                           "http_p50_ms": b, "overhead_ms": b - a}
        if label in nagle_ms:
            overhead[label]["http_client_nagle_p50_ms"] = float(
                np.median(nagle_ms[label]))
        log(f"[phase 11e] {label}: in process p50 {a:.3f} ms, controller "
            f"dispatch (no socket) p50 {d:.3f} ms, HTTP p50 {b:.3f} ms, "
            f"REST overhead {b - a:.3f} ms; {json.dumps(overhead[label])}")
    report["latency"] = overhead
    torch.cuda.synchronize()
    p11 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 11] kernel launches: {p11}")
    check(sum(v for k, v in p11.items() if k.startswith("tile_scoring")) > 0
          and p11["segment_sum"] > 0 and p11["knn_scoring"] > 0,
          f"phase 11 launched tile_scoring*, segment_sum and knn_scoring "
          f"over REST ({p11})")
    for k, v in p11.items():
        launches[k] += v
    report["launches"] = {k: v for k, v in p11.items() if v}
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 11] {report['seconds']:.1f} s")
    return report


# ----------------------------------------------------------------------
# Aggregations on the card (pmc-4x256k with doc-value columns)
# ----------------------------------------------------------------------

AGG_T0 = 1_672_531_200_000  # 2023-01-01T00:00:00Z
AGG_DAY = 86_400_000
AGG_MISSING = 0.03  # citations: the share of docs without a value


def _numeric_column(values, present, nd_pad):
    """A single-valued Segment.from_arrays numeric column."""
    docs = np.flatnonzero(present).astype(np.int32)
    cap = 1
    while cap < max(len(docs), 1):
        cap *= 2
    flat_docs = np.full(cap, nd_pad, np.int32)
    flat_docs[: len(docs)] = docs
    flat_values = np.zeros(cap, np.float64)
    flat_values[: len(docs)] = values[docs]
    exists = np.zeros(nd_pad, bool)
    exists[docs] = True
    first = np.zeros(nd_pad, np.float64)
    first[docs] = values[docs]
    lo = np.full(nd_pad, np.inf)
    lo[docs] = values[docs]
    hi = np.full(nd_pad, -np.inf)
    hi[docs] = values[docs]
    return dict(flat_values=flat_values, flat_docs=flat_docs,
                first_value=first, min_value=lo, max_value=hi, exists=exists,
                count=len(docs))


def agg_columns(sh, nd_pad, n, seed=None):
    """The phase-12 doc-value columns of shard ``sh`` (their own
    RandomState, seed + 100, so phases 2-11's corpus is unchanged; phase
    14's appended docs pass a ``seed`` of their own): ``ts``, integer
    epoch-millis over one year; ``citations``, a zipf count missing on
    about 3% of docs. Returns Segment.from_arrays numeric columns."""
    rng = np.random.RandomState(MESH_SEEDS[sh] + 100 if seed is None
                                else seed)
    ts = AGG_T0 + rng.randint(0, 365 * AGG_DAY, n).astype(np.int64)
    cit = np.minimum(rng.zipf(1.8, n), 100_000).astype(np.int64)
    has = rng.rand(n) >= AGG_MISSING
    return {"ts": _numeric_column(ts.astype(np.float64), np.ones(n, bool),
                                  nd_pad),
            "citations": _numeric_column(cit.astype(np.float64), has,
                                         nd_pad)}


def agg_requests(queries):
    """Phase 12's requests: (kind, body, expected fallback reason or None
    for the fused plane)."""
    tok = term_token
    dash = {
        "venues": {"terms": {"field": "venue", "size": 10}},
        "per_day": {"date_histogram": {"field": "ts", "interval": "1d"}},
        "years": {"histogram": {"field": "year", "interval": 5}},
        "year_stats": {"stats": {"field": "year"}},
        "cit_stats": {"stats": {"field": "citations"}},
        "cit_avg": {"avg": {"field": "citations"}},
        "ts_count": {"value_count": {"field": "ts"}}}
    # a dashboard's time filter: the last quarter of the year
    window = {"range": {"ts": {"gte": "2023-10-01T00:00:00Z"}}}
    reqs = [("dashboard", {"size": 0, "query": window, "aggs": dash}, None)]
    for q in queries[:4]:
        reqs.append(("dashboard_match", {"size": 10, "query": {"match": {
            "title": " ".join(tok(t) for t in q)}}, "aggs": dash}, None))
    match = {"match": {"title": " ".join(tok(t) for t in queries[4])}}
    wide = {"range": {"year": {"gte": 1996}}}  # > 100k matched a segment
    day_hist = {"date_histogram": {"field": "ts", "interval": "1d"}}
    other = [
        ("terms_sub_avg", match, {"v": {"terms": {"field": "venue"}, "aggs": {
            "c": {"avg": {"field": "citations"}}}}}, "sub_aggs"),
        ("calendar_month", window, {"m": {"date_histogram": {
            "field": "ts", "interval": "month"}}}, "unsupported_params"),
        ("stats_ts", match, {"s": {"stats": {"field": "ts"}}},
         "values_not_fusable"),
        ("hourly", window, {"h": {"date_histogram": {
            "field": "ts", "interval": "1h"}}}, "bucket_range"),
        ("range", match, {"r": {"range": {"field": "citations", "ranges": [
            {"to": 2}, {"from": 2, "to": 10}, {"from": 10}]}}},
         "unsupported_agg"),
        ("date_range", wide, {"r": {"date_range": {"field": "ts", "ranges": [
            {"to": "2023-04-01"}, {"from": "2023-04-01", "to": "2023-07-01"},
            {"from": "2023-07-01"}]}}}, "unsupported_agg"),
        ("filters", match, {"f": {"filters": {"filters": {
            "old": {"range": {"year": {"lt": 2000}}},
            "cited": {"range": {"citations": {"gte": 5}}}}}}},
         "unsupported_agg"),
        ("missing", match, {"m": {"missing": {"field": "citations"}}},
         "unsupported_agg"),
        ("global", match, {"g": {"global": {}, "aggs": {
            "v": {"terms": {"field": "venue", "size": 3}}}}},
         "unsupported_agg"),
        ("cardinality", wide, {"c": {"cardinality": {"field": "venue"}},
                               "cy": {"cardinality": {"field": "citations"}}},
         "unsupported_agg"),
        ("percentiles", wide, {"p": {"percentiles": {
            "field": "citations", "percents": [50, 90, 99]}}},
         "unsupported_agg"),
        ("extended_stats", match, {"e": {"extended_stats": {
            "field": "citations"}}}, "unsupported_agg"),
        ("top_hits", match, {"t": {"top_hits": {"size": 3}}},
         "unsupported_agg"),
        ("pipelines", window, {"d": dict(day_hist, aggs={
            "s": {"sum": {"field": "citations"}},
            "der": {"derivative": {"buckets_path": "s"}},
            "cum": {"cumulative_sum": {"buckets_path": "s"}},
            "mov": {"moving_avg": {"buckets_path": "s", "window": 7}},
            "sel": {"bucket_selector": {"buckets_path": {"n": "_count"},
                                        "script": "params.n > 0"}},
            "srt": {"bucket_sort": {"sort": [{"s": {"order": "desc"}}],
                                    "size": 5}}})}, "sub_aggs"),
        ("avg_bucket", window, {"d": day_hist, "a": {"avg_bucket": {
            "buckets_path": "d>_count"}}}, "unsupported_agg"),
    ]
    for kind, query, aggs, reason in other:
        reqs.append((kind, {"size": 0 if query is not match else 5,
                            "query": query, "aggs": aggs}, reason))
    return reqs


def same_aggs(a, b, tol_scores=False):
    """Aggregations equal; with ``tol_scores`` the top_hits scores within
    RTOL (ids exact)."""
    if not tol_scores:
        return a == b
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return False
        return all(
            np.allclose(a[k], b[k], rtol=RTOL) if k == "_score"
            else same_aggs(a[k], b[k], True) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same_aggs(x, y, True)
                                        for x, y in zip(a, b))
    return a == b


@contextlib.contextmanager
def timed_spans(torch, targets):
    """While the block runs, each (owner, attribute) callable of
    ``targets`` adds its host-clock ms, the device synced before and
    after, to ``spans[label]``."""
    spans = {}
    saved = []
    for owner, attr, label in targets:
        orig = getattr(owner, attr)
        # the class's own descriptor (a staticmethod or classmethod stays
        # one after the block)
        saved.append((owner, attr, vars(owner).get(attr, orig)
                      if isinstance(owner, type) else orig))

        def timed(*args, _orig=orig, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*args, **kw)
            torch.cuda.synchronize()
            spans[_label] = spans.get(_label, 0.0) + (
                time.perf_counter() - t0) * 1000
            return out

        setattr(owner, attr, timed)
    try:
        yield spans
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)


def agg_spans(torch, gnode, reqs, queries, reps=5):
    """Where a fused request's time goes, as host-clock spans with the
    device synced at each end: the serial dashboards (10 of each kind) and
    ``reps`` agg bursts of 16 on agg4. Spans: the whole request, the
    resolution (with staging), the program (``execute``, or
    ``execute_batched_dense_agg``: kernels and torch ops), the partials'
    finalize, and the host fetch. Returns ms per request (per burst)."""
    from elasticsearch_tpu_torch.index import index_service
    from elasticsearch_tpu_torch.parallel import plan_exec
    from elasticsearch_tpu_torch.search import fused_aggs

    Ex = plan_exec.MeshPlanExecutor
    targets = [(plan_exec.IndexMeshSearch, "_resolve_fused_aggs", "resolve"),
               (Ex, "execute", "program"),
               (Ex, "execute_batched_dense_agg", "batched_program"),
               (fused_aggs, "finalize_fused", "finalize"),
               (index_service, "fetch_hits", "fetch")]
    out = {}
    svc = gnode.indices["agg4"]
    dash = reqs[0][1]["aggs"]
    bodies = [{"query": {"match": {"title": " ".join(
        term_token(t) for t in q)}}, "size": 10, "aggs": dash}
        for q in queries[:BURST]]
    cases = [("dashboard", [b for k, b, _r in reqs if k == "dashboard"]),
             ("dashboard_match", [b for k, b, _r in reqs
                                  if k == "dashboard_match"])]
    for kind, kind_bodies in cases:
        with timed_spans(torch, targets) as spans:
            t0 = time.perf_counter()
            n = 0
            for _ in range(10 // len(kind_bodies) + 1):
                for body in kind_bodies:
                    gnode.search("agg4", dict(body))
                    n += 1
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1000
        out[kind] = {"request": total / n,
                     **{k: v / n for k, v in spans.items()}}
    with timed_spans(torch, targets) as spans:
        t0 = time.perf_counter()
        for _ in range(reps):
            svc.search_batch([dict(b) for b in bodies])
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1000
    out[f"search_batch[{BURST}]"] = {"burst": total / reps,
                                     **{k: v / reps for k, v in spans.items()}}
    return out


def time_bucket_forms(torch, ssum, timer, kept_m):
    """The fused bucket counts as the plane launches them (one f32-mask
    launch over every slot, codes offset by slot * nb) against one launch
    a slot (the codes rebased to [0, nb)), on the largest kept call's real
    inputs; and bincount over the valid entries (the library call). Counts
    must agree."""
    args, kw, _out = max(kept_m, key=lambda e: e[2][0].shape[0])
    ords, mask = args[0], args[1]
    n_ords = kw["n_ords"]
    n_slots = 4
    nb = n_ords // n_slots
    per = ords.reshape(n_slots, -1)
    base = (torch.arange(n_slots, device=ords.device, dtype=torch.int32)
            * nb)[:, None]
    rebased = [torch.where(per[i] >= 0, per[i] - base[i], per[i]).contiguous()
               for i in range(n_slots)]
    # copies: a slot's row of the stacked mask need not start on the
    # 16-byte boundary the kernel reads from
    masks = [m.clone() for m in mask.reshape(n_slots, -1)]
    whole = ssum.segment_counts_sums(ords, mask, n_ords=n_ords)[0]
    split = torch.cat([ssum.segment_counts_sums(
        rebased[i], masks[i], n_ords=nb)[0] for i in range(n_slots)])
    torch.cuda.synchronize()
    check(torch.equal(whole, split),
          "phase 12 fused bucket counts: one launch equals one a slot")
    valid = (mask > 0) & (ords >= 0)
    one_ms = timer.ms(lambda: ssum.segment_counts_sums(ords, mask,
                                                       n_ords=n_ords))
    per_slot_ms = timer.ms(lambda: [ssum.segment_counts_sums(
        rebased[i], masks[i], n_ords=nb) for i in range(n_slots)])
    library_ms = timer.ms(lambda: torch.bincount(
        ords[valid].long(), minlength=n_ords))
    # bytes: the codes and the mask read once, the counts written once
    b = bound(ords.numel() * 8 + n_ords * 4, ords.numel())
    return {"nd": int(ords.numel()), "n_ords": int(n_ords),
            "one_launch_ms": one_ms, "per_slot_ms": per_slot_ms,
            "library_ms": library_ms, "bound_ms": b[0], "bound_by": b[1]}


def aggs_phase(torch, Node, Segment, cuda_kernels, tsc, queries, lat,
               launches, errs, shard_arrays):
    """Phase 12: aggregations on the card.

    pmc-4x256k (phase 7's arrays as new segments) with doc-value columns
    ``ts`` (date) and ``citations`` (long, 3% missing) beside ``venue``
    and ``year``, on a Node(device="cuda") in three indices over the same
    segments: agg4 (the mesh plane, fused aggregations), agg4h
    (``search.aggs.fused: false``: the host reduce over the program's
    views) and agg4x (``search.mesh: false``: the host rung); and a
    Node(device="cpu") over the same arrays.

    12a. A fused dashboard, size 0 under a time filter; 12b the same
         aggregations under match queries, size 10: fused on agg4
         (``agg_fused_query_total`` moves), byte for byte the agg4h
         response, equal to agg4x and to the cpu node.
    12c. Aggregations the fused plane does not take, each counted under
         the JAX package's reason name, equal on every index and node.
    12d. One search_batch of 16 agg-carrying match bodies on agg4 (the
         batched dense agg program: one 1b launch a slot), each member
         equal to its serial response; then 16 threads at Node.search;
         before the deletes, the same burst on agg4p, a packed-codec index
         over the same segments (one 1d launch a slot).
    12e. Deletes, refresh, 12a-12d again.
    12f. One 12a and one 12c request over HTTP (an HttpServer as phase 11
         starts), equal to the in-process response.
    Every kernel-2 call (mask form: the fused bucket counts; gather form:
    the terms host reduce) is replayed through its plain version; every
    1b launch of the batched agg program is held bit for bit; the launch
    counters of segment_sum and tile_scoring_batched must move; zero plane
    faults. Prints p50 per request kind on the three indices, the host
    mask bytes a host-reduce request copies, the staged doc_values bytes
    per column and the kernel-2 plan of the fused bucket launches, the
    venue bucket counts' one launch over the slots timed against one
    launch a slot, and host-clock spans (resolve, program, finalize,
    fetch) of the fused dashboards and bursts. Also runs histogram_counts
    / value_histogram_sums on the card at a shard's ts column against
    their plain versions. Returns the report and (the card node, the cpu
    node, their segments, the mapping) for phase 19, which closes the
    nodes."""
    import threading

    from elasticsearch_tpu_torch.ops import aggs as agg_ops
    from elasticsearch_tpu_torch.ops import segment_sum as ssum
    from elasticsearch_tpu_torch.rest.http_server import HttpServer

    t_phase = time.perf_counter()
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}, "ts": {"type": "date"},
        "citations": {"type": "long"}}}}
    indices = {"agg4": {}, "agg4h": {"search": {"aggs": {"fused": False}}},
               "agg4x": {"search": {"mesh": False}}}
    gnode, cnode = Node(device="cuda"), Node(device="cpu")
    for name, extra in indices.items():
        gnode.create_index(name, {"settings": {"number_of_shards": 4,
                                               "refresh_interval": "-1",
                                               "requests.cache.enable": False,
                                               **extra},
                                  "mappings": mapping})
    cnode.create_index("agg4", {"settings": {"number_of_shards": 4,
                                             "refresh_interval": "-1",
                                             "requests.cache.enable": False},
                                "mappings": mapping})
    gsegs, csegs = [], []
    for sh, arrays in enumerate(shard_arrays):
        arrays = dict(arrays)
        nd_pad = arrays["numeric_columns"]["year"]["exists"].shape[0]
        n = len(arrays["doc_ids"])
        arrays["numeric_columns"] = {**arrays["numeric_columns"],
                                     **agg_columns(sh, nd_pad, n)}
        gs = Segment.from_arrays(f"agg4_{sh}_seg_1", device="cuda", **arrays)
        cs = Segment.from_arrays(f"agg4_{sh}_seg_1", device="cpu", **arrays)
        for name in indices:
            gnode.indices[name].shards[sh].engine.adopt_segment(gs)
        cnode.indices["agg4"].shards[sh].engine.adopt_segment(cs)
        gsegs.append(gs)
        csegs.append(cs)
    svc, svch = gnode.indices["agg4"], gnode.indices["agg4h"]
    reqs = agg_requests(queries)
    report = {"p50_ms": {}, "fallbacks": {}}
    p12 = {}

    def serve_all(label):
        """Every request on agg4, agg4h, agg4x and the cpu node, compared;
        the fallback reason of each non-fused kind checked."""
        for kind, body, reason in reqs:
            ms = svc._mesh_search
            fused0 = ms.agg_fused_query_total if ms else 0
            by0 = dict(ms.agg_host_fallback_by_reason) if ms else {}
            out = {}
            for name in indices:
                t0 = time.perf_counter()
                out[name] = gnode.search(name, dict(body))
                torch.cuda.synchronize()
                lat.setdefault(f"12/{kind}@{name}", []).append(
                    (time.perf_counter() - t0) * 1000)
            cr = cnode.search("agg4", dict(body))
            gr = out["agg4"]
            what = f"{label} {kind}"
            ms = svc._mesh_search
            by = {k: v - by0.get(k, 0) for k, v in
                  ms.agg_host_fallback_by_reason.items()
                  if v != by0.get(k, 0)}
            if reason is None:
                check(ms.agg_fused_query_total == fused0 + 1 and not by,
                      f"{what}: served fused ({by})")
                # the fused plane against the host reduce of the same
                # card node: byte for byte
                check(_same_exact(gr, out["agg4h"])
                      and gr["aggregations"] == out["agg4h"]["aggregations"],
                      f"{what}: fused equals the host reduce byte for byte")
            else:
                check(by == {reason: 1}
                      and ms.agg_fused_query_total == fused0,
                      f"{what}: host reduce counted as {reason} (got {by})")
                report["fallbacks"][kind] = reason
            check(gr["_plane"] == out["agg4h"]["_plane"] == cr["_plane"]
                  and out["agg4x"]["_plane"] == "host"
                  and gr["_plane"] in ("mesh", "mesh_pallas"),
                  f"{what}: planes {gr['_plane']} / "
                  f"{out['agg4h']['_plane']} / {out['agg4x']['_plane']} / "
                  f"cpu {cr['_plane']}")
            same_response(gr, cr, f"{what} (cpu node)")
            for name in ("agg4h", "agg4x"):
                r = out[name]
                check(r["hits"]["total"] == gr["hits"]["total"]
                      and same_aggs(r["aggregations"], gr["aggregations"],
                                    tol_scores=name == "agg4x"),
                      f"{what}: {name} equals agg4")

    def burst(label):
        """search_batch of 16 agg-carrying match bodies, then 16 threads."""
        dash = reqs[0][1]["aggs"]
        small = {"venues": dash["venues"], "per_day": dash["per_day"],
                 "cit_stats": dash["cit_stats"]}
        bodies = [{"query": {"match": {"title": " ".join(
            term_token(t) for t in q)}}, "size": 10,
            "aggs": dash if i % 2 == 0 else small}
            for i, q in enumerate(queries[:BURST])]
        serial = [gnode.search("agg4", dict(b)) for b in bodies]
        ms = svc._mesh_search
        launches0 = ms.batched_launch_total
        fused0 = ms.agg_fused_query_total
        t0 = time.perf_counter()
        out = svc.search_batch([dict(b) for b in bodies])
        torch.cuda.synchronize()
        lat.setdefault(f"12/search_batch[{BURST}]@agg4", []).append(
            (time.perf_counter() - t0) * 1000)
        check(ms.batched_launch_total == launches0 + 1
              and ms.agg_fused_query_total == fused0 + BURST,
              f"{label}: one batched dense agg launch served the "
              f"{BURST} members fused")
        for i, (got, want) in enumerate(zip(out, serial)):
            check(isinstance(got, dict) and got["_plane"] == "mesh_pallas"
                  and _same_exact(got, want)
                  and got["aggregations"] == want["aggregations"],
                  f"{label} batch member {i} equals its serial response")
        before = svc.batch_stats.as_dict()["batched_query_total"]
        got = {}
        start = threading.Barrier(BURST)

        def worker(i):
            start.wait()
            t1 = time.perf_counter()
            got[i] = gnode.search("agg4", dict(bodies[i]))
            torch.cuda.synchronize()
            lat.setdefault(f"12/threaded@{got[i]['_plane']}", []).append(
                (time.perf_counter() - t1) * 1000)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
            check(not t.is_alive(), f"{label} threaded search finished")
        for i in range(BURST):
            check(_same_exact(got.get(i), serial[i])
                  and got[i]["aggregations"] == serial[i]["aggregations"],
                  f"{label} threaded member {i} equals its serial response")
        log(f"[phase 12] {label} threaded: batched_query_total "
            f"{before} -> {svc.batch_stats.as_dict()['batched_query_total']}")

    def packed_burst():
        """The same burst on a packed-codec index over the same segments
        (kernel 1d dense at Q = 16): members equal their serial responses
        there, and their aggregations equal agg4's (the same matched
        docs)."""
        gnode.create_index("agg4p", {"settings": {
            "number_of_shards": 4, "refresh_interval": "-1",
            "requests.cache.enable": False,
            "search": {"pallas": {"postings_codec": "packed"}}},
            "mappings": mapping})
        for sh, gs in enumerate(gsegs):
            gnode.indices["agg4p"].shards[sh].engine.adopt_segment(gs)
        dash = reqs[0][1]["aggs"]
        bodies = [{"query": {"match": {"title": " ".join(
            term_token(t) for t in q)}}, "size": 10, "aggs": dash}
            for q in queries[:BURST]]
        serial = [gnode.search("agg4p", dict(b)) for b in bodies]
        raw = [gnode.search("agg4", dict(b)) for b in bodies]
        out = gnode.indices["agg4p"].search_batch([dict(b) for b in bodies])
        torch.cuda.synchronize()
        ms = gnode.indices["agg4p"]._mesh_search
        check(ms.batched_launch_total == 1
              and ms.agg_fused_query_total == 2 * BURST,
              "phase 12 packed: one batched dense agg launch, fused")
        for i, got in enumerate(out):
            check(isinstance(got, dict) and got["_plane"] == "mesh_pallas"
                  and _same_exact(got, serial[i])
                  and got["aggregations"] == serial[i]["aggregations"]
                  == raw[i]["aggregations"],
                  f"phase 12 packed batch member {i} equals its serial "
                  f"response, its aggregations the raw index's")

    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    with recording_tile_launches(
            tsc, lambda k: launch_name(k).startswith(
                "tile_scoring_batched")) as kept_b, \
            recording_segsum_calls(ssum) as kept_g, \
            recording_mask_segsum(ssum) as kept_m:
        serve_all("phase 12")
        burst("phase 12")
        packed_burst()
        routing = _routing_for_shards(4)
        for sh in range(4):
            for i in range(0, MESH_SHARD_DOCS, 1009):
                for node, names in ((gnode, indices), (cnode, ("agg4",))):
                    for name in names:
                        node.delete_doc(name, f"s{sh}p{i}",
                                        routing=routing[sh])
        for name in indices:
            gnode.refresh(name)
        cnode.refresh("agg4")
        serve_all("phase 12 after deletes")
        burst("phase 12 after deletes")
    torch.cuda.synchronize()
    p12 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 12] kernel launches: {p12}")
    for k in ("segment_sum", "tile_scoring_batched",
              "tile_scoring_batched_packed", "tile_scoring"):
        check(p12.get(k, 0) > 0, f"phase 12 launched {k}")
    for k, v in p12.items():
        launches[k] += v
    held_b = check_kept_launches(torch, tsc, kept_b, errs, "phase 12")
    check(sum(held_b.values()) == p12["tile_scoring_batched"]
          + p12.get("tile_scoring_batched_packed", 0),
          f"every 1b / 1d launch of phase 12 held against plain "
          f"({held_b})")
    n_g = check_kept_segsum(torch, ssum, kept_g, "phase 12")
    plans = check_kept_mask_segsum(torch, ssum, kept_m, "phase 12")
    n_m = len(kept_m)
    check(n_g + n_m == p12["segment_sum"],
          f"every segment_sum launch of phase 12 held against plain (gather "
          f"{n_g} + mask {n_m} of {p12['segment_sum']})")
    report["launches"] = {"segment_sum_mask_form": n_m,
                          "segment_sum_gather_form": n_g,
                          "segment_sum_combine": p12.get(
                              "segment_sum_combine", 0),
                          "tile_scoring": p12.get("tile_scoring", 0),
                          "tile_scoring_batched": p12["tile_scoring_batched"],
                          "tile_scoring_batched_packed": p12[
                              "tile_scoring_batched_packed"]}
    report["fused_bucket_plans"] = plans
    log(f"[phase 12] kernel-2 plans of the mask-form launches "
        f"(the fused bucket counts): {json.dumps(plans)}")
    report["bucket_launch_forms"] = time_bucket_forms(
        torch, ssum, Timer(torch, torch.device("cuda", 0)), kept_m)
    log(f"[phase 12] fused bucket counts, one launch over the slots "
        f"against one a slot: {json.dumps(report['bucket_launch_forms'])}")
    for name in indices:
        planes = gnode.indices[name].search_stats()["planes"]
        log(f"[phase 12] {name} planes: " + json.dumps({
            k: planes[k] for k in (
                "agg_fused_query_total", "agg_host_fallback_total",
                "agg_host_fallback_by_reason", "agg_host_mask_bytes_total",
                "mesh_query_total", "mesh_batched_launch_total",
                "host_query_total", "plane_failures_total")}))
    planes_h = svch.search_stats()["planes"]
    report["host_mask_bytes_per_request"] = (
        planes_h["agg_host_mask_bytes_total"]
        / max(planes_h["agg_host_fallback_total"], 1))
    executor = svc._mesh_search._executor
    report["doc_values_bytes"] = {
        k: t.numel() * t.element_size()
        for k, t in sorted(executor._seg_staged.items())
        if k.startswith("maggs.")}
    log(f"[phase 12] host reduce copies "
        f"{report['host_mask_bytes_per_request']:.0f} bytes of masks and "
        f"scores a request; staged doc_values bytes per column: "
        f"{json.dumps(report['doc_values_bytes'])}")
    fails = plane_failures(*(gnode.indices[n] for n in indices),
                           cnode.indices["agg4"])
    check(not any(fails), f"phase 12: zero plane faults (got {fails})")

    # the p50s: 1 more run of the dashboard kinds, none of the others
    # beside the main path's two (cut from 3 and 2 as phase 18 joined, and
    # from 2 and 1 as phase 19 did), per index
    for kind, body, _reason in reqs:
        reps = 1 if kind.startswith("dashboard") else 0
        for name in indices:
            xs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                gnode.search(name, dict(body))
                torch.cuda.synchronize()
                xs.append((time.perf_counter() - t0) * 1000)
            lat.setdefault(f"12/{kind}@{name}", []).extend(xs)
    for kind in dict.fromkeys(kind for kind, _b, _r in reqs):
        row = {name: float(np.median(lat[f"12/{kind}@{name}"]))
               for name in indices}
        report["p50_ms"][kind] = row
        log(f"[phase 12] p50 {kind}: fused rung (agg4) {row['agg4']:.3f} ms, "
            f"host reduce (agg4h) {row['agg4h']:.3f} ms, host rung (agg4x) "
            f"{row['agg4x']:.3f} ms")
    report["spans_ms"] = agg_spans(torch, gnode, reqs, queries)
    log(f"[phase 12] where a request's time goes (host clock, device synced "
        f"at each span's ends): {json.dumps(report['spans_ms'])}")

    # the histogram ops on the card: shard 0's ts column at daily buckets,
    # a match query's matched mask; each against its plain version
    seg = gsegs[0]
    col = seg.numeric_columns["ts"]
    dev = seg.device
    docs = torch.from_numpy(col.flat_docs).to(dev)
    vals = torch.from_numpy(col.flat_values).to(dev)
    m = np.zeros(seg.nd_pad + 1, bool)
    m[: seg.nd_pad] = seg.live & (np.arange(seg.nd_pad) % 3 == 0)
    mask = torch.from_numpy(m).to(dev)
    cit = seg.numeric_columns["citations"]
    by_doc = torch.from_numpy(np.concatenate([cit.first_value, [0.0]])).to(dev)
    mkey = AGG_T0 // AGG_DAY
    with recording_mask_segsum(ssum) as kept_h:
        hc = agg_ops.histogram_counts(docs, vals, mask, float(AGG_DAY), 0.0,
                                      mkey, 366)
        hs = agg_ops.value_histogram_sums(docs, vals, by_doc, mask,
                                          float(AGG_DAY), 0.0, mkey, 366)
    torch.cuda.synchronize()
    hplans = check_kept_mask_segsum(torch, ssum, kept_h, "phase 12 histogram")
    cpu = [x.cpu() for x in (docs, vals, mask, by_doc)]
    hc_p = agg_ops.histogram_counts(cpu[0], cpu[1], cpu[2], float(AGG_DAY),
                                    0.0, mkey, 366)
    check(torch.equal(hc.cpu(), hc_p) and int(hc.sum()) == int(
        m[col.flat_docs[: col.count]].sum()),
          "phase 12 histogram_counts on the card equals plain")
    report["histogram_ops"] = {"plans": hplans,
                               "buckets": 366, "docs": int(col.count),
                               "sum_max": float(hs.abs().max())}
    log(f"[phase 12] histogram_counts / value_histogram_sums on the card: "
        f"{json.dumps(report['histogram_ops'])}")

    # 12f: over HTTP
    srv = HttpServer(gnode, port=0)
    srv.start()
    try:
        client = HttpClient(srv.port)
        for kind, body, _reason in (reqs[0], next(
                r for r in reqs if r[0] == "date_range")):
            st, got = client.call("POST", "/agg4/_search", body)
            want = _as_json(gnode.search("agg4", dict(body)))
            check(st == 200 and _same_but_took(got, want),
                  f"phase 12f {kind} over HTTP equals the in-process "
                  f"response")
        client.close()
    finally:
        srv.stop()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 12] done in {report['seconds']:.1f} s")
    return report, (gnode, cnode, gsegs, csegs, mapping)


# ----------------------------------------------------------------------
# The rest of the search request on the card
# ----------------------------------------------------------------------

# responses that must be sound: every search the script sends answers with
# _shards.failed == 0 and timed_out false, unless a fault is injected
SOUND = {"checked": 0, "faults_expected": 0}


def _sound(resp, what) -> None:
    if not isinstance(resp, dict) or SOUND["faults_expected"]:
        return
    if "_shards" in resp or "timed_out" in resp:
        SOUND["checked"] += 1
        failed = (resp.get("_shards") or {}).get("failed", 0)
        check(failed == 0 and resp.get("timed_out") is False,
              f"{what}: a sound answer (_shards.failed {failed}, timed_out "
              f"{resp.get('timed_out')})")


def install_soundness_guard(Node, IndexService) -> None:
    """Hold every answer of ``Node.search`` (``msearch`` and REST go
    through it), ``IndexService.search`` and every ``search_batch``
    member to ``_shards.failed == 0`` and ``timed_out: false``: the
    per-shard failure isolation must not hide a kernel fault behind a 200
    answer. ``faults_injected()`` lifts it where a phase injects one."""
    def wrap(fn, what, many=False):
        def guarded(*args, **kw):
            out = fn(*args, **kw)
            for r in (out if many else [out]):
                _sound(r, what)
            return out
        return guarded

    Node.search = wrap(Node.search, "Node.search")
    IndexService.search = wrap(IndexService.search, "IndexService.search")
    IndexService.search_batch = wrap(IndexService.search_batch,
                                     "IndexService.search_batch", many=True)


@contextlib.contextmanager
def faults_injected():
    SOUND["faults_expected"] += 1
    try:
        yield
    finally:
        SOUND["faults_expected"] -= 1


def discover_body(queries, size=500):
    """Kibana 6.x Discover's search body: a match typed in the search bar
    under the time picker's range on ``ts`` (epoch_millis), the newest
    first, a daily histogram, every fetch option Discover sends and
    highlighting on every field."""
    return {
        "version": True, "size": size,
        "sort": [{"ts": {"order": "desc", "unmapped_type": "boolean"}}],
        "_source": {"excludes": []},
        "aggs": {"2": {"date_histogram": {"field": "ts", "interval": "1d",
                                          "min_doc_count": 1}}},
        "stored_fields": ["*"], "script_fields": {},
        "docvalue_fields": ["ts"],
        "query": {"bool": {"must": [
            {"match": {"title": " ".join(term_token(t)
                                         for t in queries[0][:2])}},
            {"range": {"ts": {"gte": AGG_T0 + 30 * AGG_DAY,
                              "lte": AGG_T0 + 120 * AGG_DAY,
                              "format": "epoch_millis"}}}],
            "filter": [], "should": [], "must_not": []}},
        "highlight": {"pre_tags": ["@kibana-highlighted-field@"],
                      "post_tags": ["@/kibana-highlighted-field@"],
                      "fields": {"*": {}}, "fragment_size": 2147483647},
    }


def _hit_keys(resp):
    return [(h["_index"], h["_id"], h.get("sort"), h.get("_score"),
             h.get("fields"), h.get("highlight"), h.get("_version"))
            for h in resp["hits"]["hits"]]


def search_request_phase(torch, cuda_kernels, tsc, ssum, knn, p12, g7, c7,
                         gP, cP, knn_body, queries, errs):
    """Phase 19: the rest of the search request on the card, over indices
    earlier phases built (no corpus is built or staged again).

    19a. Discover over ``_msearch`` on ``logs-*``: two index names over
         phase 12's segments (pmc-4x256k's doc-values form, 4 x 262,144
         docs each, ``search.mesh: false``: the host fan-out needs no
         staging of its own), 2,097,152 docs in all, with Kibana 6.x
         Discover's body; equal to the cpu twin's answer, and to the two
         single-index answers merged; the same body on ``agg4`` (the
         mesh index) against the cpu twin.
    19b. ``timeout``: a ``SearchDelayScheme`` on one shard gives
         ``timed_out: true`` with a subset of the full answer; with
         ``allow_partial_search_results: false`` the request raises; a
         deadline that expires inside the mesh plane before its launch
         answers ``timed_out``, and ``memory_allocated`` and the ledger
         stay at their levels.
    19c. Failure isolation: one failing shard gives ``_shards.failed`` 1
         and a ``runtime_error``, on one index and across indices; every
         shard failing raises "all shards failed".
    19d. ``profile`` on pmc4's ``mesh_pallas``, pmc4h's host rung and a
         kNN request: the plane and the hits equal the unprofiled
         request's, ``plane`` and ``phases`` present, equal to the cpu
         twin.
    19e. ``_explain`` of a match's top 10 hits on pmc4: the value is the
         hit's ``_score`` bit for bit; a miss answers ``matched: false``;
         ``_validate/query`` answers valid and invalid.
    19f. ``track_total_hits`` on pmc4p (packed + pruned): an exact total,
         ``relation: eq``, where the pruned request gives ``gte``.

    Every launch of the main path is held against its plain version;
    every item logs its p50 on the card, its plane and its launches.
    Phase 20 runs next over phase 12's nodes and closes them. Returns the
    report."""
    from elasticsearch_tpu_torch.common.errors import (
        SearchPhaseExecutionException,
    )
    from elasticsearch_tpu_torch.common.memory import memory_accountant
    from elasticsearch_tpu_torch.rest.controller import RestController
    from elasticsearch_tpu_torch.testing.disruption import (
        SearchDelayScheme,
        SearchFailScheme,
        clear_search_disruptions,
    )

    t_phase = time.perf_counter()
    gnode, cnode, gsegs, csegs, mapping = p12
    report = {"items": {}}
    for node, segs in ((gnode, gsegs), (cnode, csegs)):
        for name in ("logs-a", "logs-b"):
            node.create_index(name, {"settings": {
                "number_of_shards": 4, "refresh_interval": "-1",
                "requests.cache.enable": False,
                "search": {"mesh": False}},
                "mappings": mapping})
            for sh, seg in enumerate(segs):
                node.indices[name].shards[sh].engine.adopt_segment(seg)
    report["logs_docs"] = 2 * sum(s.live_doc_count for s in gsegs)

    def item(name, fn, reps=1):
        """``fn`` ``reps`` times on the card, synced: its p50, the plane
        of its answer and the launches of its first run."""
        before = dict(cuda_kernels.LAUNCHES)
        xs, out = [], None
        for i in range(reps):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            xs.append((time.perf_counter() - t0) * 1000)
            if i == 0:
                out = r
                launched = {k: v - before.get(k, 0) for k, v in
                            cuda_kernels.LAUNCHES.items()
                            if v != before.get(k, 0)}
        first = out[0] if isinstance(out, list) else out
        plane = (first.get("_plane", "host fan-out")
                 if isinstance(first, dict) else None)
        row = {"p50_ms": float(np.median(xs)), "samples": len(xs),
               "plane": plane, "launches": launched}
        report["items"][name] = row
        log(f"[phase 19] {name}: " + json.dumps(row))
        return out

    tok = term_token
    match = {"match": {"title": " ".join(tok(t) for t in queries[1])}}
    disc = discover_body(queries)
    gctl, pctl = RestController(g7), RestController(gP)
    cuda_kernels.reset_launch_counts()
    t_main = time.perf_counter()
    with recording_recovered_path(tsc, ssum, knn) as kept:
        # ---- 19a: Discover on a pattern ------------------------------
        # Discover's request beside a dashboard panel's (the top venues
        # over the same time range), one _msearch over the pattern
        panel = {"size": 0, "query": {"bool": {"filter": [
            disc["query"]["bool"]["must"][1]]}},
            "aggs": {"venues": {"terms": {"field": "venue", "size": 10}}}}

        def msearch(node):
            return node.msearch([({"index": "logs-*"}, dict(disc)),
                                 ({"index": "logs-*"}, dict(panel))])[
                "responses"]

        gm, gpanel = item("19a msearch logs-* (Discover + a panel)",
                          lambda: msearch(gnode), reps=3)
        cm, cpanel = msearch(cnode)
        check(isinstance(gm, dict) and "hits" in gm
              and isinstance(gpanel, dict) and "aggregations" in gpanel,
              f"19a: the msearch entries answered ({str(gm)[:200]})")
        check(gm["hits"]["total"] == cm["hits"]["total"]
              and _hit_keys(gm) == _hit_keys(cm)
              and gm["aggregations"] == cm["aggregations"],
              "19a: Discover over logs-* equals the cpu twin's answer")
        check(gpanel["hits"]["total"] == cpanel["hits"]["total"]
              and gpanel["aggregations"] == cpanel["aggregations"],
              "19a: the panel's top venues over logs-* equal the cpu "
              "twin's")
        # (the corpus keeps the title in its postings only: the stored
        # sources hold n, venue and year, so the highlighter runs over
        # every hit and finds no title text)
        check(gm["_shards"]["total"] == 8 and len(gm["hits"]["hits"]) == 500
              and all(h["fields"]["ts"] and "_version" in h
                      and "_source" in h for h in gm["hits"]["hits"]),
              "19a: 8 shards, 500 hits each with docvalue ts, version and "
              "_source")
        singles = [item(f"19a search {n}", lambda n=n: gnode.search(
            n, dict(disc))) for n in ("logs-a", "logs-b")]
        merged = sorted(singles[0]["hits"]["hits"]
                        + singles[1]["hits"]["hits"],
                        key=lambda h: (-h["sort"][0], h["_index"]))
        check(gm["hits"]["total"] == sum(s["hits"]["total"]
                                         for s in singles)
              and [(h["_index"], h["_id"]) for h in gm["hits"]["hits"]]
              == [(h["_index"], h["_id"]) for h in merged[:500]],
              "19a: the merged answer is the single-index answers merged")
        buckets = {b["key"]: b["doc_count"] for b in
                   gm["aggregations"]["2"]["buckets"]}
        want = {}
        for s in singles:
            for b in s["aggregations"]["2"]["buckets"]:
                want[b["key"]] = want.get(b["key"], 0) + b["doc_count"]
        check(buckets == want, "19a: the histogram's buckets are the two "
                               "indices' buckets summed")
        ga = item("19a search agg4 (mesh index)",
                  lambda: gnode.search("agg4", dict(disc)), reps=2)
        ca = cnode.search("agg4", dict(disc))
        check(ga["_plane"] == ca["_plane"] and _hit_keys(ga) == _hit_keys(ca)
              and ga["aggregations"] == ca["aggregations"]
              and ga["hits"]["total"] == cm["hits"]["total"] // 2,
              f"19a: Discover on agg4 ({ga['_plane']}) equals the cpu twin")
        report["discover"] = {"total": gm["hits"]["total"],
                              "buckets": len(buckets),
                              "agg4_plane": ga["_plane"]}

        # ---- 19b: timeout --------------------------------------------
        # a rare term, so the full answer holds every hit
        for r in range(1049, 49, -1):
            rare = {"match": {"title": tok(r)}}
            full_n = gnode.search("logs-a", {"query": rare, "size": 0})[
                "hits"]["total"]
            if 0 < full_n <= 20_000:
                break
        full_body = {"query": rare, "size": full_n, "_source": False}
        full = gnode.search("logs-a", dict(full_body))
        with faults_injected():
            delay = SearchDelayScheme(1.0, indices=["logs-a"],
                                      shards=[1]).install()
            part = item("19b timeout on logs-a (shard 1 delayed 1 s)",
                        lambda: gnode.search("logs-a", dict(
                            full_body, timeout="400ms")))
            got = {h["_id"] for h in part["hits"]["hits"]}
            # shard 0 answered; shard 1 stalled past the deadline and
            # shards 2-3 never ran (shard s holds the docs "s<s>p...")
            check(part["timed_out"] is True
                  and part["_shards"]["failed"] == 0
                  and 0 < part["hits"]["total"] < full_n
                  and got <= {h["_id"] for h in full["hits"]["hits"]}
                  and got == {h["_id"] for h in full["hits"]["hits"]
                              if h["_id"].startswith("s0p")},
                  f"19b: timed_out with shard 0's share of the full answer "
                  f"({part['hits']['total']} of {full_n})")
            mpart = item("19b timeout on logs-* (host fan-out)",
                         lambda: gnode.search("logs-*", {
                             "query": match, "size": 10,
                             "timeout": "400ms"}))
            check(mpart["timed_out"] is True
                  and mpart["_shards"]["failed"] == 0,
                  "19b: the fan-out over logs-* stops at the deadline")
            try:
                gnode.search("logs-a", {"query": match, "timeout": "400ms",
                                        "allow_partial_search_results":
                                            False})
                check(False, "19b: allow_partial_search_results false "
                             "raises")
            except SearchPhaseExecutionException as e:
                check("timed out" in e.reason,
                      f"19b: the request raises 'timed out' ({e.reason})")
            delay.remove()
            torch.cuda.synchronize()
            acct = memory_accountant()
            mem0, led0 = torch.cuda.memory_allocated(), acct.staged_bytes()
            ms = gnode.indices["agg4"]._mesh_search
            dec0 = dict(ms.decisions)
            mt = item("19b deadline inside the mesh plane (agg4)",
                      lambda: gnode.search("agg4", {
                          "query": match, "timeout": "1nanos"}))
            torch.cuda.synchronize()
            mem1, led1 = torch.cuda.memory_allocated(), acct.staged_bytes()
            check(mt["timed_out"] is True and mt["hits"]["total"] == 0
                  and mt["_shards"]["failed"] == 0
                  and ms.decisions == dec0,
                  f"19b: a deadline expired in the mesh plane answers "
                  f"timed_out before any launch ({mt['hits']['total']} "
                  f"hits)")
            check(mem1 == mem0 and led1 == led0,
                  f"19b: memory_allocated {mem0} -> {mem1} and the ledger "
                  f"{led0} -> {led1} stay at their levels")
            report["timeout"] = {"partial_total": part["hits"]["total"],
                                 "full_total": full_n,
                                 "memory": [mem0, mem1],
                                 "ledger": [led0, led1]}

            # ---- 19c: failure isolation (C14) ------------------------
            SearchFailScheme(indices=["logs-a"], shards=[2]).install()
            fr = item("19c one shard fails (logs-a)",
                      lambda: gnode.search("logs-a", {"query": match,
                                                      "size": 10}))
            cfr = cnode.search("logs-a", {"query": match, "size": 10})
            f0 = (fr["_shards"].get("failures") or [{}])[0]
            check(fr["_shards"]["failed"] == 1
                  and fr["_shards"]["successful"] == 3
                  and f0.get("shard") == 2
                  and f0["reason"]["type"] == "runtime_error"
                  and fr["timed_out"] is False
                  and [h["_id"] for h in fr["hits"]["hits"]]
                  == [h["_id"] for h in cfr["hits"]["hits"]],
                  f"19c: _shards.failed 1 with a runtime_error, the rest "
                  f"answered as the cpu twin ({fr['_shards']})")
            mfr = item("19c one shard fails (logs-*)",
                       lambda: gnode.search("logs-*", {"query": match,
                                                       "size": 10}))
            check(mfr["_shards"]["failed"] == 1
                  and mfr["_shards"]["total"] == 8,
                  f"19c: across indices one failure entry "
                  f"({mfr['_shards']})")
            clear_search_disruptions()
            SearchFailScheme(indices=["logs-a"]).install()
            try:
                gnode.search("logs-a", {"query": match})
                check(False, "19c: every shard failing raises")
            except SearchPhaseExecutionException as e:
                check(e.reason == "all shards failed"
                      and len(e.shard_failures) == 4,
                      f"19c: 'all shards failed' with 4 entries "
                      f"({e.reason}, {len(e.shard_failures)})")
            clear_search_disruptions()

        # ---- 19d: profile --------------------------------------------
        prof = {}
        for label, index, body, plane in (
                ("mesh_pallas", "pmc4", {"query": match}, "mesh_pallas"),
                ("host", "pmc4h", {"query": match}, "host"),
                ("knn", "pmc4", dict(knn_body), "mesh_pallas")):
            plain = g7.search(index, dict(body))
            pr = item(f"19d profile {label} ({index})",
                      lambda: g7.search(index, dict(body, profile=True)),
                      reps=2)
            cr = c7.search(index, dict(body, profile=True))
            p = pr.get("profile") or {}
            check(pr["_plane"] == plain["_plane"] == plane
                  and _same_exact(pr, plain)
                  and p.get("plane") == plane and p.get("phases")
                  and (label != "host" or len(p["shards"]) == 4),
                  f"19d: profiled {label} stays on {plane} with the "
                  f"unprofiled hits ({pr['_plane']}, {p.get('plane')})")
            if label == "knn":
                same_knn_response(pr, cr, 1e-4, "19d profiled knn")
            else:
                same_response(pr, cr, f"19d profiled {label}")
            prof[label] = {s["phase"]: s["time_in_nanos"] / 1e6
                           for s in p.get("phases", [])}
        # a profiled burst: the members share the batched fused top-k
        # launch (1c) and each reports the batch's shape
        burst = [{"query": {"match": {"title": " ".join(
            tok(t) for t in q)}}, "size": 10} for q in queries[2:6]]
        solo = [g7.search("pmc4", dict(b)) for b in burst]
        out = item("19d profiled burst of 4 (pmc4)",
                   lambda: g7.indices["pmc4"].search_batch(
                       [dict(b, profile=True) for b in burst]))
        check(all(isinstance(r, dict) and r["_plane"] == "mesh_pallas"
                  and _same_exact(r, want)
                  and r["profile"]["annotations"].get("batch_size") == 4
                  and r["profile"]["annotations"].get(
                      "batch_member_index") == i
                  for i, (r, want) in enumerate(zip(out, solo))),
              "19d: each profiled burst member equals its serial answer "
              "and reports the batch's shape")
        report["profile_phases_ms"] = prof
        log(f"[phase 19d] phases (ms, host clock, the kernel span ends at "
            f"the device sync): {json.dumps(prof)}")

        # ---- 19e: _explain and _validate/query ------------------------
        top = g7.search("pmc4", {"query": match, "size": 10})
        cctl = RestController(c7)
        exact, details = 0, 0
        t0 = time.perf_counter()
        for h in top["hits"]["hits"]:
            raw = json.dumps({"query": match}).encode()
            st, out = gctl.dispatch("GET", f"/pmc4/_explain/{h['_id']}", {},
                                    raw)
            _cst, cout = cctl.dispatch("GET", f"/pmc4/_explain/{h['_id']}",
                                       {}, raw)
            exact += int(st == 200 and out["matched"] is True
                         and out["explanation"]["value"] == h["_score"])
            details += int(bool(out["explanation"]["details"]))
            check(abs(out["explanation"]["value"]
                      - cout["explanation"]["value"])
                  <= RTOL * abs(cout["explanation"]["value"]),
                  f"19e: _explain of {h['_id']} equals the cpu twin's")
        explain_ms = (time.perf_counter() - t0) * 1000 / max(
            len(top["hits"]["hits"]), 1)
        check(exact == len(top["hits"]["hits"]) == 10,
              f"19e: each top hit's explanation value is its _score bit for "
              f"bit ({exact} of {len(top['hits']['hits'])})")
        # a miss: the top hit against a rare term its title lacks (an ids
        # filtered search finds no hit)
        first = top["hits"]["hits"][0]["_id"]
        for r in range(VOCAB - 1, VOCAB - 50, -1):
            absent = {"match": {"title": tok(r)}}
            if not g7.search("pmc4", {"size": 0, "query": {"bool": {
                    "must": [absent],
                    "filter": [{"ids": {"values": [first]}}]}}})[
                    "hits"]["total"]:
                break
        st, out = gctl.dispatch("GET", f"/pmc4/_explain/{first}", {},
                                json.dumps({"query": absent}).encode())
        check(st == 200 and out["matched"] is False
              and out["explanation"]["value"] == 0.0,
              f"19e: a miss answers matched false ({first}, {absent})")
        sv, ok = gctl.dispatch("GET", "/pmc4/_validate/query", {},
                               json.dumps({"query": match}).encode())
        si, bad = gctl.dispatch("GET", "/pmc4/_validate/query",
                                {"explain": "true"},
                                b'{"query": {"no_such_query": {}}}')
        check(sv == si == 200 and ok["valid"] is True
              and bad["valid"] is False and bad["explanations"],
              "19e: _validate/query answers valid and invalid")
        report["explain"] = {"bit_equal": exact, "with_details": details,
                             "ms_per_explain": explain_ms}
        log(f"[phase 19e] {json.dumps(report['explain'])}")

        # ---- 19f: track_total_hits on the pruned form -----------------
        pbody = {"query": match, "size": 10}
        pr = item("19f pruned pmc4p", lambda: gP.search("pmc4p",
                                                        dict(pbody)))
        tr = item("19f track_total_hits pmc4p", lambda: gP.search(
            "pmc4p", dict(pbody, track_total_hits=True)), reps=2)
        exact_n = gP.search("pmc4p", dict(pbody, size=0))["hits"]["total"]
        ctr = cP.search("pmc4p", dict(pbody, track_total_hits=True))
        st_p, rp = pctl.dispatch("GET", "/pmc4p/_search", {},
                                 json.dumps(pbody).encode())
        st_t, rt = pctl.dispatch("GET", "/pmc4p/_search",
                                 {"track_total_hits": "true"},
                                 json.dumps(pbody).encode())
        check("_pruned" in pr and "_pruned" not in tr
              and tr["_plane"] == pr["_plane"] == "mesh_pallas"
              and tr["hits"]["total"] == exact_n == ctr["hits"]["total"]
              and pr["hits"]["total"] <= exact_n
              and _same_exact(dict(tr, hits=dict(tr["hits"],
                                                  total=0)),
                              dict(pr, hits=dict(pr["hits"], total=0)))
              and rt["hits"]["total"] == {"value": exact_n, "relation": "eq"}
              and rp["hits"]["total"]["relation"] == "gte",
              f"19f: track_total_hits gives the exact total "
              f"({tr['hits']['total']} of {exact_n}, pruned "
              f"{pr['hits']['total']} gte)")
        report["track_total_hits"] = {"pruned_total": pr["hits"]["total"],
                                      "exact_total": exact_n}
    torch.cuda.synchronize()
    report["main_s"] = time.perf_counter() - t_main
    p19 = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    log(f"[phase 19] kernel launches: {p19}")
    t0 = time.perf_counter()
    held, _here = hold_recovered_path(torch, tsc, ssum, knn, kept, p19,
                                      errs, "phase 19")
    del kept
    report["hold_s"] = time.perf_counter() - t0
    for k in ("tile_scoring", "segment_sum", "knn_scoring",
              "tile_scoring_topk", "tile_scoring_topk_sel_packed"):
        check(p19.get(k, 0) > 0, f"phase 19 launched {k}")
    fails = plane_failures(*(gnode.indices[n] for n in gnode.indices),
                           g7.indices["pmc4"], gP.indices["pmc4p"])
    check(not any(fails), f"phase 19: zero plane faults (got {fails})")
    report.update(launches=p19, held=held)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 19] {report['seconds']:.1f} s (main path "
        f"{report['main_s']:.1f}, hold {report['hold_s']:.1f})")
    return report


# ----------------------------------------------------------------------
# Phase 20: scripting, the update API and mget on the card
# ----------------------------------------------------------------------

# 20a's threshold on citations (a zipf count: about a sixth of the docs
# are above it)
SCRIPT_T = 5
# 20e: the durable index holds the first 2,000 docs of ingest-20k (cut
# from 10,000 to pay for phase 21), and every one of them is updated once;
# 200 single updates at request durability
UPDATE_DOCS = 2_000
SINGLE_UPDATES = 200
# 20e: every 100th doc of each mesh shard is updated (about 1%)
MESH_UPDATE_EVERY = 100


def scripting_phase(torch, cuda_kernels, tsc, ssum, knn, p12, g3, c3, ops,
                    queries, errs):
    """Phase 20: scripting, the update API and mget on the card.

    The numeric forms run on phase 12's pmc-4x256k doc-values form
    (4 x 262,144 docs with ``ts``, ``citations``, 3% missing, and
    ``venue``): scr4, a new mesh index over phase 12's segments with slot
    headroom (``max_slots_per_device`` 8) for 20e's append; agg4x, phase
    12's host-rung twin on the card; and the cpu twin (phase 12's cpu
    node's agg4).

    20a. The script query: ``doc['citations'].value > params.t`` under a
         BM25 match and alone, ``doc['citations'].length``, a division
         by an absent field and a constant script. Hits and totals equal
         the cpu twin's on both planes; the totals equal a numpy count
         over the segments' citations columns and live masks. A burst of
         four (script filters, script fields) equals its serial answers.
    20b. ``script_fields`` on 10 hits: an expression over citations and
         ``_score``, a painless script returning venue's string; equal to
         the cpu twin's.
    20c. ``scripted_metric`` (``doc['citations'].value * 2``, with and
         without a reduce script) under a match beside a ``terms`` on
         venue and a ``sum`` of citations: exactly twice the sum; with no
         query, twice the numpy sum over the live docs. Served by the host
         reduce (the fused plane's ``unsupported_agg``).
    20d. A painless script query on ingest-20k (phase 3's index, 5
         shards, and its cpu twin): its ms per 1,000 docs; equal to the
         cpu twin and to a numpy count over the year columns.
    20e. Over HTTP on a durable node: bulk-index 2,000 docs of
         ingest-20k at ``async`` durability, flush, then bulk-update all
         of them (half partial ``doc`` merges, half scripted
         ``ctx._source.year += params.n``): docs/s of both. 200 single
         ``_update``s at ``request`` durability (noop, ``ctx.op =
         'delete'``, ``scripted_upsert``, a version conflict (409), a
         missing doc (404)). A second node opened over the data path
         (the first one dropped, not closed) replays the updates from the
         translog: sources and versions read back. Then on scr4 one bulk
         request updates every 100th doc's citations (about 1%) and a
         refresh follows: the first 20a answer takes the delta append, no
         rebuild, and equals the cpu twin's.
    20f. ``mget`` of 100 ids across both durable indices, one missing,
         in process and over HTTP: the gets merged.

    Every answer is sound (``_shards.failed == 0``, ``timed_out``
    false) and every launch is held against its plain version. Closes
    phase 12's nodes. Returns the report."""
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.http_server import HttpServer

    t_phase = time.perf_counter()
    gnode, cnode, gsegs, _csegs, mapping = p12
    report = {"items": {}}
    routing = _routing_for_shards(4)
    gnode.create_index("scr4", {"settings": {
        "number_of_shards": 4, "refresh_interval": "-1",
        "requests.cache.enable": False,
        "search": {"mesh": {"max_slots_per_device": 8}},
        # no background compaction: a merge re-parses the stored sources,
        # which hold no title here
        "staging": {"compact": {"threshold": 0}}}, "mappings": mapping})
    for sh, seg in enumerate(gsegs):
        gnode.indices["scr4"].shards[sh].engine.adopt_segment(seg)
    ms = gnode.indices["scr4"]._mesh_plane()

    def item(name, fn, reps=1):
        """``fn`` ``reps`` times on the card, synced: its p50, the plane
        of its answer and the launches of its first run."""
        before = dict(cuda_kernels.LAUNCHES)
        xs, out, launched = [], None, {}
        for i in range(reps):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            xs.append((time.perf_counter() - t0) * 1000)
            if i == 0:
                out = r
                launched = {k: v - before.get(k, 0) for k, v in
                            cuda_kernels.LAUNCHES.items()
                            if v != before.get(k, 0)}
        plane = out.get("_plane") if isinstance(out, dict) else None
        row = {"p50_ms": float(np.median(xs)), "samples": len(xs),
               "plane": plane, "launches": launched}
        report["items"][name] = row
        log(f"[phase 20] {name}: " + json.dumps(row))
        return out

    def numpy_count(pred):
        """Live docs of phase 12's segments whose citations satisfy
        ``pred(exists, value)``."""
        n = 0
        for seg in gsegs:
            col = seg.numeric_columns["citations"]
            nd = seg.num_docs
            n += int((seg.live[:nd] & pred(col.exists[:nd],
                                           col.first_value[:nd])).sum())
        return n

    def sc(source, **params):
        return {"script": {"script": {"source": source, **(
            {"params": params} if params else {})}}}

    tok = term_token
    match = {"match": {"title": " ".join(tok(t) for t in queries[1])}}
    gt = sc("doc['citations'].value > params.t", t=SCRIPT_T)
    forms = {
        "script under match": (
            {"query": {"bool": {"must": [match], "filter": [gt]}},
             "size": 10}, None),
        "script alone": ({"query": gt, "size": 10},
                         lambda e, v: e & (v > SCRIPT_T)),
        "length": ({"query": sc("doc['citations'].length > 0"),
                    "size": 10}, lambda e, v: e),
        "absent divisor": (
            {"query": sc("doc['citations'].value / doc['absent'].value > 1"),
             "size": 10}, lambda e, v: e & (v > 0)),
        "constant": ({"query": sc("1"), "size": 10},
                     lambda e, v: np.ones_like(e)),
    }
    cuda_kernels.reset_launch_counts()
    t_main = time.perf_counter()
    with recording_recovered_path(tsc, ssum, knn) as kept:
        # ---- 20a: the script query -----------------------------------
        planes = {}
        for name, (body, pred) in forms.items():
            gm = item(f"20a {name} (scr4)",
                      lambda: gnode.search("scr4", dict(body)), reps=3)
            gh = item(f"20a {name} (agg4x, host rung)",
                      lambda: gnode.search("agg4x", dict(body)), reps=3)
            cr = cnode.search("agg4", dict(body))
            same_response(gm, cr, f"20a {name} on scr4 ({gm['_plane']})")
            same_response(gh, cr, f"20a {name} on agg4x")
            check(gh["_plane"] == "host" and gm["_plane"] != "host",
                  f"20a {name}: agg4x on the host rung, scr4 on the mesh "
                  f"({gh['_plane']}, {gm['_plane']})")
            if pred is not None:
                want = numpy_count(pred)
                check(gm["hits"]["total"] == gh["hits"]["total"] == want,
                      f"20a {name}: the total is the numpy count "
                      f"({gm['hits']['total']}, {want})")
            planes[name] = gm["_plane"]
        report["planes"] = planes
        report["decisions"] = dict(ms.decisions)
        # a burst: members with a script filter (served one by one on the
        # mesh) beside members with script fields (one batched dense
        # launch a slot, 1b), each equal to its serial answer
        burst = [{"query": {"bool": {"must": [{"match": {"title": tok(t)}}],
                                     "filter": [gt]}}, "size": 10}
                 for t in queries[2][:2]]
        burst += [{"query": {"match": {"title": tok(t)}}, "size": 10,
                   "script_fields": {"e": {"script":
                                           "doc['citations'].value + _score"}}}
                  for t in queries[3][:2]]
        serial = [gnode.search("scr4", dict(b)) for b in burst]
        got = item("20a burst of 4 (scr4)",
                   lambda: gnode.indices["scr4"].search_batch(
                       [dict(b) for b in burst]))
        check(all(isinstance(r, dict) and _same_exact(r, w)
                  and r["hits"]["hits"] == w["hits"]["hits"]
                  for r, w in zip(got, serial)),
              "20a: each burst member equals its serial answer")

        # ---- 20b: script_fields --------------------------------------
        fbody = {"query": match, "size": 10, "script_fields": {
            "e": {"script": "doc['citations'].value * 2 + _score"},
            "v": {"script": {"source": "if (doc['venue'].size() == 0) "
                                       "{ return null } "
                                       "return doc['venue'].value"}}}}
        for index in ("scr4", "agg4x"):
            gf = item(f"20b script_fields ({index})",
                      lambda: gnode.search(index, dict(fbody)), reps=3)
            cf = cnode.search("agg4", dict(fbody))
            same_response(gf, cf, f"20b script_fields on {index}")
            ok = len(gf["hits"]["hits"]) == 10
            for h, c in zip(gf["hits"]["hits"], cf["hits"]["hits"]):
                e, ce = h["fields"]["e"][0], c["fields"]["e"][0]
                ok = ok and abs(e - ce) <= RTOL * abs(ce)
                ok = ok and h["fields"]["v"] == c["fields"]["v"]
                ok = ok and isinstance(h["fields"]["v"][0], str)
            check(ok, f"20b: {index}'s script fields equal the cpu twin's")

        # ---- 20c: scripted_metric ------------------------------------
        twice = "doc['citations'].value * 2"
        aggs = {"m": {"scripted_metric": {"map_script": twice}},
                "mr": {"scripted_metric": {"map_script": twice,
                                           "reduce_script": "params._agg / 2"}},
                "s": {"sum": {"field": "citations"}},
                "v": {"terms": {"field": "venue", "size": 10}}}
        for label, query in (("under a match", match), ("every doc", None)):
            body = {"size": 0, "aggs": aggs}
            if query is not None:
                body["query"] = query
            by0 = dict(ms.agg_host_fallback_by_reason)
            gr = item(f"20c scripted_metric {label} (scr4)",
                      lambda: gnode.search("scr4", dict(body)))
            by = {k: v - by0.get(k, 0) for k, v in
                  ms.agg_host_fallback_by_reason.items()
                  if v != by0.get(k, 0)}
            hr = gnode.search("agg4x", dict(body))
            cr = cnode.search("agg4", dict(body))
            a = gr["aggregations"]
            check(a == hr["aggregations"] == cr["aggregations"]
                  and a["m"]["value"] == 2 * a["s"]["value"]
                  and a["mr"]["value"] == a["s"]["value"]
                  and by == {"unsupported_agg": 1},
                  f"20c {label}: twice the sum of citations exactly, equal "
                  f"on every index ({a['m']['value']}, {a['s']['value']}, "
                  f"{by})")
            if query is None:
                want = 0.0
                for seg in gsegs:
                    col = seg.numeric_columns["citations"]
                    nd = seg.num_docs
                    keep = seg.live[:nd] & col.exists[:nd]
                    want += float(col.first_value[:nd][keep].sum())
                check(a["m"]["value"] == 2 * want,
                      f"20c: twice the numpy sum over the live docs "
                      f"({a['m']['value']}, {2 * want})")
            report[f"scripted_metric_{label.replace(' ', '_')}"] = \
                a["m"]["value"]

        # ---- 20d: a painless script query on ingest-20k ---------------
        pbody = {"query": sc(
            "if (doc['year'].size() == 0) { return false } "
            "def y = doc['year'].value; "
            "return y % params.m == 0 || y > params.hi", m=4, hi=2020),
            "size": 10}
        gp = item("20d painless script query (docs, ingest-20k)",
                  lambda: g3.search("docs", dict(pbody)), reps=2)
        cp = c3.search("docs", dict(pbody))
        same_response(gp, cp, "20d painless script query")
        want, n_docs = 0, 0
        for shard in g3.indices["docs"].shards.values():
            for seg in shard.engine.segments:
                nd = seg.num_docs
                col = seg.numeric_columns["year"]
                y = col.first_value[:nd]
                live = seg.live[:nd]
                n_docs += int(live.sum())
                want += int((live & col.exists[:nd]
                             & ((y % 4 == 0) | (y > 2020))).sum())
        check(gp["hits"]["total"] == want,
              f"20d: the total is the numpy count ({gp['hits']['total']}, "
              f"{want})")
        report["painless_ms_per_1000_docs"] = (
            report["items"]["20d painless script query (docs, ingest-20k)"]
            ["p50_ms"] / (n_docs / 1000))
        log(f"[phase 20d] painless over {n_docs} docs: "
            f"{report['painless_ms_per_1000_docs']:.3f} ms per 1,000 docs")

        # ---- 20e: updates over HTTP on a durable node ------------------
        path = tempfile.mkdtemp(prefix="chip_smoke_p20_")
        try:
            report["updates"] = _durable_updates(Node, HttpServer, ops,
                                                 path)
        finally:
            shutil.rmtree(path, ignore_errors=True)

        # ---- 20e: a 1% update on the mesh index, then the delta path --
        alone = forms["script alone"][0]
        count0 = numpy_count(forms["script alone"][1])
        bulk, n_old_gt = [], 0
        for sh, seg in enumerate(gsegs):
            col = seg.numeric_columns["citations"]
            local = seg.id_to_doc()
            for i in range(0, MESH_SHARD_DOCS, MESH_UPDATE_EVERY):
                d = local[f"s{sh}p{i}"]
                if not seg.live[d]:
                    continue  # deleted in phase 12e
                old = col.first_value[d] if col.exists[d] else 0.0
                n_old_gt += int(bool(col.exists[d]) and old > SCRIPT_T)
                bulk.append(("update", {"_index": "scr4", "_id": f"s{sh}p{i}",
                                        "routing": routing[sh]},
                             {"doc": {"citations": int(old) + 1000}}))
        t0 = time.perf_counter()
        r = gnode.bulk(bulk)
        bulk_s = time.perf_counter() - t0
        check(not r["errors"], "20e: the mesh index's bulk update")
        gnode.refresh("scr4")
        cbulk = [(a, dict(m, _index="agg4"), s) for a, m, s in bulk]
        check(not cnode.bulk(cbulk)["errors"], "20e: the cpu twin's update")
        cnode.refresh("agg4")
        restage0, delta0 = ms.restage_total, ms.delta_restage_total
        # the first answer after the refresh: 20a's form under a match
        # (BM25 scores, so no tie order between the planes decides it)
        under = forms["script under match"][0]
        first = item("20e first script query after the 1% update (scr4)",
                     lambda: gnode.search("scr4", dict(under)))
        same_response(first, cnode.search("agg4", dict(under)),
                      "20e the first answer after the update")
        check(ms.delta_restage_total == delta0 + 1
              and ms.restage_total == restage0
              and first["_plane"] != "host",
              f"20e: the delta append served it on the mesh, no rebuild "
              f"(delta {delta0} -> {ms.delta_restage_total}, rebuilds "
              f"{restage0} -> {ms.restage_total}, {first['_plane']})")
        # the script alone: the updated docs' new values counted (a total
        # only: every hit ties at the constant score, and the host rung's
        # order of ties across a shard's two segments is not the mesh's)
        gu = item("20e script alone after the update (scr4)",
                  lambda: gnode.search("scr4", dict(alone, size=0)), reps=3)
        cu = cnode.search("agg4", dict(alone, size=0))
        check(gu["hits"]["total"] == cu["hits"]["total"]
              == count0 - n_old_gt + len(bulk),
              f"20e: the total moved by the updated docs "
              f"({gu['hits']['total']}, cpu {cu['hits']['total']}, "
              f"{count0} - {n_old_gt} + {len(bulk)})")
        report["mesh_update"] = {
            "docs": len(bulk), "bulk_s": bulk_s,
            "docs_per_s": len(bulk) / bulk_s,
            "first_answer_ms": report["items"][
                "20e first script query after the 1% update (scr4)"]["p50_ms"],
            "first_answer_plane": first["_plane"],
            "alone_plane": gu["_plane"]}
        log(f"[phase 20e] mesh update: {json.dumps(report['mesh_update'])}")
    torch.cuda.synchronize()
    report["main_s"] = time.perf_counter() - t_main
    p20 = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    log(f"[phase 20] kernel launches: {p20}")
    t0 = time.perf_counter()
    held, _here = hold_recovered_path(torch, tsc, ssum, knn, kept, p20,
                                      errs, "phase 20")
    del kept
    report["hold_s"] = time.perf_counter() - t0
    # (a serial request's mesh_pallas program scores each slot with the
    # dense form, 1a; the burst's script-field members share 1b)
    for k in ("tile_scoring", "tile_scoring_batched", "segment_sum"):
        check(p20.get(k, 0) > 0, f"phase 20 launched {k}")
    fails = plane_failures(gnode.indices["scr4"], gnode.indices["agg4x"],
                           g3.indices["docs"])
    check(not any(fails), f"phase 20: zero plane faults (got {fails})")
    for node in (gnode, cnode):
        node.close()
    report.update(launches=p20, held=held)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 20] {report['seconds']:.1f} s (main path "
        f"{report['main_s']:.1f}, hold {report['hold_s']:.1f})")
    return report


def _durable_updates(Node, HttpServer, ops, path):
    """Phase 20e's HTTP half on a durable node at ``path``; 20f's mget
    on the node reopened over it. Returns the report entry."""
    out = {}
    node = Node(data_path=path, device="cuda")
    srv = HttpServer(node, port=0)
    srv.start()
    client = HttpClient(srv.port)
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}}}}
    try:
        st, _ = client.call("PUT", "/upd", {"settings": {
            "number_of_shards": 5, "refresh_interval": "-1",
            "requests.cache.enable": False,
            "translog": {"durability": "async"}},
            "mappings": mapping})
        st2, _ = client.call("PUT", "/updr", {"settings": {
            "number_of_shards": 5, "refresh_interval": "-1",
            "requests.cache.enable": False},
            "mappings": mapping})
        check(st == st2 == 200, "20e: the durable indices created")
        docs = ops[:UPDATE_DOCS]

        def ndjson(lines):
            return ("\n".join(json.dumps(x) for x in lines) + "\n").encode()

        def bulk(lines, what):
            st, r = client.call("POST", "/_bulk", ndjson(lines),
                                "application/x-ndjson")
            check(st == 200 and not r["errors"], f"20e: {what}")
            return r

        t0 = time.perf_counter()
        for b in range(0, len(docs), 2000):
            lines = []
            for _a, meta, src in docs[b: b + 2000]:
                lines += [{"index": {"_index": "upd", "_id": meta["_id"]}},
                          src]
            bulk(lines, "bulk index")
        out["bulk_index_docs_per_s"] = len(docs) / (time.perf_counter() - t0)
        client.call("POST", "/upd/_flush")
        t0 = time.perf_counter()
        for b in range(0, len(docs), 2000):
            lines = []
            for i in range(b, min(b + 2000, len(docs))):
                lines.append({"update": {"_index": "upd", "_id": f"d{i}"}})
                lines.append({"doc": {"venue": f"u{i % 7}"}} if i % 2 == 0
                             else {"script": {
                                 "source": "ctx._source.year += params.n",
                                 "params": {"n": 3}}})
            r = bulk(lines, "bulk update")
            check(all(it["update"]["result"] == "updated"
                      for it in r["items"]), "20e: every update applied")
        out["bulk_update_docs_per_s"] = (len(docs)
                                         / (time.perf_counter() - t0))
        client.call("POST", "/upd/_refresh")
        st, c = client.call("POST", "/upd/_count",
                            {"query": {"term": {"venue": "u3"}}})
        check(c["count"] == sum(1 for i in range(0, len(docs), 2)
                                if i % 7 == 3),
              f"20e: the merged venues count ({c['count']})")
        st, g = client.call("GET", "/upd/_doc/d1")
        check(g["_version"] == 2
              and g["_source"]["year"] == docs[1][2]["year"] + 3,
              f"20e: a scripted update read back ({g})")
        log(f"[phase 20e] bulk index {out['bulk_index_docs_per_s']:.0f} "
            f"docs/s, bulk update {out['bulk_update_docs_per_s']:.0f} "
            f"docs/s ({len(docs):,} docs over HTTP, async durability)")

        # 200 single updates at request durability
        lines = []
        for _a, meta, src in ops[:SINGLE_UPDATES]:
            lines += [{"index": {"_index": "updr", "_id": meta["_id"]}}, src]
        bulk(lines, "bulk index at request durability")
        want = {"noop": (200, "noop"), "delete": (200, "deleted"),
                "upsert": (200, "created"), "conflict": (409, None),
                "missing": (404, None)}
        got, lat = {k: 0 for k in want}, []
        for i in range(SINGLE_UPDATES):
            kind = ("noop", "delete", "upsert", "conflict",
                    "missing")[i * 5 // SINGLE_UPDATES]
            year = ops[i][2]["year"]
            path_, body = {
                "noop": (f"/updr/_update/d{i}", {"doc": {"year": year}}),
                "delete": (f"/updr/_update/d{i}",
                           {"script": "ctx.op = 'delete'"}),
                "upsert": (f"/updr/_update/new{i}", {
                    "scripted_upsert": True, "upsert": {"year": 0},
                    "script": {"source": "ctx._source.year += params.n",
                               "params": {"n": i}}}),
                "conflict": (f"/updr/_update/d{i}?version=99",
                             {"doc": {"year": 1}}),
                "missing": (f"/updr/_update/missing{i}",
                            {"doc": {"year": 1}}),
            }[kind]
            t0 = time.perf_counter()
            st, r = client.call("POST", path_, body)
            lat.append((time.perf_counter() - t0) * 1000)
            status, result = want[kind]
            got[kind] += int(st == status and (
                result is None or r.get("result") == result))
        check(all(v == SINGLE_UPDATES // 5 for v in got.values()),
              f"20e: every single update answered as its kind ({got})")
        out["single_update_p50_ms"] = float(np.median(lat))
        log(f"[phase 20e] {SINGLE_UPDATES} single _updates at request "
            f"durability: p50 {out['single_update_p50_ms']:.3f} ms, "
            f"answers {json.dumps(got)}")
        sample = ([("upd", f"d{i}") for i in range(0, len(docs), 50)]
                  + [("updr", f"d{i}") for i in range(
                      0, 2 * SINGLE_UPDATES // 5)]
                  + [("updr", f"new{i}") for i in range(
                      2 * SINGLE_UPDATES // 5, 3 * SINGLE_UPDATES // 5)])
        before = {k: node.get_doc(*k) for k in sample}
        # the async translog's next sync (the port has no sync interval
        # yet: an async op reaches the file at a sync, a flush or a close)
        for shard in node.indices["upd"].shards.values():
            shard.engine.translog.sync()
    finally:
        client.close()
        srv.stop()
    # the node is dropped without a close: a second one replays the
    # translogs (upd since its flush; updr whole)
    t0 = time.perf_counter()
    node2 = Node(data_path=path, device="cuda")
    out["reopen_s"] = time.perf_counter() - t0
    try:
        replayed = {n: sum(node2.indices[n].recovered_ops.values())
                    for n in ("upd", "updr")}
        out["replayed_ops"] = replayed
        check(replayed == {"upd": len(docs),
                           "updr": SINGLE_UPDATES + 2 * SINGLE_UPDATES // 5},
              f"20e: the reopen replayed the updates ({replayed})")
        after = {k: node2.get_doc(*k) for k in sample}
        check(after == before,
              f"20e: {len(sample)} updated sources and versions read back "
              f"after the reopen")
        # ---- 20f: mget across both indices ---------------------------
        ids = ([{"_index": "upd", "_id": f"d{i}"}
                for i in range(0, len(docs), max(len(docs) // 49, 1))][:49]
               + [{"_index": "upd", "_id": "nope"}]
               + [{"_index": "updr", "_id": f"d{i}"} for i in range(25)]
               + [{"_index": "updr", "_id": f"new{i}"}
                  for i in range(2 * SINGLE_UPDATES // 5,
                                 2 * SINGLE_UPDATES // 5 + 25)])
        t0 = time.perf_counter()
        m = node2.mget({"docs": ids})
        out["mget_ms"] = (time.perf_counter() - t0) * 1000
        merged = [node2.get_doc(d["_index"], d["_id"]) for d in ids]
        srv2 = HttpServer(node2, port=0)
        srv2.start()
        c2 = HttpClient(srv2.port)
        try:
            st, mh = c2.call("POST", "/_mget", {"docs": ids})
        finally:
            c2.close()
            srv2.stop()
        missing = sum(not d["found"] for d in m["docs"])
        check(len(ids) == 100 and m["docs"] == merged and missing == 1
              and st == 200 and mh == _as_json(m),
              f"20f: mget of 100 ids over both indices is the gets merged, "
              f"in process and over HTTP ({len(ids)} ids, {missing} "
              f"missing, merged {m['docs'] == merged}, HTTP {st} "
              f"{mh == _as_json(m)})")
        log(f"[phase 20f] mget of {len(ids)} ids: {out['mget_ms']:.3f} ms "
            f"in process; reopen {out['reopen_s']:.2f} s, replayed "
            f"{json.dumps(replayed)}")
    finally:
        node2.close()
        node.close()
    return out


# ----------------------------------------------------------------------
# Durability on the card: translog, store, restart recovery
# ----------------------------------------------------------------------

# 13b's child: indexes the docs of a JSON-lines file into a durable node on
# the card, one bulk of 1,000 at a time under the default request
# durability, and prints each bulk's acknowledged ids
CRASH_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[3])
from elasticsearch_tpu_torch.node import Node
node = Node(data_path=sys.argv[1], device="cuda")
node.create_index("docs", {"settings": {"number_of_shards": 5,
                                        "refresh_interval": "-1",
                                        "requests.cache.enable": False},
                           "mappings": {"_doc": {"properties": {
                               "id": {"type": "keyword"},
                               "title": {"type": "text"},
                               "venue": {"type": "keyword"},
                               "year": {"type": "long"}}}}})
print(json.dumps({"ready": True}), flush=True)
with open(sys.argv[2], encoding="utf-8") as f:
    docs = [json.loads(line) for line in f]
step = int(sys.argv[4])
for b in range(0, len(docs), step):
    r = node.bulk([("index", {"_index": "docs", "_id": d["id"]}, d)
                   for d in docs[b: b + step]])
    assert not r["errors"]
    print(json.dumps([next(iter(it.values()))["_id"] for it in r["items"]]),
          flush=True)
"""
CRASH_ACKED_BULKS = 2
# the child's bulk size (each op fsynced at request durability)
CRASH_BULK_DOCS = 400


def _readline(proc, timeout=600.0):
    """The child's next stdout line, or '' if it said nothing in
    ``timeout`` seconds."""
    ready, _w, _x = select.select([proc.stdout], [], [], timeout)
    return proc.stdout.readline() if ready else ""


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, files in os.walk(path) for f in files)


def _no_took(resp):
    """A response as JSON without ``took``: what must come back equal, byte
    for byte, after a restart."""
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


def _shard_seqnos(node, index):
    return {sid: sh.seq_no_stats()["max_seq_no"]
            for sid, sh in node.indices[index].shards.items()}


@contextlib.contextmanager
def recording_recovered_path(tsc, ssum, knn):
    """Every kernel call on the card while the block runs: score_tiles
    (every variant), the segment sum's gather and mask forms, kernel 3."""
    with recording_tile_launches(tsc, lambda k: True) as tiles, \
            recording_segsum_calls(ssum) as gathered, \
            recording_mask_segsum(ssum) as masked, \
            recording_knn_launches(knn) as knns:
        yield tiles, gathered, masked, knns


def hold_recovered_path(torch, tsc, ssum, knn, kept, launches, errs, label):
    """Hold every kept launch against its plain version on its inputs, and
    check that every launch the counters saw (``launches``) was held.
    Returns (launches held, largest difference), by launch name, both of
    this block alone; ``errs`` takes the largest differences too (kNN
    under ``knn``)."""
    tiles, gathered, masked, knns = kept
    here = {}
    held = dict(check_kept_launches(torch, tsc, tiles, here, label))
    for name in held:
        # a launch with no finite plain score is held by torch.equal alone
        here.setdefault(name, 0.0)
    check_kept_segsum(torch, ssum, gathered, label, here, held)
    check_kept_mask_segsum(torch, ssum, masked, label, here, held)
    for n, (args, kw, out) in enumerate(knns):
        plain = knn.knn_score_tiles_plain(
            args[0], args[1], args[2], args[3], sub=kw["sub"],
            k=min(kw["k"], kw["sub"] * knn.LANE), n_rows=kw["n_rows"])
        torch.cuda.synchronize()
        fin = torch.isfinite(plain[0])
        here["knn_scoring"] = max(here.get("knn_scoring", 0.0), float(
            (out[0][fin] - plain[0][fin]).abs().max()) if bool(fin.any())
            else 0.0)
        check(torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1]),
              f"{label} kNN launch {n} (rows {kw['n_rows']}) equals plain")
    held["knn_scoring"] = len(knns)
    for k, v in launches.items():
        if v:
            check(held.get(k, 0) == v,
                  f"{label} every {k} launch held against plain ({v}, "
                  f"held {held.get(k, 0)})")
    for k, v in here.items():
        key = "knn" if k == "knn_scoring" else k
        errs[key] = max(errs.get(key, 0.0), v)
    return held, here


def durability_phase(torch, Node, cuda_kernels, tsc, ops, inproc_rate, reqs3,
                     reqs7, knn_bodies, shard_arrays, vecs, exists, queries,
                     errs, smi=""):
    """Phase 13: durability on the card, every data path under a fresh
    ``tempfile.mkdtemp()``, removed at the end.

    13a. A ``Node(data_path=..., device="cuda")`` takes phase 3's first
         1,000 docs in bulks of 1,000 under
         ``index.translog.durability: async``
         and the first 400 into a second index under ``request`` (one
         fsync per op): docs/s for each beside phase 3's in-memory rate.
         ``_flush``, every 100th doc deleted, phase 3's requests
         recorded, ``close()``;
         a new Node over the path answers them equal byte for byte (bar
         ``took``) on the host rung, every launch (1a, kernel 2 and its
         combine pass) held against plain; each shard's next ``_seq_no`` continues from its
         last; deleted docs stay deleted; ``_forcemerge`` leaves every
         total and bucket as it was and the merged index equals a cpu node
         opened over the same data path.
    13b. A child ``python3`` on the card indexes phase 3's docs (with an
         ``id`` keyword) under ``request`` durability, printing each
         bulk's acknowledged ids, and is killed with SIGKILL in the middle
         of its third bulk. Reopened on the card: every acknowledged doc
         is found by GET and by a ``terms`` query on ``id``, no doc twice,
         each shard's local checkpoint at its max seqno, and the match
         totals equal an in-memory node that took exactly the recovered
         docs.
    13c. pmc-4x256k at full width (phase 7's arrays, phase 12's ``ts`` /
         ``citations``, phase 9's ``emb``) in one durable 4-shard index:
         phase 7's, 9's and 12's bodies and two ``search_batch`` bursts
         of 16 (phase 8's matches, 1c; phase 12's agg bodies, 1b)
         recorded, synced flush, ``close()`` (``memory_allocated`` back to
         its level before the index); the reopen timed as Node
         construction (load, checksums, version maps), staging, then the
         first answer (host clock, no profiler, with host-clock spans of
         its mesh staging, program and fetch); then the mesh plane's
         staging dropped and the same body answered again under
         torch.profiler, for the device split into copies and kernels;
         every recorded response equal bit for bit with ``_plane``
         unchanged, and every launch (1a, 1b, 1c, kernel 2 and its
         combine pass, kernel 3) held against plain, with 13c's own
         largest difference per kernel. Then phase 22e on the same
         recovered node (``snapshot_restore_phase``: its ``path.repo`` is
         ``<root>/repos``); its report goes under ``13c``'s ``22e``.
    Returns the report (the summary line's ``durability`` entry)."""
    from elasticsearch_tpu_torch.ops import knn_scoring as knn
    from elasticsearch_tpu_torch.ops import segment_sum as ssum

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="estpu-durable-")
    report = {"data_root_free_bytes": shutil.disk_usage(root).free}
    try:
        report["13a"] = _durable_ingest(torch, Node, cuda_kernels, tsc, ssum,
                                        knn, ops, inproc_rate, reqs3, errs,
                                        os.path.join(root, "a"))
        report["13b"] = _crash_recovery(torch, Node, ops, reqs3,
                                        os.path.join(root, "b"))
        report["13c"] = _recover_full_width(
            torch, Node, cuda_kernels, tsc, ssum, knn, reqs7, knn_bodies,
            shard_arrays, vecs, exists, queries, errs,
            os.path.join(root, "c"), os.path.join(root, "repos"), smi)
    finally:
        shutil.rmtree(root)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 13] done in {report['seconds']:.1f} s")
    return report


def _durable_ingest(torch, Node, cuda_kernels, tsc, ssum, knn, ops,
                    inproc_rate, reqs, errs, path):
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}}}}
    g = Node(data_path=path, device="cuda")
    g.create_index("docs", {"settings": {
        "number_of_shards": 5, "refresh_interval": "-1",
        "requests.cache.enable": False,
        "translog": {"durability": "async"}},
        "mappings": mapping})
    g.create_index("docs_req", {"settings": {"number_of_shards": 5,
                                             "refresh_interval": "-1",
                                             "requests.cache.enable": False},
                                "mappings": mapping})
    rates = {}
    for index, docs in (("docs", ops[:ASYNC_DURABLE_DOCS]),
                        ("docs_req", ops[:REQUEST_DURABLE_DOCS])):
        t0 = time.perf_counter()
        for b in range(0, len(docs), 1000):
            r = g.bulk([(a, {**meta, "_index": index}, src)
                        for a, meta, src in docs[b: b + 1000]])
            check(not r["errors"], f"phase 13a bulk into {index}")
        g.refresh(index)
        torch.cuda.synchronize()
        rates[index] = len(docs) / (time.perf_counter() - t0)
    log(f"[phase 13a] durable ingest + refresh: async {rates['docs']:.0f} "
        f"docs/s ({ASYNC_DURABLE_DOCS:,} docs), request "
        f"{rates['docs_req']:.0f} docs/s "
        f"({REQUEST_DURABLE_DOCS:,} docs, one fsync per op), in memory "
        f"(phase 3) "
        f"{inproc_rate:.0f} docs/s")
    t0 = time.perf_counter()
    g.flush("docs")
    flush_s = time.perf_counter() - t0
    deleted = [f"d{i}" for i in range(0, ASYNC_DURABLE_DOCS, 100)]
    for d in deleted:
        check(g.delete_doc("docs", d)["result"] == "deleted",
              f"phase 13a delete {d}")
    g.refresh("docs")
    before = [_no_took(g.search("docs", dict(body))) for _k, body, _t in reqs]
    last = _shard_seqnos(g, "docs")
    t0 = time.perf_counter()
    g.close()
    close_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    g2 = Node(data_path=path, device="cuda")
    reopen_s = time.perf_counter() - t0
    svc = g2.indices["docs"]
    check(sorted(g2.indices) == ["docs", "docs_req"],
          f"phase 13a reopened both indices ({sorted(g2.indices)})")
    check(sum(svc.recovered_ops.values()) == 0,
          f"phase 13a close's synced flush left nothing to replay "
          f"({svc.recovered_ops})")
    check(g2.indices["docs_req"].num_docs() == REQUEST_DURABLE_DOCS,
          f"phase 13a request-durability index reopened with "
          f"{REQUEST_DURABLE_DOCS:,} docs")
    cuda_kernels.reset_launch_counts()
    with recording_recovered_path(tsc, ssum, knn) as kept:
        after = [_no_took(g2.search("docs", dict(body)))
                 for _k, body, _t in reqs]
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.LAUNCHES)
    held, _ = hold_recovered_path(torch, tsc, ssum, knn, kept, launches,
                                  errs, "phase 13a")
    del kept
    same = sum(a == b for a, b in zip(after, before))
    check(same == len(reqs),
          f"phase 13a: {same} of {len(reqs)} responses after the reopen "
          f"equal those before the close")
    check(all(json.loads(a)["_plane"] == "host" for a in after),
          "phase 13a served on the host rung")
    for k in HOST_PATH_KERNELS:
        check(launches[k] > 0,
              f"phase 13a launched {k} on the recovered path "
              f"({launches[k]})")
    for d in deleted[:10]:
        check(not g2.get_doc("docs", d)["found"],
              f"phase 13a deleted {d} stays deleted")
    # each shard's next seqno continues from its last
    routing = _routing_for_shards(5)
    for sid, seq in last.items():
        r = g2.index_doc("docs", f"n{sid}", {"title": "t00001"},
                         routing=routing[sid])
        check(r["_seq_no"] == seq + 1,
              f"phase 13a shard {sid} next _seq_no {r['_seq_no']} after "
              f"{seq}")
        g2.delete_doc("docs", f"n{sid}", routing=routing[sid])
    g2.refresh("docs")
    # force merge: the deleted docs leave the segments, and with them
    # their share of each segment's BM25 statistics; totals and buckets
    # stay, and the merged index equals a cpu node over the same path
    check(g2.force_merge("docs")["_shards"]["successful"] == 5,
          "phase 13a _forcemerge")
    g2.flush("docs")
    shutil.copytree(path, path + "-cpu")
    c2 = Node(data_path=path + "-cpu", device="cpu")
    merged_same = 0
    for (kind, body, _t), b in zip(reqs, before):
        gr = g2.search("docs", dict(body))
        want = json.loads(b)
        merged_same += (gr["hits"]["total"] == want["hits"]["total"]
                        and gr.get("aggregations")
                        == want.get("aggregations"))
        same_response(gr, c2.search("docs", dict(body)),
                      f"phase 13a merged {kind}")
    check(merged_same == len(reqs),
          f"phase 13a _forcemerge kept {merged_same} of {len(reqs)} totals "
          f"and buckets")
    c2.close()
    g2.close()
    out = {"async_docs_per_s": rates["docs"],
           "request_docs_per_s": rates["docs_req"],
           "inproc_docs_per_s": inproc_rate, "flush_s": flush_s,
           "close_s": close_s, "reopen_s": reopen_s,
           "responses_equal": same, "launches": launches, "held": held}
    log(f"[phase 13a] {json.dumps(out)}")
    return out


def _crash_recovery(torch, Node, ops, reqs, path):
    os.makedirs(path)
    docs_file = os.path.join(path, "docs.jsonl")
    with open(docs_file, "w", encoding="utf-8") as f:
        for _a, meta, src in ops:
            f.write(json.dumps({**src, "id": meta["_id"]}) + "\n")
    data = os.path.join(path, "node")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-c", CRASH_CHILD, data,
                             docs_file, root, str(CRASH_BULK_DOCS)],
                            stdout=subprocess.PIPE, text=True)
    acked = []
    t0 = time.perf_counter()
    bulk_s = []
    try:
        check(json.loads(_readline(proc) or "{}").get("ready", False),
              "phase 13b child ready")
        t_bulk = time.perf_counter()
        for _ in range(CRASH_ACKED_BULKS):
            line = _readline(proc)
            check(bool(line), "phase 13b child acknowledged a bulk")
            if not line:
                break
            acked += json.loads(line)
            bulk_s.append(time.perf_counter() - t_bulk)
            t_bulk = time.perf_counter()
        # the next bulk is in flight: a third of a bulk's time into it,
        # some of its ops are in the translog and none is acknowledged
        time.sleep(min(bulk_s[1:] or [0.3]) / 3)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    child_s = time.perf_counter() - t0
    sent = {meta["_id"] for _a, meta, _s in
            ops[: (CRASH_ACKED_BULKS + 1) * CRASH_BULK_DOCS]}
    in_flight = sent - set(acked)
    t0 = time.perf_counter()
    g = Node(data_path=data, device="cuda")
    reopen_s = time.perf_counter() - t0
    svc = g.indices["docs"]
    g.refresh("docs")
    replayed = sum(svc.recovered_ops.values())
    found = sum(g.get_doc("docs", d)["found"] for d in acked)
    check(found == len(acked) == CRASH_ACKED_BULKS * CRASH_BULK_DOCS,
          f"phase 13b every acknowledged doc found by GET ({found} of "
          f"{len(acked)})")
    by_terms = 0
    for b in range(0, len(acked), 500):
        chunk = acked[b: b + 500]
        r = g.search("docs", {"query": {"terms": {"id": chunk}},
                              "size": len(chunk)})
        by_terms += (r["hits"]["total"] == len(chunk) and sorted(
            h["_id"] for h in r["hits"]["hits"]) == sorted(chunk))
    check(by_terms == -(-len(acked) // 500),
          "phase 13b every acknowledged doc found once by a terms query on "
          "its id")
    for d in acked[::97]:
        r = g.search("docs", {"query": {"term": {"id": d}}})
        check(r["hits"]["total"] == 1 and r["hits"]["hits"][0]["_id"] == d,
              f"phase 13b term query on id {d}")
    everything = g.search("docs", {"query": {"match_all": {}},
                                   "size": 10_000})
    got = [h["_id"] for h in everything["hits"]["hits"]]
    check(len(got) == len(set(got)) == everything["hits"]["total"],
          "phase 13b no doc twice")
    check(set(acked) <= set(got) <= sent,
          f"phase 13b recovered the acknowledged docs and only docs of the "
          f"bulk in flight ({len(got)} docs, {len(acked)} acknowledged)")
    for sid, sh in svc.shards.items():
        s = sh.seq_no_stats()
        check(s["local_checkpoint"] == s["max_seq_no"],
              f"phase 13b shard {sid} local checkpoint {s}")
    # an in-memory node that took exactly the recovered docs, in seqno order
    mem = Node(device="cuda")
    mem.create_index("docs", {"settings": {"number_of_shards": 5,
                                           "refresh_interval": "-1",
                                           "requests.cache.enable": False},
                              "mappings": {"_doc": {"properties": {
                                  "id": {"type": "keyword"},
                                  "title": {"type": "text"},
                                  "venue": {"type": "keyword"},
                                  "year": {"type": "long"}}}}})
    order = sorted(got, key=lambda d: g.get_doc("docs", d)["_seq_no"])
    srcs = {h["_id"]: h["_source"] for h in everything["hits"]["hits"]}
    mem.bulk([("index", {"_index": "docs", "_id": d}, srcs[d])
              for d in order], refresh=True)
    totals_same = sum(
        g.search("docs", dict(body))["hits"]["total"]
        == mem.search("docs", dict(body))["hits"]["total"]
        for _k, body, _t in reqs)
    check(totals_same == len(reqs),
          f"phase 13b {totals_same} of {len(reqs)} match totals equal an "
          f"in-memory node over the recovered docs")
    mem.close()
    g.close()
    out = {"acked": len(acked), "recovered": len(got),
           "recovered_of_bulk_in_flight": len(set(got) & in_flight),
           "replayed_ops": replayed, "child_s": child_s,
           "bulk_s": bulk_s, "reopen_s": reopen_s}
    log(f"[phase 13b] {json.dumps(out)}")
    return out


def _first_answer(torch, fn):
    """Run ``fn`` once, with no profiler: its host-clock ms ending in a
    device sync, and host-clock spans of the mesh plane's steps inside it
    (each span syncs the card at its ends): the staging of the slot
    structures (``_stage_rebuild``), a delta (``_apply_delta``, inside it
    the appended segments' own staging, the successor's build and the
    tombstones), of the kernel plane (``ensure_kernel``), the program
    (``execute``) and the fetch. What the spans leave is the rest of the
    host work (routing, plan building, reduce)."""
    from elasticsearch_tpu_torch.index import index_service
    from elasticsearch_tpu_torch.parallel import plan_exec

    targets = [(plan_exec.IndexMeshSearch, "_stage_rebuild", "mesh_stage"),
               (plan_exec.IndexMeshSearch, "_apply_delta", "delta_stage"),
               (plan_exec.MeshPlanExecutor, "stage_delta_segments",
                "delta_segments_stage"),
               (plan_exec.MeshPlanExecutor, "delta_append", "delta_append"),
               (plan_exec.MeshPlanExecutor, "apply_tombstones",
                "tombstones"),
               (plan_exec.MeshPlanExecutor, "ensure_kernel",
                "kernel_plane_stage"),
               (plan_exec.MeshPlanExecutor, "execute", "program"),
               (index_service, "fetch_hits", "fetch")]
    with timed_spans(torch, targets) as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    spans = dict(spans)
    # the delta spans run inside delta_stage: the rest leaves them out
    nested = ("delta_segments_stage", "delta_append", "tombstones")
    spans["rest"] = wall - sum(v for k, v in spans.items()
                               if k not in nested)
    return out, wall, spans


def _device_split(torch, fn):
    """Run ``fn`` once under torch.profiler: the device time of the port's
    kernels, of copies and fills (staging), and of the other device work,
    in ms. The profiler's own host cost makes its wall time no answer
    time, so none is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    split = {"kernels_ms": 0.0, "copies_ms": 0.0, "other_ms": 0.0,
             "kernel_launches": 0, "copies": 0}
    ours = ("tile_scoring", "segment_sum", "knn_scoring")
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1000.0
        if any(k in ev.name for k in ours):
            split["kernels_ms"] += ms
            split["kernel_launches"] += 1
        elif ev.name.startswith(("Memcpy", "Memset")):
            split["copies_ms"] += ms
            split["copies"] += 1
        else:
            split["other_ms"] += ms
    return out, split


def _recover_full_width(torch, Node, cuda_kernels, tsc, ssum, knn, reqs7,
                        knn_bodies, shard_arrays, vecs, exists, queries, errs,
                        path, repo_root, smi):
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.segment import Segment

    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}, "ts": {"type": "date"},
        "citations": {"type": "long"},
        "emb": {"type": "dense_vector", "dims": KNN_DIMS,
                "similarity": "cosine"}}}}
    aggs12 = agg_requests(queries)
    # one body of each kind of phases 7, 9 and 12 (cut from every body as
    # phase 24 joined: the kinds, and so the paths, are the same)
    kinds, bodies = set(), []
    for label, body in ([(f"7/{i}/{k}", b)
                         for i, (k, b, _t) in enumerate(reqs7)]
                        + [(f"9/{k}", b) for k, b in knn_bodies]
                        + [(f"12/{i}/{k}", b)
                           for i, (k, b, _r) in enumerate(aggs12)]):
        kind = (label.split("/")[0], label.rsplit("/", 1)[-1])
        if kind not in kinds:
            kinds.add(kind)
            bodies.append((label, body))
    # phase 8's match burst (one batched fused top-k launch a slot, 1c)
    # and phase 12's agg burst (one batched dense launch a slot, 1b)
    dash = aggs12[0][1]["aggs"]
    small = {k: dash[k] for k in ("venues", "per_day", "cit_stats")}
    matches = [{"match": {"title": " ".join(term_token(t) for t in q)}}
               for q in queries[:BURST]]
    bursts = {"burst_match": [{"query": m, "size": 10} for m in matches],
              "burst_aggs": [{"query": m, "size": 10,
                              "aggs": dash if i % 2 == 0 else small}
                             for i, m in enumerate(matches)]}

    def serve_bursts(svc):
        out = {}
        for name, members in bursts.items():
            got = svc.search_batch([dict(b) for b in members])
            check(all(isinstance(r, dict) for r in got),
                  f"phase 13c {name}: every member answered")
            for i, r in enumerate(got):
                if isinstance(r, dict):
                    out[f"{name}/{i}"] = _no_took(r)
        return out

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    g = Node(data_path=path, device="cuda")
    g.create_index("dur4", {"settings": {"number_of_shards": 4,
                                         "refresh_interval": "-1",
                                         "requests.cache.enable": False},
                            "mappings": mapping})
    for sh, arrays in enumerate(shard_arrays):
        arrays = dict(arrays)
        nd_pad = arrays["numeric_columns"]["year"]["exists"].shape[0]
        n = len(arrays["doc_ids"])
        arrays["numeric_columns"] = {**arrays["numeric_columns"],
                                     **agg_columns(sh, nd_pad, n)}
        rows = slice(sh * MESH_SHARD_DOCS, (sh + 1) * MESH_SHARD_DOCS)
        arrays["vector_columns"] = {"emb": dict(
            vectors=vecs[rows], exists=exists[rows], dims=KNN_DIMS,
            count=int(exists[rows].sum()))}
        g.indices["dur4"].shards[sh].engine.adopt_segment(
            Segment.from_arrays(f"dur4_{sh}_seg_1", device="cuda", **arrays))
    build_s = time.perf_counter() - t0
    before = {}
    for label, body in bodies:
        before[label] = _no_took(g.search("dur4", dict(body)))
    before.update(serve_bursts(g.indices["dur4"]))
    planes = {label: json.loads(r)["_plane"] for label, r in before.items()}
    t0 = time.perf_counter()
    g.indices["dur4"].synced_flush()
    flush_s = time.perf_counter() - t0
    disk = _dir_bytes(path)
    by_kind = {}
    for d, _s, files in os.walk(path):
        for f in files:
            by_kind[f] = by_kind.get(f, 0) + os.path.getsize(
                os.path.join(d, f))
    # what arrays.npz holds, by kind
    segs = [seg for sh in g.indices["dur4"].shards.values()
            for seg in sh.engine.segments]
    by_kind["arrays.npz: postings"] = sum(
        s.block_docs.nbytes + s.block_tfs.nbytes for s in segs)
    by_kind["arrays.npz: vectors"] = sum(
        c.vectors.nbytes for s in segs for c in s.vector_columns.values())
    t0 = time.perf_counter()
    g.close()
    torch.cuda.synchronize()
    close_s = time.perf_counter() - t0
    mem_closed = torch.cuda.memory_allocated()
    check(abs(mem_closed - mem0) <= 1 << 20,
          f"phase 13c close returned device memory to within 1 MB of its "
          f"level before the index ({mem0} -> {mem_closed} bytes)")
    del g

    # the reopen: construction (load, checksums, version maps), staging,
    # the first answer
    t0 = time.perf_counter()
    g2 = cold_reopen(Node, path, "cuda", {"path.repo": [repo_root]})
    load_s = time.perf_counter() - t0
    svc = g2.indices["dur4"]
    check(sum(svc.recovered_ops.values()) == 0,
          "phase 13c synced flush left nothing to replay")
    t0 = time.perf_counter()
    for sh in svc.shards.values():
        for seg in sh.engine.searchable_segments():
            check(seg.device == torch.device("cuda", 0),
                  f"phase 13c recovered {seg.name} on the node's card")
            seg.device_arrays()
            seg.ensure_vector_staged("emb")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    cuda_kernels.reset_launch_counts()
    with recording_recovered_path(tsc, ssum, knn) as kept:
        first_label, first_body = bodies[0]
        first, first_ms, first_spans = _first_answer(
            torch, lambda: g2.search("dur4", dict(first_body)))
        after = {first_label: _no_took(first)}
        # the device split in a separate pass: the mesh plane's staging
        # dropped, so the same body stages it again under the profiler
        svc._mesh_search._drop_staging()
        again, split = _device_split(
            torch, lambda: g2.search("dur4", dict(first_body)))
        check(_no_took(again) == before[first_label],
              "phase 13c the profiled restaged answer equals the first")
        for label, body in bodies[1:]:
            after[label] = _no_took(g2.search("dur4", dict(body)))
        after.update(serve_bursts(svc))
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.LAUNCHES)
    held, errs13 = hold_recovered_path(torch, tsc, ssum, knn, kept, launches,
                                       errs, "phase 13c")
    del kept
    same = [label for label in before if after.get(label) == before[label]]
    check(len(same) == len(before) == len(bodies) + 2 * BURST,
          f"phase 13c: {len(same)} of {len(before)} responses after the "
          f"reopen equal those before, bit for bit (differ: "
          f"{[k for k in before if k not in same][:5]})")
    check(all(json.loads(after[k])["_plane"] == planes[k] for k in after),
          "phase 13c every response on the plane it was served by before")
    moved = {"tile_scoring": launches["tile_scoring"],
             "tile_scoring_topk": launches["tile_scoring_topk"],
             "tile_scoring_batched": launches["tile_scoring_batched"],
             "segment_sum": launches["segment_sum"],
             "knn_scoring": launches["knn_scoring"]}
    for k, v in moved.items():
        check(v > 0, f"phase 13c launched {k} on the recovered path ({v})")
    snap = snapshot_restore_phase(torch, cuda_kernels, tsc, ssum, knn, g2,
                                  bodies, repo_root, errs, smi)
    g2.close()
    torch.cuda.synchronize()
    mem_end = torch.cuda.memory_allocated()
    check(abs(mem_end - mem0) <= 1 << 20,
          f"phase 13c close after the recovery returned device memory "
          f"({mem0} -> {mem_end} bytes)")
    # phase 24d: the same index reopened warm
    warm = warm_reopen(torch, Node, cuda_kernels, tsc, ssum, knn, path,
                       repo_root, bodies, before, first_ms, errs, smi)
    mem_warm = torch.cuda.memory_allocated()
    check(abs(mem_warm - mem0) <= 1 << 20,
          f"phase 24d close after the warm reopen returned device memory "
          f"({mem0} -> {mem_warm} bytes)")
    # every launched kernel was held (hold_recovered_path checks it), so
    # each has its held count and its largest difference of 13c alone
    kernels = [{"name": k, "launches": v, "held": held[k],
                "max_abs_err": errs13[k]}
               for k, v in sorted(launches.items()) if v]
    out = {"docs": 4 * MESH_SHARD_DOCS, "bytes_on_disk": disk,
           "bytes_by_file": by_kind, "build_s": build_s,
           "synced_flush_s": flush_s, "close_s": close_s,
           "load_s": load_s, "stage_s": stage_s,
           "first_answer_ms": first_ms, "first_answer_spans_ms": first_spans,
           "restaged_answer_device_split": split,
           "first_request": first_label, "responses_equal": len(same),
           "responses": len(before), "planes": sorted(set(planes.values())),
           "memory_allocated": {"before": mem0, "after_close": mem_closed,
                                "after_recovered_close": mem_end},
           "launches": launches, "held": held, "kernels": kernels}
    log(f"[phase 13c] {json.dumps(out)}")
    out["22e"] = snap
    out["24d"] = warm
    return out


# ----------------------------------------------------------------------
# phase 14: the staging lifecycle (delta append, tombstones, budget,
# faults, compaction) on pmc-4x256k at full width
# ----------------------------------------------------------------------

APPEND_DOCS = 4096  # a refresh's worth a shard: each shard seals one segment
APPEND_SEED = 200  # the appended docs' corpus seeds: MESH_SEEDS[sh] + 200
STAGING_MAX_SLOTS = 8


def _staged_tensors(torch, svc):
    """The index's tensors on the card, each once (the segments' own
    stagings and the mesh generation's): {(data_ptr, numel): tensor}."""
    groups = []
    for sh in svc.shards.values():
        for seg in sh.engine.segments:
            groups += list((seg._device or {}).values())
            for tables in list(seg._kernel_tables.values()):
                groups += list(tables.values())
            groups += list(seg.dev_cache.values())
    ms = svc._mesh_search
    ex = ms._executor if ms is not None else None
    if ex is not None:
        groups += list(ex._seg_staged.values())
        groups += [e["mask"] for e in ex._knn.values() if isinstance(e, dict)]
    return {(t.data_ptr(), t.numel()): t for t in groups
            if torch.is_tensor(t) and t.is_cuda}


def _active_blocks(torch):
    """{address: size} of the caching allocator's allocated blocks."""
    return {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated"}


def _leftover_note(torch, blocks0):
    """The blocks allocated since ``blocks0`` and the Python tensors that
    live in them, with their referrers' types: what keeps memory after a
    close."""
    import gc

    new = {a: n for a, n in _active_blocks(torch).items() if a not in blocks0}
    found = []
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            ptr = o.data_ptr()
            if any(a <= ptr < a + n for a, n in new.items()):
                found.append({"shape": list(o.shape), "dtype": str(o.dtype),
                              "referrers": [type(r).__name__ for r in
                                            gc.get_referrers(o)][:6]})
    return {"blocks": sorted(new.values()), "tensors": found[:8]}


def _append_segments(sh, vecs, exists):
    """Shard ``sh``'s appended segment: APPEND_DOCS docs from the corpus
    generator with a seed of its own, their ts / citations columns and
    their emb vectors (rows of ``vecs``)."""
    corpus = build_synthetic_corpus(MESH_SEEDS[sh] + APPEND_SEED,
                                    n_docs=APPEND_DOCS)
    arrays = corpus_segment_arrays(corpus, id_prefix=f"s{sh}n")
    arrays["numeric_columns"] = {
        **arrays["numeric_columns"],
        **agg_columns(sh, corpus["nd_pad"], APPEND_DOCS,
                      seed=MESH_SEEDS[sh] + APPEND_SEED + 100)}
    rows = slice(sh * APPEND_DOCS, (sh + 1) * APPEND_DOCS)
    arrays["vector_columns"] = {"emb": dict(
        vectors=vecs[rows], exists=exists[rows], dims=KNN_DIMS,
        count=int(exists[rows].sum()))}
    return arrays


def staging_phase(torch, Segment, cuda_kernels, tsc, ssum, knn, reqs7,
                  knn_bodies, shard_arrays, vecs, exists, queries, ops,
                  errs):
    """Phase 14: pmc-4x256k at full width in three indices over the same
    arrays: ``stg4`` (delta staging on), ``stg4f`` (``index.staging.delta
    .enabled: false``, every change a full rebuild) and ``stg4c`` on the
    cpu; ``index.search.mesh.max_slots_per_device: 8`` and block-max
    pruning on all three. 14a the initial staging against the allocator;
    14b an append of APPEND_DOCS docs a shard, timed against the full
    rebuild; 14c a 1% delete of one shard. At a smaller depth, on
    ``stgc`` (10,000 of phase 3's docs over 4 shards on the card: the
    adopted corpus keeps no title text to re-analyze, and the full-width
    restages of a budget and fault cycle would cost the script's time
    limit): 14d the HBM budget; 14e transient and deterministic staging
    faults; 14f compaction. 14g close. Every launch of phase 14 is held
    against its plain version."""
    from elasticsearch_tpu_torch.common.memory import memory_accountant
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.fused_aggs import resolve_fused_aggs
    from elasticsearch_tpu_torch.testing.disruption import (
        StagingFailScheme,
        clear_search_disruptions,
    )

    t_phase = time.perf_counter()
    acct = memory_accountant()
    mapping = {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}, "ts": {"type": "date"},
        "citations": {"type": "long"},
        "emb": {"type": "dense_vector", "dims": KNN_DIMS,
                "similarity": "cosine"}}}
    aggs12 = agg_requests(queries)
    # one body of each of phase 7's, 9's and 12's request kinds
    seen = set()
    bodies = []
    for i, (k, b, _t) in enumerate(reqs7):
        if k not in seen:
            seen.add(k)
            bodies.append((f"7/{k}", b))
    bodies += [(f"9/{k}", b) for k, b in knn_bodies]
    bodies += [(f"12/{k}", b) for k, b, _r in aggs12 if k != "pipelines"]
    dash = aggs12[0][1]["aggs"]
    small = {k: dash[k] for k in ("venues", "per_day", "cit_stats")}
    matches = [{"match": {"title": " ".join(term_token(t) for t in q)}}
               for q in queries[:BURST]]
    # a pruned burst (1e), an exhaustive one (a size-0 member: 1c) and an
    # agg burst (1b with the fused columns)
    bursts = {
        "burst_pruned": [{"query": m, "size": 10} for m in matches],
        "burst_exact": [{"query": m, "size": 0 if i == 0 else 10}
                        for i, m in enumerate(matches)],
        "burst_aggs": [{"query": m, "size": 10,
                        "aggs": dash if i % 2 == 0 else small}
                       for i, m in enumerate(matches)]}
    routing = _routing_for_shards(4)

    def norm(svc, r):
        """A response without ``took`` and its index's name."""
        return _no_took(r).replace(f'"_index": "{svc.name}"',
                                   '"_index": "-"')

    def answers(svc, with_bursts=True):
        out = {label: norm(svc, svc.search(dict(b))) for label, b in bodies}
        for name, members in (bursts.items() if with_bursts else ()):
            got = svc.search_batch([dict(b) for b in members])
            for i, r in enumerate(got):
                check(isinstance(r, dict),
                      f"phase 14 {svc.name} {name}/{i} answered")
                out[f"{name}/{i}"] = norm(svc, r) if isinstance(r, dict) \
                    else None
        return out

    def new_events(name, before):
        """The index's generation events that ``before`` (an earlier
        ``staging_events`` list) does not hold: the event ring is bounded,
        so no count marks a position in it."""
        return [e for e in acct.stats(name)["staging_events"]
                if e not in before and e["segment"].startswith("mesh#")]

    def same_answers(a, b, what):
        differ = [k for k in a if a[k] != b.get(k)]
        check(not differ and len(a) == len(b),
              f"phase 14 {what}: {len(a) - len(differ)} of {len(a)} "
              f"responses equal byte for byte (differ: {differ[:4]})")

    # stagings the earlier phases left are evicted first, so the budget of
    # 14d and the memory level of 14g see this phase's indices alone
    acct.set_budget(1)
    acct.set_budget(0)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    blocks0 = _active_blocks(torch)

    def make(name, device, delta):
        svc = IndexService(name, Settings({
            "index.number_of_shards": 4, "index.refresh_interval": -1,
            "index.requests.cache.enable": False,
            "index.search.mesh.max_slots_per_device": STAGING_MAX_SLOTS,
            "index.staging.delta.enabled": delta,
            "index.staging.compact.threshold": 0,
            "index.search.plane_quarantine.cooldown": "200ms",
            "search.pallas.pruning.enabled": True}),
            mapping=mapping, device=device)
        for sh, arrays in enumerate(shard_arrays):
            arrays = dict(arrays)
            nd_pad = arrays["numeric_columns"]["year"]["exists"].shape[0]
            n = len(arrays["doc_ids"])
            arrays["numeric_columns"] = {**arrays["numeric_columns"],
                                         **agg_columns(sh, nd_pad, n)}
            rows = slice(sh * MESH_SHARD_DOCS, (sh + 1) * MESH_SHARD_DOCS)
            arrays["vector_columns"] = {"emb": dict(
                vectors=vecs[rows], exists=exists[rows], dims=KNN_DIMS,
                count=int(exists[rows].sum()))}
            svc.shards[sh].engine.adopt_segment(Segment.from_arrays(
                f"{name}_{sh}_seg_1", device=device, **arrays))
        return svc

    t0 = time.perf_counter()
    gD = make("stg4", "cuda", True)
    gF = make("stg4f", "cuda", False)
    cC = make("stg4c", "cpu", True)
    build_s = time.perf_counter() - t0
    out = {"docs": 4 * MESH_SHARD_DOCS, "append_docs": 4 * APPEND_DOCS,
           "max_slots_per_device": STAGING_MAX_SLOTS, "build_s": build_s}

    # ---- 14a: the initial staging, the ledger against the allocator ----
    torch.cuda.synchronize()
    m_before = torch.cuda.memory_allocated()
    r_before = torch.cuda.memory_stats().get("requested_bytes.all.current")
    t0 = time.perf_counter()
    ms = gD._mesh_plane()
    ex = ms._ensure_staged()
    check(ex is not None and ex.ensure_kernel() is not None
          and ex.ensure_knn("emb", KNN_DIMS, "cosine") is not None,
          "phase 14a the generation, its kernel plane and kNN plane staged")
    plan, reason = resolve_fused_aggs(parse_aggs(dash), ex)
    check(plan is not None, f"phase 14a the dashboard's doc-value columns "
                            f"staged ({reason})")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    m_after = torch.cuda.memory_allocated()
    r_after = torch.cuda.memory_stats().get("requested_bytes.all.current")
    by_kind = acct.staged_bytes_by_kind("stg4")
    tensors = _staged_tensors(torch, gD)
    walked = sum(t.numel() * t.element_size() for t in tensors.values())
    # bound_tables are host arrays, counted as the JAX package counts them
    ledger_dev = sum(v for k, v in by_kind.items() if k != "bound_tables")
    # the caching allocator rounds a block to 512 B, and keeps a large
    # block (1 MiB or more) whole when splitting it would leave 1 MiB or
    # less: memory_allocated may exceed the tensors' bytes by that much a
    # tensor; the bytes the tensors requested are exact
    sizes = [t.numel() * t.element_size() for t in tensors.values()]
    tol = sum(512 + (1 << 20 if n >= 1 << 20 else 0) for n in sizes)
    check(ledger_dev == walked,
          f"phase 14a the ledger's device kinds equal the staged tensors' "
          f"bytes ({ledger_dev} vs {walked})")
    check(r_before is not None and r_after - r_before == ledger_dev,
          f"phase 14a the ledger equals the allocator's requested bytes, "
          f"exactly ({ledger_dev} vs {None if r_before is None else r_after - r_before})")
    check(0 <= (m_after - m_before) - ledger_dev <= tol,
          f"phase 14a memory_allocated's delta exceeds the ledger by at "
          f"most the allocator's rounding ({ledger_dev} vs "
          f"{m_after - m_before}, bound {tol} over {len(tensors)} tensors)")
    reasons = {e["reason"] for e in new_events("stg4", [])}
    check(reasons == {"initial"}, f"phase 14a reason initial ({reasons})")
    n_tensors = len(tensors)
    del tensors
    out["14a"] = {"stage_s": stage_s, "ledger_by_kind": by_kind,
                  "allocator_delta": m_after - m_before,
                  "requested_delta": (None if r_before is None
                                      else r_after - r_before),
                  "ledger_device_bytes": ledger_dev, "tensors": n_tensors,
                  "tolerance": tol, "n_slots": ex.n_slots,
                  "free_slots": ex.free_slots(), "scope": ex.scope}
    out['14a']["t_s"] = time.perf_counter() - t_phase
    log(f"[phase 14a] {json.dumps(out['14a'])}")

    cuda_kernels.reset_launch_counts()
    with recording_recovered_path(tsc, ssum, knn) as kept:
        # the rebuild twin stages its generation before the append
        first_label, first_body = bodies[0]
        check(gF.search(dict(first_body))["_plane"] == "mesh_pallas",
              "phase 14a stg4f staged its generation")

        # ---- 14b: append a refresh's worth a shard ----------------------
        avecs, aexists, _r = knn_vectors(4 * APPEND_DOCS, seed=KNN_SEED + 1)
        appended = [_append_segments(sh, avecs, aexists) for sh in range(4)]
        for svc, device in ((gD, "cuda"), (gF, "cuda"), (cC, "cpu")):
            for sh in range(4):
                svc.shards[sh].engine.adopt_segment(Segment.from_arrays(
                    f"{svc.name}_{sh}_seg_2", device=device, **appended[sh]))
        del appended
        st0 = acct.stats("stg4")
        rD, ms_d, spans_d = _first_answer(
            torch, lambda: gD.search(dict(first_body)))
        rF, ms_f, spans_f = _first_answer(
            torch, lambda: gF.search(dict(first_body)))
        st1 = acct.stats("stg4")
        restaged = st1["restaged_bytes_total"] - st0["restaged_bytes_total"]
        logical = (st1["bytes_logically_changed_total"]
                   - st0["bytes_logically_changed_total"])
        ev = new_events("stg4", st0["staging_events"])
        check(ms.delta_restage_total == 1 and ms.restage_total == 1,
              f"phase 14b the append served as a delta "
              f"(delta_restage_total {ms.delta_restage_total}, "
              f"restage_total {ms.restage_total})")
        check(any(e["reason"] == "delta_append" for e in ev),
              "phase 14b reason delta_append")
        check(gF._mesh_search.restage_total == 2
              and gF._mesh_search.delta_restage_total == 0,
              "phase 14b stg4f rebuilt its generation")
        check(norm(gD, rD) == norm(gF, rF),
              "phase 14b the appended answer equals the rebuilt one")
        after_d = answers(gD)
        after_f = answers(gF)
        same_answers(after_d, after_f, "14b stg4 (appended) vs stg4f")
        ex_b = ms._executor
        out["14b"] = {
            "first_request": first_label,
            "appended_answer_ms": ms_d, "appended_spans_ms": spans_d,
            "rebuilt_answer_ms": ms_f, "rebuilt_spans_ms": spans_f,
            "restaged_bytes": restaged, "logically_changed_bytes": logical,
            "amplification": (restaged / logical) if logical else None,
            "reasons": sorted({e["reason"] for e in ev}),
            "delta_events_bytes": {f"{e['kind']}/{e['table']}": e["bytes"]
                                   for e in ev},
            "n_slots": ex_b.n_slots, "free_slots": ex_b.free_slots(),
            "rebuilt_n_slots": gF._mesh_search._executor.n_slots}
        out['14b']["t_s"] = time.perf_counter() - t_phase
        log(f"[phase 14b] {json.dumps(out['14b'])}")

        # ---- 14c: tombstones, 1% of one shard's docs --------------------
        dead = [f"s1p{i}" for i in range(0, MESH_SHARD_DOCS, 100)]
        for svc in (gD, gF, cC):
            for d in dead:
                svc.delete_doc(d, routing=routing[1])
            svc.refresh()
        tomb0 = ms.tombstone_update_total
        ev0 = acct.stats("stg4")["staging_events"]
        rD, ms_t, spans_t = _first_answer(
            torch, lambda: gD.search(dict(first_body)))
        rF, ms_tf, spans_tf = _first_answer(
            torch, lambda: gF.search(dict(first_body)))
        ev = new_events("stg4", ev0)
        ex_c = ms._executor
        slot = next(i for i, (sid, seg) in enumerate(ex_c.pairs)
                    if sid == 1 and seg.name.endswith("seg_1"))
        # one slot's row of each live layout (a comprehension: no loop
        # variable keeps a tensor of the generation alive)
        rows = {key: t[slot].numel() * t.element_size()
                for key, t in ex_c._seg_staged.items()
                if key == "live1" or key.startswith("k_live_t")}
        rows["seg_stacked"] = rows.pop("live1")
        rows["knn_mask:emb"] = ex_c._knn["emb"]["mask"][slot].numel() * 4
        check(ms.tombstone_update_total == tomb0 + 1
              and ms.restage_total == 1 and ex_c is ex_b,
              "phase 14c the deletes tombstoned the live generation in "
              "place (tombstone_update_total + 1, no rebuild)")
        check(bool(ev) and all(e["reason"] == "tombstone" for e in ev)
              and all(e["bytes"] == rows.get(e["table"]) for e in ev),
              f"phase 14c only the live rows of slot {slot} restaged "
              f"({[(e['table'], e['bytes']) for e in ev]} vs {rows})")
        check(norm(gD, rD) == norm(gF, rF),
              "phase 14c the tombstoned answer equals the rebuilt one")
        after_c = answers(gD)
        same_answers(after_c, answers(gF), "14c stg4 (tombstoned) vs stg4f")
        out["14c"] = {"deleted": len(dead), "slot": slot,
                      "tombstoned_answer_ms": ms_t,
                      "tombstoned_spans_ms": spans_t,
                      "rebuilt_answer_ms": ms_tf,
                      "rebuilt_spans_ms": spans_tf,
                      "restaged_bytes": sum(e["bytes"] for e in ev),
                      "events": [(e["table"], e["bytes"]) for e in ev]}
        out['14c']["t_s"] = time.perf_counter() - t_phase
        log(f"[phase 14c] {json.dumps(out['14c'])}")

        # ---- 14d-14f at a smaller depth: 10,000 of phase 3's docs ---------
        t_small = time.perf_counter()
        cp = IndexService("stgc", Settings({
            "index.number_of_shards": 4, "index.refresh_interval": -1,
            "index.requests.cache.enable": False,
            "index.search.mesh.max_slots_per_device": STAGING_MAX_SLOTS,
            "index.staging.compact.threshold": 0,
            "index.search.plane_quarantine.cooldown": "200ms"}),
            mapping={"properties": {"title": {"type": "text"},
                                    "venue": {"type": "keyword"},
                                    "year": {"type": "long"}}}, device="cuda")
        for _op, meta, src in ops[:8000]:
            cp.index_doc(meta["_id"], src)
        cp.refresh()
        cbodies = [(label, b) for label, b in bodies
                   if label.startswith("7/") and "aggs" not in b]
        cbodies.append(("agg", {"size": 0, "aggs": {
            "v": {"terms": {"field": "venue", "size": 10}},
            "y": {"stats": {"field": "year"}}}}))
        small_answers = {label: norm(cp, cp.search(dict(b)))
                         for label, b in cbodies}
        cms = cp._mesh_search

        # ---- 14d: the budget --------------------------------------------
        probe = [next(lb for lb in cbodies if lb[0] == "7/match_or"),
                 cbodies[-1]]
        mesh_answers = {label: json.loads(small_answers[label])
                        for label, _b in probe}
        check(all(a["_plane"] in ("mesh", "mesh_pallas")
                  for a in mesh_answers.values()),
              "phase 14d the probes served on the mesh plane")
        ev0, den0 = acct.evictions_total, acct.budget_denials_total
        acct.set_budget(1)
        check(acct.evictions_total > ev0 and cms._executor is None,
              "phase 14d the budget evicted the generation (LRU)")
        for label, b in probe:
            r = cp.search(dict(b))
            check(r["_plane"] == "host",
                  f"phase 14d {label} demoted to the host rung "
                  f"({r['_plane']})")
            same_ranked(r, mesh_answers[label], f"phase 14d {label}")
            check((r.get("aggregations") or {}).get("v")
                  == (mesh_answers[label].get("aggregations") or {}).get("v"),
                  f"phase 14d {label} buckets equal the mesh answer's")
        decisions = cp.search_stats()["planes"]["decisions"]
        check(decisions.get("host.hbm_budget", 0) >= len(probe)
              and acct.budget_denials_total > den0,
              f"phase 14d decisions host.hbm_budget ({decisions})")
        acct.set_budget(0)
        evs0 = acct.stats("stgc")["staging_events"]
        for label, b in probe:
            r = cp.search(dict(b))
            check(r["_plane"] == mesh_answers[label]["_plane"]
                  and norm(cp, r) == small_answers[label],
                  f"phase 14d {label} restaged, byte for byte")
        ev = new_events("stgc", evs0)
        check(any(e["reason"] == "probe" and e["kind"] == "mesh_slot_tables"
                  for e in ev), "phase 14d the restage's reason is probe")
        out["14d"] = {"docs": 8000,
                      "evictions": acct.evictions_total - ev0,
                      "denials": acct.budget_denials_total - den0,
                      "restage_reasons": sorted({e["reason"] for e in ev})}
        out['14d']["t_s"] = time.perf_counter() - t_phase
        log(f"[phase 14d] {json.dumps(out['14d'])}")

        # ---- 14e: staging faults ----------------------------------------
        label, b = probe[0]
        retries = acct.staging_retries_total
        cms._drop_staging()
        scheme = StagingFailScheme(kinds=["mesh_slot_tables"],
                                   transient=True, times=1,
                                   indices=["stgc"]).install()
        r = cp.search(dict(b))
        check(scheme.hits == 1 and r["_plane"] == "mesh_pallas"
              and acct.staging_retries_total == retries + 1
              and norm(cp, r) == small_answers[label],
              "phase 14e a transient staging fault retried, served on "
              "mesh_pallas byte for byte")
        clear_search_disruptions()
        cms._drop_staging()
        # the host rung's own tables staged first (the budget of 14d
        # evicted them): the snapshot then holds all the rung stages
        cp._search_uncached(dict(b), skip_mesh=True)
        snap = acct.staged_bytes_by_kind("stgc")
        faults = acct.staging_faults_deterministic_total
        scheme = StagingFailScheme(kinds=["mesh_slot_tables"],
                                   transient=False, times=1,
                                   indices=["stgc"]).install()
        r = cp.search(dict(b))
        check(scheme.hits == 1 and r["_plane"] == "host"
              and acct.staging_faults_deterministic_total == faults + 1,
              "phase 14e a deterministic staging fault benched the staging")
        same_ranked(r, mesh_answers[label], f"phase 14e host {label}")
        check(acct.staged_bytes_by_kind("stgc") == snap,
              "phase 14e the ledger exact after the fault")
        check(cp.search_stats()["planes"]["plane_failures_by_reason"].get(
            "staging_fault", 0) >= 1, "phase 14e reason staging_fault")
        clear_search_disruptions()
        # past the staging's bench and the plane's quarantine (200 ms, set
        # when the faulted search ran)
        time.sleep(0.3)
        r = cp.search(dict(b))
        check(r["_plane"] == "mesh_pallas"
              and norm(cp, r) == small_answers[label],
              "phase 14e after the cooldown the probe restaged, byte for "
              "byte")
        out["14e"] = {"docs": 8000,
                      "retries": acct.staging_retries_total - retries,
                      "deterministic_faults":
                          acct.staging_faults_deterministic_total - faults}
        out['14e']["t_s"] = time.perf_counter() - t_phase
        log(f"[phase 14e] {json.dumps(out['14e'])}")

        # ---- 14f: compaction --------------------------------------------
        t0 = time.perf_counter()
        for _label, b in cbodies:
            cp.search(dict(b))
        for _op, meta, src in ops[8000:10000]:
            cp.index_doc(meta["_id"], src)
        cp.refresh()
        pre = {label: json.loads(_no_took(cp.search(dict(b))))
               for label, b in cbodies}
        check(cms.delta_restage_total == 1,
              "phase 14f the refresh appended into the generation")
        old_scope, old_slots = cms._executor.scope, cms._executor.n_occupied
        cp._compact_threshold = lambda: 0.25
        check(cp._compaction_due(), "phase 14f the fragmentation crossed 0.25")
        res = cp.compact_now()
        post = {label: json.loads(_no_took(cp.search(dict(b))))
                for label, b in cbodies}
        new = cms._executor
        check(res["ran"] and res["restaged"] and new.scope != old_scope
              and new.n_occupied < old_slots,
              f"phase 14f compaction shrank the generation ({old_slots} -> "
              f"{new.n_occupied} slots, {res})")
        check(not [row for row in acct.table() if row["index"] == "stgc"
                   and row["segment"] == old_scope],
              "phase 14f the old generation's scope released")
        check(all(pre[k]["hits"]["total"] == post[k]["hits"]["total"]
                  and pre[k].get("aggregations") == post[k].get("aggregations")
                  and post[k]["_plane"] == pre[k]["_plane"] for k in pre),
              "phase 14f totals, aggregations and planes unchanged")
        check(any(e["reason"] == "compaction"
                  for e in acct.stats("stgc")["staging_events"]),
              "phase 14f reason compaction")
        out["14f"] = {"docs": 10000, "slots_before": old_slots,
                      "slots_after": new.n_occupied,
                      "merged_shards": res["merged_shards"],
                      "compaction_runs_total": cms.compaction_runs_total,
                      "s": time.perf_counter() - t0,
                      "small_index_s": time.perf_counter() - t_small}
        out['14f']["t_s"] = time.perf_counter() - t_phase
        log(f"[phase 14f] {json.dumps(out['14f'])}")
        del new, cms
        cp.close()
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.LAUNCHES)
    t0 = time.perf_counter()
    held, errs14 = hold_recovered_path(torch, tsc, ssum, knn, kept, launches,
                                       errs, "phase 14")
    del kept
    out["hold_s"] = time.perf_counter() - t0
    # the cpu node: every kind of 14b and 14c, byte for byte (its plain
    # versions against the card's kernels)
    t0 = time.perf_counter()
    serial = {k: v for k, v in after_c.items() if not k.startswith("burst")}
    same_answers(serial, answers(cC, with_bursts=False),
                 "14c stg4 vs the cpu node (serial kinds)")
    out["cpu_node_s"] = time.perf_counter() - t0
    for k in ("tile_scoring", "tile_scoring_batched", "tile_scoring_topk",
              "tile_scoring_topk_sel", "segment_sum", "segment_sum_combine",
              "knn_scoring"):
        check(launches.get(k, 0) > 0,
              f"phase 14 launched {k} ({launches.get(k, 0)})")

    # ---- 14g: close -------------------------------------------------------
    for svc in (gD, gF, cC):
        svc.close()
    del gD, gF, cC, ex, ex_b, ex_c, ms
    torch.cuda.synchronize()
    mem_end = torch.cuda.memory_allocated()
    import gc

    gc.collect()
    torch.cuda.synchronize()
    mem_gc = torch.cuda.memory_allocated()
    left = {name: acct.staged_bytes(name)
            for name in ("stg4", "stg4f", "stg4c", "stgc")}
    if mem_gc != mem0:
        log(f"[phase 14g] left on the card: "
            f"{json.dumps(_leftover_note(torch, blocks0))}")
    check(mem_end == mem0,
          f"phase 14g memory_allocated back to its level before the indices "
          f"({mem0} -> {mem_end}; {mem_gc} after a cycle collection)")
    check(not any(left.values()), f"phase 14g the ledger holds 0 bytes "
                                  f"for them ({left})")
    out["14g"] = {"memory_allocated_before": mem0,
                  "memory_allocated_after_close": mem_end,
                  "memory_allocated_after_gc": mem_gc,
                  "ledger_after_close": left}
    out["launches"] = launches
    out["held"] = held
    out["kernels"] = [{"name": k, "launches": v, "held": held.get(k, 0),
                       "max_abs_err": errs14.get(k, 0.0)}
                      for k, v in sorted(launches.items()) if v]
    out["s"] = time.perf_counter() - t_phase
    log(f"[phase 14] launches {json.dumps(launches)} held {json.dumps(held)}"
        f" in {out['s']:.1f} s")
    return out


# ----------------------------------------------------------------------
# Phase 15: the query DSL beyond match (pmcq)
# ----------------------------------------------------------------------

# pmcq's abstract: the corpus generator with these seeds, empty on 3% of
# docs (the field missing there), under an LM-Dirichlet similarity
QDSL_ABSTRACT_SEEDS = (17, 18, 19, 20)
QDSL_EMPTY_SHARE = 0.03
# samples a kind and twin: the main path's run (one more until phase 18
# joined)
QDSL_REPS = 1


def stream_positions(torch, tokens, doc_len, tid_base):
    """The flat (term id, doc, position) int32 columns of a token stream
    in doc order, sorted by (term, doc, position): a stable sort by term
    on the card keeps each term's tokens in stream order. A token's
    position is its index within its doc."""
    dev = torch.device("cuda", 0)
    lens = torch.from_numpy(np.asarray(doc_len, np.int64)).to(dev)
    starts = torch.cumsum(lens, 0) - lens
    n = int(lens.sum())
    docs = torch.repeat_interleave(
        torch.arange(len(doc_len), device=dev, dtype=torch.int32), lens,
        output_size=n)
    pos = (torch.arange(n, device=dev, dtype=torch.int64)
           - torch.repeat_interleave(starts, lens, output_size=n))
    terms, order = torch.sort(torch.from_numpy(tokens).to(dev), stable=True)
    return ((terms + tid_base).int().cpu().numpy(),
            docs[order].cpu().numpy(), pos[order].int().cpu().numpy())


class _QSources(_Sources):
    """pmcq's stored sources: venue and year as phase 7's, the title and
    abstract text rebuilt from the token streams on demand."""

    def __init__(self, corpus, title, abstract):
        super().__init__(corpus)
        self._words = [term_token(i) for i in range(VOCAB)]
        self._fields = []
        for name, (tokens, lens) in (("title", title), ("abstract", abstract)):
            ends = np.cumsum(lens)
            self._fields.append((name, tokens, ends - lens, ends))

    def __getitem__(self, d):
        src = super().__getitem__(d)
        for name, tokens, lo, hi in self._fields:
            if hi[d] > lo[d]:
                src[name] = " ".join(self._words[t]
                                     for t in tokens[lo[d]: hi[d]].tolist())
        return src


def qdsl_segment_arrays(torch, title_arrays, title_stream, abstract, sh,
                        vecs, exists):
    """pmcq's shard ``sh``: phase 7's title, venue, year and emb beside
    the ``abstract`` corpus, both fields with positions as flat columns
    (the abstract's term ids first: its keys sort first)."""
    from elasticsearch_tpu_torch.index.segment import FIELD_SEP

    n = abstract["n_docs"]
    n_abs_blocks = abstract["block_docs"].shape[0]
    a = dict(title_arrays)
    abs_cols = stream_positions(torch, abstract["tokens"],
                                abstract["doc_len"], 0)
    title_cols = stream_positions(torch, *title_stream, VOCAB)
    a.update(
        term_keys=[f"abstract{FIELD_SEP}{term_token(i)}"
                   for i in range(VOCAB)] + title_arrays["term_keys"],
        term_block_start=np.concatenate([
            abstract["term_block_start"],
            title_arrays["term_block_start"] + n_abs_blocks]),
        term_block_count=np.concatenate([
            abstract["n_blocks_per_term"],
            title_arrays["term_block_count"]]),
        term_doc_freq=np.concatenate([abstract["term_df"],
                                      title_arrays["term_doc_freq"]]),
        block_docs=np.concatenate([abstract["block_docs"],
                                   title_arrays["block_docs"]]),
        block_tfs=np.concatenate([abstract["block_tfs"],
                                  title_arrays["block_tfs"]]),
        norms=np.concatenate([abstract["norms"], title_arrays["norms"]]),
        field_stats={"abstract": {
            "doc_count": int((abstract["doc_len"] > 0).sum()),
            "sum_ttf": abstract["sum_ttf"]},
            **title_arrays["field_stats"]},
        field_norm_idx={"abstract": 0, "title": 1},
        doc_ids=[f"q{sh}p{i}" for i in range(n)],
        sources=_QSources(abstract, title_stream,
                          (abstract["tokens"], abstract["doc_len"])),
        positions=tuple(np.concatenate([x, y])
                        for x, y in zip(abs_cols, title_cols)),
    )
    rows = slice(sh * MESH_SHARD_DOCS, (sh + 1) * MESH_SHARD_DOCS)
    a["vector_columns"] = {"emb": dict(
        vectors=vecs[rows], exists=exists[rows], dims=KNN_DIMS,
        count=int(exists[rows].sum()))}
    return a


def qdsl_requests(queries):
    """Phase 15's (kind, body) requests, phase 7's draws where a term is
    needed."""
    tok = term_token

    def text(q):
        return " ".join(tok(t) for t in q)

    rng = np.random.RandomState(15)
    ids = [f"q{sh}p{int(d)}" for sh in range(4)
           for d in rng.choice(MESH_SHARD_DOCS, 25, replace=False)]
    mm_best = {"multi_match": {"query": text(queries[0]),
                               "fields": ["title^2", "abstract"],
                               "tie_breaker": 0.3}}
    return [
        ("multi_match_best", {"query": mm_best}),
        ("multi_match_most", {"query": {"multi_match": {
            "query": text(queries[1]), "fields": ["title", "abstract"],
            "type": "most_fields"}}}),
        ("dis_max", {"query": {"dis_max": {"queries": [
            {"match": {"title": text(queries[2])}},
            {"match": {"abstract": text(queries[3])}}]}}}),
        ("prefix", {"query": {"prefix": {"title": "t0012"}}}),
        ("wildcard", {"query": {"wildcard": {"title": "t00?7*"}}}),
        ("regexp", {"query": {"regexp": {"title": "t0[0-2]5[0-9]{2}"}}}),
        ("fuzzy", {"query": {"fuzzy": {"title": {"value": "t00123",
                                                 "fuzziness": 1}}}}),
        ("exists", {"query": {"exists": {"field": "abstract"}}}),
        ("ids", {"query": {"ids": {"values": ids}}, "size": 100}),
        ("function_score_fvf", {"query": {"function_score": {
            "query": {"match": {"title": text(queries[4])}},
            "field_value_factor": {"field": "year", "modifier": "log1p"},
            "boost_mode": "sum"}}}),
        ("function_score_random", {"query": {"function_score": {
            "query": {"match": {"title": text(queries[5])}},
            "random_score": {"seed": 15}}}}),
        ("match_phrase_big", {"query": {"match_phrase": {
            "title": "t00000 t00001"}}}),
        ("match_phrase", {"query": {"match_phrase": {
            "title": "t00050 t00051"}}}),
        ("match_phrase_slop2", {"query": {"match_phrase": {"title": {
            "query": "t00050 t00051", "slop": 2}}}}),
        ("match_phrase_prefix", {"query": {"match_phrase_prefix": {
            "title": "t00000 t0001"}}}),
        ("query_string", {"query": {"query_string": {
            "query": "title:(t00050 OR t00051) AND NOT abstract:t00007"}}}),
        ("query_string_not", {"query": {"query_string": {
            "query": "title:(t00050 OR t00051) -abstract:t00007"}}}),
        ("query_string_phrase", {"query": {"query_string": {
            "query": 'title:"t00050 t00051"'}}}),
        ("terms_agg_multi_match", {"size": 0, "query": mm_best, "aggs": {
            "venues": {"terms": {"field": "venue", "size": 10}}}}),
        ("more_like_this", {"query": {"more_like_this": {
            "fields": ["title", "abstract"], "like": [{"_id": "q1p77"}]}}}),
    ]


def bigram_docs(torch, tokens, doc_len, a, b):
    """The reference count of docs holding term ``b`` right after ``a``,
    straight from a token stream (on the card)."""
    dev = torch.device("cuda", 0)
    t = torch.from_numpy(tokens).to(dev)
    lens = torch.from_numpy(np.asarray(doc_len, np.int64)).to(dev)
    doc = torch.repeat_interleave(torch.arange(len(doc_len), device=dev),
                                  lens, output_size=t.numel())
    hit = (t[:-1] == a) & (t[1:] == b) & (doc[:-1] == doc[1:])
    return int(torch.unique(doc[:-1][hit]).numel())


@contextlib.contextmanager
def timing_phrase_intersections(Q):
    """While the block runs, the host seconds of every phrase position
    intersection (``query_dsl.phrase_freqs``) add to ``spent[0]``."""
    orig = Q.phrase_freqs
    spent = [0.0]

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kw)
        finally:
            spent[0] += time.perf_counter() - t0

    Q.phrase_freqs = timed
    try:
        yield spent
    finally:
        Q.phrase_freqs = orig


def query_dsl_phase(torch, Node, Segment, cuda_kernels, tsc, ssum, queries,
                    shard_arrays, title_streams, vecs, exists, ops,
                    ingest_rate, errs):
    """Phase 15: the query DSL beyond ``match`` at full width (pmcq), and
    custom analysis on ingest-20k.

    15a: pmc-4x256k's title (phase 7's corpora) beside an ``abstract``
    (the generator with seeds 17-20, empty on 3% of docs, under an
    LM-Dirichlet similarity), both with positions from their token
    streams, in three twins: ``pmcq`` on the card node (the mesh plane),
    ``pmcqh`` on the card node (``search.mesh: false``, the host rung) and
    ``pmcq`` on a cpu node. Every request kind answers equally on the
    three (ids, totals and buckets exact, scores rtol 1e-5), its plane
    logged; p50 per kind on pmcq and pmcqh; each phrase kind's host
    intersection ms apart from the rest; each multi-term kind's expanded
    lanes per shard; ``?q=`` over HTTP on ``_search`` and ``_count``.
    Every 1a launch held bit for bit against its plain version, every
    kernel-2 call (and its combine) replayed through its plain version.
    15b: phase 3's docs bulked into an index with a custom analyzer
    (html_strip, standard, lowercase, stop, stemmer) on ``title`` and the
    ``english`` analyzer on ``title.en`` (docs/s beside phase 3's), the
    cpu node adopting its segments; match, match_phrase and query_string
    answer equally on both."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.rest.http_server import HttpServer
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t_phase = time.perf_counter()
    report = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        abstracts = list(pool.map(lambda seed: build_synthetic_corpus(
            seed, MESH_SHARD_DOCS, empty_share=QDSL_EMPTY_SHARE,
            keep_stream=True), QDSL_ABSTRACT_SEEDS))
    report["abstract_corpora_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = [qdsl_segment_arrays(torch, shard_arrays[sh], title_streams[sh],
                                  abstracts[sh], sh, vecs, exists)
              for sh in range(4)]
    report["segment_arrays_s"] = time.perf_counter() - t0
    log(f"[phase 15] pmcq arrays: abstract corpora "
        f"{report['abstract_corpora_s']:.1f} s, positions and segment "
        f"arrays {report['segment_arrays_s']:.1f} s; positions per shard "
        f"{[len(a['positions'][0]) for a in arrays]}; abstract docs "
        f"{[a['field_stats']['abstract']['doc_count'] for a in arrays]}")
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"},
        "abstract": {"type": "text", "similarity": "lm"},
        "venue": {"type": "keyword"}, "year": {"type": "long"},
        "emb": {"type": "dense_vector", "dims": KNN_DIMS,
                "similarity": "cosine"}}}}
    sim = {"lm": {"type": "LMDirichlet", "mu": 2000}}
    gnode, cnode = Node(device="cuda"), Node(device="cpu")
    for node in (gnode, cnode):
        node.create_index("pmcq", {"settings": {
            "number_of_shards": 4, "refresh_interval": "-1",
            "requests.cache.enable": False,
            "similarity": sim}, "mappings": mapping})
    gnode.create_index("pmcqh", {"settings": {
        "number_of_shards": 4, "refresh_interval": "-1",
        "requests.cache.enable": False, "similarity": sim,
        "search": {"mesh": False}}, "mappings": mapping})
    for sh, a in enumerate(arrays):
        gs = Segment.from_arrays(f"pmcq_{sh}_seg_1", device="cuda", **a)
        cs = Segment.from_arrays(f"pmcq_{sh}_seg_1", device="cpu", **a)
        for index in ("pmcq", "pmcqh"):
            gnode.indices[index].shards[sh].engine.adopt_segment(gs)
        cnode.indices["pmcq"].shards[sh].engine.adopt_segment(cs)
    segs = [gnode.indices["pmcq"].shards[sh].engine.segments[0]
            for sh in range(4)]
    csegs = [cnode.indices["pmcq"].shards[sh].engine.segments[0]
             for sh in range(4)]
    # each segment's own tables (postings, norms, the kernel's tables over
    # both fields) staged side by side: host numpy, then the copies
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda seg: seg.device_arrays(), segs + csegs))
    torch.cuda.synchronize()
    # the mesh planes stage their generations, and the segments their id
    # maps, before the main path's run: its first sample times the query
    for node in (gnode, cnode):
        node.search("pmcq", {"query": {"match": {"title": "t00001"}},
                             "size": 1})
    for seg in segs + csegs:
        seg.id_to_doc()
    report["stage_s"] = time.perf_counter() - t0
    report["build_s"] = time.perf_counter() - t_phase
    log(f"[phase 15] the 8 segments' own tables and both mesh generations "
        f"staged in {report['stage_s']:.1f} s; pmcq built in "
        f"{report['build_s']:.1f} s")

    reqs = qdsl_requests(queries)
    # expanded lanes per shard of each multi-term kind
    expansions = {}
    for kind, body in reqs:
        qb = Q.parse_query(body["query"])
        if isinstance(qb, Q.MultiTermExpandingBuilder):
            expansions[kind] = [len(qb.expand(seg)[:Q.MAX_EXPANSIONS])
                                for seg in segs]
    log(f"[phase 15] expanded lanes per shard: {json.dumps(expansions)}")
    check(expansions["prefix"] == [10] * 4,
          f"phase 15 prefix t0012 expands to 10 terms a shard "
          f"({expansions['prefix']})")
    report["expansions"] = expansions

    planes, p50, phrase_ms, cpu_ms, first = {}, {}, {}, {}, {}
    cuda_kernels.reset_launch_counts()
    zero_searcher_counters(gnode)
    t0 = time.perf_counter()
    samples = {}  # (kind, index) -> [(ms, host intersection ms)]

    def timed_search(kind, index, body, spent):
        spent[0] = 0.0
        t1 = time.perf_counter()
        r = gnode.search(index, dict(body))
        torch.cuda.synchronize()
        samples.setdefault((kind, index), []).append(
            ((time.perf_counter() - t1) * 1000, spent[0] * 1000))
        return r

    # the main path: each request once on each twin, every launch kept
    with recording_tile_launches(
            tsc, lambda k: launch_name(k) == "tile_scoring") as kept, \
            recording_segsum_calls(ssum) as kept_seg, \
            recording_mask_segsum(ssum) as kept_mask, \
            timing_phrase_intersections(Q) as spent:
        for kind, body in reqs:
            gr = timed_search(kind, "pmcq", body, spent)
            hr = timed_search(kind, "pmcqh", body, spent)
            t1 = time.perf_counter()
            cr = cnode.search("pmcq", dict(body))
            cpu_ms[kind] = (time.perf_counter() - t1) * 1000
            same_response(gr, cr, f"phase 15 {kind} (mesh vs cpu)")
            same_response(hr, cr, f"phase 15 {kind} (host rung vs cpu)")
            check(gr["_plane"] == cr["_plane"],
                  f"phase 15 {kind}: the card and the cpu node serve from "
                  f"one plane ({gr['_plane']}, {cr['_plane']})")
            check(hr["_plane"] == "host",
                  f"phase 15 {kind} on pmcqh: host ({hr['_plane']})")
            planes[kind] = gr["_plane"]
            first[(kind, "resp")] = gr
        # ?q= over HTTP on _search and _count
        srv = HttpServer(gnode, port=0)
        srv.start()
        try:
            client = HttpClient(srv.port)
            st, r = client.call("GET", "/pmcq/_search?q=title:t00050")
            cr = cnode.search("pmcq", {"query": {"query_string": {
                "query": "title:t00050"}}})
            check(st == 200, f"phase 15 GET _search?q=: {st}")
            same_response(r, _as_json(cr), "phase 15 _search?q= over HTTP")
            qs = "title:t00050%20AND%20abstract:t00007"
            st, r = client.call("GET", f"/pmcq/_count?q={qs}")
            cr = cnode.search("pmcq", {"size": 0, "query": {"query_string": {
                "query": "title:t00050 AND abstract:t00007"}}})
            check(st == 200 and r["count"] == cr["hits"]["total"] > 0,
                  f"phase 15 _count?q= over HTTP: {r} == "
                  f"{cr['hits']['total']}")
            client.close()
        finally:
            srv.stop()
    report["serve_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    p15 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 15] kernel launches: {p15}")
    t0 = time.perf_counter()
    held = {}
    held["tile_scoring"] = check_kept_launches(
        torch, tsc, kept, errs, "phase 15").get("tile_scoring", 0)
    check_kept_segsum(torch, ssum, kept_seg, "phase 15", errs, held)
    check_kept_mask_segsum(torch, ssum, kept_mask, "phase 15", errs, held)
    del kept, kept_seg, kept_mask
    report["hold_s"] = time.perf_counter() - t0
    for k in ("tile_scoring", "segment_sum", "segment_sum_combine"):
        check(p15[k] > 0, f"phase 15 launched {k}")
        check(held.get(k, 0) == p15[k],
              f"every {k} launch of phase 15 held against plain "
              f"({held.get(k, 0)} of {p15[k]})")
    # what comes out is right: totals against references of their own
    gx = first[("exists", "resp")]["hits"]["total"]
    want = sum(a["field_stats"]["abstract"]["doc_count"] for a in arrays)
    check(gx == want, f"phase 15 exists total {gx} == docs holding an "
                      f"abstract {want}")
    check(first[("ids", "resp")]["hits"]["total"] == 100,
          "phase 15 ids: 100 docs")
    want = sum(bigram_docs(torch, *title_streams[sh], 50, 51)
               for sh in range(4))
    got = first[("match_phrase", "resp")]["hits"]["total"]
    check(got == want and got > 0,
          f"phase 15 match_phrase total {got} == the bigram count of the "
          f"token streams {want}")
    # the latency of each kind: the main path's run and QDSL_REPS - 1 more
    # on each card twin (after the main path's count), the phrase
    # intersection timed apart
    t0 = time.perf_counter()
    with timing_phrase_intersections(Q) as spent:
        for kind, body in reqs:
            times = {}
            for index in ("pmcq", "pmcqh"):
                for _ in range(QDSL_REPS - 1):
                    timed_search(kind, index, body, spent)
                ms, host_ms = zip(*samples[(kind, index)])
                times[index] = float(np.median(ms))
                if "phrase" in kind:
                    phrase_ms.setdefault(kind, {})[index] = {
                        "intersection_ms": float(np.median(host_ms)),
                        "rest_ms": float(np.median(ms)
                                         - np.median(host_ms))}
            p50[kind] = times
            log(f"[phase 15] {kind}: plane {planes[kind]}, total "
                f"{first[(kind, 'resp')]['hits']['total']}, p50 pmcq "
                f"{times['pmcq']:.3f} ms, pmcqh {times['pmcqh']:.3f} ms "
                f"(first on pmcq {samples[(kind, 'pmcq')][0][0]:.1f} ms, "
                f"cpu node {cpu_ms[kind]:.1f} ms)")
    report["time_s"] = time.perf_counter() - t0
    fails = plane_failures(gnode.indices["pmcq"], gnode.indices["pmcqh"],
                           cnode.indices["pmcq"])
    check(not any(fails), f"phase 15 zero plane faults (got {fails})")
    log(f"[phase 15] planes: {json.dumps(planes)}")
    log(f"[phase 15] ladder: "
        f"{json.dumps(gnode.indices['pmcq'].search_stats()['planes'])}")
    log(f"[phase 15] phrase intersection on the host: "
        f"{json.dumps(phrase_ms)}")
    report.update(planes=planes, p50_ms=p50, phrase_ms=phrase_ms,
                  cpu_ms={k: v for k, v in cpu_ms.items()},
                  launches=dict(p15), held=held)
    # pmcq's nodes stay open for phase 23, which closes them
    del arrays, abstracts

    # 15b: custom analysis on phase 3's docs
    t0 = time.perf_counter()
    analysis = {"filter": {"en_stop": {"type": "stop",
                                       "stopwords": "_english_"}},
                "analyzer": {"prose": {
                    "type": "custom", "char_filter": ["html_strip"],
                    "tokenizer": "standard",
                    "filter": ["lowercase", "en_stop", "stemmer"]}}}
    body = {"settings": {"number_of_shards": 5, "refresh_interval": "-1",
                         "requests.cache.enable": False,
                         "analysis": analysis},
            "mappings": {"_doc": {"properties": {
                "title": {"type": "text", "analyzer": "prose", "fields": {
                    "en": {"type": "text", "analyzer": "english"}}},
                "venue": {"type": "keyword"}, "year": {"type": "long"}}}}}
    gA, cA = Node(device="cuda"), Node(device="cpu")
    for node in (gA, cA):
        node.create_index("docs_an", body)
    an_ops = [(a, {**m, "_index": "docs_an"}, src)
              for a, m, src in ops[:ANALYZED_DOCS]]
    cuda_kernels.reset_launch_counts()
    t1 = time.perf_counter()
    r = gA.bulk(an_ops)
    gA.refresh("docs_an")
    torch.cuda.synchronize()
    rate = len(an_ops) / (time.perf_counter() - t1)
    check(not r["errors"], "phase 15b bulk without errors")
    _adopt_copies(gA, cA, "docs_an", Segment)
    log(f"[phase 15b] bulk {len(an_ops)} docs into two analyzed fields "
        f"(custom prose, english) + refresh: {rate:.0f} docs/s; phase 3's "
        f"standard analyzer in this call: {ingest_rate:.0f} docs/s")
    q = " ".join(term_token(t) for t in queries[6])
    with recording_tile_launches(
            tsc, lambda k: launch_name(k) == "tile_scoring") as kept, \
            recording_segsum_calls(ssum) as kept_seg:
        answers = [(kind, {"query": qbody, "size": 20}) for kind, qbody in (
            ("match", {"match": {"title": q}}),
            ("match_en", {"match": {"title.en": q}}),
            ("match_phrase", {"match_phrase": {"title": "t00000 t00001"}}),
            ("match_phrase_en", {"match_phrase": {
                "title.en": {"query": "t00002 t00000", "slop": 1}}}),
            ("query_string", {"query_string": {
                "query": "title:t00003 AND title.en:\"t00000 t00001\""}}))]
        for kind, b in answers:
            gr, cr = gA.search("docs_an", b), cA.search("docs_an", b)
            same_response(gr, cr, f"phase 15b {kind}")
            check(gr["hits"]["total"] > 0, f"phase 15b {kind} matches")
    torch.cuda.synchronize()
    pa = dict(cuda_kernels.LAUNCHES)
    n_held = check_kept_launches(torch, tsc, kept, errs,
                                 "phase 15b").get("tile_scoring", 0)
    check_kept_segsum(torch, ssum, kept_seg, "phase 15b", errs, held)
    check(pa["tile_scoring"] > 0 and n_held == pa["tile_scoring"],
          f"every 1a launch of phase 15b held against plain ({n_held} of "
          f"{pa['tile_scoring']})")
    held["tile_scoring"] += n_held
    for k, v in pa.items():
        report["launches"][k] = report["launches"].get(k, 0) + v
    gA.close()
    cA.close()
    report["analysis"] = {"docs_per_s": rate, "phase3_docs_per_s": ingest_rate,
                          "seconds": time.perf_counter() - t0}
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 15] {report['seconds']:.1f} s (build "
        f"{report['build_s']:.1f}, serve {report['serve_s']:.1f}, hold "
        f"{report['hold_s']:.1f}, timing {report['time_s']:.1f}, 15b "
        f"{report['analysis']['seconds']:.1f})")
    return report, (gnode, cnode)


# ----------------------------------------------------------------------
# Phase 16: sort and paging
# ----------------------------------------------------------------------

SRT_PAGE = 100  # 16b's page
SRT_PAGES = 20
SRT_REPS = 2  # samples a 16a kind and index (the main path's run and one)
SCROLL_PAGE = 100  # 16e's page
SCROLL_HITS = 1000
SCROLL_APPEND = 4096  # docs indexed while 16e's scroll is open
RARE_RANK = 1000  # a term of about 7,000 docs in pmc-4x256k
RESCORE_RANK = 60


class _TitledSources:
    """pmc-4x256k's stored sources with the title text rebuilt from its
    token stream on demand (phase 16 highlights it)."""

    def __init__(self, base, title_stream):
        tokens, lens = title_stream
        ends = np.cumsum(lens)
        self._base, self._tokens = base, tokens
        self._lo, self._hi = ends - lens, ends
        self._words = [term_token(i) for i in range(VOCAB)]

    def __len__(self):
        return len(self._base)

    def __getitem__(self, d):
        src = self._base[d]
        src["title"] = " ".join(self._words[t] for t in
                                self._tokens[self._lo[d]: self._hi[d]].tolist())
        return src


def same_sorted(gr, cr, what):
    """A field-sorted response: totals, ids, sort arrays and planes
    exact."""
    check(gr["hits"]["total"] == cr["hits"]["total"]
          and gr["_plane"] == cr["_plane"]
          and gr.get("terminated_early") == cr.get("terminated_early")
          and [(h["_id"], h["sort"]) for h in gr["hits"]["hits"]]
          == [(h["_id"], h["sort"]) for h in cr["hits"]["hits"]],
          f"cuda response equals cpu response: {what}")


def strict_after_walk(hits, page, pages):
    """The pages a one-field search_after walk returns over ``hits`` (one
    request's hits in sort order): each page starts at the first hit whose
    key is strictly after the previous page's last key, so the hits tied
    with that key are skipped (the cut's contract)."""
    out, pos = [], 0
    for _ in range(pages):
        cur = hits[pos: pos + page]
        if not cur:
            break
        out.append(cur)
        last = cur[-1]["sort"]
        pos += len(cur)
        while pos < len(hits) and hits[pos]["sort"] == last:
            pos += 1
    return out


def sort_paging_phase(torch, Node, Segment, cuda_kernels, tsc, ssum, queries,
                      shard_arrays, title_streams, ingest_node, errs,
                      device="cuda"):
    """Phase 16: sort and paging at full width, on pmc-4x256k's doc-values
    form (phase 12's ``ts`` over one year and ``citations`` missing on 3%,
    with ``venue`` and the ``title`` text rebuilt for highlighting) in
    ``srt4`` (the mesh plane) and ``srt4h`` (``search.mesh: false``, the
    host rung) on the card node, each held against a cpu node's twin:

    16a. Sorts: ``citations`` desc and asc with missing ``_first``,
         ``_last`` and a number, ``venue`` asc by global ordinals, ``_doc``
         on the mesh; ``ts`` desc (not f32-exact: ``sort_ineligible``) and
         ``[venue, citations]`` on the host rung; each kind's p50 and
         plane; the tie case (``citations`` asc over every doc, k 10): the
         top-k candidates a slot keeps and the top-k's device ms.
    16b. search_after: 20 pages of 100 under a match, on the mesh by
         ``citations`` desc (equal to the strict-after walk over one
         request: a one-field cursor skips the ties of a page's last key)
         and on the host rung by ``[citations desc, ts asc]`` (equal to
         one size-2000 request hit for hit and sort value for sort value).
    16c. Slices of a match (``max`` 2, 4, 8): disjoint, their union every
         hit.
    16d. Rescore (window 50, each score mode), ``terminate_after: 1000``,
         ``collapse`` on ``venue`` with ``inner_hits``, ``highlight`` on
         ``title`` (plain and unified) over HTTP.
    16e. On ``scr`` (ingest-20k's segments: the port's force merge
         re-parses every stored source, which at 262,144 docs a shard
         would take minutes), a 1,000-hit scroll over a match whose first
         page carries a terms aggregation; between its pages 1% of a shard
         is deleted, 4,096 matching docs indexed, refreshed and that shard
         force-merged: the pages equal the snapshot taken at open, no
         duplicates and no gaps, and the cpu node's pages; pages/s and the
         first page's ms against the deeper pages'; a sliced scroll over
         HTTP. Then, apart from the main path: ``clear_scroll`` and a
         reaped keep-alive expiry return ``memory_allocated`` to its level
         before each scroll opened.
    Every 1a launch of the main path (mesh, host rung, pinned views,
    rescore) is held bit for bit against its plain version and every
    kernel-2 call replayed through its plain version. Returns the
    report."""
    from elasticsearch_tpu_torch.ops.scoring import top_k
    from elasticsearch_tpu_torch.rest.http_server import HttpServer

    t_phase = time.perf_counter()
    report = {}
    tok = term_token
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}, "ts": {"type": "date"},
        "citations": {"type": "long"}}}}
    gnode, cnode = Node(device=device), Node(device="cpu")
    for node in (gnode, cnode):
        for name, extra in (("srt4", {}),
                            ("srt4h", {"search": {"mesh": False}})):
            node.create_index(name, {"settings": {
                "number_of_shards": 4, "refresh_interval": "-1",
                "requests.cache.enable": False, **extra},
                "mappings": mapping})
        node.create_index("scr", {"settings": {"number_of_shards": 5,
                                               "refresh_interval": "-1",
                                               "requests.cache.enable": False},
                                  "mappings": {"_doc": {"properties": {
                                      "title": {"type": "text"},
                                      "venue": {"type": "keyword"},
                                      "year": {"type": "long"}}}}})
    segs = []
    for sh, arrays in enumerate(shard_arrays):
        arrays = dict(arrays)
        nd_pad = arrays["numeric_columns"]["year"]["exists"].shape[0]
        n = len(arrays["doc_ids"])
        arrays["numeric_columns"] = {**arrays["numeric_columns"],
                                     **agg_columns(sh, nd_pad, n)}
        arrays["sources"] = _TitledSources(arrays["sources"],
                                           title_streams[sh])
        for node, dev in ((gnode, device), (cnode, "cpu")):
            seg = Segment.from_arrays(f"srt4_{sh}_seg_1", device=dev,
                                      **arrays)
            for name in ("srt4", "srt4h"):
                node.indices[name].shards[sh].engine.adopt_segment(seg)
            segs.append(seg)
    _adopt_copies(ingest_node, gnode, "docs", Segment, device=device,
                  index_to="scr")
    _adopt_copies(ingest_node, cnode, "docs", Segment, index_to="scr")
    t0 = time.perf_counter()
    for seg in segs:
        seg.device_arrays()
    # the mesh generations stage before the main path's run
    for node in (gnode, cnode):
        node.search("srt4", {"query": {"match": {"title": tok(1)}},
                             "size": 1})
    if device == "cuda":
        torch.cuda.synchronize()
    report["stage_s"] = time.perf_counter() - t0
    log(f"[phase 16] srt4 and scr built, staged in {report['stage_s']:.1f} "
        f"s ({time.perf_counter() - t_phase:.1f} s in all)")

    def match(q):
        return {"match": {"title": " ".join(tok(t) for t in q)}}

    q_rare = {"match": {"title": tok(RARE_RANK)}}
    sorts = [  # (kind, query, sort, plane)
        ("citations_desc", match(queries[0]), [{"citations": "desc"}],
         "mesh_pallas"),
        ("citations_asc_first", match(queries[0]),
         [{"citations": {"order": "asc", "missing": "_first"}}],
         "mesh_pallas"),
        ("citations_asc_last", match(queries[0]),
         [{"citations": {"order": "asc", "missing": "_last"}}],
         "mesh_pallas"),
        ("citations_desc_missing_5", match(queries[0]),
         [{"citations": {"order": "desc", "missing": 5}}], "mesh_pallas"),
        ("venue_asc", match(queries[0]), [{"venue": "asc"}], "mesh_pallas"),
        ("doc", match(queries[0]), ["_doc"], "mesh_pallas"),
        ("ties_citations_asc_all", {"match_all": {}},
         [{"citations": "asc"}], "mesh"),
        ("ts_desc", match(queries[0]), [{"ts": "desc"}], "host"),
        ("venue_citations", match(queries[0]),
         [{"venue": "asc"}, {"citations": "desc"}], "host"),
    ]
    samples = {}

    def timed(index, body, kind):
        t1 = time.perf_counter()
        r = gnode.search(index, dict(body))
        if device == "cuda":
            torch.cuda.synchronize()
        samples.setdefault((kind, index), []).append(
            (time.perf_counter() - t1) * 1000)
        return r

    ms0 = gnode.indices["srt4"]._mesh_plane()
    dec0 = dict(ms0.decisions)
    cuda_kernels.reset_launch_counts()
    t_main = time.perf_counter()
    with recording_tile_launches(
            tsc, lambda k: launch_name(k) == "tile_scoring") as kept, \
            recording_segsum_calls(ssum) as kept_seg, \
            recording_mask_segsum(ssum) as kept_mask:
        # ---- 16a ----
        planes = {}
        for kind, query, sort, plane in sorts:
            body = {"query": query, "sort": sort, "size": 10}
            for index in ("srt4", "srt4h"):
                gr = timed(index, body, kind)
                cr = cnode.search(index, dict(body))
                same_sorted(gr, cr, f"phase 16a {kind} on {index}")
                want = plane if index == "srt4" else "host"
                check(gr["_plane"] == want,
                      f"phase 16a {kind} on {index}: plane {gr['_plane']}, "
                      f"want {want}")
                if index == "srt4":
                    planes[kind] = gr["_plane"]
                    check(gr["hits"]["max_score"] is None and all(
                        h["_score"] is None for h in gr["hits"]["hits"]),
                          f"phase 16a {kind}: no scores under a field sort")
        dec = {k: v - dec0.get(k, 0) for k, v in ms0.decisions.items()
               if v != dec0.get(k, 0)}
        check(dec.get("host.sort_ineligible") == 2,
              f"phase 16a: ts and the two-field sort decline the mesh as "
              f"sort_ineligible ({dec})")
        report["planes"] = planes
        # ---- 16b ----
        walks = {}
        for plane, index, sort in (
                ("mesh", "srt4", [{"citations": "desc"}]),
                ("host", "srt4", [{"citations": "desc"}, {"ts": "asc"}])):
            base = {"query": match(queries[1]), "sort": sort,
                    "_source": False}
            pages, cpages, after = [], [], None
            for _ in range(SRT_PAGES):
                body = dict(base, size=SRT_PAGE)
                if after is not None:
                    body["search_after"] = after
                gr = gnode.search(index, dict(body))
                cr = cnode.search(index, dict(body))
                same_sorted(gr, cr, f"phase 16b {plane} page {len(pages)}")
                check(gr["_plane"] == ("host" if plane == "host"
                                       else "mesh_pallas"),
                      f"phase 16b {plane} page plane {gr['_plane']}")
                if not gr["hits"]["hits"]:
                    break
                pages.append(gr["hits"]["hits"])
                after = gr["hits"]["hits"][-1]["sort"]
            joined = [(h["_id"], h["sort"]) for p in pages for h in p]
            if plane == "host":
                one = gnode.search(index, dict(base, size=SRT_PAGE
                                               * SRT_PAGES))
                want = [(h["_id"], h["sort"]) for h in one["hits"]["hits"]]
            else:
                one = gnode.search(index, dict(base, size=2 * SRT_PAGE
                                               * SRT_PAGES))
                want = [(h["_id"], h["sort"]) for p in strict_after_walk(
                    one["hits"]["hits"], SRT_PAGE, SRT_PAGES) for h in p]
            check(len(pages) == SRT_PAGES and joined == want,
                  f"phase 16b {plane}: {len(pages)} pages joined equal the "
                  f"one-request reference ({len(joined)} / {len(want)} "
                  f"hits)")
            check(len({i for i, _ in joined}) == len(joined),
                  f"phase 16b {plane}: no hit twice")
            walks[plane] = {"pages": len(pages), "hits": len(joined),
                            "plane": one["_plane"]}
        report["search_after"] = walks
        # ---- 16c ----
        whole = gnode.search("srt4", {"query": q_rare, "size": 0})
        total = whole["hits"]["total"]
        every = gnode.search("srt4", {"query": q_rare, "size": total,
                                      "_source": False})
        every_ids = {h["_id"] for h in every["hits"]["hits"]}
        slices = {}
        for smax in (2, 4, 8):
            union, n_hits = set(), 0
            for sid in range(smax):
                body = {"query": q_rare, "slice": {"id": sid, "max": smax},
                        "size": total, "_source": False}
                gr = gnode.search("srt4", dict(body))
                cr = cnode.search("srt4", dict(body))
                same_response(gr, cr, f"phase 16c slice {sid}/{smax}")
                check(gr["_plane"] == "mesh_pallas",
                      f"phase 16c slice {sid}/{smax} plane {gr['_plane']}")
                ids = {h["_id"] for h in gr["hits"]["hits"]}
                check(not ids & union, f"phase 16c slices of {smax} "
                                       f"disjoint")
                union |= ids
                n_hits += gr["hits"]["total"]
            check(union == every_ids and n_hits == total,
                  f"phase 16c slices of {smax}: union is every hit "
                  f"({len(union)} of {total})")
            slices[smax] = len(union)
        report["slices"] = {"total": total, **slices}
        # ---- 16d ----
        for mode in ("total", "multiply", "avg", "max", "min"):
            body = {"query": match(queries[2]), "size": 10, "rescore": {
                "window_size": 50, "query": {
                    "rescore_query": {"match": {"title": tok(RESCORE_RANK)}},
                    "query_weight": 0.7, "rescore_query_weight": 1.3,
                    "score_mode": mode}}}
            gr = timed("srt4", body, f"rescore_{mode}")
            same_response(gr, cnode.search("srt4", dict(body)),
                          f"phase 16d rescore {mode}")
            check(gr["_plane"] == "mesh_pallas",
                  f"phase 16d rescore {mode} plane {gr['_plane']}")
            hr = gnode.search("srt4h", dict(body))
            same_response(hr, cnode.search("srt4h", dict(body)),
                          f"phase 16d rescore {mode} (host rung)")
        body = {"query": match(queries[3]), "size": 10,
                "terminate_after": 1000}
        gr = timed("srt4", body, "terminate_after")
        cr = cnode.search("srt4", dict(body))
        same_response(gr, cr, "phase 16d terminate_after")
        check(gr["terminated_early"] is True and gr["hits"]["total"]
              == cr["hits"]["total"] == 4000,
              f"phase 16d terminate_after: terminated_early "
              f"{gr.get('terminated_early')}, total {gr['hits']['total']}")
        body = {"query": q_rare, "size": 10, "collapse": {
            "field": "venue", "inner_hits": {
                "name": "top", "size": 2, "sort": [{"citations": "desc"}]}}}
        gr = timed("srt4", body, "collapse")
        cr = cnode.search("srt4", dict(body))
        same_response(gr, cr, "phase 16d collapse")
        check(gr["_plane"] == "host"
              and [(h["fields"], [x["_id"] for x in
                                  h["inner_hits"]["top"]["hits"]["hits"]])
                   for h in gr["hits"]["hits"]]
              == [(h["fields"], [x["_id"] for x in
                                 h["inner_hits"]["top"]["hits"]["hits"]])
                  for h in cr["hits"]["hits"]]
              and len({h["fields"]["venue"][0]
                       for h in gr["hits"]["hits"]}) == 10,
              "phase 16d collapse: ten distinct venues, inner hits equal")
        srv = HttpServer(gnode, port=0)
        srv.start()
        try:
            client = HttpClient(srv.port)
            for hl_type in ("plain", "unified"):
                body = {"query": match(queries[4]), "size": 5, "highlight": {
                    "type": hl_type, "fields": {"title": {}}}}
                st, r = client.call("POST", "/srt4/_search", body)
                cr = cnode.search("srt4", dict(body))
                same_response(r, cr, f"phase 16d {hl_type} highlight")
                check(st == 200 and r["hits"]["hits"]
                      and {h["_id"]: h.get("highlight")
                           for h in r["hits"]["hits"]}
                      == {h["_id"]: h.get("highlight")
                          for h in cr["hits"]["hits"]}
                      and all("<em>" in h["highlight"]["title"][0]
                              for h in r["hits"]["hits"]),
                      f"phase 16d {hl_type} highlight over HTTP equals the "
                      f"cpu node's")
            # ---- 16e ----
            scroll = scroll_phase(torch, gnode, cnode, client, match(
                queries[5]), device)
            report["scroll"] = scroll
            client.close()
        finally:
            srv.stop()
    if device == "cuda":
        torch.cuda.synchronize()
    report["main_s"] = time.perf_counter() - t_main
    p16 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 16] kernel launches: {p16}")
    t0 = time.perf_counter()
    held = {}
    held["tile_scoring"] = check_kept_launches(
        torch, tsc, kept, errs, "phase 16").get("tile_scoring", 0)
    check_kept_segsum(torch, ssum, kept_seg, "phase 16", errs, held)
    check_kept_mask_segsum(torch, ssum, kept_mask, "phase 16", errs, held)
    del kept, kept_seg, kept_mask
    report["hold_s"] = time.perf_counter() - t0
    for k in ("tile_scoring", "segment_sum"):
        check(p16[k] > 0, f"phase 16 launched {k}")
    for k, v in p16.items():
        check(held.get(k, 0) == v, f"every {k} launch of phase 16 held "
                                   f"against plain ({held.get(k, 0)} of {v})")
    # the tie case: candidates a slot's top-k keeps, and its device time
    ex = gnode.indices["srt4"]._mesh_search._executor
    name = "msort.citations.asc._last"
    keys = ex._seg_staged[name][: ex.n_occupied]
    masked = torch.where(ex._seg_staged["live1"][: ex.n_occupied], keys,
                         torch.full_like(keys, float("-inf")))
    kth = torch.topk(masked, 10, dim=1).values[:, -1:]
    cands = (masked >= kth).sum(dim=1).tolist()
    timer = Timer(torch, torch.device(device)) if device == "cuda" else None
    ties = {"k": 10, "candidates_per_slot": cands,
            "slot_docs": int(masked.shape[1])}
    if timer is not None:
        ties["top_k_ms"] = timer.ms(lambda: top_k(masked[0], 10), reps=10)
        ties["torch_topk_ms"] = timer.ms(
            lambda: torch.topk(masked[0], 10), reps=10)
    report["ties"] = ties
    log(f"[phase 16a] tie case (citations asc, k 10): {json.dumps(ties)}")
    # each kind's p50: the main path's run and SRT_REPS - 1 more
    t0 = time.perf_counter()
    p50 = {}
    for kind, query, sort, _plane in sorts:
        body = {"query": query, "sort": sort, "size": 10}
        row = {}
        for index in ("srt4", "srt4h"):
            for _ in range(SRT_REPS - 1):
                timed(index, body, kind)
            row[index] = float(np.median(samples[(kind, index)]))
        p50[kind] = row
        log(f"[phase 16a] {kind}: plane {planes[kind]}, p50 srt4 "
            f"{row['srt4']:.3f} ms, srt4h {row['srt4h']:.3f} ms")
    for kind in ("rescore_total", "rescore_max", "terminate_after",
                 "collapse"):
        p50[kind] = {"srt4": float(np.median(samples[(kind, "srt4")]))}
    report["time_s"] = time.perf_counter() - t0
    # apart from the main path: the pinned tensors return their memory
    report["memory"] = scroll_memory_phase(torch, gnode, match(queries[5]),
                                           device)
    fails = plane_failures(gnode.indices["srt4"], gnode.indices["srt4h"],
                           cnode.indices["srt4"])
    check(not any(fails), f"phase 16 zero plane faults (got {fails})")
    log(f"[phase 16] ladder: "
        f"{json.dumps(gnode.indices['srt4'].search_stats()['planes']['decisions'])}")
    report.update(p50_ms=p50, launches=p16, held=held)
    gnode.close()
    cnode.close()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 16] {report['seconds']:.1f} s (main path "
        f"{report['main_s']:.1f}, hold {report['hold_s']:.1f}, timing "
        f"{report['time_s']:.1f})")
    return report


def scroll_phase(torch, gnode, cnode, client, query, device):
    """16e's main path on ``scr``: the mutated 1,000-hit scroll and a
    sliced scroll over HTTP. Returns its report."""
    body = {"query": query, "size": SCROLL_PAGE,
            "aggs": {"v": {"terms": {"field": "venue", "size": 5}}}}
    snap = gnode.search("scr", {"query": query, "size": SCROLL_HITS,
                                "_source": False})
    check(snap["hits"]["total"] > SCROLL_HITS + SCROLL_PAGE,
          f"phase 16e scroll query matches over {SCROLL_HITS} docs "
          f"({snap['hits']['total']})")
    pages, ms = {}, []
    firsts = {}
    for name, node in (("cuda", gnode), ("cpu", cnode)):
        t1 = time.perf_counter()
        first = node.search("scr", dict(body), scroll="1m")
        if name == "cuda" and device == "cuda":
            torch.cuda.synchronize()
        if name == "cuda":
            ms.append((time.perf_counter() - t1) * 1000)
        firsts[name] = first
        pages[name] = [first]
    same_response(firsts["cuda"], firsts["cpu"], "phase 16e first page")
    check(firsts["cuda"]["_plane"] == "host"
          and firsts["cuda"]["aggregations"]["v"]["buckets"],
          "phase 16e the first page: host rung, with its aggregation")
    shard0 = gnode.indices["scr"].shards[0].engine.segments[0]
    live = np.flatnonzero(shard0.live[: shard0.num_docs])
    doomed = [shard0.doc_ids[d] for d in live[:: 100]]
    title = query["match"]["title"]
    t_all = time.perf_counter()
    while sum(len(p["hits"]["hits"]) for p in pages["cuda"]) < SCROLL_HITS:
        if len(pages["cuda"]) == 3:
            for node in (gnode, cnode):
                for d in doomed:
                    node.delete_doc("scr", d)
                for i in range(SCROLL_APPEND):
                    node.index_doc("scr", f"late{i}", {
                        "title": f"{title} t00001", "venue": "v0001",
                        "year": 2024})
                node.refresh("scr")
                node.indices["scr"].shards[0].force_merge()
        for name, node in (("cuda", gnode), ("cpu", cnode)):
            t1 = time.perf_counter()
            page = node.scroll(firsts[name]["_scroll_id"])
            if name == "cuda":
                if device == "cuda":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1000)
            pages[name].append(page)
    seconds = time.perf_counter() - t_all
    for i, (gp, cp) in enumerate(zip(pages["cuda"], pages["cpu"])):
        same_response(gp, cp, f"phase 16e scroll page {i}")
    got = [(h["_id"], h["_score"]) for p in pages["cuda"]
           for h in p["hits"]["hits"]]
    want = [(h["_id"], h["_score"]) for h in snap["hits"]["hits"]]
    check(got == want and len({i for i, _ in got}) == len(got),
          f"phase 16e {len(pages['cuda'])} pages equal the snapshot at open "
          f"({len(got)} hits), no duplicate, no gap")
    check(not any(i.startswith("late") for i, _ in got),
          "phase 16e docs indexed after open stay invisible")
    for name, node in (("cuda", gnode), ("cpu", cnode)):
        check(node.clear_scroll([firsts[name]["_scroll_id"]])["num_freed"]
              == 1, f"phase 16e clear_scroll ({name})")
    # a sliced scroll over HTTP, after the writes: the slices' union is
    # every hit of the same query now
    now = gnode.search("scr", {"query": query, "size": 0})["hits"]["total"]
    union, n_pages = set(), 0
    for sid in range(2):
        st, r = client.call("POST", "/scr/_search?scroll=1m", {
            "query": query, "size": 500, "_source": False,
            "slice": {"id": sid, "max": 2}})
        check(st == 200, f"phase 16e sliced scroll over HTTP: {st}")
        while r["hits"]["hits"]:
            ids = {h["_id"] for h in r["hits"]["hits"]}
            check(not ids & union, "phase 16e slices disjoint")
            union |= ids
            n_pages += 1
            st, r = client.call("POST", "/_search/scroll", {
                "scroll": "1m", "scroll_id": r["_scroll_id"]})
    st, r = client.call("DELETE", "/_search/scroll")
    check(st == 200 and r["num_freed"] == 2 and len(union) == now,
          f"phase 16e sliced scroll over HTTP: {len(union)} of {now} hits "
          f"in {n_pages} pages, both contexts cleared")
    # pages/s over the card node's own page times (the writes between the
    # pages and the cpu twin's pages are not the scroll's)
    out = {"pages": len(pages["cuda"]), "hits": len(got),
           "pages_per_s": len(ms) / (sum(ms) / 1000.0),
           "seconds_with_writes": seconds,
           "first_page_ms": ms[0], "deeper_page_ms": float(np.median(ms[1:])),
           "page_ms": ms, "deleted": len(doomed),
           "deleted_in_snapshot": len(set(doomed) & {i for i, _ in want}),
           "appended": SCROLL_APPEND,
           "sliced_hits": len(union)}
    log(f"[phase 16e] {json.dumps(out)}")
    return out


def scroll_memory_phase(torch, gnode, query, device):
    """16e apart from the main path: ``memory_allocated`` before a scroll
    opens, while it is open, after ``clear_scroll``; and again for a
    keep-alive expiry the reaper's sweep drops."""
    import gc

    if device != "cuda":
        return {}

    def level():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    body = {"query": query, "size": SCROLL_PAGE,
            "aggs": {"v": {"terms": {"field": "venue", "size": 5}}}}
    gnode.search("scr", dict(body))  # its columns stage before the levels
    out = {}
    m0 = level()
    first = gnode.search("scr", dict(body), scroll="1m")
    for _ in range(3):
        gnode.scroll(first["_scroll_id"])
    m_open = level()
    gnode.clear_scroll([first["_scroll_id"]])
    del first
    m1 = level()
    check(m_open > m0 and m1 == m0,
          f"phase 16e clear_scroll returns memory_allocated to its level "
          f"(before {m0}, open {m_open}, after {m1})")
    first = gnode.search("scr", dict(body), scroll="100ms")
    sid = first["_scroll_id"]
    del first
    time.sleep(0.2)
    reaped = gnode._reap_expired_scrolls()
    m2 = level()
    check(reaped == 1 and sid not in gnode.scrolls and m2 == m0,
          f"phase 16e keep-alive expiry reaped ({reaped}), memory_allocated "
          f"back to its level ({m2} against {m0})")
    out.update(before=m0, open=m_open, after_clear=m1, after_expiry=m2,
               pinned_bytes=m_open - m0)
    log(f"[phase 16e] memory: {json.dumps(out)}")
    return out


GEO_SEED_OFFSET = 400  # loc: RandomState(MESH_SEEDS[sh] + 400)
IP_SEED_OFFSET = 500  # clientip draws
ACTIVE_SEED_OFFSET = 600  # active's date ranges
GEO_CENTRES = 500
GEO_SIGMA_DEG = 12.5 / 111.2  # about 50 km across (two sigma each way)
IP_POOL = 50_000
IP_V6_SHARE = 0.10
# samples a 17a-17e kind and index: the main path's (one more until phase
# 18 joined)
GEO_REPS = 1
GEO_PAGE = 100  # 17b's page
GEO_PAGES = 10
GEO_BREAKER = {"indices.breaker.total.limit": "16gb",
               "indices.breaker.fielddata.limit": "8gb"}
# land masses' bounding boxes (lat lo, lat hi, lon lo, lon hi) and their
# share of the centres
LAND_BOXES = ((25.0, 70.0, -168.0, -55.0, 0.22),  # North America
              (-55.0, 12.0, -81.0, -35.0, 0.12),  # South America
              (36.0, 70.0, -10.0, 40.0, 0.15),  # Europe
              (-34.0, 36.0, -17.0, 51.0, 0.17),  # Africa
              (5.0, 72.0, 40.0, 179.5, 0.28),  # Asia, to the antimeridian
              (-44.0, -11.0, 113.0, 154.0, 0.06))  # Australia


def geo_centres():
    """The 500 centres (lat, lon) and their zipf weights, one world for
    every shard (``RandomState(MESH_SEEDS[0] + 400)``): the shapes of
    Rally's geonames ``location`` field."""
    rng = np.random.RandomState(MESH_SEEDS[0] + GEO_SEED_OFFSET)
    boxes = np.asarray(LAND_BOXES)
    pick = rng.choice(len(boxes), GEO_CENTRES, p=boxes[:, 4] / boxes[:, 4].sum())
    lat = rng.uniform(boxes[pick, 0], boxes[pick, 1])
    lon = rng.uniform(boxes[pick, 2], boxes[pick, 3])
    w = 1.0 / np.arange(1, GEO_CENTRES + 1)
    return lat, lon, rng.permutation(w / w.sum())


def ip_pool():
    """50,000 addresses (90% IPv4, 10% IPv6 in 2001:db8::/32), in their
    ``format_ip`` form, with exact ints and zipf weights: the shape of
    Rally's http_logs ``clientip``."""
    import ipaddress

    rng = np.random.RandomState(MESH_SEEDS[0] + IP_SEED_OFFSET)
    n6 = int(IP_POOL * IP_V6_SHARE)
    v4 = np.unique(rng.randint(0, 1 << 32, 2 * IP_POOL, dtype=np.int64))
    v4 = rng.permutation(v4)[: IP_POOL - n6]
    addrs = [str(ipaddress.IPv4Address(int(a))) for a in v4]
    hi = rng.randint(0, 1 << 31, n6, dtype=np.int64)
    lo = rng.randint(0, 1 << 62, n6, dtype=np.int64)
    addrs += [str(ipaddress.IPv6Address((0x20010db8 << 96) | (int(h) << 64)
                                        | int(l))) for h, l in zip(hi, lo)]
    ints = [int(ipaddress.IPv6Address(f"::ffff:{a}")) if ":" not in a
            else int(ipaddress.IPv6Address(a)) for a in addrs]
    order = rng.permutation(IP_POOL)
    w = 1.0 / np.arange(1, IP_POOL + 1) ** 0.9
    return ([addrs[i] for i in order], [ints[i] for i in order],
            w / w.sum())


def geo_shard_columns(sh, nd_pad, n, doc_len, centres, pool):
    """Phase 17's columns of shard ``sh``: ``loc`` (one point for 93% of
    docs, two for 5%, none for 2%, around zipf-weighted centres),
    ``clientip`` (zipf over the pool), ``active`` (a date range of 1-90
    days inside ``ts``'s year) and ``title.length`` (the doc's token
    count). Returns (geo_columns, numeric_columns, ordinal_columns, the
    doc -> pool index array)."""
    from elasticsearch_tpu_torch.index.segment import build_geo_column

    rng = np.random.RandomState(MESH_SEEDS[sh] + GEO_SEED_OFFSET)
    k = rng.choice(3, n, p=[0.02, 0.93, 0.05])
    m = int(k.sum())
    docs = np.repeat(np.arange(n, dtype=np.int32), k)
    c = rng.choice(GEO_CENTRES, m, p=centres[2])
    lat = np.clip(centres[0][c] + rng.randn(m) * GEO_SIGMA_DEG, -90, 90)
    lon = centres[1][c] + rng.randn(m) * GEO_SIGMA_DEG / np.maximum(
        np.cos(np.radians(lat)), 0.05)
    lon = (lon + 180.0) % 360.0 - 180.0
    geo = {"loc": vars(build_geo_column(docs, lat, lon, nd_pad))}
    # clientip: an ordinal column over the addresses this shard uses
    irng = np.random.RandomState(MESH_SEEDS[sh] + IP_SEED_OFFSET)
    pidx = irng.choice(IP_POOL, n, p=pool[2])
    used = np.unique(pidx)
    terms = sorted(pool[0][i] for i in used.tolist())
    ord_of = {t: o for o, t in enumerate(terms)}
    pool_ord = np.full(IP_POOL, -1, np.int64)
    pool_ord[used] = [ord_of[pool[0][i]] for i in used.tolist()]
    ords = pool_ord[pidx].astype(np.int32)
    cap = 1
    while cap < n:
        cap *= 2
    ip_docs = np.full(cap, nd_pad, np.int32)
    ip_docs[:n] = np.arange(n, dtype=np.int32)
    ip_ords = np.zeros(cap, np.int32)
    ip_ords[:n] = ords
    first_ord = np.full(nd_pad, -1, np.int32)
    first_ord[:n] = ords
    present = np.zeros(nd_pad, bool)
    present[:n] = True
    ordinal = {"clientip": dict(terms=terms, flat_ords=ip_ords,
                                flat_docs=ip_docs, first_ord=first_ord,
                                exists=present, count=n)}
    # active: [start, start + days) inside the year of ts
    arng = np.random.RandomState(MESH_SEEDS[sh] + ACTIVE_SEED_OFFSET)
    days = arng.randint(1, 91, n)
    start = AGG_T0 + arng.randint(0, 365 - days) * AGG_DAY \
        + arng.randint(0, AGG_DAY, n)
    alo = np.zeros(nd_pad, np.float64)
    ahi = np.zeros(nd_pad, np.float64)
    alo[:n] = start
    ahi[:n] = start + days * AGG_DAY - 1
    tl = np.zeros(nd_pad, np.float64)
    tl[:n] = doc_len
    numeric = {"active#lo": _numeric_column(alo, present, nd_pad),
               "active#hi": _numeric_column(ahi, present, nd_pad),
               "title.length": _numeric_column(tl, present, nd_pad)}
    return geo, numeric, ordinal, pidx


def _hav64(lat, lon, clat, clon):
    """Float64 haversine (m) with the geo_distance query's radius."""
    r1, r2 = np.radians(lat), np.radians(clat)
    a = (np.sin((r2 - r1) / 2) ** 2 + np.cos(r1) * np.cos(r2)
         * np.sin(np.radians(clon - lon) / 2) ** 2)
    return 2 * 6371008.8 * np.arcsin(np.sqrt(a))


def geo_band(segs, center, radius):
    """The docs (ids) with a point whose float64 distance lies within
    1e-5 * radius of the radius: the float32 test may flip there between
    devices."""
    out = set()
    for seg in segs:
        col = seg.geo_columns["loc"]
        m = col.count
        d = _hav64(col.lat[:m].astype(np.float64),
                   col.lon[:m].astype(np.float64), center[0], center[1])
        for doc in np.unique(col.flat_docs[:m][np.abs(d - radius)
                                               <= 1e-5 * radius]).tolist():
            out.add(seg.doc_ids[doc])
    return out


def same_banded(gr, cr, band, what):
    """Equal responses, leaving out the band's docs: totals may differ by
    the band docs each side holds, every other hit is the same."""
    if not band:
        same_response(gr, cr, what)
        return
    gi = [h["_id"] for h in gr["hits"]["hits"] if h["_id"] not in band]
    ci = [h["_id"] for h in cr["hits"]["hits"] if h["_id"] not in band]
    check(gi == ci and abs(gr["hits"]["total"] - cr["hits"]["total"])
          <= len(band), f"cuda response equals cpu response outside "
                        f"{len(band)} band docs: {what}")


def geo_fields_phase(torch, Node, Segment, cuda_kernels, tsc, ssum, queries,
                     shard_arrays, title_streams, ingest_ops, errs,
                     device="cuda"):
    """Phase 17: the field types and text fielddata at full width, on
    two of pmc-4x256k's shards in their doc-values form (phase 16's ``ts``, ``citations``,
    ``venue``) with ``loc`` (geo_point), ``clientip`` (ip), ``active``
    (date_range), ``title.length`` (token_count) and text fielddata on
    ``title``, in ``geo4`` (the mesh plane) and ``geo4h`` (the host rung)
    on the card node, each request of both held against the same request
    on a cpu node's ``geo4h`` (its host rung, over the same host arrays):

    17a. geo_distance (50 km, 1,000 km), geo_bounding_box (inside a
         hemisphere; across the antimeridian) and a 5-point geo_polygon
         under a match: p50, plane, the tile form that scored it, and the
         boundary band (docs within 1e-5 of the radius in float64, left
         out of the comparison and counted).
    17b. ``_geo_distance`` sorts: asc/min, desc/max, avg over two points,
         km; 10 search_after pages of 100 equal one 1,000-hit request;
         the host rung with ``sort_ineligible``.
    17c. geo_bounds, geo_centroid, geohash_grid (precision 3 and 5) under
         a match and over every doc; the vectorized geohash against the
         scalar loop on one segment.
    17d. ``term`` and ``range`` (intersects, within, contains) on
         ``active``; ``term`` on ``clientip`` (v4, v6), a /16 block as a
         CIDR term and as a range, ``terms`` on ``clientip``, each total
         held against a numpy oracle over the sources; ``range`` on
         ``title.length``.
    17e. ``terms`` on ``title`` (text fielddata) under a match and over
         every doc: the fielddata breaker's bytes, each segment's build
         ms, the kernel-2 plans of the gather over about 50,000
         ordinals; the fused plane declines with ``field_ineligible``.
    17f. ingest-20k's first 1,000 docs over ``bulk`` with every new type
         in each accepted
         form and one malformed value of each kind (a 400 with the JAX
         package's message), a flush and a restart through
         ``Node(data_path=...)``: the reopened node answers 17a-17d's kinds
         as before (the geo store round trip).
    Every 1a (and mesh tile-form) launch and every kernel-2 call of the
    main path is held against its plain version. After ``DELETE`` the
    fielddata breaker is back to its level and ``memory_allocated`` too.
    Returns the report."""
    import gc
    import ipaddress

    from elasticsearch_tpu_torch.common.breaker import breaker_service
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.search import aggregations as A
    from elasticsearch_tpu_torch.search import query_dsl as Q
    from elasticsearch_tpu_torch.utils import geohash

    t_phase = time.perf_counter()
    report = {}
    tok = term_token
    fd_breaker = breaker_service().get_breaker("fielddata")

    def level():
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()
        return 0

    mem0, fd0 = level(), fd_breaker.used_bytes
    mapping = {"_doc": {"properties": {
        "title": {"type": "text",
                  "fields": {"length": {"type": "token_count"}}},
        "venue": {"type": "keyword"}, "year": {"type": "long"},
        "ts": {"type": "date"}, "citations": {"type": "long"},
        "loc": {"type": "geo_point"}, "clientip": {"type": "ip"},
        "active": {"type": "date_range"}}}}
    shard_arrays = shard_arrays[:GEO_SHARDS]
    settings = Settings(GEO_BREAKER)
    gnode = Node(settings, device=device)
    cnode = Node(settings, device="cpu")
    twins = {gnode: ("geo4", "geo4h"), cnode: ("geo4h",)}
    for node, names in twins.items():
        for name in names:
            extra = {"search": {"mesh": False}} if name == "geo4h" else {}
            node.create_index(name, {"settings": {
                "number_of_shards": GEO_SHARDS, "refresh_interval": "-1",
                "requests.cache.enable": False, **extra},
                "mappings": mapping})
    t0 = time.perf_counter()
    centres, pool = geo_centres(), ip_pool()
    gsegs, csegs, pidx_of = [], [], []
    adopt_s = 0.0
    for sh, arrays in enumerate(shard_arrays):
        arrays = dict(arrays)
        nd_pad = arrays["numeric_columns"]["year"]["exists"].shape[0]
        n = len(arrays["doc_ids"])
        geo, numeric, ordinal, pidx = geo_shard_columns(
            sh, nd_pad, n, title_streams[sh][1], centres, pool)
        pidx_of.append(pidx)
        arrays["numeric_columns"] = {**arrays["numeric_columns"],
                                     **agg_columns(sh, nd_pad, n), **numeric}
        arrays["ordinal_columns"] = {**arrays["ordinal_columns"], **ordinal}
        arrays["geo_columns"] = geo
        t1 = time.perf_counter()
        for node, segs, dev in ((gnode, gsegs, device),
                                (cnode, csegs, "cpu")):
            seg = Segment.from_arrays(f"geo4_{sh}_seg_1", device=dev,
                                      **arrays)
            for name in twins[node]:
                node.indices[name].shards[sh].engine.adopt_segment(seg)
            segs.append(seg)
        adopt_s += time.perf_counter() - t1
    report["columns_s"] = time.perf_counter() - t0
    report["adopt_s"] = adopt_s
    report["points"] = sum(s.geo_columns["loc"].count for s in gsegs)
    # text fielddata: each card segment's build, charged before it; the
    # cpu twin's segments hold the same host arrays, so they take the same
    # columns (uncharged) instead of building them again
    builds = []
    for seg, cseg in zip(gsegs, csegs):
        before = fd_breaker.used_bytes
        t1 = time.perf_counter()
        col = A._text_fielddata(seg, "title")
        builds.append({"ms": (time.perf_counter() - t1) * 1000,
                       "ords": len(col.terms), "pairs": col.count,
                       "breaker_bytes": fd_breaker.used_bytes - before})
        cseg.host_cache["fielddata.title"] = col
    # the same for clientip's vocabulary as parse_ip ints (the ip term and
    # range queries map it once a segment)
    for seg, cseg in zip(gsegs, csegs):
        cseg.host_cache["ipints.clientip"] = Q.ip_vocabulary_ints(
            seg, "clientip")
    report["fielddata_builds"] = builds
    log(f"[phase 17e] title fielddata builds: {json.dumps(builds)}")
    # the segments' terms are all title's: the JAX estimate is 8 bytes a
    # posting and 5 a doc
    check(all(b["breaker_bytes"] == 8 * int(seg.term_doc_freq.sum())
              + 5 * seg.nd_pad for b, seg in zip(builds, gsegs)),
          "phase 17e: each build charged the JAX estimate")
    for seg in gsegs + csegs:
        seg.device_arrays()
    gnode.search("geo4", {"query": {"match": {"title": tok(1)}}, "size": 1})
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"[phase 17] geo4 built ({report['points']} points, columns "
        f"{report['columns_s']:.1f} s, of it segments adopted "
        f"{report['adopt_s']:.1f} s), staged "
        f"({time.perf_counter() - t_phase:.1f} s in all)")

    def match(q):
        return {"match": {"title": " ".join(tok(t) for t in q)}}

    heavy = int(np.argmax(centres[2]))
    hc = (float(centres[0][heavy]), float(centres[1][heavy]))
    filters = [  # (kind, filter, band (center, radius m) or None)
        ("geo_distance_50km", {"geo_distance": {
            "distance": "50km", "loc": {"lat": hc[0], "lon": hc[1]}}},
         (hc, 50_000.0)),
        ("geo_distance_1000km", {"geo_distance": {
            "distance": "1000km", "loc": f"{hc[0]},{hc[1]}"}},
         (hc, 1_000_000.0)),
        ("geo_box", {"geo_bounding_box": {"loc": {
            "top_left": {"lat": 60.0, "lon": -10.0},
            "bottom_right": {"lat": 35.0, "lon": 30.0}}}}, None),
        ("geo_box_antimeridian", {"geo_bounding_box": {"loc": {
            "top_left": [150.0, 72.0], "bottom_right": [-150.0, 45.0]}}},
         None),
        ("geo_polygon", {"geo_polygon": {"loc": {"points": [
            [-10, 36], [30, 36], [40, 55], [10, 70], [-12, 58]]}}}, None),
    ]
    samples, forms, planes, bands = {}, {}, {}, {}

    def timed(index, body, kind):
        before = dict(cuda_kernels.LAUNCHES)
        t1 = time.perf_counter()
        r = gnode.search(index, dict(body))
        if device == "cuda":
            torch.cuda.synchronize()
        samples.setdefault((kind, index), []).append(
            (time.perf_counter() - t1) * 1000)
        forms[(kind, index)] = {k: v - before.get(k, 0) for k, v in
                                cuda_kernels.LAUNCHES.items()
                                if v != before.get(k, 0)}
        return r

    cpu_s = {}

    def both(index, body, kind, band=None):
        gr = timed(index, body, kind)
        cr = cpu_answer(body)
        same_banded(gr, cr, band or set(), f"phase 17 {kind} on {index}")
        return gr, cr

    cpu_cache = {}

    def cpu_answer(body):
        """The cpu node's host-rung answer to ``body`` (once a body: both
        card indices are held against it)."""
        key = json.dumps(body, sort_keys=True)
        if key not in cpu_cache:
            t1 = time.perf_counter()
            cpu_cache[key] = cnode.search("geo4h", dict(body))
            cpu_s[sub[0]] = cpu_s.get(sub[0], 0.0) \
                + time.perf_counter() - t1
            check(cpu_cache[key]["_plane"] == "host",
                  f"phase 17: the cpu twin answers on its host rung "
                  f"({cpu_cache[key]['_plane']})")
        return cpu_cache[key]

    ms0 = gnode.indices["geo4"]._mesh_plane()
    dec0 = dict(ms0.decisions)
    fb0 = dict(ms0.agg_host_fallback_by_reason)
    cuda_kernels.reset_launch_counts()
    t_main = time.perf_counter()
    bodies = {}
    sub, sub_s = ["17a"], {}

    def mark(name):
        """Close the running subphase's clock and start ``name``'s."""
        now = time.perf_counter()
        sub_s[sub[0]] = now - sub_s.pop("_t", t_main)
        sub_s["_t"] = now
        sub[0] = name
    with recording_tile_launches(
            tsc, lambda k: True) as kept, \
            recording_segsum_calls(ssum) as kept_seg, \
            recording_mask_segsum(ssum) as kept_mask:
        # ---- 17a ----
        for kind, flt, circle in filters:
            band = geo_band(gsegs, *circle) if circle else set()
            bands[kind] = len(band)
            body = {"query": {"bool": {"must": match(queries[0]),
                                       "filter": flt}}, "size": 10}
            bodies[kind] = body
            for index in ("geo4", "geo4h"):
                gr, _cr = both(index, body, kind, band)
                planes[(kind, index)] = gr["_plane"]
                want = ("host",) if index == "geo4h" else (
                    "mesh", "mesh_pallas")
                check(gr["_plane"] in want,
                      f"phase 17a {kind} on {index}: plane {gr['_plane']}")
            # the filter alone: every hit over the card's float32 test
            alone = {"query": flt, "size": 0}
            gr, cr = both("geo4", alone, kind + "_count", band)
            bands[kind + "_total"] = gr["hits"]["total"]
        # ---- 17b ----
        mark("17b")
        two = [{"lat": hc[0], "lon": hc[1]}, {"lat": -33.9, "lon": 151.2}]
        sorts = [
            ("sort_asc_min", [{"_geo_distance": {
                "loc": {"lat": hc[0], "lon": hc[1]}, "order": "asc",
                "unit": "km"}}]),
            ("sort_desc_max", [{"_geo_distance": {
                "loc": [hc[1], hc[0]], "order": "desc", "unit": "km"}}]),
            ("sort_avg_two", [{"_geo_distance": {
                "loc": two, "order": "asc", "mode": "avg", "unit": "km"}}]),
        ]
        for kind, sort in sorts:
            body = {"query": match(queries[1]), "sort": sort, "size": 10}
            bodies[kind] = body
            for index in ("geo4", "geo4h"):
                gr = timed(index, body, kind)
                same_sorted(gr, cpu_answer(body),
                            f"phase 17b {kind} on {index}")
                planes[(kind, index)] = gr["_plane"]
                check(gr["_plane"] == "host",
                      f"phase 17b {kind} on {index}: plane {gr['_plane']}")
        dec = {k: v - dec0.get(k, 0) for k, v in ms0.decisions.items()
               if v != dec0.get(k, 0)}
        check(dec.get("host.sort_ineligible", 0) >= len(sorts),
              f"phase 17b: the geo sorts decline the mesh as "
              f"sort_ineligible ({dec})")
        base = {"query": match(queries[2]), "sort": sorts[0][1],
                "_source": False}
        pages, after = [], None
        for _ in range(GEO_PAGES):
            body = dict(base, size=GEO_PAGE)
            if after is not None:
                body["search_after"] = after
            gr = gnode.search("geo4", dict(body))
            same_sorted(gr, cpu_answer(body), f"phase 17b page {len(pages)}")
            if not gr["hits"]["hits"]:
                break
            pages.append(gr["hits"]["hits"])
            after = gr["hits"]["hits"][-1]["sort"]
        one = gnode.search("geo4", dict(base, size=GEO_PAGE * GEO_PAGES))
        joined = [(h["_id"], h["sort"]) for p in pages for h in p]
        check(len(pages) == GEO_PAGES and joined == [
            (h["_id"], h["sort"]) for h in one["hits"]["hits"]],
              f"phase 17b: {len(pages)} search_after pages equal one "
              f"{GEO_PAGE * GEO_PAGES}-hit request hit for hit")
        report["search_after"] = {"pages": len(pages), "hits": len(joined),
                                  "total": one["hits"]["total"]}
        # ---- 17c ----
        mark("17c")
        aggs = [("geo_bounds", {"b": {"geo_bounds": {"field": "loc"}}}),
                ("geo_centroid", {"c": {"geo_centroid": {"field": "loc"}}}),
                ("geohash_3", {"g": {"geohash_grid": {"field": "loc",
                                                      "precision": 3}}}),
                ("geohash_5", {"g": {"geohash_grid": {"field": "loc",
                                                      "precision": 5,
                                                      "size": 100}}})]
        for kind, agg in aggs:
            for qname, query in (("match", match(queries[3])),
                                 ("all", {"match_all": {}})):
                body = {"size": 0, "query": query, "aggs": agg}
                bodies[f"{kind}_{qname}"] = body
                for index in ("geo4", "geo4h"):
                    gr, _cr = both(index, body, f"{kind}_{qname}")
                    planes[(f"{kind}_{qname}", index)] = gr["_plane"]
        check(ms0.agg_host_fallback_by_reason.get("unsupported_agg", 0)
              > fb0.get("unsupported_agg", 0),
              "phase 17c: geo aggregations decline the fused plane "
              "(unsupported_agg)")
        # ---- 17d ----
        mark("17d")
        oracle = {}
        v4 = next(i for i in np.argsort(-pool[2]) if ":" not in pool[0][i])
        v6 = next(i for i in np.argsort(-pool[2]) if ":" in pool[0][i])
        net = ipaddress.ip_network(f"{pool[0][v4]}/16", strict=False)
        n_lo = int(ipaddress.IPv6Address(f"::ffff:{net.network_address}"))
        n_hi = int(ipaddress.IPv6Address(f"::ffff:{net.broadcast_address}"))
        ip_ints = pool[1]
        in_net = np.asarray([n_lo <= v <= n_hi for v in ip_ints])

        def ip_total(pred):
            return int(sum(int(pred[p].sum()) for p in pidx_of))

        is_v4 = np.arange(IP_POOL) == v4
        is_v6 = np.arange(IP_POOL) == v6
        day = AGG_T0 + 180 * AGG_DAY
        ranges = [
            ("active_term", {"term": {"active": day}}, None),
            ("active_intersects", {"range": {"active": {
                "gte": day, "lte": day + 7 * AGG_DAY}}}, None),
            ("active_within", {"range": {"active": {
                "gte": day, "lte": day + 60 * AGG_DAY,
                "relation": "within"}}}, None),
            ("active_contains", {"range": {"active": {
                "gte": day, "lte": day + 10 * AGG_DAY,
                "relation": "contains"}}}, None),
            ("ip_term_v4", {"term": {"clientip": pool[0][v4]}}, is_v4),
            ("ip_term_v6", {"term": {"clientip": pool[0][v6]}}, is_v6),
            ("ip_cidr_term", {"term": {"clientip": str(net)}}, in_net),
            ("ip_cidr_range", {"range": {"clientip": {
                "gte": str(net.network_address),
                "lte": str(net.broadcast_address)}}}, in_net),
            ("title_length", {"range": {"title.length": {"gte": 150}}},
             None),
        ]
        for kind, q, pred in ranges:
            shapes = [("alone", {"query": q, "size": 10})]
            if kind in ("active_intersects", "active_contains",
                        "ip_term_v6", "ip_cidr_range", "title_length"):
                shapes.append(("match", {"query": {"bool": {
                    "must": match(queries[4]), "filter": q}}, "size": 10}))
            for shape, body in shapes:
                bodies[f"{kind}_{shape}"] = body
                for index in ("geo4", "geo4h"):
                    gr, _cr = both(index, body, f"{kind}_{shape}")
                    planes[(f"{kind}_{shape}", index)] = gr["_plane"]
                    if pred is not None and shape == "alone":
                        want = ip_total(pred)
                        oracle[kind] = want
                        check(gr["hits"]["total"] == want and want > 0,
                              f"phase 17d {kind} on {index}: total "
                              f"{gr['hits']['total']}, oracle {want}")
        body = {"size": 0, "aggs": {"ip": {"terms": {"field": "clientip",
                                                     "size": 10}}}}
        bodies["ip_terms"] = body
        for index in ("geo4", "geo4h"):
            gr, _cr = both(index, body, "ip_terms")
            planes[("ip_terms", index)] = gr["_plane"]
            counts = np.bincount(np.concatenate(pidx_of), minlength=IP_POOL)
            top = sorted(((-c, pool[0][i]) for i, c in enumerate(counts)
                          if c))[:10]
            check([(b["key"], b["doc_count"]) for b in
                   gr["aggregations"]["ip"]["buckets"]]
                  == [(k, -c) for c, k in top],
                  f"phase 17d ip terms on {index} equal the oracle's top 10")
        report["ip_oracle"] = oracle
        # ---- 17e ----
        mark("17e")
        fb1 = ms0.agg_host_fallback_by_reason.get("field_ineligible", 0)
        for qname, query in (("match", match(queries[5])),
                             ("all", {"match_all": {}})):
            body = {"size": 0, "query": query, "aggs": {"t": {"terms": {
                "field": "title", "size": 10}}}}
            bodies[f"fielddata_{qname}"] = body
            for index in ("geo4", "geo4h"):
                gr, _cr = both(index, body, f"fielddata_{qname}")
                planes[(f"fielddata_{qname}", index)] = gr["_plane"]
        report["field_ineligible"] = \
            ms0.agg_host_fallback_by_reason.get("field_ineligible", 0) - fb1
        check(report["field_ineligible"] == 2,
              f"phase 17e: the fused plane declines text fielddata as "
              f"field_ineligible ({report['field_ineligible']} of 2)")
        mark("end")
    if device == "cuda":
        torch.cuda.synchronize()
    report["main_s"] = time.perf_counter() - t_main
    sub_s.pop("_t", None)
    report["subphase_s"] = sub_s
    report["cpu_twin_s"] = cpu_s
    log(f"[phase 17] main path by subphase (s): {json.dumps(sub_s)}; of "
        f"it the cpu twin's answers: {json.dumps(cpu_s)}")
    p17 = dict(cuda_kernels.LAUNCHES)
    log(f"[phase 17] kernel launches: {p17}")
    t0 = time.perf_counter()
    held = dict(check_kept_launches(torch, tsc, kept, errs, "phase 17"))
    check_kept_segsum(torch, ssum, kept_seg, "phase 17", errs, held)
    mask_plans = check_kept_mask_segsum(torch, ssum, kept_mask, "phase 17",
                                        errs, held)
    sm = torch.cuda.get_device_properties(0).multi_processor_count \
        if device == "cuda" else 132
    gather, call = {}, None
    for call in kept_seg:
        nd, kw = call[0][0].shape[0], call[1]
        if kw["n_ords"] >= 10_000:
            p = ssum.segment_sum_plan(nd, kw["n_ords"],
                                      kw.get("with_count", True), False, sm)
            key = f"nd {nd} n_ords {kw['n_ords']}"
            g = gather.setdefault(key, {"path": p.path, "grid": p.grid,
                                        "threads": p.threads,
                                        "kernels": p.kernels, "launches": 0})
            g["launches"] += 1
    report["fielddata_gather_plans"] = gather
    report["mask_plans"] = mask_plans
    log(f"[phase 17e] kernel-2 gathers over 10,000 ordinals or more (the "
        f"title fielddata's 50,000, clientip's about 38,800 a segment): "
        f"{json.dumps(gather)}")
    del kept, kept_seg, kept_mask, call
    report["hold_s"] = time.perf_counter() - t0
    for k in ("tile_scoring", "segment_sum"):
        check(p17.get(k, 0) > 0, f"phase 17 launched {k}")
    for k, v in p17.items():
        check(held.get(k, 0) == v, f"every {k} launch of phase 17 held "
                                   f"against plain ({held.get(k, 0)} of {v})")
    check(any(k.endswith("n_ords 50000") for k in gather),
          "phase 17e: the title terms gathered over 50,000 ordinals "
          "through kernel 2")
    report["fielddata_breaker_bytes"] = fd_breaker.used_bytes - fd0
    log(f"[phase 17e] fielddata breaker {report['fielddata_breaker_bytes']}"
        f" bytes over both nodes' segments")
    # the tile form each kind's card request launched, and p50s
    t0 = time.perf_counter()
    p50 = {}
    for key, body in bodies.items():
        row = {}
        for index in ("geo4", "geo4h"):
            for _ in range(GEO_REPS - 1):
                timed(index, body, key)
            row[index] = {"p50_ms": float(np.median(samples[(key, index)])),
                          "plane": planes.get((key, index)),
                          "launches": forms.get((key, index), {})}
        p50[key] = row
        if key in bands:
            row["band"] = bands[key]
            row["filter_total"] = bands[key + "_total"]
        log(f"[phase 17] {key}: " + json.dumps(row))
    report["time_s"] = time.perf_counter() - t0
    # one segment's geohash_grid partial at precision 5: the vectorized
    # cells (what the aggregation runs: codes, their counts, the cells'
    # strings) against the JAX package's scalar loop
    from collections import Counter

    col = gsegs[0].geo_columns["loc"]
    lat, lon = col.lat[: col.count], col.lon[: col.count]
    t1 = time.perf_counter()
    codes, counts = np.unique(geohash.encode_cells(lat, lon, 5),
                              return_counts=True)
    cells = dict(zip(geohash.cell_strings(codes, 5), counts.tolist()))
    vec_ms = (time.perf_counter() - t1) * 1000
    t1 = time.perf_counter()
    loop = Counter(geohash.encode(a, b, 5) for a, b in zip(lat.tolist(),
                                                            lon.tolist()))
    loop_ms = (time.perf_counter() - t1) * 1000
    check(cells == dict(loop), "phase 17c: the vectorized geohash cells "
                               "equal the scalar encode's on every point "
                               "of a segment")
    report["geohash_encode"] = {"points": int(col.count),
                                "vectorized_ms": vec_ms, "loop_ms": loop_ms}
    log(f"[phase 17c] geohash precision 5 over {col.count} points: "
        f"vectorized {vec_ms:.1f} ms, scalar loop {loop_ms:.1f} ms")
    fails = plane_failures(gnode.indices["geo4"], gnode.indices["geo4h"],
                           cnode.indices["geo4h"])
    check(not any(fails), f"phase 17 zero plane faults (got {fails})")
    log(f"[phase 17] ladder: "
        f"{json.dumps(gnode.indices['geo4'].search_stats()['planes']['decisions'])}")
    # ---- 17f ----
    report["ingest"] = geo_ingest_phase(torch, Node, Segment, ingest_ops,
                                        bodies, device)
    # DELETE: the fielddata charges and the card's memory come back
    for node, names in twins.items():
        for name in names:
            node.delete_index(name)
        node.close()
    del twins
    del gsegs, csegs, gnode, cnode, ms0
    mem1, fd1 = level(), fd_breaker.used_bytes
    check(fd1 == fd0, f"phase 17e: the fielddata breaker back to its level "
                      f"after DELETE ({fd1} against {fd0})")
    check(device != "cuda" or mem1 == mem0,
          f"phase 17e: memory_allocated back to its level after DELETE "
          f"({mem1} against {mem0})")
    report["memory"] = {"before": mem0, "after_delete": mem1,
                        "fielddata_before": fd0, "fielddata_after": fd1}
    report.update(p50=p50, launches=p17, held=held)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 17] {report['seconds']:.1f} s (main path "
        f"{report['main_s']:.1f}, hold {report['hold_s']:.1f}, timing "
        f"{report['time_s']:.1f})")
    return report


# the JAX package's messages for one malformed value of each new kind
GEO_BAD_VALUES = [
    ("loc", {"lat": 91.0, "lon": 0.0},
     "illegal latitude/longitude value [91.0, 0.0]"),
    ("loc", "1,2,3", "failed to parse geo_point [1,2,3]"),
    ("clientip", "300.1.2.3", "'300.1.2.3' is not an IP string literal."),
    ("active", {"gte": "2023-01-01", "until": "x"},
     "error parsing field [active], unknown range parameter [until]"),
    ("active", 17, "error parsing field [active], expected an object but "
                   "got [17]"),
    ("s", 40000, "failed to parse field [s]: value [40000] is out of range "
                 "for type [short]"),
    ("b", -200, "failed to parse field [b]: value [-200] is out of range "
                "for type [byte]"),
    ("h", "warm", "failed to parse field [h] of type [half_float] value "
                  "[warm]"),
    ("price", True, "failed to parse field [price] of type [scaled_float]: "
                    "booleans are not numbers"),
    ("blob", "not base64!", "failed to parse field [blob]: invalid base64"),
]


def geo_ingest_phase(torch, Node, Segment, ingest_ops, bodies, device):
    """17f: phase 3's first 1,000 docs (``ingest_ops``) with the new types in
    each accepted form through ``bulk`` into a ``Node(data_path=...)``;
    the malformed values; a flush, a restart, and the request kinds of
    17a-17d answered as before and as a cpu node holding the same
    segments answers them."""
    from elasticsearch_tpu_torch.utils import murmur3

    out = {}
    mapping = {"_doc": {"properties": {
        "title": {"type": "text",
                  "fields": {"length": {"type": "token_count"}}},
        "venue": {"type": "keyword", "fields": {"hash": {"type": "murmur3"}}},
        "year": {"type": "long"}, "loc": {"type": "geo_point"},
        "clientip": {"type": "ip"}, "active": {"type": "date_range"},
        "span": {"type": "integer_range"}, "temp": {"type": "float_range"},
        "net": {"type": "ip_range"}, "s": {"type": "short"},
        "b": {"type": "byte"}, "h": {"type": "half_float"},
        "price": {"type": "scaled_float", "scaling_factor": 100},
        "blob": {"type": "binary", "doc_values": True}}}}
    rng = np.random.RandomState(MESH_SEEDS[0] + 700)
    ops = []
    for i, (op, meta, src) in enumerate(ingest_ops):
        src = dict(src)
        lat, lon = float(rng.uniform(-60, 70)), float(rng.uniform(-179, 179))
        form = i % 4
        if form == 0:
            src["loc"] = {"lat": lat, "lon": lon}
        elif form == 1:
            src["loc"] = f"{lat},{lon}"
        elif form == 2:
            src["loc"] = [{"lat": lat, "lon": lon},
                          f"{-lat / 2},{lon / 2}"]
        a = int(rng.randint(0, 1 << 24))
        src["clientip"] = (f"10.{a >> 16}.{(a >> 8) & 255}.{a & 255}"
                           if i % 3 else
                           f"2001:db8::{a >> 16:x}:{a & 0xffff:x}"
                           if i % 2 else
                           f"::ffff:10.{a >> 16}.{(a >> 8) & 255}.{a & 255}")
        start = AGG_T0 + int(rng.randint(0, 300)) * AGG_DAY
        src["active"] = ({"gte": start, "lte": start + 5 * AGG_DAY}
                         if i % 2 else
                         {"gt": "2023-03-01", "lt": "2023-04-01"})
        # the other types a doc in turn, each in every accepted form
        other = i % 8
        if other == 0:
            src["span"] = {"gte": i % 50, "lt": i % 50 + 10}
        elif other == 1:
            src["temp"] = {"gt": -1.5, "lte": float(i % 7)}
        elif other == 2:
            src["net"] = ("10.0.0.0/8" if i % 3 else
                          {"gte": "10.0.0.0", "lt": "10.1.0.0"})
        elif other == 3:
            src["s"], src["b"] = int(i % 30000) - 15000, int(i % 200) - 100
        elif other == 4:
            src["h"] = float(i % 11) / 4 if i % 3 else str(i % 11)
        elif other == 5:
            src["price"] = f"{i % 97}.4567" if i % 3 else i % 97 + 0.125
        elif other == 6:
            src["blob"] = "aGVsbG8="
        ops.append((op, {**meta, "_index": "gi"}, src))
    for j, (field, value, _msg) in enumerate(GEO_BAD_VALUES):
        ops.append(("index", {"_index": "gi", "_id": f"bad{j}"},
                    {"title": "bad", field: value}))
    tmp = tempfile.mkdtemp(prefix="geo17f_")
    try:
        node = Node(data_path=tmp, device=device)
        # per-op fsyncs would time the disk, not the parsing (phase 13a
        # measures the durability's cost)
        node.create_index("gi", {"settings": {
            "number_of_shards": 5, "refresh_interval": "-1",
            "requests.cache.enable": False,
            "index": {"translog": {"durability": "async"}}},
            "mappings": mapping})
        t0 = time.perf_counter()
        r = node.bulk(ops)
        node.refresh("gi")
        if device == "cuda":
            torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        out["docs_per_s"] = len(ingest_ops) / out["ingest_s"]
        items = [next(iter(it.values())) for it in r["items"]]
        good = items[: len(ingest_ops)]
        bad = [it for it in good if it["status"] not in (200, 201)]
        if bad:
            log(f"[phase 17f] first refused doc: {json.dumps(bad[0])}")
        check(all(it["status"] in (200, 201) for it in good),
              f"phase 17f: every accepted form indexed ({sum(it['status'] in (200, 201) for it in good)} of {len(good)})")
        for it, (field, value, msg) in zip(items[len(ingest_ops):],
                                           GEO_BAD_VALUES):
            err = it.get("error") or {}
            check(it["status"] == 400 and err.get("type")
                  == "mapper_parsing_exception"
                  and err.get("reason") == msg,
                  f"phase 17f: {field}={value!r} is a 400 with the JAX "
                  f"message ({it['status']}, {err.get('reason')!r})")
        log(f"[phase 17f] bulk {len(ingest_ops)} docs with the new types "
            f"+ {len(GEO_BAD_VALUES)} malformed in {out['ingest_s']:.1f} s:"
            f" {out['docs_per_s']:.0f} docs/s")
        # one request of each of 17a-17e's kinds
        kinds = {k: bodies[k] for k in (
            "geo_distance_1000km", "geo_box_antimeridian", "geo_polygon",
            "sort_avg_two", "geo_centroid_match", "geohash_3_all",
            "active_contains_match", "ip_cidr_range_alone", "ip_terms",
            "fielddata_match")}
        h = murmur3.murmur3_32(b"v0001")
        extra = {
            "span_term": {"query": {"term": {"span": 12}}, "size": 10},
            "net_term": {"query": {"term": {"net": "10.0.200.1"}},
                         "size": 0},
            "hash_term": {"query": {"term": {"venue.hash": h}}, "size": 0},
            "blob_cardinality": {"size": 0, "aggs": {"c": {
                "cardinality": {"field": "blob"}}}},
            "price_stats": {"size": 0, "aggs": {"p": {
                "stats": {"field": "price"}}}}}
        kinds.update(extra)

        def answers(n):
            return {k: _no_took(n.search("gi", dict(b)))
                    for k, b in kinds.items()}

        t0 = time.perf_counter()
        before = answers(node)
        out["answers_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cnode = Node(device="cpu")
        cnode.create_index("gi", {"settings": {"number_of_shards": 5,
                                               "refresh_interval": "-1",
                                               "requests.cache.enable": False},
                                  "mappings": mapping})
        _adopt_copies(node, cnode, "gi", Segment)
        for k, b in kinds.items():
            same = same_sorted if "sort" in b else same_response
            same(node.search("gi", dict(b)), cnode.search("gi", dict(b)),
                 f"phase 17f {k}")
        cnode.close()
        out["cpu_twin_s"] = time.perf_counter() - t0
        check(all(json.loads(before[k])["hits"]["total"] > 0
                  for k in ("net_term", "span_term", "hash_term")),
              "phase 17f: the range and murmur3 fields answer")
        t0 = time.perf_counter()
        node.flush("gi")
        node.close()
        out["flush_close_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        node = cold_reopen(Node, tmp, device)
        out["reopen_s"] = time.perf_counter() - t0
        after = answers(node)
        check(after == before, "phase 17f: the reopened node answers every "
                               "kind as before the restart (the geo store "
                               "round trip)")
        out["kinds"] = len(kinds)
        log(f"[phase 17f] flush and close {out['flush_close_s']:.1f} s, "
            f"reopen {out['reopen_s']:.1f} s; {len(kinds)} kinds equal "
            f"after the restart")
        node.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# Phase 18: nested documents and the parent-join field
# ----------------------------------------------------------------------

# sonested-2x256k: Rally's nested track (StackOverflow questions with their
# answers as nested objects), one shard a pmc-4x256k segment's title; two
# shards (cut from four: a depth cut, the coverage is a multi-shard mesh's)
SO_SEEDS = (21, 22, 23, 24)
SO_SHARDS = 2
SO_T0 = 1_199_145_600_000  # 2008-01-01T00:00:00Z
SO_T1 = 1_483_228_800_000  # 2017-01-01T00:00:00Z
SO_DAY = 86_400_000
SO_TAGS = 5_000
SO_ASKERS = 50_000
SO_USERS = 200_000  # the answerers' pool (askers are its first 50,000)
SO_NO_ANSWER = 0.15  # the share of questions without an answer
SO_MAX_ANSWERS = 8
SO_REPS = 1  # samples a kind and index (the main path's run alone)
SO_PAGE, SO_PAGES = 100, 10
SO_APPEND = 4096  # 18e's appended questions a shard
# 18f's questions through bulk (cut from 10,000 as phase 22 joined)
SO_BULK = 4_000
SO_JOIN_BULK = 2_000  # 18f's join-form questions through bulk
SO_PARENT_BULK = 500  # 18f's legacy _parent children
SO_EMB_DIMS = 16
SO_NESTED_MAPPING = {"_doc": {"properties": {
    "title": {"type": "text"}, "qid": {"type": "keyword"},
    "user": {"type": "keyword"}, "tag": {"type": "keyword"},
    "creationDate": {"type": "date"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"}, "date": {"type": "date"}}}}}}
SO_JOIN_MAPPING = {"_doc": {"properties": {
    "title": {"type": "text"}, "qid": {"type": "keyword"},
    "user": {"type": "keyword"}, "tag": {"type": "keyword"},
    "creationDate": {"type": "date"}, "date": {"type": "date"},
    "qa": {"type": "join", "relations": {"question": "answer"}}}}}
# the JAX package's 400 for one malformed doc of each kind:
# (index, source, routing, error type, reason)
SO_BAD_DOCS = [
    ("soi", {"title": "bad", "answers": "oops"}, None,
     "mapper_parsing_exception",
     "object mapping for [answers] tried to parse field [answers] as "
     "object, but found a concrete value"),
    ("soj", {"qa": "comment"}, "q0", "mapper_parsing_exception",
     "unknown join name [comment] for field [qa]"),
    ("soj", {"qa": {"name": "answer"}}, "q0", "mapper_parsing_exception",
     "[parent] is missing for join field [qa]"),
    ("soj", {"qa": {"name": "answer", "parent": "q0"}}, None,
     "illegal_argument_exception",
     "[routing] is missing for join field [qa]: child document [bad3] must "
     "be routed to its parent's shard"),
]


class _Lazy:
    """A read-only sequence whose items are made on access (the stored
    sources and the nested objects' ids of a full-width segment)."""

    def __init__(self, n, fn):
        self._n, self._fn = n, fn

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._fn(j) for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._fn(i)

    def __iter__(self):
        return (self._fn(i) for i in range(self._n))


def _zipf_draw(rng, n_values, size):
    p = 1.0 / np.arange(1, n_values + 1)
    return rng.choice(n_values, size, p=p / p.sum())


def _pow2(n):
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def _ord_column(docs, ords, terms, nd_pad):
    """A Segment.from_arrays ordinal column from (doc, ord) pairs over
    sorted ``terms``: each distinct pair once, by doc then ord, against
    the terms present (as a segment builder's column holds them)."""
    present, ords = np.unique(ords, return_inverse=True)
    terms = [terms[p] for p in present.tolist()]
    key = np.unique(docs.astype(np.int64) * len(terms) + ords)
    d = (key // len(terms)).astype(np.int32)
    o = (key % len(terms)).astype(np.int32)
    cap = _pow2(len(key))
    flat_docs = np.full(cap, nd_pad, np.int32)
    flat_docs[: len(key)] = d
    flat_ords = np.zeros(cap, np.int32)
    flat_ords[: len(key)] = o
    first = np.full(nd_pad, -1, np.int32)
    first[d[::-1]] = o[::-1]  # a doc's smallest ord wins
    exists = np.zeros(nd_pad, bool)
    exists[d] = True
    return dict(terms=terms, flat_ords=flat_ords, flat_docs=flat_docs,
                first_ord=first, exists=exists, count=len(key))


def _keyword_postings(field, docs, ords, terms, nd_pad):
    """A keyword field's term keys and block-packed postings (tf 1) from
    (doc, ord) pairs, one a doc and term."""
    from elasticsearch_tpu_torch.index.segment import FIELD_SEP

    order = np.lexsort((docs, ords))
    present, tid = np.unique(ords[order], return_inverse=True)
    block_docs, block_tfs, start, count, df = pack_postings(
        tid.astype(np.int64), docs[order].astype(np.int32),
        np.ones(len(order), np.float32), len(present), nd_pad)
    keys = [f"{field}{FIELD_SEP}{terms[p]}" for p in present]
    return keys, start, count, df, block_docs, block_tfs


def so_columns(sh, n, ids, seed=None):
    """sonested's draws for the ``n`` questions of shard ``sh`` (ids
    ``ids``): asker, 1-5 zipf tags of 5,000, the creation date (2008-2016),
    0-8 answers (15% none, a mean near 1.7), each with a zipf user of
    200,000 and a date after its question's."""
    rng = np.random.RandomState(SO_SEEDS[sh] if seed is None else seed)
    asker = _zipf_draw(rng, SO_ASKERS, n)
    ntag = rng.randint(1, 6, n)
    tag_docs = np.repeat(np.arange(n), ntag)
    tags = _zipf_draw(rng, SO_TAGS, int(ntag.sum()))
    created = SO_T0 + (rng.rand(n) * (SO_T1 - SO_T0 - 400 * SO_DAY)
                       ).astype(np.int64)
    k = np.where(rng.rand(n) < SO_NO_ANSWER, 0,
                 np.minimum(rng.geometric(0.5, n), SO_MAX_ANSWERS))
    parent_of = np.repeat(np.arange(n), k).astype(np.int32)
    starts = np.cumsum(k) - k
    offset_of = (np.arange(len(parent_of)) - np.repeat(starts, k)
                 ).astype(np.int32)
    auser = _zipf_draw(rng, SO_USERS, len(parent_of))
    adate = created[parent_of] + rng.randint(3_600_000, 400 * SO_DAY,
                                             len(parent_of))
    tag_start = np.cumsum(ntag) - ntag
    return dict(n=n, ids=ids, asker=asker, ntag=ntag, tag_docs=tag_docs,
                tags=tags, tag_start=tag_start, created=created, k=k,
                starts=starts, parent_of=parent_of, offset_of=offset_of,
                auser=auser, adate=adate)


SO_USER_TERMS = [f"u{i:06d}" for i in range(SO_USERS)]
SO_TAG_TERMS = [f"tag{i:04d}" for i in range(SO_TAGS)]


def _so_question(c, i):
    a, b = int(c["tag_start"][i]), int(c["tag_start"][i] + c["ntag"][i])
    return {"qid": c["ids"][i], "user": SO_USER_TERMS[c["asker"][i]],
            "tag": [SO_TAG_TERMS[t] for t in c["tags"][a:b]],
            "creationDate": int(c["created"][i])}


def _qid_rank(c):
    """Each question's rank in the sorted ids, and the sorted ids (once a
    shard's draws)."""
    if "qid_rank" not in c:
        arr = np.asarray(c["ids"])
        order = np.argsort(arr, kind="stable")
        rank = np.empty(len(arr), np.int64)
        rank[order] = np.arange(len(arr))
        c["qid_rank"], c["qid_terms"] = rank, arr[order].tolist()
    return c["qid_rank"], c["qid_terms"]


def so_nested_arrays(arrays, c):
    """The nested form's Segment.from_arrays fields: the pmc title segment
    with sonested's root columns and its ``answers`` sub-segment."""
    n = c["n"]
    nd_pad = arrays["norms"].shape[1] - 1
    m = len(c["parent_of"])
    sub_nd = _pow2(m)
    objs = np.arange(m)
    keys, start, count, df, bdocs, btfs = _keyword_postings(
        "answers.user", objs, c["auser"], SO_USER_TERMS, sub_nd)
    norms = np.zeros((1, sub_nd + 1), np.float32)
    norms[0, :m] = 1.0
    norms[0, sub_nd] = 1.0
    live = np.zeros(sub_nd, bool)
    live[:m] = True
    ids, parent_of, auser, adate = (c["ids"], c["parent_of"], c["auser"],
                                    c["adate"])
    answers = dict(
        term_keys=keys, term_block_start=start, term_block_count=count,
        term_doc_freq=df, block_docs=bdocs, block_tfs=btfs, norms=norms,
        live=live,
        field_stats={"answers.user": {"doc_count": m, "sum_ttf": m}},
        field_norm_idx={"answers.user": 0},
        doc_ids=_Lazy(m, lambda o: ids[parent_of[o]]),
        sources=_Lazy(m, lambda o: {"user": SO_USER_TERMS[auser[o]],
                                    "date": int(adate[o])}),
        seqnos=np.full(m, -1, np.int64),
        ordinal_columns={"answers.user": _ord_column(
            objs, auser, SO_USER_TERMS, sub_nd)},
        numeric_columns={"answers.date": _numeric_column(
            adate.astype(np.float64), np.ones(m, bool), sub_nd)},
        parent_of=parent_of, offset_of=c["offset_of"])
    rank, qterms = _qid_rank(c)
    qcol = _ord_column(np.arange(n), rank, qterms, nd_pad)
    out = dict(arrays)
    out["numeric_columns"] = {"creationDate": _numeric_column(
        c["created"].astype(np.float64), np.ones(n, bool), nd_pad)}
    out["ordinal_columns"] = {
        "qid": qcol,
        "user": _ord_column(np.arange(n), c["asker"], SO_USER_TERMS, nd_pad),
        "tag": _ord_column(c["tag_docs"], c["tags"], SO_TAG_TERMS, nd_pad),
        # the join form's relation (its questions are this segment)
        "qa": _ord_column(np.arange(n), np.ones(n, np.int64),
                          ["answer", "question"], nd_pad)}
    starts, k = c["starts"], c["k"]

    def source(i):
        src = _so_question(c, i)
        a = int(starts[i])
        src["answers"] = [{"user": SO_USER_TERMS[auser[o]],
                           "date": int(adate[o])}
                          for o in range(a, a + int(k[i]))]
        return src

    out["sources"] = _Lazy(n, source)
    out["nested"] = {"answers": answers}
    return out


def so_answer_arrays(c, sh):
    """The join form's answers segment of a shard: each answer an
    ``answer`` doc (ids ``s<shard>a<j>``, routed by its question's qid)
    whose ``qa#parent`` is its question's qid, with ``user`` (postings and
    ordinals) and ``date``. The questions are the nested form's root
    segment, which carries the ``qa`` column too: a shard of the join
    form holds two segments, as two refreshes leave them."""
    m = len(c["parent_of"])
    nd = _pow2(m)
    docs = np.arange(m)
    parent_of, auser, adate, ids = (c["parent_of"], c["auser"], c["adate"],
                                    c["ids"])
    keys, start, count, df, bdocs, btfs = _keyword_postings(
        "user", docs, auser, SO_USER_TERMS, nd)
    norms = np.zeros((1, nd + 1), np.float32)
    norms[0, :m] = 1.0
    norms[0, nd] = 1.0
    live = np.zeros(nd, bool)
    live[:m] = True
    rank, qterms = _qid_rank(c)
    parent_ids = np.asarray(ids, dtype=object)[parent_of].tolist()
    return dict(
        term_keys=keys, term_block_start=start, term_block_count=count,
        term_doc_freq=df, block_docs=bdocs, block_tfs=btfs, norms=norms,
        live=live, field_stats={"user": {"doc_count": m, "sum_ttf": m}},
        field_norm_idx={"user": 0},
        doc_ids=[f"s{sh}a{j}" for j in range(m)],
        sources=_Lazy(m, lambda o: {
            "qa": {"name": "answer", "parent": parent_ids[o]},
            "user": SO_USER_TERMS[auser[o]], "date": int(adate[o])}),
        routings=parent_ids,
        numeric_columns={"date": _numeric_column(
            adate.astype(np.float64), np.ones(m, bool), nd)},
        ordinal_columns={
            "qa": _ord_column(docs, np.zeros(m, np.int64),
                              ["answer", "question"], nd),
            "qa#parent": _ord_column(docs, rank[parent_of], qterms, nd),
            "user": _ord_column(docs, auser, SO_USER_TERMS, nd)})


def so_bulk_sources(n, seed, prefix):
    """``n`` sonested questions for bulk: a title of pmc tokens, the root
    fields, 0-8 answers, and an ``accepted`` nested object (one, with a
    16-dim vector flattened to the root) on about half of them."""
    rng = np.random.RandomState(seed)
    ids = [f"{prefix}{i}" for i in range(n)]
    c = so_columns(0, n, ids, seed=seed)
    ranks = np.arange(1, VOCAB + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    lens = rng.randint(5, 30, n)
    toks = rng.choice(VOCAB, int(lens.sum()), p=p)
    at = np.cumsum(lens) - lens
    out = []
    for i in range(n):
        src = _so_question(c, i)
        src["title"] = " ".join(term_token(int(t))
                                for t in toks[at[i]: at[i] + lens[i]])
        a = int(c["starts"][i])
        if c["k"][i]:
            src["answers"] = [{"user": SO_USER_TERMS[c["auser"][o]],
                               "date": int(c["adate"][o])}
                              for o in range(a, a + int(c["k"][i]))]
        if i % 2:
            src["accepted"] = [{"emb": [float(x) for x in
                                        rng.randn(SO_EMB_DIMS)]}]
        out.append((ids[i], src))
    return out, c


def same_inner_hits(gr, cr, what):
    """The inner hits of equal ids: totals, ids and offsets exact, scores
    within RTOL."""
    ch = {h["_id"]: h for h in cr["hits"]["hits"]}
    ok = True
    for h in gr["hits"]["hits"]:
        other = ch.get(h["_id"])
        if other is None:
            continue
        a, b = h.get("inner_hits") or {}, other.get("inner_hits") or {}
        ok = ok and sorted(a) == sorted(b)
        for name in a if ok else ():
            x, y = a[name]["hits"], b[name]["hits"]
            ok = ok and x["total"] == y["total"] and [
                (e["_id"], e.get("_nested")) for e in x["hits"]] == [
                (e["_id"], e.get("_nested")) for e in y["hits"]] and (
                not x["hits"] or np.allclose(
                    [e["_score"] for e in x["hits"]],
                    [e["_score"] for e in y["hits"]], rtol=RTOL))
    check(ok, f"cuda inner hits equal cpu inner hits: {what}")


def _kernel_table_ptrs(segments) -> set:
    """The device addresses of the segments' staged posting tables (a
    launch whose first argument is one of them scored that segment)."""
    return {t.data_ptr() for seg in segments
            for tables in seg._kernel_tables.values()
            for key, t in tables.items() if key in ("k_docs", "k_packed")}


def _gather_plans(torch, ssum, calls, min_ords) -> dict:
    """The kernel-2 plan of each kept gather-form call over ``min_ords``
    ordinals or more, with its launches, by (docs, ordinals)."""
    plans = {}
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for args, kw, _out in calls:
        if kw["n_ords"] < min_ords:
            continue
        nd = args[0].shape[0]
        p = ssum.segment_sum_plan(nd, kw["n_ords"],
                                  kw.get("with_count", True), False, sm)
        g = plans.setdefault(f"nd {nd} n_ords {kw['n_ords']}", {
            "path": p.path, "grid": p.grid, "threads": p.threads,
            "kernels": p.kernels, "launches": 0})
        g["launches"] += 1
    return plans


def _timed_wraps(Q):
    """Wrap the join builders to clock, on the host, each join's whole
    plan build and, inside it, its inner query's pass: the join's own host
    ms is the difference. Returns (clocks, undo)."""
    clocks = {"join_s": 0.0, "inner_s": 0.0}
    saved = {}

    def wrap(owner, name, key):
        orig = getattr(owner, name)
        saved[(owner, name)] = orig

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                clocks[key] += time.perf_counter() - t
        setattr(owner, name, timed)

    wrap(Q, "_matched_by_relation", "inner_s")
    wrap(Q.HasChildQueryBuilder, "to_plan", "join_s")
    wrap(Q.HasParentQueryBuilder, "to_plan", "join_s")

    def undo():
        for (owner, name), orig in saved.items():
            setattr(owner, name, orig)
    return clocks, undo


def nested_phase(torch, Node, Segment, cuda_kernels, tsc, ssum, knn,
                 queries, shard_arrays, errs, device="cuda"):
    """Phase 18: nested documents and the parent-join field at full width,
    on sonested-2x256k (two of pmc-4x256k's shards; Rally's ``nested`` track: pmc-4x256k's titles as
    StackOverflow questions with ``qid``, ``user``, 1-5 zipf ``tag``s of
    5,000 and ``creationDate``, and 0-8 ``answers`` as nested objects,
    about 0.9M, each with a zipf ``answers.user`` of 200,000 and an
    ``answers.date``) in ``sonested`` (the mesh plane) and ``sonestedh``
    (the host rung), and its join form in ``sojoin`` / ``sojoinh``: the
    same questions segment as ``question`` parents beside a segment a
    shard of the answers as ``answer`` child docs routed by their
    question's qid (about 1.4M docs). Every request runs twice on the
    mesh index (its p50's samples) and once on the host twin, the mesh
    index's answers held against the host twin's (the twin runs first;
    no cpu node copies the corpus: the host rung's 1a and kernel-2
    launches are held against their plain versions as every launch is):

    18a. Rally's randomized nested queries (``term`` answers.user and
         ``range`` answers.date in one object) alone and under a match,
         every score_mode, inner_hits at 3 and 100: p50, plane and
         decision, the node and kernel that scored the inner query, the
         1a launches on the sub-segments.
    18b. nested sorts (answers.date max desc, min asc) under a match:
         ``host`` with ``sort_ineligible``; 10 search_after pages of 100
         equal one 1,000-hit request.
    18c. nested -> date_histogram by month (Rally's nested-date-histo) and
         nested -> terms answers.user -> reverse_nested -> terms tag, under
         a match and over every doc: p50, the fused plane's decision, the
         kernel-2 plans over the sub-segments' user ordinals.
    18d. has_child (term on an answer's user; score_mode none, max, sum;
         min_children 2), has_parent (a match on title, score), parent_id,
         inner_hits on both sides, children -> terms user; ROADMAP C13: a
         has_child and a has_parent whose matches lie outside the first
         shard answer the host rung's answer on both indices. The join's
         own host ms apart from its inner query's.
    18e. 1% of the questions deleted (a nested count drops by exactly
         their objects; it and the nested queries alone equal the host
         twin's), 2 x 4,096 questions appended (a delta append), 18a's
         nested clauses again; after ``DELETE`` ``memory_allocated`` and
         the ledger back to their levels with the sub-segments' scopes
         released.
    18f. 10,000 questions through ``bulk`` (an ``accepted`` nested object
         with a 16-dim vector flattened to the root: kernel 3 through
         include_in_parent), the join form with routing, a legacy
         ``_parent`` index with ``parent``, one malformed doc of each kind
         (a 400 with the JAX package's message); one shard force-merged
         with its nested answers unchanged; a flush and a restart through
         ``Node(data_path=...)`` answering 18a-18d's kinds as before, and
         ``stored_fields=_parent`` over HTTP.
    Every 1a (and tile-form), kernel-2 and kernel-3 launch of the phase's
    main path is held against its plain version. Returns the report."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.common.memory import memory_accountant
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t_phase = time.perf_counter()
    report = {}
    tok = term_token
    shard_arrays = shard_arrays[:SO_SHARDS]
    acct = memory_accountant()

    def level():
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()
        return 0

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    mem0 = level()
    gnode = Node(Settings.EMPTY, device=device)
    names = {"sonested": SO_NESTED_MAPPING, "sojoin": SO_JOIN_MAPPING}
    for node, twins in ((gnode, ("", "h")),):
        for base, mapping in names.items():
            for suffix in twins:
                # the mesh twin: slot headroom for 18e's append, and no
                # background compaction (a merge re-parses the stored
                # sources, which hold no title here)
                extra = ({"search": {"mesh": False}} if suffix else
                         {"search": {"mesh": {"max_slots_per_device": 8}},
                          "staging": {"compact": {"threshold": 0}}})
                node.create_index(base + suffix, {"settings": {
                    "number_of_shards": SO_SHARDS,
                    "refresh_interval": "-1",
                    "requests.cache.enable": False,
                    **extra}, "mappings": mapping})
    t0 = time.perf_counter()
    split = {"arrays": 0.0, "segments": 0.0, "adopt": 0.0}

    def clocked(key, fn, *a, **kw):
        t1 = time.perf_counter()
        out = fn(*a, **kw)
        split[key] += time.perf_counter() - t1
        return out

    def shard_build(sh):
        """A shard's columns, nested form and join answers (numpy over
        the shard's own seed: the shards build on threads at once)."""
        arrays = shard_arrays[sh]
        c = so_columns(sh, len(arrays["doc_ids"]), arrays["doc_ids"])
        return c, so_nested_arrays(arrays, c), so_answer_arrays(c, sh)

    cols, gsegs, gjoin = [], [], []
    # millions of long-lived objects (lists, column arrays): no cycle
    # collection while they are made
    gc.disable()
    try:
        with ThreadPoolExecutor(len(shard_arrays)) as pool:
            built = clocked("arrays", lambda: list(pool.map(
                shard_build, range(len(shard_arrays)))))
        for sh, (c, nested, answers) in enumerate(built):
            cols.append(c)
            for node, dev, segs, jsegs, twins in (
                    (gnode, device, gsegs, gjoin, ("", "h")),):
                seg = clocked("segments", Segment.from_arrays,
                              f"sonested_{sh}_seg_1", device=dev, **nested)
                jseg = clocked("segments", Segment.from_arrays,
                               f"sojoin_{sh}_seg_2", device=dev, **answers)
                for suffix in twins:
                    # the questions segment is both forms' (one staging)
                    for base in ("sonested", "sojoin"):
                        clocked("adopt", node.indices[base + suffix]
                                .shards[sh].engine.adopt_segment, seg)
                    clocked("adopt", node.indices["sojoin" + suffix]
                            .shards[sh].engine.adopt_segment, jseg)
                segs.append(seg)
                jsegs.append(jseg)
    finally:
        gc.enable()
    # the corpus lives to the phase's end: keep the collector off it
    gc.freeze()
    report["build_split_s"] = split
    report["questions"] = sum(c["n"] for c in cols)
    report["answers"] = sum(len(c["parent_of"]) for c in cols)
    report["join_docs"] = sum(s.num_docs for s in gsegs + gjoin)
    report["build_s"] = time.perf_counter() - t0
    log(f"[phase 18] sonested-{SO_SHARDS}x256k: {report['questions']} "
        f"questions, "
        f"{report['answers']} answers as nested objects (mean "
        f"{report['answers'] / report['questions']:.3f}), the join form "
        f"{report['join_docs']} docs; built in {report['build_s']:.1f} s "
        f"({json.dumps({k: round(v, 2) for k, v in split.items()})})")
    # every segment and sub-segment staged before the clocks start (each
    # sub-segment under its own ledger scope)
    t0 = time.perf_counter()
    stage_split = {}
    for label, segs in (("card", gsegs + gjoin),):
        t1 = time.perf_counter()
        for seg in segs:
            seg.device_arrays()
            for nctx in seg.nested.values():
                nctx.segment.device_arrays()
        sync()
        stage_split[label] = time.perf_counter() - t1
    report["stage_s"] = time.perf_counter() - t0
    report["stage_split_s"] = stage_split
    sub_scopes = {s.nested["answers"].segment.ledger_scope for s in gsegs}
    # (the questions segment is adopted by the four indices: the ledger
    # names the one whose engine stamped it last)
    scopes = {k[1] for k in acct._entries if k[0] in (
        "sonested", "sonestedh", "sojoin", "sojoinh")}
    check(sub_scopes <= scopes, "phase 18: each answers sub-segment staged "
                                "under its own ledger scope of an index")
    report["sub_segment_bytes"] = sum(
        s.nested["answers"].segment.staged_bytes() for s in gsegs)
    log(f"[phase 18] staged in {report['stage_s']:.1f} s "
        f"({json.dumps({k: round(v, 2) for k, v in stage_split.items()})}); "
        f"the answers "
        f"sub-segments hold {report['sub_segment_bytes']} bytes on the "
        f"card")

    def match(q):
        return {"match": {"title": " ".join(tok(t) for t in q)}}

    # answerers by rank: a common one and a middling one
    users = [SO_USER_TERMS[r] for r in (40, 300)]
    d0 = 1_325_376_000_000  # 2012-01-01

    def nested_user(u, **kw):
        return {"nested": {"path": "answers", **kw, "query": {"bool": {
            "must": [{"term": {"answers.user": u}}],
            "filter": [{"range": {"answers.date": {"gte": d0}}}]}}}}

    samples, planes, decisions, forms = {}, {}, {}, {}
    ref_cache = {}
    ms_nested = gnode.indices["sonested"]._mesh_plane()
    ms_join = gnode.indices["sojoin"]._mesh_plane()

    def ref_key(index, body):
        return (index, json.dumps(body, sort_keys=True))

    def host_answer(index, body):
        """The reference: the card's host-rung twin's answer (the twin's
        timed one where ``both`` ran it)."""
        key = ref_key(index, body)
        if key not in ref_cache:
            ref_cache[key] = gnode.search(index + "h", dict(body))
            check(ref_cache[key]["_plane"] == "host",
                  f"phase 18: the host twin answers on its host rung "
                  f"({ref_cache[key]['_plane']})")
        return ref_cache[key]

    def timed(index, body, kind):
        """One request on the card node, timed; the first of a kind and
        index records its plane, launches and ladder decisions."""
        base = index.rstrip("h")
        ms = ms_nested if base == "sonested" else ms_join
        before = dict(cuda_kernels.LAUNCHES)
        dec = dict(ms.decisions)
        fb = dict(ms.agg_host_fallback_by_reason)
        t1 = time.perf_counter()
        r = gnode.search(index, dict(body))
        sync()
        samples.setdefault((kind, index), []).append(
            (time.perf_counter() - t1) * 1000)
        if (kind, index) in planes:
            return r
        forms[(kind, index)] = {k: v - before.get(k, 0) for k, v in
                                cuda_kernels.LAUNCHES.items()
                                if v != before.get(k, 0)}
        if not index.endswith("h"):
            decisions[kind] = {
                **{k: v - dec.get(k, 0) for k, v in ms.decisions.items()
                   if v != dec.get(k, 0)},
                **{f"agg_fallback.{k}": v - fb.get(k, 0) for k, v in
                   ms.agg_host_fallback_by_reason.items()
                   if v != fb.get(k, 0)}}
        planes[(kind, index)] = r["_plane"]
        return r

    def both(base, body, kind, sorted_=False, reps=SO_REPS, twin=True):
        """Once on the host twin (``twin``: the reference), then ``reps``
        times on the mesh index (the p50's samples), held against the host
        twin's answer."""
        out = {}
        for index in (base + "h", base) if twin else (base,):
            gr = timed(index, body, kind)
            for _ in range(reps - 1 if index == base else 0):
                timed(index, body, kind)
            if index != base:
                ref_cache[ref_key(base, body)] = gr
            cr = host_answer(base, body)
            what = f"phase 18 {kind} on {index}"
            if sorted_:
                same_sorted(dict(gr, _plane="host"), cr, what)
            else:
                same_response(gr, cr, what)
            same_inner_hits(gr, cr, what)
            check(index == base or gr["_plane"] == "host",
                  f"{what}: the host twin answers on the host rung")
            out[index] = gr
        return out

    bodies = {}
    clocks, undo = _timed_wraps(Q)
    dec0 = dict(ms_nested.decisions)
    cuda_kernels.reset_launch_counts()
    t_main = time.perf_counter()
    sub_s = {}
    sub = ["18a"]

    def mark(name):
        now = time.perf_counter()
        sub_s[sub[0]] = now - sub_s.pop("_t", t_main)
        sub_s["_t"] = now
        sub[0] = name

    sub_kdocs = _kernel_table_ptrs(s.nested["answers"].segment
                                   for s in gsegs)
    try:
        with recording_recovered_path(tsc, ssum, knn) as kept:
            # ---- 18a ----
            for i, u in enumerate(users):
                bodies[f"nested_alone_{i}"] = ("sonested", {
                    "query": nested_user(u), "size": 10})
                bodies[f"nested_under_match_{i}"] = ("sonested", {
                    "query": {"bool": {"must": [match(queries[i])],
                                       "should": [nested_user(u)]}},
                    "size": 10})
            # avg, the default, is nested_alone_0's
            for mode in ("sum", "min", "max", "none"):
                # "none" scores every hit 0: the size takes them all, so no
                # tie is cut where the planes order ties apart
                bodies[f"nested_score_{mode}"] = ("sonested", {
                    "query": nested_user(users[0], score_mode=mode),
                    "size": 5000 if mode == "none" else 10})
            bodies["nested_inner_hits_3"] = ("sonested", {
                "query": nested_user(users[1], inner_hits={}), "size": 10})
            bodies["nested_inner_hits_100"] = ("sonested", {
                "query": nested_user(users[0], inner_hits={"size": 100}),
                "size": 10})
            for kind, (base, body) in bodies.items():
                both(base, body, kind)
            a_kinds = list(bodies)
            n_sub = sum(1 for args, _kw, _o in kept[0]
                        if args[0].data_ptr() in sub_kdocs)
            report["sub_segment_1a_launches"] = n_sub
            nseg0 = gsegs[0].nested["answers"].segment
            inner = Q.parse_query(nested_user(users[0])["nested"]["query"])
            node0 = inner.to_plan(Q.ShardQueryContext(
                gnode.indices["sonested"].mapper_service), nseg0)

            def tree(nd):
                kids = [tree(k) for k in nd.children()]
                return type(nd).__name__ + (f"({', '.join(kids)})"
                                            if kids else "")
            report["inner_plan"] = tree(node0)
            report["inner_kernel"] = ("1a (tile_scoring)" if "Pallas" in
                                      report["inner_plan"] else "scatter")
            n_objs, nd_objs = nseg0.num_docs, nseg0.nd_pad
            del node0, nseg0  # it holds the sub-segment's tables
            log(f"[phase 18a] the inner query on a sub-segment "
                f"({n_objs} objects, nd_pad {nd_objs}): "
                f"{report['inner_plan']} -> {report['inner_kernel']}; "
                f"{n_sub} 1a launches on the sub-segments")
            check(n_sub > 0 or device != "cuda",
                  "phase 18a: the inner query launched 1a on the "
                  "sub-segments")
            for i in range(len(users)):
                p_alone = planes[(f"nested_alone_{i}", "sonested")]
                p_match = planes[(f"nested_under_match_{i}", "sonested")]
                check(p_alone in ("mesh", "host")
                      and p_match in ("mesh_pallas", "host"),
                      f"phase 18a user {i}: planes {p_alone} / {p_match}")
            # ---- 18b ----
            mark("18b")
            for kind, spec in (
                    ("sort_max_desc", {"order": "desc", "mode": "max",
                                       "nested_path": "answers"}),
                    ("sort_min_asc", {"order": "asc", "mode": "min",
                                      "nested": {"path": "answers"}})):
                body = {"query": match(queries[1]),
                        "sort": [{"answers.date": spec}], "size": 10}
                bodies[kind] = ("sonested", body)
                out = both("sonested", body, kind, sorted_=True)
                check(out["sonested"]["_plane"] == "host"
                      and decisions[kind].get("host.sort_ineligible") == 1,
                      f"phase 18b {kind}: host with sort_ineligible "
                      f"({out['sonested']['_plane']}, {decisions[kind]})")
            walk = {"query": match(queries[1]), "sort": [
                {"answers.date": {"order": "desc",
                                  "nested_path": "answers"}},
                {"qid": "asc"}]}
            whole = gnode.search("sonested", dict(
                walk, size=SO_PAGE * SO_PAGES))
            pages, after = [], None
            for _ in range(SO_PAGES):
                body = dict(walk, size=SO_PAGE)
                if after is not None:
                    body["search_after"] = after
                page = gnode.search("sonested", body)["hits"]["hits"]
                if not page:
                    break
                pages.extend(page)
                after = page[-1]["sort"]
            check([(h["_id"], h["sort"]) for h in pages]
                  == [(h["_id"], h["sort"]) for h in whole["hits"]["hits"]],
                  "phase 18b: 10 search_after pages of 100 equal one "
                  "1,000-hit request, hit for hit")
            report["walk_hits"] = len(pages)
            # ---- 18c ----
            mark("18c")
            histo = {"a": {"nested": {"path": "answers"}, "aggs": {
                "m": {"date_histogram": {"field": "answers.date",
                                         "interval": "month"}}}}}
            rev = {"a": {"nested": {"path": "answers"}, "aggs": {
                "u": {"terms": {"field": "answers.user", "size": 10},
                      "aggs": {"r": {"reverse_nested": {}, "aggs": {
                          "t": {"terms": {"field": "tag",
                                          "size": 10}}}}}}}}}
            for name, aggs in (("nested_histo", histo),
                               ("nested_terms_reverse", rev)):
                for scope, q in (("match", match(queries[2])),
                                 ("all", {"match_all": {}})):
                    kind = f"{name}_{scope}"
                    body = {"size": 0, "query": q, "aggs": aggs}
                    bodies[kind] = ("sonested", body)
                    both("sonested", body, kind)
                    check(decisions[kind].get(
                        "agg_fallback.unsupported_agg") == 1,
                        f"phase 18c {kind}: the fused plane declines with "
                        f"unsupported_agg ({decisions[kind]})")
            # ---- 18d ----
            mark("18d")
            for mode in ("none", "max", "sum"):
                bodies[f"has_child_{mode}"] = ("sojoin", {"query": {
                    "has_child": {"type": "answer", "score_mode": mode,
                                  "query": {"term": {"user": users[1]}}}},
                    "size": 10})
            bodies["has_child_min2_inner_hits"] = ("sojoin", {"query": {
                "has_child": {"type": "answer", "score_mode": "sum",
                              "min_children": 2,
                              "query": {"term": {"user": users[0]}},
                              "inner_hits": {"size": 3}}}, "size": 10})
            bodies["has_parent_score_inner_hits"] = ("sojoin", {"query": {
                "has_parent": {"parent_type": "question", "score": True,
                               "query": match(queries[3]),
                               "inner_hits": {}}}, "size": 10})
            with_answers = int(np.flatnonzero(cols[1]["k"] > 2)[0])
            bodies["parent_id"] = ("sojoin", {"query": {"parent_id": {
                "type": "answer", "id": cols[1]["ids"][with_answers]}},
                "size": 10})
            bodies["children_terms"] = ("sojoin", {
                "size": 0, "query": match(queries[4]),
                "aggs": {"c": {"children": {"type": "answer"}, "aggs": {
                    "u": {"terms": {"field": "user", "size": 10}}}}}})
            # C13: a user who answers only outside the first shard, a
            # title term only outside it
            per_shard = [np.bincount(c["auser"], minlength=SO_USERS) > 0
                         for c in cols]
            outside = np.flatnonzero(~per_shard[0] & np.logical_or.reduce(
                per_shard[1:]))
            c13_user = SO_USER_TERMS[int(outside[0])]
            c13_qids = [cols[-1]["ids"][5], cols[-1]["ids"][9]]
            bodies["c13_has_child"] = ("sojoin", {"query": {"has_child": {
                "type": "answer", "query": {"term": {"user": c13_user}}}}})
            bodies["c13_has_parent"] = ("sojoin", {"query": {"has_parent": {
                "parent_type": "question",
                "query": {"terms": {"qid": c13_qids}}}}})
            for kind in [k for k in bodies if bodies[k][0] == "sojoin"]:
                out = both("sojoin", bodies[kind][1], kind)
                if kind.startswith("c13"):
                    want = host_answer("sojoin", bodies[kind][1])
                    check(want["hits"]["total"] > 0 and all(
                        r["hits"]["total"] == want["hits"]["total"]
                        for r in out.values()),
                        f"phase 18d {kind}: both indices return the host "
                        f"rung's answer ({want['hits']['total']} hits; "
                        f"planes {[r['_plane'] for r in out.values()]})")
            report["c13"] = {k: {"planes": [planes[(k, i)] for i in (
                "sojoin", "sojoinh")], "total": host_answer(
                "sojoin", bodies[k][1])["hits"]["total"]}
                for k in ("c13_has_child", "c13_has_parent")}
            log(f"[phase 18d] C13 (matches only outside shard 0): "
                f"{json.dumps(report['c13'])}")
            # ---- 18e ----
            mark("18e")
            count_body = {"size": 0, "aggs": {"a": {"nested": {
                "path": "answers"}}}}
            count_kind = "nested_count"
            before = {i: gnode.search(i, dict(count_body))["aggregations"][
                "a"]["doc_count"] for i in ("sonested", "sonestedh")}
            routing = _routing_for_shards(SO_SHARDS)
            dropped = 0
            n_deleted = 0
            for sh, c in enumerate(cols):
                for i in range(0, c["n"], 100):
                    dropped += int(c["k"][i])
                    n_deleted += 1
                    for index in ("sonested", "sonestedh"):
                        gnode.delete_doc(index, c["ids"][i],
                                         routing=routing[sh])
            tomb0 = ms_nested.tombstone_update_total
            for index in ("sonested", "sonestedh"):
                gnode.refresh(index)
            ref_cache.clear()
            for i in ("sonested", "sonestedh"):
                after_n = gnode.search(i, dict(count_body))["aggregations"][
                    "a"]["doc_count"]
                check(before[i] - after_n == dropped,
                      f"phase 18e {i}: the nested count dropped by exactly "
                      f"the deleted questions' objects ({before[i]} -> "
                      f"{after_n}, want -{dropped})")
            for kind in [count_kind] + [k for k in a_kinds
                                        if k.startswith("nested_alone")]:
                both("sonested", bodies.get(kind, ("", count_body))[1],
                     kind + "_after_delete", reps=1, twin=False)
            report["deleted"] = {"questions": n_deleted, "objects": dropped,
                                 "tombstone_updates":
                                     ms_nested.tombstone_update_total - tomb0}
            delta0 = ms_nested.delta_restage_total
            appended = []
            for sh in range(SO_SHARDS):
                corpus = build_synthetic_corpus(SO_SEEDS[sh] + 200,
                                                SO_APPEND)
                arrays = corpus_segment_arrays(corpus, id_prefix=f"s{sh}n")
                c = so_columns(sh, SO_APPEND, arrays["doc_ids"],
                               seed=SO_SEEDS[sh] + 200)
                nested = so_nested_arrays(arrays, c)
                seg = Segment.from_arrays(f"sonested_{sh}_seg_2",
                                          device=device, **nested)
                for suffix in ("", "h"):
                    gnode.indices["sonested" + suffix].shards[sh] \
                        .engine.adopt_segment(seg)
                appended.append(len(c["parent_of"]))
            ref_cache.clear()
            for kind in a_kinds:
                if "under_match" not in kind:
                    both("sonested", bodies[kind][1], kind + "_after_append",
                         reps=1, twin=False)
            report["appended"] = {"questions": SO_SHARDS * SO_APPEND,
                                  "objects": sum(appended),
                                  "delta_appends":
                                      ms_nested.delta_restage_total - delta0}
            check(device != "cuda"
                  or ms_nested.delta_restage_total > delta0,
                  "phase 18e: the appended segments staged as a delta "
                  "append")
            log(f"[phase 18e] {json.dumps(report['deleted'])}; appended "
                f"{json.dumps(report['appended'])}")
            # ---- 18f ----
            mark("18f")
            report["ingest"] = nested_ingest_phase(
                torch, Node, Segment, device, bodies)
            mark("end")
    finally:
        undo()
    sync()
    report["main_s"] = time.perf_counter() - t_main
    sub_s.pop("_t", None)
    report["subphase_s"] = sub_s
    report["join_host_ms"] = (clocks["join_s"] - clocks["inner_s"]) * 1000
    report["join_inner_ms"] = clocks["inner_s"] * 1000
    log(f"[phase 18] main path by subphase (s): {json.dumps(sub_s)}; host "
        f"clock over the main path: the joins' own work "
        f"{report['join_host_ms']:.1f} ms beside their inner queries' "
        f"{report['join_inner_ms']:.1f}")
    p18 = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    log(f"[phase 18] kernel launches: {p18}")
    t0 = time.perf_counter()
    if device == "cuda":
        held, _here = hold_recovered_path(torch, tsc, ssum, knn, kept, p18,
                                          errs, "phase 18")
    else:
        held = {}
    plans = (_gather_plans(torch, ssum, kept[1], 10_000)
             if device == "cuda" else {})
    report["user_ordinal_plans"] = plans
    log(f"[phase 18c] kernel-2 plans over 10,000 ordinals or more (the "
        f"users present in a sub-segment or a join segment, of 200,000): "
        f"{json.dumps(plans)}")
    del kept
    report["hold_s"] = time.perf_counter() - t0
    if device == "cuda":
        for k in ("tile_scoring", "segment_sum", "knn_scoring"):
            check(p18.get(k, 0) > 0, f"phase 18 launched {k}")
    # p50s: the main path's SO_REPS samples of each kind (before 18e's
    # deletes and append; their own samples under their own kinds)
    t0 = time.perf_counter()
    p50 = {}
    for kind, (base, body) in bodies.items():
        row = {}
        for index in (base, base + "h"):
            row[index] = {"p50_ms": float(np.median(samples[(kind, index)])),
                          "plane": planes.get((kind, index)),
                          "launches": forms.get((kind, index), {})}
        row["decisions"] = decisions.get(kind, {})
        p50[kind] = row
        log(f"[phase 18] {kind}: " + json.dumps(row))
    report["time_s"] = time.perf_counter() - t0
    fails = plane_failures(*(gnode.indices[i] for i in (
        "sonested", "sonestedh", "sojoin", "sojoinh")))
    check(not any(fails), f"phase 18 zero plane faults (got {fails})")
    log(f"[phase 18] ladder on sonested: " + json.dumps(
        {k: v - dec0.get(k, 0) for k, v in ms_nested.decisions.items()
         if v != dec0.get(k, 0)}))
    # DELETE: the card's memory and the ledger come back, the answers
    # sub-segments' scopes with them
    for name in list(gnode.indices):
        gnode.delete_index(name)
    gnode.close()
    del gsegs, gjoin, gnode, ms_nested, ms_join
    gc.unfreeze()
    mem1 = level()
    left = [k for k in acct._entries if k[0] in (
        "sonested", "sonestedh", "sojoin", "sojoinh")]
    check(not left, f"phase 18e: the ledger released every scope of the "
                    f"deleted indices ({len(left)} entries left)")
    check(device != "cuda" or mem1 == mem0,
          f"phase 18e: memory_allocated back to its level after DELETE "
          f"({mem1} against {mem0})")
    if device == "cuda" and mem1 != mem0:
        # what still holds the card's memory: each live tensor and the
        # types that refer to it
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                refs = sorted({type(r).__name__
                               for r in gc.get_referrers(obj)})[:6]
                log(f"[phase 18e] left on the card: {tuple(obj.shape)} "
                    f"{obj.dtype} {obj.numel() * obj.element_size()} "
                    f"bytes, held by {refs}")
    report["memory"] = {"before": mem0, "after_delete": mem1}
    report.update(p50=p50, launches=p18, held=held)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 18] {report['seconds']:.1f} s (build {report['build_s']:.1f}"
        f", staging {report['stage_s']:.1f}, main path "
        f"{report['main_s']:.1f}, hold {report['hold_s']:.1f}, timing "
        f"{report['time_s']:.1f})")
    return report


def nested_ingest_phase(torch, Node, Segment, device, bodies):
    """18f: sonested questions, its join form and a legacy ``_parent``
    index through ``bulk`` into a ``Node(data_path=...)``; the malformed
    docs; a force merge of one shard; a flush, a restart, 18a-18d's kinds
    and ``stored_fields=_parent`` over HTTP answered as before."""
    from elasticsearch_tpu_torch.rest.http_server import HttpServer

    out = {}
    tmp = tempfile.mkdtemp(prefix="nested18f_")
    nested_map = json.loads(json.dumps(SO_NESTED_MAPPING))
    nested_map["_doc"]["properties"]["accepted"] = {
        "type": "nested", "include_in_parent": True, "properties": {
            "emb": {"type": "dense_vector", "dims": SO_EMB_DIMS}}}
    try:
        node = Node(data_path=tmp, device=device)
        async_tl = {"index": {"translog": {"durability": "async"}}}
        for name, mapping in (("soi", nested_map),
                              ("soj", SO_JOIN_MAPPING)):
            node.create_index(name, {"settings": {
                "number_of_shards": 4, "refresh_interval": "-1",
                "requests.cache.enable": False,
                **async_tl}, "mappings": mapping})
        node.create_index("sop", {"settings": {"number_of_shards": 4,
                                               "refresh_interval": "-1",
                                               "requests.cache.enable": False,
                                               **async_tl},
                                  "mappings": {"answer": {
                                      "_parent": {"type": "question"},
                                      "properties": {
                                          "user": {"type": "keyword"}}}}})
        docs, c = so_bulk_sources(SO_BULK, SO_SEEDS[0] + 300, "b")
        ops = [("index", {"_index": "soi", "_id": i}, s) for i, s in docs]
        for i, s in docs[:SO_JOIN_BULK]:
            q = {k: v for k, v in s.items() if k not in ("answers",
                                                         "accepted")}
            ops.append(("index", {"_index": "soj", "_id": i},
                        {**q, "qa": "question"}))
            for j, a in enumerate(s.get("answers", [])):
                ops.append(("index", {"_index": "soj", "_id": f"{i}a{j}",
                                      "routing": i},
                            {"qa": {"name": "answer", "parent": i},
                             "user": a["user"], "date": a["date"]}))
        for j in range(SO_PARENT_BULK):
            ops.append(("index", {"_index": "sop", "_id": f"c{j}",
                                  "parent": f"q{j % 50}"},
                        {"user": SO_USER_TERMS[j]}))
        for j, (index, src, routing, _t, _m) in enumerate(SO_BAD_DOCS):
            meta = {"_index": index, "_id": f"bad{j}"}
            if routing is not None:
                meta["routing"] = routing
            ops.append(("index", meta, src))
        t0 = time.perf_counter()
        r = node.bulk(ops)
        for name in ("soi", "soj", "sop"):
            node.refresh(name)
        if device == "cuda":
            torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        good = len(ops) - len(SO_BAD_DOCS)
        out["docs_per_s"] = good / out["ingest_s"]
        items = [next(iter(it.values())) for it in r["items"]]
        check(all(it["status"] in (200, 201) for it in items[:good]),
              f"phase 18f: every well-formed doc indexed "
              f"({sum(it['status'] in (200, 201) for it in items[:good])} "
              f"of {good})")
        for it, (index, src, _r, etype, msg) in zip(items[good:],
                                                    SO_BAD_DOCS):
            err = it.get("error") or {}
            check(it["status"] == 400 and err.get("type") == etype
                  and err.get("reason") == msg,
                  f"phase 18f: {json.dumps(src)} into {index} is a 400 "
                  f"with the JAX message ({it['status']}, "
                  f"{err.get('reason')!r})")
        log(f"[phase 18f] bulk {good} docs ({SO_BULK} nested questions, "
            f"the join form of {SO_JOIN_BULK}, {SO_PARENT_BULK} _parent "
            f"children) + {len(SO_BAD_DOCS)} malformed in "
            f"{out['ingest_s']:.1f} s: {out['docs_per_s']:.0f} docs/s")
        # the kinds of 18a-18d, on these indices
        users = sorted(SO_USER_TERMS[int(u)] for u in c["auser"][:3])
        kinds = {
            "nested": ("soi", {"query": {"nested": {
                "path": "answers", "query": {"term": {
                    "answers.user": users[0]}}, "inner_hits": {}}},
                "size": 10}),
            "nested_sort": ("soi", {"query": {"match_all": {}}, "sort": [
                {"answers.date": {"order": "desc"}}, {"qid": "asc"}],
                "size": 20}),
            "nested_aggs": ("soi", {"size": 0, "aggs": bodies[
                "nested_terms_reverse_all"][1]["aggs"]}),
            "knn_include_in_parent": ("soi", {"knn": {
                "field": "accepted.emb",
                "query_vector": [1.0] * SO_EMB_DIMS, "k": 10}}),
            "has_child": ("soj", {"query": {"has_child": {
                "type": "answer", "score_mode": "max",
                "query": {"term": {"user": users[1]}}}}}),
            "has_parent": ("soj", {"query": {"has_parent": {
                "parent_type": "question", "score": True,
                "query": {"match": {"title": term_token(3)}}}},
                "size": 10}),
            "parent_id": ("soj", {"query": {"parent_id": {
                "type": "answer", "id": docs[int(np.flatnonzero(
                    c["k"][:SO_JOIN_BULK] > 0)[0])][0]}}}),
            "children": ("soj", {"size": 0, "aggs": {"c": {
                "children": {"type": "answer"}, "aggs": {"u": {
                    "terms": {"field": "user", "size": 5}}}}}}),
        }

        def answers(n):
            return {k: _no_took(n.search(i, dict(b)))
                    for k, (i, b) in kinds.items()}

        before = answers(node)
        check(all(json.loads(before[k])["hits"]["total"] > 0 for k in (
            "nested", "knn_include_in_parent", "has_child", "has_parent",
            "parent_id")), "phase 18f: the ingested indices answer")
        # a cpu node's host rung over the same segments
        t0 = time.perf_counter()
        cnode = Node(device="cpu")
        for name, mapping in (("soi", nested_map), ("soj", SO_JOIN_MAPPING)):
            cnode.create_index(name, {"settings": {
                "number_of_shards": 4, "refresh_interval": "-1",
                "requests.cache.enable": False,
                "search": {"mesh": False}},
                "mappings": mapping})
            _adopt_copies(node, cnode, name, Segment)
        for k, (i, b) in kinds.items():
            gr, cr = node.search(i, dict(b)), cnode.search(i, dict(b))
            if k == "knn_include_in_parent":
                same_knn_response(gr, cr, 1e-4, f"phase 18f {k}")
            elif "sort" in b:
                same_sorted(dict(gr, _plane="host"), cr, f"phase 18f {k}")
            else:
                same_response(gr, cr, f"phase 18f {k}")
                same_inner_hits(gr, cr, f"phase 18f {k}")
        cnode.close()
        out["cpu_twin_s"] = time.perf_counter() - t0
        # one shard force-merged: the nested answers unchanged
        nested_kinds = [k for k, (i, _b) in kinds.items() if i == "soi"
                        and k != "knn_include_in_parent"]
        svc = node.indices["soi"]
        node.index_doc("soi", "extra", docs[0][1])
        node.refresh("soi")
        node.delete_doc("soi", "extra")
        node.refresh("soi")
        segs_before = len(svc.shards[svc._route("extra")].engine.segments)
        t0 = time.perf_counter()
        svc.shards[svc._route("extra")].force_merge()
        out["force_merge_s"] = time.perf_counter() - t0
        merged = answers(node)
        check(all(merged[k] == before[k] for k in nested_kinds),
              f"phase 18f: a force-merged shard ({segs_before} segments -> "
              f"1) answers the nested kinds unchanged")
        t0 = time.perf_counter()
        for name in ("soi", "soj", "sop"):
            node.flush(name)
        node.close()
        out["flush_close_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        node = cold_reopen(Node, tmp, device)
        out["reopen_s"] = time.perf_counter() - t0
        after = answers(node)
        check(after == merged, "phase 18f: the reopened node answers every "
                               "kind as before the restart (the nested and "
                               "_parent store round trip)")
        srv = HttpServer(node, port=0)
        srv.start()
        try:
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=60)
            conn.request("GET", "/sop/answer/c7?stored_fields=_parent"
                                "&parent=q7")
            resp = conn.getresponse()
            got = json.loads(resp.read())
            conn.close()
        finally:
            srv.stop()
        check(resp.status == 200 and got.get("_parent") == "q7",
              f"phase 18f: stored_fields=_parent after the restart "
              f"({resp.status}, {got.get('_parent')!r})")
        out["kinds"] = len(kinds)
        log(f"[phase 18f] force merge {out['force_merge_s']:.1f} s; flush "
            f"and close {out['flush_close_s']:.1f} s, reopen "
            f"{out['reopen_s']:.1f} s; {len(kinds)} kinds equal after the "
            f"restart; _parent over HTTP {got.get('_parent')!r}")
        node.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# Phase 21: cluster metadata on the card
# ----------------------------------------------------------------------

# 21d: wait_for writes at each refresh interval
WAIT_FOR_WRITES = 3
# 21e: the small durable node's packed index (docs whose terms cluster by
# position, so tile bounds differ and pruning fires)
SMALL_DOCS = 2000


def small_prune_docs(n, seed=3):
    """Docs over a 20-term vocabulary that drifts with the doc position,
    a few terms repeated: block-max bounds differ between tiles."""
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(20)]
    out = []
    for d in range(n):
        base = (d * len(vocab)) // n
        toks = [vocab[(base + int(rng.zipf(2.0)) - 1) % len(vocab)]
                for _ in range(rng.randint(3, 12))]
        out.append((str(d), {"body": " ".join(toks), "n": d}))
    return out


def cluster_metadata_phase(torch, Node, HttpServer, cuda_kernels, tsc, ssum,
                           knn, g7, pk_segs, dv_segs, dv_mapping, queries,
                           knn_body, errs, smi, device="cuda"):
    """Phase 21: cluster metadata on the card, over indices earlier phases
    built (no corpus is built): phase 7's node (pmc4, its host twin pmc4h
    and the kNN vectors), phase 12's doc-values segments (pmc-4x256k with
    ``ts``, ``citations`` and ``venue``, adopted again), and phase 10's
    packed segments (``pk_segs``: each shard's list) under a packed index.
    Every request goes over REST through an ``HttpServer`` on the card's
    node.

    21a. ``PUT _template/logs`` (``logs-*``: 4 shards, a mesh with slot
         headroom, the doc-values mapping, an alias ``logs``); logs-a and
         logs-b (``search.mesh: false``, phase 19's log pattern, 2,097,152
         docs) made before it, logs-c through it. ``POST _aliases`` adds
         ``logs`` to logs-a and logs-b and ``kibana`` to logs-c. A match
         with a ``terms`` through ``logs``, ``logs-*`` and the three names
         gives the same hits, totals and buckets; through ``kibana`` it
         runs on logs-c's ``mesh_pallas`` and equals logs-c by name and
         logs-a's host rung (the same segments). A filtered alias answers
         as the index does (ROADMAP C19). ``_cat/aliases``,
         ``_cat/templates``, ``GET _alias/logs``.
    21b. ``PUT _scripts/q`` (a mustache match); ``_search/template`` by
         id and inline through ``kibana`` equal the plain body's answer;
         ``_render/template`` renders the plain body.
    21c. Dynamic cluster settings, each set transient then cleared:
         ``search.pallas.pruning.enabled`` on pk4 (phase 10's packed
         segments, their tables staged): 1e packed launches, the top 10 equal
         the exhaustive ones, and clearing stops them;
         ``search.aggs.fused: false`` on logs-c: the host reduce (reason
         ``disabled``, kernel 2's gather form), cleared the fused mask
         form; ``search.knn.enabled: false`` on pmc4: the host rung,
         cleared kernel 3 on the mesh; ``search.memory.hbm_budget_bytes``
         1b: logs-c demotes to the host rung with the same hits,
         ``_nodes/stats`` shows the budget and the evictions, cleared the
         mesh serves again. ``_cluster/settings`` and ``_cluster/state``
         show each value while set.
    21d. logs-c's ``index.refresh_interval`` 1s, then writes with
         ``refresh=wait_for``: each visible to the next search with no
         explicit refresh, the first answer through the delta append;
         then -1, where ``wait_for`` forces a refresh. ``_close`` of
         logs-b: ``logs-*`` skips it, by name it is a 400; ``_open`` brings
         back the same answers. ``PUT _mapping`` adds a field. ``_stats``
         on logs-a and logs-b, ``_segments``, ``_cat/shards`` and
         ``_cat/segments``: doc counts equal the engines'.
    21e. A small durable node: a template, persistent settings (pruning
         on, 2 probe tiles), a stored script and an alias survive a close
         and a reopen, and the reopened node's pruned request launches 1e
         packed.

    Every answer is sound and every launch of the main path is held
    against its plain version. Prints each item's p50 on the card, its
    plane and its launches, and the ms from a settings change to the
    changed answer, the ``wait_for`` p50s and the ``_stats`` ms.
    Returns the report."""
    import shutil
    import tempfile

    from elasticsearch_tpu_torch.common.memory import memory_accountant

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    report = {"items": {}}
    tok = term_token
    srv = HttpServer(g7, port=0)
    srv.start()
    client = HttpClient(srv.port)

    def call(method, path, body=None, want=200,
             ctype="application/json"):
        st, r = client.call(method, path, body, ctype)
        check(st == want, f"21: {method} {path} answered {st} (want {want}: "
                          f"{str(r)[:300]})")
        return r

    def item(name, fn, reps=1):
        """``fn`` ``reps`` times, synced: its p50, the plane of its answer
        and the launches of its first run."""
        before = dict(cuda_kernels.LAUNCHES)
        xs, out, launched = [], None, {}
        for i in range(reps):
            t0 = time.perf_counter()
            r = fn()
            if on_card:
                torch.cuda.synchronize()
            xs.append((time.perf_counter() - t0) * 1000)
            if i == 0:
                out = r
                launched = {k: v - before.get(k, 0) for k, v in
                            cuda_kernels.LAUNCHES.items()
                            if v != before.get(k, 0)}
        plane = (out.get("_plane", "host fan-out")
                 if isinstance(out, dict) and "hits" in out else None)
        row = {"p50_ms": float(np.median(xs)), "samples": len(xs),
               "plane": plane, "launches": launched}
        report["items"][name] = row
        log(f"[phase 21] {name}: {json.dumps(row)} ({smi})")
        return out

    def search(expr, body, name=None, reps=1):
        fn = lambda: call("POST", f"/{expr}/_search", body)  # noqa: E731
        return item(name, fn, reps) if name else fn()

    def keys(r):
        return [(h["_index"], h["_id"], h["_score"]) for h in
                r["hits"]["hits"]]

    def transient(values):
        return call("PUT", "/_cluster/settings", {"transient": values})

    def committed():
        return call("GET", "/_cluster/settings")["transient"]

    match = {"match": {"title": " ".join(tok(t) for t in queries[1])}}
    body_mt = {"query": match, "size": 10,
               "aggs": {"v": {"terms": {"field": "venue", "size": 10}}}}
    body_agg = {"size": 0, "query": match,
                "aggs": {"v": {"terms": {"field": "venue", "size": 10}}}}
    cuda_kernels.reset_launch_counts()
    t_main = time.perf_counter()
    with recording_recovered_path(tsc, ssum, knn) as kept:
        # ---- 21a: aliases and templates ------------------------------
        for name in ("logs-a", "logs-b"):
            call("PUT", f"/{name}", {"settings": {
                "number_of_shards": 4, "refresh_interval": "-1",
                "requests.cache.enable": False,
                "search": {"mesh": False}}, "mappings": dv_mapping})
        call("PUT", "/_template/logs", {
            "index_patterns": ["logs-*"], "order": 1,
            "settings": {"number_of_shards": 4, "refresh_interval": "-1",
                         "requests.cache.enable": False,
                         # headroom for 21d's appended segments; no
                         # compaction (a merge re-parses the stored
                         # sources, which hold no title here)
                         "search": {"mesh": {"max_slots_per_device": 8}},
                         "staging": {"compact": {"threshold": 0}}},
            "mappings": dv_mapping, "aliases": {"logs": {}}})
        call("PUT", "/logs-c")
        for name in ("logs-a", "logs-b", "logs-c"):
            for sh, seg in enumerate(dv_segs):
                g7.indices[name].shards[sh].engine.adopt_segment(seg)
        report["logs_docs"] = 3 * sum(s.live_doc_count for s in dv_segs)
        call("POST", "/_aliases", {"actions": [
            {"add": {"indices": ["logs-a", "logs-b"], "alias": "logs"}},
            {"add": {"index": "logs-c", "alias": "kibana"}},
            {"add": {"index": "logs-c", "alias": "v1",
                     "filter": {"term": {"venue": "v0001"}},
                     "search_routing": "1"}}]})
        md = g7.cluster_service.state.indices["logs-c"]
        check(md.settings.get_int("index.search.mesh.max_slots_per_device")
              == 8 and set(md.aliases) == {"logs", "kibana", "v1"},
              f"21a: logs-c took the template's settings and alias "
              f"({sorted(md.aliases)})")
        by_alias = search("logs", body_mt, "21a match+terms through logs "
                                           "(3 indices)", reps=3)
        by_glob = search("logs-*", body_mt, "21a match+terms through logs-*")
        by_names = search("logs-a,logs-b,logs-c", body_mt,
                          "21a match+terms by the three names", reps=3)
        check(keys(by_alias) == keys(by_glob) == keys(by_names)
              and by_alias["hits"]["total"] == by_glob["hits"]["total"]
              == by_names["hits"]["total"]
              and by_alias["aggregations"] == by_glob["aggregations"]
              == by_names["aggregations"]
              and by_alias["_shards"]["total"] == 12,
              "21a: logs, logs-* and the three names give the same hits, "
              "totals and buckets")
        kib = search("kibana", body_mt, "21a match+terms through kibana "
                                        "(logs-c)", reps=3)
        by_c = search("logs-c", body_mt, "21a match+terms on logs-c by "
                                         "name", reps=3)
        host_a = search("logs-a", body_mt, "21a match+terms on logs-a "
                                           "(host rung)")
        check(kib.get("_plane") == by_c.get("_plane") == "mesh_pallas"
              and keys(kib) == keys(by_c),
              f"21a: kibana answers on logs-c's mesh_pallas as logs-c does "
              f"({kib.get('_plane')})")
        same_response(kib, host_a, "21a kibana (mesh_pallas) against the "
                                   "host rung over the same segments",
                      claim="answers equal")
        # the log pattern's totals: three indices over one set of segments
        check(by_alias["hits"]["total"] == 3 * host_a["hits"]["total"],
              "21a: the pattern's total is three times one index's")
        filtered = search("v1", {"query": match, "size": 0},
                          "21a filtered alias v1 (ROADMAP C19)")
        check(filtered["hits"]["total"] == by_c["hits"]["total"],
              f"21a: the filtered alias answers as the index does "
              f"({filtered['hits']['total']}, C19)")
        rows = call("GET", "/_cat/aliases?format=json")
        check(sorted((r["alias"], r["index"], r["filter"]) for r in rows)
              == [("kibana", "logs-c", "-"), ("logs", "logs-a", "-"),
                  ("logs", "logs-b", "-"), ("logs", "logs-c", "-"),
                  ("v1", "logs-c", "*")], f"21a: _cat/aliases ({rows})")
        rows = call("GET", "/_cat/templates?format=json")
        check([(r["name"], r["index_patterns"]) for r in rows]
              == [("logs", "[logs-*]")], f"21a: _cat/templates ({rows})")
        check(set(call("GET", "/_alias/logs"))
              == {"logs-a", "logs-b", "logs-c"}, "21a: GET _alias/logs")

        # ---- 21b: stored scripts and search templates ----------------
        # a string source: the size goes in unquoted, as a number
        source = ('{"query": {"match": {"title": "{{q}}"}}, "size": {{n}}, '
                  '"aggs": {"v": {"terms": {"field": "venue", "size": 10}}}}')
        params = {"q": match["match"]["title"], "n": 10}
        call("PUT", "/_scripts/q", {"script": {"lang": "mustache",
                                               "source": source}})
        by_id = item("21b _search/template by id (kibana)", lambda: call(
            "POST", "/kibana/_search/template", {"id": "q",
                                                 "params": params}), reps=3)
        inline = item("21b _search/template inline (kibana)", lambda: call(
            "POST", "/kibana/_search/template", {"source": source,
                                                 "params": params}))
        rendered = call("POST", "/_render/template", {"id": "q",
                                                      "params": params})
        check(rendered["template_output"] == body_mt,
              "21b: _render/template gives the plain body")
        check(keys(by_id) == keys(inline) == keys(kib)
              and by_id["aggregations"] == kib["aggregations"]
              and by_id.get("_plane") == "mesh_pallas",
              "21b: the template's hits equal the plain body's")

        # ---- 21c: dynamic cluster settings on the card's planes ------
        call("PUT", "/pk4", {"settings": {
            "number_of_shards": 4, "refresh_interval": "-1",
            "requests.cache.enable": False,
            "search": {"pallas": {"postings_codec": "packed"}}},
            "mappings": {"_doc": {"properties": {
                "title": {"type": "text"}, "venue": {"type": "keyword"},
                "year": {"type": "long"}}}}})
        for sh, segs in enumerate(pk_segs):
            for seg in segs:
                g7.indices["pk4"].shards[sh].engine.adopt_segment(seg)
        pr_body = {"query": {"match": {"title": " ".join(
            tok(t) for t in queries[0])}}, "size": 10}
        sel = "tile_scoring_topk_sel_packed"
        exhaustive = search("pk4", pr_body, "21c pk4 exhaustive (packed)")
        t0 = time.perf_counter()
        transient({"search.pallas.pruning.enabled": True})
        pruned = search("pk4", pr_body, "21c pk4 pruned (transient)",
                        reps=3)
        report["pruning_toggle_ms"] = (time.perf_counter() - t0) * 1000
        check(committed() == {"search": {"pallas": {"pruning": {
            "enabled": True}}}}, "21c: _cluster/settings shows pruning")
        check("_pruned" in pruned, "21c: the transient setting prunes")
        # (a pruned total is a lower bound: the hits are held)
        same_response({"hits": dict(pruned["hits"], total=0)},
                      {"hits": dict(exhaustive["hits"], total=0)},
                      "21c the pruned top 10 against the exhaustive ones",
                      claim="answers equal")
        if on_card:
            check(report["items"]["21c pk4 pruned (transient)"][
                "launches"].get(sel, 0) > 0, "21c: pruning launched 1e packed")
        transient({"search.pallas.pruning.enabled": None})
        cleared = search("pk4", pr_body, "21c pk4 pruning cleared")
        check("_pruned" not in cleared and keys(cleared) == keys(exhaustive)
              and not report["items"]["21c pk4 pruning cleared"][
                  "launches"].get(sel) and committed() == {},
              "21c: clearing pruning stops 1e and answers exhaustively")
        # fused aggregations on logs-c's mesh
        ms = g7.indices["logs-c"]._mesh_plane()
        fused0 = ms.agg_fused_query_total
        by0 = dict(ms.agg_host_fallback_by_reason)
        g0, m0 = len(kept[1]), len(kept[2])
        transient({"search.aggs.fused": False})
        host_red = search("logs-c", body_agg, "21c logs-c terms, "
                                              "aggs.fused false (host "
                                              "reduce)")
        g1, m1 = len(kept[1]), len(kept[2])
        check(ms.agg_fused_query_total == fused0
              and ms.agg_host_fallback_by_reason.get("disabled", 0)
              == by0.get("disabled", 0) + 1,
              f"21c: aggs.fused false takes the host reduce (reason "
              f"disabled: {ms.agg_host_fallback_by_reason})")
        transient({"search.aggs.fused": None})
        fused = search("logs-c", body_agg, "21c logs-c terms, fused again")
        g2, m2 = len(kept[1]), len(kept[2])
        check(ms.agg_fused_query_total == fused0 + 1
              and host_red["aggregations"] == fused["aggregations"]
              == kib["aggregations"],
              "21c: cleared, the fused plane serves the same buckets")
        if on_card:
            check(g1 > g0 and m1 == m0 and m2 > m1 and g2 == g1,
                  f"21c: kernel 2's gather form on the host reduce, the mask "
                  f"form fused (gather {g0}->{g1}->{g2}, mask {m0}->{m1}->"
                  f"{m2})")
        # kNN on pmc4
        knn_mesh = search("pmc4", knn_body, "21c pmc4 kNN (mesh)")
        t0 = time.perf_counter()
        transient({"search.knn.enabled": False})
        knn_host = search("pmc4", knn_body, "21c pmc4 kNN, knn.enabled "
                                            "false")
        report["knn_toggle_ms"] = (time.perf_counter() - t0) * 1000
        check(knn_mesh.get("_plane") == "mesh_pallas"
              and knn_host.get("_plane") == "host",
              f"21c: knn.enabled false serves kNN on the host rung "
              f"({knn_host.get('_plane')})")
        same_knn_response(knn_host, knn_mesh, 2e-6, "21c kNN on the host "
                                                    "rung against the mesh",
                          claim="answers equal")
        transient({"search.knn.enabled": None})
        knn_back = search("pmc4", knn_body, "21c pmc4 kNN, cleared")
        check(knn_back.get("_plane") == "mesh_pallas"
              and keys(knn_back) == keys(knn_mesh),
              "21c: cleared, kNN is back on the mesh")
        if on_card:
            check(report["items"]["21c pmc4 kNN, cleared"]["launches"].get(
                "knn_scoring", 0) > 0 and not report["items"][
                "21c pmc4 kNN, knn.enabled false"]["launches"].get(
                "knn_scoring"), "21c: kernel 3 only on the mesh")
        # the HBM budget below what is staged
        staged = memory_accountant().stats(None)["staged_bytes_total"]
        ev0 = memory_accountant().evictions_total
        t0 = time.perf_counter()
        transient({"search.memory.hbm_budget_bytes": "1b"})
        demoted = search("logs-c", body_mt, "21c logs-c, budget 1b")
        report["budget_toggle_ms"] = (time.perf_counter() - t0) * 1000
        stats = next(iter(call("GET", "/_nodes/stats")["nodes"].values()))
        mem = stats["indices"]["search"]["memory"]
        check(demoted.get("_plane") == "host",
              f"21c: over budget logs-c demotes to the host rung "
              f"({demoted.get('_plane')})")
        same_response(demoted, by_c, "21c the demoted answer against the "
                                     "mesh's", claim="answers equal")
        check(mem["hbm_budget_bytes"] == 1
              and stats["breakers"]["accounting"]["limit_size_in_bytes"] == 1
              and mem["evictions_total"] > ev0,
              f"21c: _nodes/stats shows the budget and the evictions "
              f"({mem['evictions_total']} after {ev0}; {staged} B staged)")
        state = call("GET", "/_cluster/state")
        check(state["metadata"]["cluster_settings"]["transient"] == {
            "search": {"memory": {"hbm_budget_bytes": "1b"}}},
            "21c: _cluster/state shows the budget")
        transient({"search.memory.hbm_budget_bytes": None})
        back = search("logs-c", body_mt, "21c logs-c, budget cleared")
        check(back.get("_plane") == "mesh_pallas"
              and memory_accountant().budget_bytes == 0 and committed() == {},
              "21c: cleared, the mesh serves logs-c again")
        same_response(back, by_c, "21c the restaged answer against the "
                                  "first", claim="answers equal")

        # ---- 21d: index settings, open/close, stats ------------------
        call("PUT", "/logs-c/_settings", {"index.refresh_interval": "1s"})
        check(g7.indices["logs-c"].refresh_interval == 1.0,
              "21d: logs-c's refresh interval is 1s")
        restage0, delta0 = ms.restage_total, ms.delta_restage_total
        waits = {}
        for interval in ("1s", "-1"):
            if interval == "-1":
                call("PUT", "/logs-c/_settings",
                     {"index": {"refresh_interval": "-1"}})
            lat = []
            for i in range(WAIT_FOR_WRITES):
                doc_id = f"w{interval}-{i}"
                t0 = time.perf_counter()
                # (no keyword: its norm row would exceed the staged
                # generation's one and force a rebuild)
                call("PUT", f"/logs-c/_doc/{doc_id}?refresh=wait_for",
                     {"title": f"{tok(3)} fresh{i}", "year": 2020,
                      "ts": AGG_T0, "citations": i}, want=201)
                lat.append((time.perf_counter() - t0) * 1000)
                if interval == "1s" and i == 0:
                    first = search("kibana", body_mt, "21d first answer "
                                                      "after a wait_for "
                                                      "write")
                    check(ms.delta_restage_total > delta0
                          and ms.restage_total == restage0
                          and first.get("_plane") == "mesh_pallas",
                          f"21d: the first answer took the delta append "
                          f"(delta {delta0}->{ms.delta_restage_total}, "
                          f"rebuilds {restage0}->{ms.restage_total})")
                seen = search("logs-c", {"query": {"ids": {
                    "values": [doc_id]}}})
                check(seen["hits"]["total"] == 1,
                      f"21d: the wait_for write {doc_id} is visible")
            waits[interval] = float(np.median(lat))
        report["wait_for_p50_ms"] = waits
        check(g7.indices["logs-c"]._refresh_thread is None,
              "21d: -1 stopped logs-c's refresh thread")
        before = search("logs-*", body_mt)
        call("POST", "/logs-b/_close")
        closed = search("logs-*", body_mt, "21d logs-* with logs-b closed")
        check(closed["_shards"]["total"] == 8
              and all(h["_index"] != "logs-b"
                      for h in closed["hits"]["hits"]),
              "21d: logs-* skips the closed logs-b")
        call("POST", "/logs-b/_search", body_mt, want=400)
        call("POST", "/logs-b/_open")
        after = search("logs-*", body_mt, "21d logs-* after _open")
        check(keys(after) == keys(before)
              and after["hits"]["total"] == before["hits"]["total"]
              and after["aggregations"] == before["aggregations"],
              "21d: _open brings back the same answers")
        call("PUT", "/logs-c/_mapping", {"properties": {
            "tag": {"type": "keyword"}}})
        check(call("GET", "/logs-c/_mapping")["logs-c"]["mappings"]["_doc"][
            "properties"]["tag"] == {"type": "keyword"},
              "21d: PUT _mapping added a field")
        stats = item("21d _stats on logs-a,logs-b (2,097,152 docs)",
                     lambda: call("GET", "/logs-a,logs-b/_stats"), reps=3)
        engines = {n: sum(sh.engine.num_docs for sh in
                          g7.indices[n].shards.values())
                   for n in ("logs-a", "logs-b", "logs-c")}
        check(all(stats["indices"][n]["total"]["docs"]["count"] == engines[n]
                  for n in ("logs-a", "logs-b"))
              and stats["_all"]["total"]["docs"]["count"]
              == engines["logs-a"] + engines["logs-b"],
              f"21d: _stats doc counts equal the engines' ({engines})")
        segs = call("GET", "/logs-c/_segments")
        check(sum(s["num_docs"] - s["deleted_docs"]
                  for copies in segs["indices"]["logs-c"]["shards"].values()
                  for c in copies for s in c["segments"].values())
              == engines["logs-c"], "21d: _segments' live docs")
        rows = call("GET", "/_cat/shards/logs-c?format=json")
        check(sum(int(r["docs"]) for r in rows) == engines["logs-c"]
              and len(rows) == 4, "21d: _cat/shards' docs")
        rows = call("GET", "/_cat/segments?format=json&h=index,docs.count,"
                           "docs.deleted")
        check(sum(int(r["docs.count"]) - int(r["docs.deleted"])
                  for r in rows if r["index"] == "logs-c")
              == engines["logs-c"], "21d: _cat/segments' live docs")

        # ---- 21e: the global _state across a restart -----------------
        path = tempfile.mkdtemp(prefix="p21_")
        try:
            report["restart"] = _metadata_restart(Node, HttpServer, path,
                                                  device, item)
        finally:
            shutil.rmtree(path, ignore_errors=True)
        if on_card:
            check(report["items"]["21e pruned request after the reopen"][
                "launches"].get(sel, 0) > 0,
                "21e: the reopened node's pruned request launched 1e packed")
    if on_card:
        torch.cuda.synchronize()
    report["main_s"] = time.perf_counter() - t_main
    p21 = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    log(f"[phase 21] kernel launches: {p21}")
    client.close()
    srv.stop()
    t0 = time.perf_counter()
    if on_card:
        held, report["max_abs_err"] = hold_recovered_path(
            torch, tsc, ssum, knn, kept, p21, errs, "phase 21")
        for k in ("tile_scoring", sel, "segment_sum", "knn_scoring"):
            check(p21.get(k, 0) > 0, f"phase 21 launched {k}")
        report["forms"] = {"segment_sum_gather_form": len(kept[1]),
                           "segment_sum_mask_form": len(kept[2])}
    else:
        held = {}
    report["held"] = held
    del kept
    report["hold_s"] = time.perf_counter() - t0
    for name in ("logs-a", "logs-b", "logs-c", "pk4"):
        g7.delete_index(name)
    call_fails = plane_failures(g7.indices["pmc4"])
    check(not any(call_fails), f"phase 21: zero plane faults "
                               f"({call_fails})")
    report["launches"] = p21
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 21] {report['seconds']:.1f} s (main path "
        f"{report['main_s']:.1f}, hold {report['hold_s']:.1f}); " + json.dumps(
            {k: report.get(k) for k in (
                "pruning_toggle_ms", "knn_toggle_ms", "budget_toggle_ms",
                "wait_for_p50_ms", "held", "max_abs_err", "forms")})
        + f" ({smi})")
    return report


def _metadata_restart(Node, HttpServer, path, device, item):
    """21e on a durable node at ``path``: the global metadata and an alias
    across a close and a reopen."""
    out = {}
    mapping = {"_doc": {"properties": {
        "body": {"type": "text", "analyzer": "whitespace"},
        "n": {"type": "long"}}}}
    node = Node(data_path=path, device=device)
    srv = HttpServer(node, port=0)
    srv.start()
    client = HttpClient(srv.port)
    try:
        for method, p, body in (
                ("PUT", "/_template/sm", {"index_patterns": ["sm-*"],
                                          "order": 2, "settings": {
                                              "number_of_shards": 2}}),
                ("PUT", "/_cluster/settings", {"persistent": {
                    "search.pallas.pruning.enabled": True,
                    "search.pallas.pruning.probe_tiles": 2}}),
                ("PUT", "/_scripts/s1", {"script": {
                    "lang": "mustache", "source": {"query": {"match": {
                        "body": "{{q}}"}}}}}),
                ("PUT", "/small", {"settings": {
                    "number_of_shards": 2, "refresh_interval": "-1",
                    "requests.cache.enable": False,
                    "search": {"pallas": {"postings_codec": "packed"}}},
                    "mappings": mapping, "aliases": {"sm": {}}})):
            st, r = client.call(method, p, body)
            check(st == 200, f"21e: {method} {p} ({st} {str(r)[:200]})")
        lines = []
        for doc_id, src in small_prune_docs(SMALL_DOCS):
            lines += [{"index": {"_index": "small", "_id": doc_id}}, src]
        st, r = client.call(
            "POST", "/_bulk?refresh=true",
            ("\n".join(json.dumps(x) for x in lines) + "\n").encode(),
            "application/x-ndjson")
        check(st == 200 and not r["errors"], "21e: the bulk")
    finally:
        client.close()
        srv.stop()
    t0 = time.perf_counter()
    node.close()
    out["close_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    node2 = cold_reopen(Node, path, device)
    out["reopen_s"] = time.perf_counter() - t0
    srv = HttpServer(node2, port=0)
    srv.start()
    client = HttpClient(srv.port)
    try:
        st, s = client.call("GET", "/_cluster/settings")
        check(st == 200 and s["persistent"] == {"search": {"pallas": {
            "pruning": {"enabled": True, "probe_tiles": 2}}}},
              f"21e: the persistent settings came back ({s})")
        st, t = client.call("GET", "/_template/sm")
        check(st == 200 and t["sm"]["order"] == 2, "21e: the template")
        st, sc = client.call("GET", "/_scripts/s1")
        check(st == 200 and sc["found"], "21e: the stored script")
        st, a = client.call("GET", "/_alias/sm")
        check(st == 200 and set(a) == {"small"}, "21e: the alias")
        body = {"query": {"match": {"body": "t0 t3 t7"}}, "size": 10}
        r = item("21e pruned request after the reopen", lambda: client.call(
            "POST", "/sm/_search", body)[1])
        check("_pruned" in r and r["hits"]["hits"],
              f"21e: the reopened node prunes ({str(r)[:200]})")
        st, r2 = client.call("POST", "/sm/_search/template", {
            "id": "s1", "params": {"q": "t0 t3 t7"}})
        check(st == 200 and [h["_id"] for h in r2["hits"]["hits"]]
              == [h["_id"] for h in r["hits"]["hits"]],
              "21e: the stored template after the reopen")
    finally:
        client.close()
        srv.stop()
        node2.close()
    return out


# ----------------------------------------------------------------------
# phase 22: data movement (reindex, by query, tasks, ingest, index admin;
# the snapshot and restore, 22e, run inside 13c over its recovered node)
# ----------------------------------------------------------------------

# dm4's slots: a generation holds one refresh's worth of headroom (one
# segment a shard); the cap leaves room for it
DM_SLOTS = 16
REINDEX_DOCS = 5_000  # 22a's source query selects about this many docs
REINDEX_BATCH = 1_000  # 22a's scroll size: the task shows its status after each
BYQUERY_DOCS = 2_621  # 22b's update and delete each select about 1%
WRITER_DOCS = 40  # 22b's concurrent writer (one refresh)
PIPELINE_DOCS = 2_000  # 22d: ingest-20k's first docs through the pipeline
ADMIN_DOCS = 2_000  # 22f's shrink source
CANCEL_HOLD_S = 0.3  # 22c: how long a held search waits at its checkpoint


class _DMSources:
    """pmc-4x256k's stored sources for phase 22: the title rebuilt from
    its token stream, ``n`` and ``year``. No ``venue``: a keyword adds a
    norm row, and a segment with one more norm row than the staged
    generation cannot append into it (the by-query writes re-index from
    the source)."""

    def __init__(self, base, title_stream):
        self._titled = _TitledSources(base, title_stream)

    def __len__(self):
        return len(self._titled)

    def __getitem__(self, d):
        src = self._titled[d]
        src.pop("venue", None)
        return src


def routed_ids(n_shards, per_shard, prefix="m"):
    """Doc ids for each shard that route to it by their own hash (the
    by-query writes carry no routing): candidates ``<prefix><7 digits>``
    hashed as ``shard_id_for`` does (murmur3 over the UTF-16LE bytes), all
    at once, then bucketed by shard."""
    from elasticsearch_tpu_torch.utils.murmur3 import _murmur3_32_same_length

    width = 7
    m = per_shard * n_shards * 21 // 20 + 1024
    while True:
        j = np.arange(m, dtype=np.int64)
        rows = np.zeros((m, 2 * (1 + width)), np.uint8)
        rows[:, 0] = ord(prefix)
        for k in range(width):
            rows[:, 2 * (k + 1)] = ord("0") + (j // 10 ** (width - 1 - k)) % 10
        shard = np.mod(_murmur3_32_same_length(rows, 0), n_shards)
        picks = [np.flatnonzero(shard == s)[:per_shard]
                 for s in range(n_shards)]
        if min(len(p) for p in picks) == per_shard:
            return [[f"{prefix}{x:0{width}d}" for x in p.tolist()]
                    for p in picks]
        m *= 2


def term_docs(arrays, tid):
    """The local docs of term ``tid`` in one shard's segment arrays."""
    s = int(arrays["term_block_start"][tid])
    c = int(arrays["term_block_count"][tid])
    docs = arrays["block_docs"][s: s + c].reshape(-1)
    return np.unique(docs[docs < len(arrays["doc_ids"])])


def term_near(shard_arrays, lives, target, skip=()):
    """The title term whose live document frequency over every shard is
    closest to ``target`` (a few hundred candidates near it by the
    segments' own frequencies, then counted exactly)."""
    df = sum(a["term_doc_freq"].astype(np.int64) for a in shard_arrays)
    order = np.argsort(np.abs(df - target))
    best, best_n = None, None
    for tid in order[:40].tolist():
        if tid in skip:
            continue
        n = sum(int(live[term_docs(a, tid)].sum())
                for a, live in zip(shard_arrays, lives))
        if best is None or abs(n - target) < abs(best_n - target):
            best, best_n = tid, n
    return best, best_n


@contextlib.contextmanager
def timed_scan(trx, stats):
    """While the block runs, every by-query scan (``_scan_batches``) adds
    the host-clock seconds it spends producing batches (the plans, the
    launches and each segment's mask to the host: the scan apart from
    the writes that consume its batches) to ``stats["s"]``, and the
    segments it pins to ``stats["segments"]``."""
    orig = trx._scan_batches

    def timed(*args, **kw):
        inner = orig(*args, **kw)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(inner)
                except StopIteration:
                    return
                finally:
                    stats["s"] = stats.get("s", 0.0) + (time.perf_counter()
                                                        - t0)
                yield batch
        finally:
            inner.close()

    trx._scan_batches = timed
    try:
        yield stats
    finally:
        trx._scan_batches = orig


@contextlib.contextmanager
def held_block(torch, cuda_kernels, tsc, ssum, knn, errs, label, acc,
               on_card=True):
    """Record every kernel call of the block; then hold each against its
    plain version on its inputs, check that every launch was held, and
    drop the records (they keep the launches' inputs alive). ``acc``
    takes the launches by name; the yielded dict takes this block's."""
    before = dict(cuda_kernels.LAUNCHES)
    mine = {}
    if not on_card:
        yield mine
        return
    with recording_recovered_path(tsc, ssum, knn) as kept:
        yield mine
    torch.cuda.synchronize()
    mine.update({k: v - before.get(k, 0) for k, v in
                 cuda_kernels.LAUNCHES.items() if v != before.get(k, 0)})
    hold_recovered_path(torch, tsc, ssum, knn, kept, mine, errs, label)
    for k, v in mine.items():
        acc[k] = acc.get(k, 0) + v
    del kept


def data_movement_phase(torch, Node, HttpServer, cuda_kernels, tsc, ssum,
                        knn, g7, shard_arrays, title_streams, ops, queries,
                        errs, smi, device="cuda"):
    """Phase 22: data movement on the card, over REST through an
    ``HttpServer`` on phase 7's node.

    dm4 is a new 4-shard mesh index over pmc-4x256k's arrays (new
    segments, their own live masks; ids that route to their shard by
    their hash, since the by-query writes carry no routing; sources with
    the title; ``max_slots_per_device`` 24 and no compaction).

    22a. ``_reindex`` of a ``match`` on one title term selecting about
         5,000 docs into a 1-shard index: the scan's 1a launches (one a
         segment, held against plain), the scan's host-clock ms apart
         from the bulk, docs/s; the destination's ``_count`` and ids equal
         the source's for the same query and the numpy postings count;
         ``memory_allocated`` back to its level; the reindex seen in
         ``_tasks`` with its ``status`` while it runs.
    22b. ``_update_by_query`` with a painless script over a term of about
         1% of the docs: it updates the numpy postings count, and the
         first answer after it takes the delta append (no rebuild).
         ``_delete_by_query`` over another 1% term while a writer thread
         indexes 40 docs holding that term into dm4 and refreshes, after
         the scan pinned its snapshot: deleted equals the numpy count
         (point in time: none of the writer's docs), the term then
         matches the writer's docs alone and ``match_all`` counts the
         rest exactly (the path of that answer is reported: the update's
         append used the generation's headroom). ``memory_allocated``
         back after each call.
    22c. A search held on the host rung (pmc4h, ``SearchDelayScheme``) and
         one held on the mesh plane (dm4, ``MeshPlaneDelayScheme`` before
         the plane attempt's checkpoint) are listed by ``GET
         _tasks?actions=*search*`` and cancelled by ``POST
         _tasks/{id}/_cancel``: the ms from the cancel to the 400
         ``task_cancelled_exception``, no launch after the cancel,
         ``memory_allocated`` at its level.
    22d. ingest-20k's first 2,000 docs as combined-log lines through a
         pipeline shaped like Filebeat's nginx access log (grok, date,
         geoip on the built-in table, user_agent, convert, remove) with
         ``_bulk?pipeline=`` beside the same bulk without it; the
         ``_simulate`` of all 2,000 docs; every indexed source equals its
         simulated one.
    22f. On small host-rung indices: rollover of a ``logs-000001`` write
         alias by ``max_docs`` (a ``dry_run`` moves nothing), a shrink of
         a 4-shard 2,000-doc index to 1 (equal answers), ``_field_caps``
         over ``logs-*``, ``_termvectors`` of one doc against the
         segment's postings. The p50 of each.

    Every launch is held against its plain version; dm4 and every index
    made here is deleted at the end. Returns the report."""
    from elasticsearch_tpu_torch.index import reindex as trx
    from elasticsearch_tpu_torch.index.segment import Segment
    from elasticsearch_tpu_torch.testing import disruption as tdis

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    report = {"items": {}}
    acc = {}
    tok = term_token

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def mem():
        sync()
        return torch.cuda.memory_allocated() if on_card else 0

    srv = HttpServer(g7, port=0)
    srv.start()
    client = HttpClient(srv.port)

    def call(method, path, body=None, want=200, ctype="application/json",
             cl=None):
        st, r = (cl or client).call(method, path, body, ctype)
        check(st == want, f"22: {method} {path} answered {st} (want {want}: "
                          f"{str(r)[:300]})")
        return r

    def timed(name, fn, reps=1):
        xs, out = [], None
        for i in range(reps):
            t0 = time.perf_counter()
            r = fn()
            sync()
            xs.append((time.perf_counter() - t0) * 1000)
            if i == 0:
                out = r
        row = {"p50_ms": float(np.median(xs)), "samples": len(xs)}
        report["items"][name] = row
        log(f"[phase 22] {name}: {json.dumps(row)} ({smi})")
        return out

    def bulk_lines(index, docs, extra=""):
        lines = []
        for doc_id, src in docs:
            lines.append(json.dumps({"index": {"_index": index,
                                               "_id": doc_id}}))
            lines.append(json.dumps(src))
        return ("\n".join(lines) + "\n").encode()

    # ---- dm4 ---------------------------------------------------------
    t0 = time.perf_counter()
    per_shard = len(shard_arrays[0]["doc_ids"])
    ids = routed_ids(len(shard_arrays), per_shard)
    mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}, "n": {"type": "long"}}}}
    call("PUT", "/dm4", {"settings": {
        "number_of_shards": len(shard_arrays), "refresh_interval": "-1",
        "requests.cache.enable": False,
        "search": {"mesh": {"max_slots_per_device": DM_SLOTS}},
        "staging": {"compact": {"threshold": 0}}}, "mappings": mapping})
    lives = []
    for sh, arrays in enumerate(shard_arrays):
        arrays = dict(arrays, doc_ids=ids[sh], live=arrays["live"].copy(),
                      sources=_DMSources(arrays["sources"],
                                         title_streams[sh]))
        lives.append(arrays["live"].copy())
        # (a name of its own: the engine's first sealed buffer is
        # dm4_<shard>_seg_1, and the write-backs seal one)
        g7.indices["dm4"].shards[sh].engine.adopt_segment(
            Segment.from_arrays(f"dm4src_{sh}_seg_1", device=device,
                                **arrays))
    ms = g7.indices["dm4"]._mesh_plane()
    n_live = int(sum(int(lv[:per_shard].sum()) for lv in lives))

    def expected(tid):
        return {ids[sh][d] for sh, a in enumerate(shard_arrays)
                for d in term_docs(a, tid).tolist() if lives[sh][d]}

    ta, na = term_near(shard_arrays, lives, REINDEX_DOCS)
    tu, nu = term_near(shard_arrays, lives, BYQUERY_DOCS, skip=(ta,))
    td, nd = term_near(shard_arrays, lives, BYQUERY_DOCS, skip=(ta, tu))
    warm = call("POST", "/dm4/_search", {
        "query": {"match": {"title": tok(tu)}}, "size": 10})
    check(warm.get("_plane") == "mesh_pallas",
          f"22: dm4 serves on mesh_pallas ({warm.get('_plane')})")
    report["dm4"] = {"docs": n_live, "build_s": time.perf_counter() - t0,
                     "terms": {"reindex": [tok(ta), na],
                               "update": [tok(tu), nu],
                               "delete": [tok(td), nd]}}
    log(f"[phase 22] dm4: {json.dumps(report['dm4'])}")

    # ---- 22a: reindex ------------------------------------------------
    q_a = {"match": {"title": tok(ta)}}
    want_a = expected(ta)
    call("PUT", "/dm1", {"settings": {"number_of_shards": 1,
                                      "refresh_interval": "-1",
                                      "requests.cache.enable": False},
                         "mappings": mapping})
    seen = []
    stop = threading.Event()

    def watch():
        cl = HttpClient(srv.port)
        try:
            while not stop.is_set():
                st, t = cl.call("GET", "/_tasks?actions=*reindex")
                for node_tasks in (t or {}).get("nodes", {}).values():
                    for entry in node_tasks["tasks"].values():
                        if entry.get("status"):
                            seen.append(entry)
                time.sleep(0.01)
        finally:
            cl.close()

    watcher = threading.Thread(target=watch)
    mem0 = mem()
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs, "phase 22a",
                    acc, on_card) as la, timed_scan(trx, {}) as scan:
        watcher.start()
        t0 = time.perf_counter()
        out_a = call("POST", "/_reindex", {
            "source": {"index": "dm4", "query": q_a, "size": REINDEX_BATCH},
            "dest": {"index": "dm1"}})
        call_s = time.perf_counter() - t0
        stop.set()
        watcher.join()
    mem1 = mem()
    got = call("POST", "/dm1/_search", {"query": q_a, "size": len(want_a)})
    src = call("POST", "/dm4/_search", {"query": q_a, "size": len(want_a)})
    count = call("POST", "/dm1/_count", {"query": q_a})
    check(out_a["created"] == out_a["total"] == len(want_a)
          and not out_a["failures"],
          f"22a: reindex created every matched doc ({out_a['created']} of "
          f"{len(want_a)})")
    check(count["count"] == got["hits"]["total"] == src["hits"]["total"]
          == len(want_a)
          and {h["_id"] for h in got["hits"]["hits"]}
          == {h["_id"] for h in src["hits"]["hits"]} == want_a,
          "22a: the destination's _count and ids equal the source's and the "
          "numpy postings'")
    check(abs(mem1 - mem0) <= 1 << 20,
          f"22a: memory_allocated back to its level ({mem0} -> {mem1})")
    check(bool(seen) and seen[0]["action"] == "indices:data/write/reindex"
          and seen[0]["status"]["total"] > 0,
          f"22a: the reindex listed in _tasks with its status "
          f"({seen[:1]})")
    if on_card:
        check(la.get("tile_scoring", 0) == len(shard_arrays),
              f"22a: the scan launched 1a once a segment ({la})")
    report["22a"] = {
        "docs": out_a["created"], "call_s": call_s,
        "docs_per_s": out_a["created"] / call_s,
        "scan_ms": scan["s"] * 1000,
        "bulk_and_rest_ms": (call_s - scan["s"]) * 1000,
        "launches": la, "memory_allocated": [mem0, mem1],
        "task_status_seen": seen[0]["status"] if seen else None}
    log(f"[phase 22a] {json.dumps(report['22a'])} ({smi})")

    # ---- 22b: update and delete by query, a writer alongside ----------
    q_u = {"match": {"title": tok(tu)}}
    want_u = expected(tu)
    restage0, delta0 = ms.restage_total, ms.delta_restage_total
    mem0 = mem()
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs, "phase 22b",
                    acc, on_card) as lu, timed_scan(trx, {}) as scan_u:
        t0 = time.perf_counter()
        out_u = call("POST", "/dm4/_update_by_query", {
            "query": q_u, "script": {"source": "ctx._source.year += params.d",
                                     "params": {"d": 1000}}})
        upd_s = time.perf_counter() - t0
    mem1 = mem()
    check(out_u["total"] == out_u["updated"] == len(want_u)
          and not out_u["failures"],
          f"22b: the update updated the numpy count ({out_u['total']} of "
          f"{len(want_u)})")
    check(abs(mem1 - mem0) <= 1 << 20,
          f"22b: memory_allocated back after the update ({mem0} -> {mem1})")
    body_u = {"query": q_u, "size": 10}
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs,
                    "phase 22b first answer", acc, on_card) as lf:
        t0 = time.perf_counter()
        first = call("POST", "/dm4/_search", body_u)
        sync()
        first_ms = (time.perf_counter() - t0) * 1000
    check(first.get("_plane") == "mesh_pallas"
          and ms.delta_restage_total == delta0 + 1
          and ms.restage_total == restage0,
          f"22b: the first answer after the update took the delta append "
          f"(delta {delta0} -> {ms.delta_restage_total}, rebuilds "
          f"{restage0} -> {ms.restage_total}, {first.get('_plane')})")
    check(first["hits"]["total"] == len(want_u)
          and all(h["_source"]["year"] >= 2990
                  for h in first["hits"]["hits"]),
          f"22b: the term's docs carry the update ({first['hits']['total']}"
          f" of {len(want_u)})")
    # the delete, with a writer thread indexing docs of the deleted term
    # into dm4 (a refresh after them) once the scan has pinned its
    # snapshot: the scan must not see them
    q_d = {"match": {"title": tok(td)}}
    want_d = expected(td)
    pinned, written = threading.Event(), threading.Event()
    writer_ids = []
    orig_scan = trx._scan_batches

    def signalling_scan(*args, **kw):
        inner = orig_scan(*args, **kw)
        try:
            for i, batch in enumerate(inner):
                yield batch
                if i == 0:
                    # the run goes on once the writer is done
                    pinned.set()
                    written.wait(60)
        finally:
            inner.close()

    def writer():
        try:
            if not pinned.wait(60):
                return
            for i in range(WRITER_DOCS):
                doc_id = f"writer{i}"
                g7.index_doc("dm4", doc_id, {"title": f"{tok(td)} fresh{i}",
                                             "year": 5000, "n": -1})
                writer_ids.append(doc_id)
            g7.refresh("dm4")
        finally:
            written.set()

    tomb0, delta1 = ms.tombstone_update_total, ms.delta_restage_total
    mem0 = mem()
    trx._scan_batches = signalling_scan
    try:
        with held_block(torch, cuda_kernels, tsc, ssum, knn, errs,
                        "phase 22b delete", acc, on_card) as ld:
            w = threading.Thread(target=writer)
            w.start()
            t0 = time.perf_counter()
            out_d = call("POST", "/dm4/_delete_by_query", {"query": q_d})
            del_s = time.perf_counter() - t0
            pinned.set()
            w.join()
    finally:
        trx._scan_batches = orig_scan
    mem1 = mem()
    check(len(writer_ids) == WRITER_DOCS, "22b: the writer wrote its docs")
    check(out_d["deleted"] == out_d["total"] == len(want_d),
          f"22b: delete by query removed the numpy count, none of the "
          f"writer's docs ({out_d['deleted']} of {len(want_d)}, "
          f"{WRITER_DOCS} written meanwhile)")
    check(abs(mem1 - mem0) <= 1 << 20,
          f"22b: memory_allocated back after the delete ({mem0} -> {mem1})")
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs,
                    "phase 22b after delete", acc, on_card) as lt:
        t0 = time.perf_counter()
        left = call("POST", "/dm4/_search", {"query": q_d, "size": 10})
        sync()
        tomb_ms = (time.perf_counter() - t0) * 1000
        rest = call("POST", "/dm4/_count", {"query": {"match_all": {}}})
    # (the update's append filled the generation's one refresh of
    # headroom, so the writer's segments make this answer a rebuild)
    check(left["hits"]["total"] == WRITER_DOCS
          and {h["_id"] for h in left["hits"]["hits"]} <= set(writer_ids)
          and left.get("_plane") == "mesh_pallas",
          f"22b: the deleted term matches the writer's docs alone "
          f"({left['hits']['total']}, {left.get('_plane')})")
    check(rest["count"] == n_live - len(want_d) + WRITER_DOCS,
          f"22b: match_all counts the rest exactly ({rest['count']} = "
          f"{n_live} - {len(want_d)} + {WRITER_DOCS})")
    report["22b"] = {
        "update": {"docs": out_u["updated"], "s": upd_s,
                   "docs_per_s": out_u["updated"] / upd_s,
                   "scan_ms": scan_u["s"] * 1000, "launches": lu,
                   "first_answer_ms": first_ms, "first_answer_launches": lf},
        "delete": {"docs": out_d["deleted"], "s": del_s,
                   "docs_per_s": out_d["deleted"] / del_s, "launches": ld,
                   "writer_docs": len(writer_ids),
                   "answer_after_ms": tomb_ms, "answer_launches": lt,
                   "answer_after_path": {
                       "rebuilds": ms.restage_total - restage0,
                       "delta_appends": ms.delta_restage_total - delta1,
                       "tombstone_updates":
                           ms.tombstone_update_total - tomb0}}}
    log(f"[phase 22b] {json.dumps(report['22b'])} ({smi})")

    # ---- 22c: tasks: cancel a held search on each plane ---------------
    report["22c"] = {}
    for plane, index, scheme in (
            ("host", "pmc4h", tdis.SearchDelayScheme(
                CANCEL_HOLD_S, indices=["pmc4h"])),
            ("mesh_pallas", "dm4", tdis.MeshPlaneDelayScheme(
                CANCEL_HOLD_S, indices=["dm4"]))):
        body = {"query": {"match": {"title": " ".join(
            tok(t) for t in queries[2])}}, "size": 10}
        call("POST", f"/{index}/_search", body)  # warm: nothing new stages
        mem0 = mem()
        scheme.install()
        got, when = [], []
        cl = HttpClient(srv.port)

        def held_search():
            got.append(cl.call("POST", f"/{index}/_search", body))
            when.append(time.perf_counter())

        th = threading.Thread(target=held_search)
        with held_block(torch, cuda_kernels, tsc, ssum, knn, errs,
                        f"phase 22c {plane}", acc, on_card) as lc:
            th.start()
            task_id, deadline = None, time.perf_counter() + 10
            while task_id is None and time.perf_counter() < deadline:
                t = call("GET", "/_tasks?actions=*search*")
                tasks = next(iter(t["nodes"].values()))["tasks"]
                task_id = next(iter(tasks), None)
            # cancel while the search sits in its hold
            while scheme.hits == 0 and time.perf_counter() < deadline:
                time.sleep(0.001)
            t_held = time.perf_counter()
            at_cancel = dict(cuda_kernels.LAUNCHES)
            t_cancel = time.perf_counter()
            r = call("POST", f"/_tasks/{task_id}/_cancel")
            th.join()
            sync()
            after = dict(cuda_kernels.LAUNCHES)
        cl.close()
        tdis.clear_search_disruptions()
        mem1 = mem()
        st, body_c = got[0]
        check(task_id is not None and task_id in next(iter(
            r["nodes"].values()))["tasks"],
            f"22c {plane}: the held search was listed and cancelled")
        check(st == 400 and body_c["error"]["type"]
              == "task_cancelled_exception"
              and body_c["error"]["reason"]
              == "task cancelled [by user request]",
              f"22c {plane}: the search answered 400 task_cancelled "
              f"({st} {str(body_c)[:200]})")
        check(after == at_cancel,
              f"22c {plane}: no launch after the cancel")
        check(abs(mem1 - mem0) <= 1 << 20,
              f"22c {plane}: memory_allocated at its level ({mem0} -> "
              f"{mem1})")
        row = {"cancel_to_400_ms": (when[0] - t_cancel) * 1000,
               "hold_s": CANCEL_HOLD_S,
               "cancelled_after_hold_began_ms": (t_cancel - t_held) * 1000,
               "launches": lc, "held_at": ("the shard query phase"
                                           if plane == "host" else
                                           "the plane attempt's checkpoint"),
               "memory_allocated": [mem0, mem1]}
        report["22c"][plane] = row
        log(f"[phase 22c] {plane}: {json.dumps(row)} ({smi})")

    # ---- 22d: an nginx access-log pipeline ----------------------------
    uas = [("Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
            "(KHTML, like Gecko) Chrome/70.0.3538.77 Safari/537.36"),
           "curl/7.54.0",
           ("Mozilla/5.0 (iPhone; CPU iPhone OS 12_0 like Mac OS X) "
            "AppleWebKit/605.1.15 (KHTML, like Gecko) Version/12.0 "
            "Mobile/15E148 Safari/604.1")]
    ips = ["8.8.8.8", "1.1.1.1", "81.2.69.144", "10.0.0.7", "81.2.69.160"]
    rng = np.random.RandomState(22)
    docs = []
    for i, (_a, meta, s) in enumerate(ops[:PIPELINE_DOCS]):
        words = s["title"].split()
        line = (f'{ips[i % len(ips)]} - {s["venue"]} '
                f'[{1 + i % 28:02d}/{1 + i % 12:02d}/{s["year"]}:'
                f'{i % 24:02d}:{i % 60:02d}:{(7 * i) % 60:02d}] '
                f'"GET /{s["venue"]}/{words[0]} HTTP/1.1" '
                f'{[200, 200, 304, 404, 500][int(rng.randint(5))]} '
                f'{len(s["title"])} "-" "{uas[i % len(uas)]}"')
        docs.append((meta["_id"], {"message": line}))
    pipeline = {"description": "nginx access log (Filebeat's shape)",
                "processors": [
                    {"grok": {"field": "message", "patterns": [
                        '%{IP:source.ip} - %{DATA:user.name} '
                        '\\[%{DATA:nginx.access.time}\\] "%{WORD:http.method}'
                        ' %{DATA:url.original} HTTP/%{NUMBER:http.version}" '
                        '%{NUMBER:http.response.status_code} '
                        '%{NUMBER:http.response.body.bytes} '
                        '"%{DATA:http.referrer}" '
                        '"%{DATA:user_agent.original}"']}},
                    {"date": {"field": "nginx.access.time",
                              "formats": ["dd/MM/yyyy:HH:mm:ss"]}},
                    {"geoip": {"field": "source.ip",
                               "target_field": "source.geo"}},
                    {"user_agent": {"field": "user_agent.original"}},
                    {"convert": {"field": "http.response.status_code",
                                 "type": "integer"}},
                    {"convert": {"field": "http.response.body.bytes",
                                 "type": "long"}},
                    {"remove": {"field": ["message", "nginx.access.time"]}}]}
    call("PUT", "/_ingest/pipeline/nginx", pipeline)
    rates = {}
    for name, qs in (("weblogs-n", ""), ("weblogs-p", "?pipeline=nginx")):
        call("PUT", f"/{name}", {"settings": {"number_of_shards": 5,
                                              "refresh_interval": "-1",
                                              "requests.cache.enable": False}})
        t0 = time.perf_counter()
        errors = False
        for lo in range(0, len(docs), 1000):
            r = call("POST", f"/_bulk{qs}",
                     bulk_lines(name, docs[lo: lo + 1000]),
                     ctype="application/x-ndjson")
            errors = errors or r["errors"]
        call("POST", f"/{name}/_refresh")
        rates[name] = len(docs) / (time.perf_counter() - t0)
        check(not errors, f"22d: the bulk into {name}")
    t0 = time.perf_counter()
    sim = call("POST", "/_ingest/pipeline/nginx/_simulate", {
        "docs": [{"_id": i, "_source": s} for i, s in docs]})
    sim_ms = (time.perf_counter() - t0) * 1000
    same = sum(
        1 for (doc_id, _s), d in zip(docs, sim["docs"])
        if "doc" in d
        and g7.get_doc("weblogs-p", doc_id)["_source"] == d["doc"]["_source"])
    geo = sum(1 for d in sim["docs"] if "source" in d.get("doc", {}).get(
        "_source", {}) and "geo" in d["doc"]["_source"]["source"])
    check(same == len(docs),
          f"22d: every indexed source equals its _simulate output ({same} "
          f"of {len(docs)})")
    check(call("GET", "/weblogs-p/_count")["count"] == len(docs)
          and geo > 0, f"22d: {len(docs)} docs, {geo} with a geo block")
    report["22d"] = {"docs": len(docs),
                     "pipeline_docs_per_s": rates["weblogs-p"],
                     "plain_docs_per_s": rates["weblogs-n"],
                     "simulate_ms": sim_ms, "simulated_equal": same,
                     "geo_resolved": geo}
    log(f"[phase 22d] {json.dumps(report['22d'])} ({smi})")

    # ---- 22f: rollover, shrink, _field_caps, _termvectors -------------
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs, "phase 22f",
                    acc, on_card) as lad:
        small_map = {"_doc": {"properties": {"title": {"type": "text"},
                                             "venue": {"type": "keyword"},
                                             "year": {"type": "long"}}}}
        call("PUT", "/logs-000001", {
            "settings": {"number_of_shards": 1, "refresh_interval": "-1",
                         "requests.cache.enable": False},
            "mappings": small_map, "aliases": {"logs": {}}})
        src_docs = [(m["_id"], s) for _a, m, s in ops[:ADMIN_DOCS]]
        call("POST", "/_bulk?refresh=true", bulk_lines("logs",
                                                       src_docs[:60]),
             ctype="application/x-ndjson")
        dry = timed("22f rollover dry_run", lambda: call(
            "POST", "/logs/_rollover?dry_run",
            {"conditions": {"max_docs": 50}}), reps=3)
        check(dry["dry_run"] and not dry["rolled_over"]
              and set(call("GET", "/_alias/logs")) == {"logs-000001"},
              "22f: dry_run moves nothing")
        xs = []
        for k in range(2, 5):
            if k > 2:
                call("POST", "/_bulk?refresh=true", bulk_lines(
                    "logs", src_docs[60 * k: 60 * k + 60]),
                    ctype="application/x-ndjson")
            t0 = time.perf_counter()
            r = call("POST", "/logs/_rollover",
                     {"conditions": {"max_docs": 50}})
            xs.append((time.perf_counter() - t0) * 1000)
            check(r["rolled_over"] and r["new_index"] == f"logs-{k:06d}"
                  and set(call("GET", "/_alias/logs")) == {r["new_index"]},
                  f"22f: rollover to logs-{k:06d} moved the alias")
        report["items"]["22f rollover"] = {"p50_ms": float(np.median(xs)),
                                           "samples": len(xs)}
        call("PUT", "/big4", {"settings": {"number_of_shards": 4,
                                           "refresh_interval": "-1",
                                           "requests.cache.enable": False},
                              "mappings": small_map})
        for lo in range(0, len(src_docs), 1000):
            call("POST", "/_bulk", bulk_lines("big4", src_docs[lo: lo + 1000]),
                 ctype="application/x-ndjson")
        call("POST", "/big4/_refresh")
        xs = []
        for k in range(2):
            t0 = time.perf_counter()
            call("POST", f"/big4/_shrink/small{k}", {"settings": {
                "index.number_of_shards": 1}})
            xs.append((time.perf_counter() - t0) * 1000)
        report["items"]["22f shrink 4 -> 1"] = {"p50_ms": float(np.median(xs)),
                                                "samples": len(xs)}
        for q in ([queries[0][0]], queries[1][:2], [queries[3][0]]):
            body = {"query": {"match": {"title": " ".join(tok(t)
                                                          for t in q)}},
                    "size": ADMIN_DOCS}
            a = call("POST", "/big4/_search", body)
            b = call("POST", "/small0/_search", body)
            check(a["hits"]["total"] == b["hits"]["total"]
                  and {h["_id"] for h in a["hits"]["hits"]}
                  == {h["_id"] for h in b["hits"]["hits"]},
                  f"22f: the shrunk index answers {q} as the source does")
        caps = timed("22f _field_caps logs-*", lambda: call(
            "GET", "/logs-*/_field_caps?fields=*"), reps=5)
        check(caps["fields"]["title"] == {"text": {
            "type": "text", "searchable": True, "aggregatable": False}}
            and "venue" in caps["fields"], "22f: _field_caps over logs-*")
        doc_id, src0 = src_docs[0]
        tv = timed("22f _termvectors", lambda: call(
            "GET", f"/big4/_termvectors/{doc_id}"), reps=5)
        svc = g7.indices["big4"]
        shard = svc.shards[svc._route(doc_id)]
        seg = next(s for s in shard.engine.searchable_segments()
                   if doc_id in s.id_to_doc())
        words = src0["title"].split()
        terms = tv["term_vectors"]["title"]["terms"]
        check(tv["found"] and set(terms) == set(words) and all(
            terms[w]["term_freq"] == words.count(w)
            and terms[w]["doc_freq"] == int(seg.term_doc_freq[
                seg.term_id("title", w)])
            and [t["position"] for t in terms[w]["tokens"]]
            == [i for i, x in enumerate(words) if x == w]
            for w in set(words)),
            "22f: _termvectors equal the segment's postings and the text")
    log(f"[phase 22f] items: " + json.dumps(
        {k: v for k, v in report["items"].items() if k.startswith("22f")})
        + f" launches {lad} ({smi})")
    for name in ("dm4", "dm1", "weblogs-n", "weblogs-p", "big4", "small0",
                 "small1", "logs-000001", "logs-000002", "logs-000003",
                 "logs-000004"):
        call("DELETE", f"/{name}")
    call("DELETE", "/_ingest/pipeline/nginx")
    client.close()
    srv.stop()
    fails = plane_failures(g7.indices["pmc4"], g7.indices["pmc4h"])
    check(not any(fails), f"phase 22: zero plane faults ({fails})")
    report["launches"] = acc
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 22] {report['seconds']:.1f} s, launches {acc} ({smi})")
    return report


def snapshot_restore_phase(torch, cuda_kernels, tsc, ssum, knn, g2, bodies,
                           repo_root, errs, smi):
    """22e, on 13c's recovered node (pmc-4x256k, durable, synced-flushed,
    its ``path.repo`` the run's temporary ``repo_root``): a 200-doc index
    beside it; ``PUT _snapshot/r`` (fs, relative location) and snapshot
    ``s1`` of both (seconds and bytes), then ``s2`` (incremental: 0 new
    bytes); ``_restore`` of dur4 with ``rename_pattern`` (seconds), the
    restored index's staging and first answer (ms, 1a launches); 40 of
    13c's requests equal byte for byte between dur4 and the restored
    index; one blob of dur4 corrupted in a hard-linked copy of the
    repository: its restore fails dur4 alone. Restored indices deleted.
    Every launch held against plain. Returns the report."""
    from elasticsearch_tpu_torch.rest.controller import RestController

    report = {}
    acc = {}
    t_phase = time.perf_counter()
    rc = RestController(g2)

    def call(method, path, body=None, want=200, params=None):
        raw = b"" if body is None else json.dumps(body).encode()
        st, r = rc.dispatch(method, path, dict(params or {}), raw,
                            "application/json")
        check(st == want, f"22e: {method} {path} answered {st} (want "
                          f"{want}: {str(r)[:300]})")
        return r

    g2.create_index("tiny", {"settings": {
        "number_of_shards": 1, "refresh_interval": "-1",
        "requests.cache.enable": False,
        "translog": {"durability": "async"}}})
    g2.bulk([("index", {"_index": "tiny", "_id": str(i)},
              {"n": i, "msg": f"w{i % 7}"}) for i in range(200)],
            refresh=True)
    call("PUT", "/_snapshot/r", {"type": "fs", "settings": {"location": "r"}})
    call("POST", "/_snapshot/r/_verify")
    snaps = {}
    for name in ("s1", "s2"):
        t0 = time.perf_counter()
        r = call("PUT", f"/_snapshot/r/{name}", {"indices": "dur4,tiny"},
                 params={"wait_for_completion": "true"})
        snaps[name] = {"s": time.perf_counter() - t0,
                       "bytes_written": g2.snapshots.bytes_written,
                       "bytes_reused": g2.snapshots.bytes_reused,
                       "state": r["snapshot"]["state"]}
    check(snaps["s1"]["state"] == snaps["s2"]["state"] == "SUCCESS"
          and snaps["s1"]["bytes_written"] > 0
          and snaps["s2"]["bytes_written"] == 0
          and snaps["s2"]["bytes_reused"] == snaps["s1"]["bytes_written"],
          f"22e: s1 wrote the index, s2 no new byte ({snaps})")
    repo_dir = os.path.join(repo_root, "r")
    report["snapshots"] = snaps
    # (s2's blobs are hard links to s1's: each file counted once)
    inodes = {}
    for d, _s, files in os.walk(repo_dir):
        for f in files:
            st = os.stat(os.path.join(d, f))
            inodes[(st.st_dev, st.st_ino)] = st.st_size
    report["repository_bytes"] = sum(inodes.values())
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = call("POST", "/_snapshot/r/s1/_restore", {
        "indices": "dur4", "rename_pattern": "dur4",
        "rename_replacement": "dur4r"})
    restore_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    check(out["snapshot"]["indices"] == ["dur4r"]
          and out["snapshot"]["shards"]["failed"] == 0,
          f"22e: dur4 restored as dur4r ({out})")
    svc = g2.indices["dur4r"]
    check(mem1 - mem0 <= 1 << 20,
          f"22e: the restore staged nothing on the card ({mem0} -> {mem1})")
    t0 = time.perf_counter()
    for sh in svc.shards.values():
        for seg in sh.engine.searchable_segments():
            seg.device_arrays()
            seg.ensure_vector_staged("emb")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    label, first_body = bodies[0]
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs,
                    "phase 22e first answer", acc) as lf:
        first, first_ms, spans = _first_answer(
            torch, lambda: g2.search("dur4r", dict(first_body)))
    check(first.get("_plane") == "mesh_pallas",
          f"22e: the restored index's first answer on the mesh "
          f"({first.get('_plane')})")
    chosen = bodies[:40]
    same = 0
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs,
                    "phase 22e requests", acc) as lr:
        for label, body in chosen:
            a = _no_took(g2.search("dur4", dict(body)))
            b = _no_took(g2.search("dur4r", dict(body))).replace(
                '"dur4r"', '"dur4"')
            same += a == b
    check(same == len(chosen),
          f"22e: {same} of {len(chosen)} requests equal byte for byte "
          f"between dur4 and the restored dur4r")
    # the corrupt copy: every blob hard-linked, one replaced by a flipped
    # copy (the original repository keeps its bytes)
    copy_dir = os.path.join(repo_root, "rc")
    for d, _s, files in os.walk(repo_dir):
        rel = os.path.relpath(d, repo_dir)
        os.makedirs(os.path.join(copy_dir, rel), exist_ok=True)
        for f in files:
            os.link(os.path.join(d, f), os.path.join(copy_dir, rel, f))
    manifest = g2.snapshots._repo("r").read_manifest("s1")
    blob = next(iter(manifest["indices"]["dur4"]["shards"]["0"]["digests"]))
    target = os.path.join(copy_dir, "snapshots", "s1", "indices", "dur4",
                          "0", blob)
    with open(target, "rb") as f:
        data = bytearray(f.read())
    data[0] ^= 0x01
    os.unlink(target)
    with open(target, "wb") as f:
        f.write(data)
    call("PUT", "/_snapshot/rc", {"type": "fs",
                                  "settings": {"location": "rc"}})
    t0 = time.perf_counter()
    bad = call("POST", "/_snapshot/rc/s1/_restore", {
        "rename_pattern": "^", "rename_replacement": "c-"})
    bad_ms = (time.perf_counter() - t0) * 1000
    snap = bad["snapshot"]
    check(snap["indices"] == ["c-tiny"] and snap["shards"]["failed"] == 1
          and snap["failures"][0]["index"] == "dur4"
          and snap["failures"][0]["type"] == "corrupted_snapshot_exception"
          and "c-dur4" not in g2.indices
          and g2.search("c-tiny", {"size": 0})["hits"]["total"] == 200,
          f"22e: the corrupt blob failed dur4 alone ({str(snap)[:300]})")
    for name in ("dur4r", "c-tiny", "tiny"):
        g2.delete_index(name)
    report.update({
        "docs": 4 * MESH_SHARD_DOCS, "restore_s": restore_s,
        "restored_stage_s": stage_s, "first_answer_ms": first_ms,
        "first_answer_spans_ms": spans, "first_answer_launches": lf,
        "requests_equal": same, "requests": len(chosen),
        "request_launches": lr, "corrupt_restore_ms": bad_ms,
        "launches": acc, "seconds": time.perf_counter() - t_phase})
    log(f"[phase 22e] {json.dumps(report)} ({smi})")
    return report


# ----------------------------------------------------------------------
# Phase 23: the field-type and query remainder (geo_shape, index sorting,
# the request cache, percolate, suggest, spans)
# ----------------------------------------------------------------------

# 23a: geo4's shapes, one set a shard, over a 200 x 100 degree box
GEO23_SHARD_DOCS = 65_536
GEO23_SEEDS = (41, 42, 43, 44)
# geo4's titles: the corpus generator at a median of 20 tokens (a match
# beside the shape filter needs the postings, not the 80-token length)
GEO23_TITLE_LEN = 20
# an envelope over about 1% of that box (14.14 degrees square); the query
# coordinates carry 7 decimals, the shapes' 6, so no vertex lies on a
# query edge
GEO23_ENV = [[-7.0710681, 7.0710679], [7.0710677, -7.0710683]]
GEO23_ENV_B = [[-57.0710681, -12.9289321], [-42.9289319, -27.0710679]]
GEO23_HEX = [[round(40.0000003 + 6 * math.cos(a), 7),
              round(10.0000007 + 6 * math.sin(a), 7)]
             for a in (k * math.pi / 3 for k in range(6))]
GEO23_POINT = [0.5000001, 0.5000003]
# 23d: an alerting rule set (its own vocabulary of 200 words) and its
# candidate documents
PERC23_QUERIES = 1_000
PERC23_CANDIDATES = 20
PERC23_WORDS = [f"w{i:03d}" for i in range(200)]
# 23e: the search-as-you-type index; 23f: _size's small index
COMPL23_DOCS = 5_000
SIZE23_DOCS = 2_000


def geoshape_set(seed, n):
    """``n`` shapes in the mix of Rally's ``geoshape`` track (OpenStreetMap
    ways and relations): 60% linestrings of 2-16 vertices, 30% polygons of
    5-32 ring points (a quarter of those with 5 or more vertices carry a
    square hole, 0.2% of them country-sized), 10% points, centred over a
    200 x 100 degree box, coordinates at 6 decimals. Returns the GeoJSON
    of each and the flat arrays ``geo_oracle`` reads: every ring (closed),
    every segment, and the points ``utils/geometry`` relates (a line's
    vertices, a shell's without its closing one, the point)."""
    rng = np.random.RandomState(seed)
    kind = rng.choice(3, n, p=[0.1, 0.6, 0.3])  # point, line, polygon
    cx = rng.uniform(-100, 100, n)
    cy = rng.uniform(-50, 50, n)
    nv = np.where(kind == 1, rng.randint(2, 17, n),
                  np.where(kind == 2, rng.randint(4, 32, n), 1))
    owner = np.repeat(np.arange(n), nv)
    start = np.cumsum(nv) - nv
    k_in = np.arange(len(owner)) - np.repeat(start, nv)
    # lines: a random walk; polygons: stratified angles around the centre
    step = rng.randn(len(owner), 2) * 0.3
    step[k_in == 0] = 0.0
    walk = np.cumsum(step, axis=0)
    walk -= np.repeat(walk[start], nv, axis=0)
    big = rng.rand(n) < 0.002
    r0 = np.where(big, rng.uniform(10, 20, n), rng.uniform(0.2, 1.5, n))
    ang = 2 * np.pi * (k_in + rng.rand(len(owner))) / np.repeat(nv, nv)
    rad = np.repeat(r0, nv) * rng.uniform(0.7, 1.0, len(owner))
    is_line = np.repeat(kind == 1, nv)
    is_poly = np.repeat(kind == 2, nv)
    vx = np.repeat(cx, nv) + np.where(is_line, walk[:, 0],
                                      np.where(is_poly, rad * np.cos(ang), 0))
    vy = np.repeat(cy, nv) + np.where(is_line, walk[:, 1],
                                      np.where(is_poly, rad * np.sin(ang), 0))
    vx, vy = np.round(vx, 6), np.round(vy, 6)
    holed = (kind == 2) & (nv >= 5) & (rng.rand(n) < 0.25)
    # rings: every shell (its vertices, then the first again), then every
    # hole (a square of half-side 0.2 r0 around the centre)
    polys = np.flatnonzero(kind == 2)
    slen = nv[polys] + 1
    sown = np.repeat(polys, slen)
    soff = np.arange(slen.sum()) - np.repeat(np.cumsum(slen) - slen, slen)
    soff[soff == np.repeat(nv[polys], slen)] = 0
    sidx = start[sown] + soff
    holes = np.flatnonzero(holed)
    h = 0.2 * r0[holes]
    hx = np.round(cx[holes, None] + np.array([-1, 1, 1, -1, -1]) * h[:, None],
                  6).ravel()
    hy = np.round(cy[holes, None] + np.array([-1, -1, 1, 1, -1])
                  * h[:, None], 6).ravel()
    rx = np.concatenate([vx[sidx], hx])
    ry = np.concatenate([vy[sidx], hy])
    rlen = np.concatenate([slen, np.full(len(holes), 5)])
    ring_owner = np.concatenate([polys, holes])
    ring_hole = np.concatenate([np.zeros(len(polys), bool),
                                np.ones(len(holes), bool)])
    # GeoJSON, a shape at a time over Python lists
    allpts = np.stack([vx, vy], 1).tolist()
    hpts = np.stack([hx, hy], 1).tolist()
    hole_of = {int(o): k for k, o in enumerate(holes.tolist())}
    geojson = []
    for i, (kd, lo, cnt) in enumerate(zip(kind.tolist(), start.tolist(),
                                          nv.tolist())):
        pts = allpts[lo: lo + cnt]
        if kd == 0:
            geojson.append({"type": "point", "coordinates": pts[0]})
        elif kd == 1:
            geojson.append({"type": "linestring", "coordinates": pts})
        else:
            rings = [pts + [pts[0]]]
            k = hole_of.get(i)
            if k is not None:
                rings.append(hpts[5 * k: 5 * k + 5])
            geojson.append({"type": "polygon", "coordinates": rings})
    # segments: a line's consecutive vertices, every ring's edges
    lines = np.flatnonzero(is_line & (k_in + 1 < np.repeat(nv, nv)))
    rstart = np.cumsum(rlen) - rlen
    edge = np.ones(len(rx), bool)
    edge[rstart + rlen - 1] = False
    redges = np.flatnonzero(edge)
    shell_pts = np.flatnonzero(edge & ~np.repeat(ring_hole, rlen))
    pts = np.flatnonzero(~is_poly)
    bbox = np.stack([np.minimum.reduceat(vx, start),
                     np.minimum.reduceat(vy, start),
                     np.maximum.reduceat(vx, start),
                     np.maximum.reduceat(vy, start)], 1)
    return {
        "geojson": geojson, "kind": kind, "bbox": bbox,
        "ring_owner": ring_owner, "ring_hole": ring_hole,
        "edge_x1": rx[redges], "edge_y1": ry[redges],
        "edge_x2": rx[redges + 1], "edge_y2": ry[redges + 1],
        "edge_ring": np.repeat(np.arange(len(rlen)), rlen - 1),
        "seg_x1": np.concatenate([vx[lines], rx[redges]]),
        "seg_y1": np.concatenate([vy[lines], ry[redges]]),
        "seg_x2": np.concatenate([vx[lines + 1], rx[redges + 1]]),
        "seg_y2": np.concatenate([vy[lines + 1], ry[redges + 1]]),
        "seg_owner": np.concatenate([owner[lines],
                                     np.repeat(ring_owner, rlen - 1)]),
        "pt_x": np.concatenate([vx[pts], rx[shell_pts]]),
        "pt_y": np.concatenate([vy[pts], ry[shell_pts]]),
        "pt_owner": np.concatenate([owner[pts],
                                    np.repeat(ring_owner, rlen)[shell_pts]]),
    }


def _subset(sset, keep):
    """The flat arrays of the docs ``keep`` marks (their owner ids kept)."""
    out = dict(sset)
    for prefix, owner in (("edge_", "edge_ring"), ("seg_", "seg_owner"),
                          ("pt_", "pt_owner")):
        if prefix == "edge_":
            sel = keep[sset["ring_owner"][sset["edge_ring"]]]
        else:
            sel = keep[sset[owner]]
        for key in sset:
            if key.startswith(prefix) or key == owner:
                out[key] = sset[key][sel]
    return out


def _ray_parity(px, py, x1, y1, x2, y2):
    """[points, edges] crossings of ``utils/geometry._point_in_ring``'s
    ray cast, in its arithmetic order."""
    px, py = px[:, None], py[:, None]
    straddle = (y1 > py) != (y2 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = (x2 - x1) * (py - y1) / (y2 - y1) + x1
    return straddle & (px < xin)


def _orient(ax, ay, bx, by, cx, cy):
    v = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    return np.where(np.abs(v) < 1e-12, 0, np.sign(v))


def _segments_cross(ax, ay, bx, by, cx, cy, dx, dy):
    """``utils/geometry._seg_intersect`` for every pair (broadcast)."""
    o1, o2 = _orient(ax, ay, bx, by, cx, cy), _orient(ax, ay, bx, by, dx, dy)
    o3, o4 = _orient(cx, cy, dx, dy, ax, ay), _orient(cx, cy, dx, dy, bx, by)

    def on(px, py, qx, qy, rx, ry):
        return ((np.minimum(px, qx) - 1e-12 <= rx)
                & (rx <= np.maximum(px, qx) + 1e-12)
                & (np.minimum(py, qy) - 1e-12 <= ry)
                & (ry <= np.maximum(py, qy) + 1e-12))

    return (((o1 != o2) & (o3 != o4)) | ((o1 == 0) & on(ax, ay, bx, by, cx, cy))
            | ((o2 == 0) & on(ax, ay, bx, by, dx, dy))
            | ((o3 == 0) & on(cx, cy, dx, dy, ax, ay))
            | ((o4 == 0) & on(cx, cy, dx, dy, bx, by)))


def geo_oracle(sset, shape, relation):
    """The docs whose shape holds ``relation`` to the query ``shape`` (a
    GeoJSON point, envelope or polygon), computed with numpy over the
    set's flat arrays as ``utils/geometry`` decides it (a shape point in
    the query's area, a query point in a polygon's area with its holes,
    an edge crossing; within: every point and segment midpoint in the
    other's area). Boundary contacts are left out: no shape coordinate
    lies on a query edge."""
    from elasticsearch_tpu_torch.utils.geometry import parse_shape

    q = parse_shape(shape)
    n = len(sset["kind"])
    # only the docs the bbox prefilter keeps can hold the relation (but
    # disjoint, its complement): the arrays shrink to theirs
    qb = q.bbox()
    b = sset["bbox"]
    overlap = ~((b[:, 0] > qb[2]) | (qb[0] > b[:, 2])
                | (b[:, 1] > qb[3]) | (qb[1] > b[:, 3]))
    cand = overlap
    if relation == "contains":
        cand = ((b[:, 0] <= qb[0]) & (b[:, 1] <= qb[1])
                & (b[:, 2] >= qb[2]) & (b[:, 3] >= qb[3]))
    sset = _subset(sset, cand)
    qpts = np.asarray(q.points(), np.float64).reshape(-1, 2)
    qsegs = np.asarray(q.segments(), np.float64).reshape(-1, 4)
    qring = np.asarray(q.rings()[0].shell, np.float64) if q.rings() else None

    def in_query(px, py):
        if qring is None:
            return np.zeros(len(px), bool)
        return _ray_parity(px, py, qring[:-1, 0], qring[:-1, 1],
                           qring[1:, 0], qring[1:, 1]).sum(1) % 2 == 1

    def in_shapes(px, py):
        """[query points, docs]: the point in the doc's polygon area."""
        par = _ray_parity(px, py, sset["edge_x1"], sset["edge_y1"],
                          sset["edge_x2"], sset["edge_y2"])
        n_rings = len(sset["ring_owner"])
        ring_in = np.stack([np.bincount(sset["edge_ring"], weights=row,
                                        minlength=n_rings) % 2 == 1
                            for row in par])
        out = np.zeros((len(px), n), bool)
        shell = ~sset["ring_hole"]
        for k in range(len(px)):
            inside = np.zeros(n, bool)
            inside[sset["ring_owner"][shell]] = ring_in[k][shell]
            in_hole = np.zeros(n, bool)
            np.logical_or.at(in_hole, sset["ring_owner"][~shell],
                             ring_in[k][~shell])
            out[k] = inside & ~in_hole
        return out

    def per_doc_any(flags, owner):
        out = np.zeros(n, bool)
        np.logical_or.at(out, owner, flags)
        return out

    def per_doc_all(flags, owner):
        bad = np.zeros(n, bool)
        np.logical_or.at(bad, owner, ~flags)
        return ~bad

    px, py, po = sset["pt_x"], sset["pt_y"], sset["pt_owner"]
    sx1, sy1, sx2, sy2 = (sset[k] for k in ("seg_x1", "seg_y1", "seg_x2",
                                            "seg_y2"))
    if relation in ("intersects", "disjoint"):
        hit = per_doc_any(in_query(px, py), po)
        if len(qpts):
            hit |= in_shapes(qpts[:, 0], qpts[:, 1]).any(0)
        for x1, y1, x2, y2 in qsegs:
            hit |= per_doc_any(_segments_cross(sx1, sy1, sx2, sy2,
                                               x1, y1, x2, y2),
                               sset["seg_owner"])
        hit &= overlap
        return ~hit if relation == "disjoint" else hit
    if relation == "within":
        ok = per_doc_all(in_query(px, py), po)
        mx, my = (sx1 + sx2) / 2.0, (sy1 + sy2) / 2.0
        return (ok & per_doc_all(in_query(mx, my), sset["seg_owner"])
                & cand)
    # contains: the query's points and segment midpoints in the doc's area
    tests = [qpts] + ([(qsegs[:, :2] + qsegs[:, 2:]) / 2.0]
                      if len(qsegs) else [])
    pts = np.concatenate(tests)
    return in_shapes(pts[:, 0], pts[:, 1]).all(0) & cand


class _ShapeSources:
    """Stored sources made on demand: the corpus's fields and the doc's
    shape."""

    def __init__(self, base, geojson):
        self._base, self._geojson = base, geojson

    def __len__(self):
        return len(self._geojson)

    def __getitem__(self, d):
        return dict(self._base[d], region=self._geojson[d])


class _PermutedSources:
    """Stored sources in a new doc order: ``perm[new] = old``."""

    def __init__(self, base, perm):
        self._base, self._perm = base, perm

    def __len__(self):
        return len(self._perm)

    def __getitem__(self, d):
        return self._base[int(self._perm[d])]

    def __iter__(self):
        return (self._base[i] for i in self._perm.tolist())


def index_sorted_fields(torch, isort, fields, spec, device="cuda"):
    """``Segment.from_arrays`` fields with their docs in the index sort
    ``spec``: the order ``SegmentBuilder(index_sort=spec).seal()`` gives
    the same documents. The permutation is the port's
    ``isort.index_sort_permutation`` over the fields' doc-value columns of
    the sort fields; each posting list is re-sorted by its new doc ids on
    ``device`` (its block layout stays: a term's doc count does not
    change). Takes what phase 12's doc-values segments carry (postings,
    norms, live docs, ids, sources, numeric and ordinal columns, and
    routings, parents, seqnos and versions where given); refuses
    positions, nested objects, exists masks, geo, vector and shape
    columns."""
    from types import SimpleNamespace

    for key in ("positions", "nested", "exists_masks", "geo_columns",
                "vector_columns", "shapes"):
        if fields.get(key):
            raise ValueError(f"index_sorted_fields: {key} not permuted")
    n = len(fields["doc_ids"])
    num = fields.get("numeric_columns") or {}
    ords = fields.get("ordinal_columns") or {}
    sort_fields = {f for f, *_ in spec}
    view = SimpleNamespace(
        num_docs=n,
        numeric_values={
            f: (np.asarray(c["flat_docs"][: c["count"]], np.int64),
                np.asarray(c["flat_values"][: c["count"]], np.float64))
            for f, c in num.items() if f in sort_fields},
        string_values={
            f: [(d, c["terms"][o]) for d, o in zip(
                c["flat_docs"][: c["count"]].tolist(),
                c["flat_ords"][: c["count"]].tolist())]
            for f, c in ords.items() if f in sort_fields})
    perm = isort.index_sort_permutation(view, spec)
    if perm is None:
        return dict(fields)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    def per_doc(a):
        a = np.array(a)
        a[:n] = a[:n][perm]
        return a

    def flat(c, per_doc_keys, flat_keys):
        """A column's flat entries sorted stably by their new doc (a doc's
        values keep their order), its per-doc arrays permuted."""
        out = dict(c)
        cnt = c["count"]
        new_docs = inv[np.asarray(c["flat_docs"][:cnt], np.int64)]
        order = np.argsort(new_docs, kind="stable")
        out["flat_docs"] = np.array(c["flat_docs"])
        out["flat_docs"][:cnt] = new_docs[order]
        for k in flat_keys:
            out[k] = np.array(c[k])
            out[k][:cnt] = np.asarray(c[k][:cnt])[order]
        for k in per_doc_keys:
            out[k] = per_doc(c[k])
        return out

    out = dict(fields)
    # postings: a term's entries fill its blocks in order, so the valid
    # lanes row by row are every term's list in term order
    block_docs = np.asarray(fields["block_docs"], np.int32)
    block_tfs = np.asarray(fields["block_tfs"], np.float32)
    valid = np.flatnonzero(block_docs.reshape(-1) < n)
    df = np.asarray(fields["term_doc_freq"], np.int64)
    term = np.repeat(np.arange(len(df), dtype=np.int64), df)
    docs = inv[block_docs.reshape(-1)[valid]]
    key = torch.from_numpy(term * n + docs).to(device)
    order = torch.argsort(key, stable=True).cpu().numpy()
    bd, bt = block_docs.reshape(-1).copy(), block_tfs.reshape(-1).copy()
    bd[valid] = docs[order]
    bt[valid] = block_tfs.reshape(-1)[valid][order]
    out["block_docs"] = bd.reshape(block_docs.shape)
    out["block_tfs"] = bt.reshape(block_tfs.shape)
    norms = np.array(fields["norms"], np.float32)
    norms[:, :n] = norms[:, :n][:, perm]
    out["norms"] = norms
    out["live"] = per_doc(fields["live"])
    out["doc_ids"] = list(map(fields["doc_ids"].__getitem__, perm.tolist()))
    out["sources"] = _PermutedSources(fields["sources"], perm)
    for key in ("routings", "parents"):
        if fields.get(key) is not None:
            out[key] = list(map(fields[key].__getitem__, perm.tolist()))
    for key in ("seqnos", "versions"):
        if fields.get(key) is not None:
            out[key] = np.asarray(fields[key])[perm]
    out["numeric_columns"] = {
        f: flat(c, ("first_value", "min_value", "max_value", "exists"),
                ("flat_values",)) for f, c in num.items()}
    out["ordinal_columns"] = {
        f: flat(c, ("first_ord", "exists"), ("flat_ords",))
        for f, c in ords.items()}
    return out


@contextlib.contextmanager
def no_cycle_collection():
    """The block makes hundreds of thousands of objects that live to the
    phase's end (shapes, version-map entries): no cycle collection while
    it runs, and what it made frozen after it (a full collection walks the
    whole, by then large, heap), as phase 18 does with its corpus."""
    import gc

    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.freeze()


@contextlib.contextmanager
def timing_calls(module, names, sync):
    """While the block runs, the host seconds of each named function of
    ``module`` (ending in ``sync()``, a device sync) add to
    ``spent[name]``."""
    spent = {name: 0.0 for name in names}
    orig = {name: getattr(module, name) for name in names}

    def timed(name):
        def fn(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig[name](*args, **kw)
            finally:
                sync()
                spent[name] += time.perf_counter() - t0
        return fn

    for name in names:
        setattr(module, name, timed(name))
    try:
        yield spent
    finally:
        for name in names:
            setattr(module, name, orig[name])


def alert_queries(n, seed):
    """An alerting rule set: a third ``match`` of two words, a third a
    ``bool`` with a ``match`` and a ``range`` on ``year``, a third a
    ``term`` on ``venue``."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            q = {"match": {"title": " ".join(rng.choice(PERC23_WORDS, 2))}}
        elif kind == 1:
            q = {"bool": {"must": [{"match": {"title": str(
                rng.choice(PERC23_WORDS))}}], "filter": [{"range": {"year": {
                    "gte": int(rng.randint(1990, 2024))}}}]}}
        else:
            q = {"term": {"venue": f"v{int(rng.randint(0, 20)):04d}"}}
        out.append((f"rule{i}", {"q": q}))
    return out


def alert_match(q, doc):
    """The stored query evaluated in plain Python."""
    words = set(doc["title"].split())
    if "match" in q:
        return bool(words & set(q["match"]["title"].split()))
    if "term" in q:
        return doc["venue"] == q["term"]["venue"]
    return (q["bool"]["must"][0]["match"]["title"] in words
            and doc["year"] >= q["bool"]["filter"][0]["range"]["year"]["gte"])


def misspell(word, rng):
    """One edit of ``word``: a deletion, a substitution or a repeat."""
    i = int(rng.randint(1, len(word)))
    op = int(rng.randint(3))
    if op == 0:
        return word[:i] + word[i + 1:]
    if op == 1:
        return word[:i] + str((int(word[i]) + 1) % 10) + word[i + 1:] \
            if word[i].isdigit() else word[:i] + "x" + word[i + 1:]
    return word[:i] + word[i] + word[i:]


def remainder_phase(torch, Node, Segment, cuda_kernels, tsc, ssum, knn,
                    pmcq, dv_segs, dv_mapping, queries, errs, smi,
                    device="cuda"):
    """Phase 23: the field-type and query remainder on the card.

    23a. geo4: a 4-shard index of 4 x 65,536 docs (the corpus generator's
         title, venue and year, seeds 41-44) with a ``region`` geo_shape
         on every doc, 262,144 shapes in Rally geoshape's mix
         (``geoshape_set``); geo4h the same segments with ``search.mesh:
         false``. An envelope over about 1% of the docs under
         ``intersects``, ``within``, ``contains`` and ``disjoint``, a
         point under ``contains``, a hexagon under ``intersects`` and
         ``within``, and an ``indexed_shape`` (a second envelope stored in
         ``zones``): each alone on geo4h (host rung) and in a bool beside
         a ``match`` on geo4 (``mesh_pallas``). Totals equal the numpy
         oracle (``geo_oracle``; beside the match, the oracle and the
         match's postings), geo4 equals geo4h hit for hit. Logs the shape
         columns' build, the bbox tables' staged bytes, the prefilter's
         device ms apart from the host relation's ms.
    23b. logs-sorted: phase 12's doc-values arrays permuted into
         ``ts`` desc by the port's ``index_sort_permutation``
         (``index_sorted_fields``) and adopted as a 4-shard index sorted
         by ``ts`` desc; logs-a phase 12's segments unsorted
         (``search.mesh: false``). Discover's body (a match
         sorted by ``ts`` desc, size 500): ``terminated_early`` on
         logs-sorted with the exact total, the hits, sort values and
         buckets equal logs-a's; the p50 of both.
    23c. The request cache on logs-a (``index.requests.cache.enable``):
         a dashboard panel (``size: 0``, a ``terms`` and a
         ``date_histogram``): the miss launches kernel 2, the hit launches
         nothing and answers the miss's hits and buckets, a write and a
         refresh make the next request a miss; ``_stats``' counts and
         ``_cache/clear``'s answer over REST.
    23d. alerts: a 1-shard index of 1,000 stored queries
         (``alert_queries``); 20 candidate documents percolated, the
         matched ids equal the plain Python evaluation; the ms a candidate
         and the 1a launches on the one-doc segment.
    23e. The term and phrase suggesters on pmcq's title with seeded
         misspellings (card node against the cpu twin), and a
         ``completion`` field with a category and a geo context on a
         5,000-doc bulk-ingested index (against a plain Python
         evaluation); the p50s.
    23f. Each span kind on pmcq's title and abstract alone on pmcqh (the
         host rung) and in a bool beside a match on pmcq (``mesh_pallas``),
         equal to the cpu twin's, with the span enumeration's host ms
         apart from the rest; ``type`` answers as ``match_all``; ``_size``
         under a range, a sort and a ``max`` on a 2,000-doc index against
         the sources' byte counts.

    Every 1a and kernel-2 launch of the main path is held against its
    plain version. Closes ``pmcq``'s nodes and its own. Returns the
    report."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.index import index_sort as isort
    from elasticsearch_tpu_torch.index.segment import tensor_bytes
    from elasticsearch_tpu_torch.rest.controller import RestController
    from elasticsearch_tpu_torch.search import query_dsl as Q
    from elasticsearch_tpu_torch.search import spans as S
    from elasticsearch_tpu_torch.utils.geohash import encode

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    gq, cq = pmcq
    report = {"items": {}}
    tok = term_token

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def item(name, fn, reps=1):
        """``fn`` ``reps`` times on the card, synced: its p50, the plane of
        its answer and the launches of its first run."""
        before = dict(cuda_kernels.LAUNCHES)
        xs, out, launched = [], None, {}
        for i in range(reps):
            t0 = time.perf_counter()
            r = fn()
            sync()
            xs.append((time.perf_counter() - t0) * 1000)
            if i == 0:
                out = r
                launched = {k: v - before.get(k, 0) for k, v in
                            cuda_kernels.LAUNCHES.items()
                            if v != before.get(k, 0)}
        plane = out.get("_plane") if isinstance(out, dict) else None
        row = {"p50_ms": float(np.median(xs)), "samples": len(xs),
               "plane": plane, "launches": launched}
        report["items"][name] = row
        log(f"[phase 23] {name}: {json.dumps(row)} ({smi})")
        return out

    # ---- build: geo4 -----------------------------------------------------
    t0 = time.perf_counter()
    g = Node(device=device)
    geo_mapping = {"_doc": {"properties": {
        "title": {"type": "text"}, "venue": {"type": "keyword"},
        "year": {"type": "long"}, "region": {"type": "geo_shape"}}}}
    g.create_index("geo4", {"settings": {
        "number_of_shards": 4, "refresh_interval": "-1",
        "requests.cache.enable": False},
        "mappings": geo_mapping})
    g.create_index("geo4h", {"settings": {
        "number_of_shards": 4, "refresh_interval": "-1",
        "requests.cache.enable": False,
        "search": {"mesh": False}}, "mappings": geo_mapping})
    sets, match_docs = [], []
    mterms = [tok(t) for t in queries[2][:2]]
    with ThreadPoolExecutor(4) as pool:
        corpora = list(pool.map(lambda seed: build_synthetic_corpus(
            seed, n_docs=GEO23_SHARD_DOCS, avg_len=GEO23_TITLE_LEN),
            GEO23_SEEDS))
    with no_cycle_collection():
        for sh, seed in enumerate(GEO23_SEEDS):
            corpus = corpora[sh]
            sset = geoshape_set(seed, GEO23_SHARD_DOCS)
            arrays = corpus_segment_arrays(corpus, id_prefix=f"g{sh}p")
            arrays["sources"] = _ShapeSources(arrays["sources"],
                                              sset["geojson"])
            seg = Segment.from_arrays(
                f"geo4_{sh}_seg_1", device=device,
                shapes={"region": {d: [gj] for d, gj in
                                   enumerate(sset["geojson"])}}, **arrays)
            for index in ("geo4", "geo4h"):
                g.indices[index].shards[sh].engine.adopt_segment(seg)
            # the docs of the match's terms, from the corpus's postings
            m = np.zeros(GEO23_SHARD_DOCS, bool)
            for t in queries[2][:2]:
                lo = int(corpus["term_block_start"][t])
                rows = corpus["block_docs"][lo: lo + int(
                    corpus["n_blocks_per_term"][t])].ravel()
                m[rows[rows < GEO23_SHARD_DOCS]] = True
            sets.append(sset)
            match_docs.append(m)
    g.create_index("zones", {"settings": {"number_of_shards": 1},
                             "mappings": {"_doc": {"properties": {
                                 "shape": {"type": "geo_shape"}}}}})
    g.index_doc("zones", "z1", {"shape": {"type": "envelope",
                                          "coordinates": GEO23_ENV_B}},
                refresh=True)
    report["geo_build_s"] = time.perf_counter() - t0
    counts = np.bincount(np.concatenate([s["kind"] for s in sets]),
                         minlength=3)
    log(f"[phase 23] geo4 built in {report['geo_build_s']:.1f} s: "
        f"{int(counts.sum())} shapes (points {int(counts[0])}, lines "
        f"{int(counts[1])}, polygons {int(counts[2])})")

    env = {"type": "envelope", "coordinates": GEO23_ENV}
    hexagon = {"type": "polygon",
               "coordinates": [GEO23_HEX + [GEO23_HEX[0]]]}
    point = {"type": "point", "coordinates": GEO23_POINT}
    cases = [("env_intersects", env, "intersects"),
             ("env_within", env, "within"),
             ("env_contains", env, "contains"),
             ("env_disjoint", env, "disjoint"),
             ("point_contains", point, "contains"),
             ("hexagon_intersects", hexagon, "intersects"),
             ("indexed_shape_intersects", None, "intersects")]

    def shape_clause(shape, relation):
        if shape is None:
            return {"geo_shape": {"region": {"indexed_shape": {
                "index": "zones", "id": "z1", "path": "shape"},
                "relation": relation}}}
        return {"geo_shape": {"region": {"shape": shape,
                                         "relation": relation}}}

    # the shape columns (bbox table a segment) build on the first
    # geo_shape query of each segment: timed apart
    t0 = time.perf_counter()
    with no_cycle_collection():
        for sh in range(4):
            g.indices["geo4"].shards[sh].engine.segments[0].shape_column(
                "region")
    report["shape_columns_s"] = time.perf_counter() - t0
    log(f"[phase 23] 23a shape columns (the bbox tables of 262,144 shapes; "
        f"a shape is parsed when a query first reads it) in "
        f"{report['shape_columns_s']:.1f} s")

    cuda_kernels.reset_launch_counts()
    t_main = time.perf_counter()
    geo = {}
    steps = report["steps_s"] = {}
    t_step = [time.perf_counter()]

    def step(name):
        """The seconds since the previous step ended."""
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    with recording_recovered_path(tsc, ssum, knn) as kept:
        # ---- 23a: geo_shape ----------------------------------------------
        with timing_calls(Q, ("shape_prefilter", "shape_relation"),
                          sync) as spent:
            for name, shape, relation in cases:
                oracle_shape = ({"type": "envelope",
                                 "coordinates": GEO23_ENV_B}
                                if shape is None else shape)
                want = [geo_oracle(s, oracle_shape, relation) for s in sets]
                clause = shape_clause(shape, relation)
                for k in spent:
                    spent[k] = 0.0
                alone = item(f"23a {name} alone on geo4h", lambda: g.search(
                    "geo4h", {"query": clause, "size": 10}))
                split = dict(spent)
                for k in spent:
                    spent[k] = 0.0
                body = {"query": {"bool": {
                    "must": [{"match": {"title": " ".join(mterms)}}],
                    "filter": [clause]}}, "size": 10}
                mixed = item(f"23a {name} beside a match on geo4",
                             lambda: g.search("geo4", dict(body)))
                # the host rung's answer beside the match, hit for hit
                host = (g.search("geo4h", dict(body))
                        if name == "env_intersects" else mixed)
                n_want = int(sum(w.sum() for w in want))
                n_both = int(sum((w & m).sum()
                                 for w, m in zip(want, match_docs)))
                check(alone["_plane"] == "host"
                      and alone["hits"]["total"] == n_want,
                      f"23a {name} alone: host rung, total "
                      f"{alone['hits']['total']} = the oracle's {n_want}")
                check(mixed["_plane"] == "mesh_pallas"
                      and mixed["hits"]["total"] == n_both
                      and _same_exact(mixed, host),
                      f"23a {name} beside a match: {mixed['_plane']}, total "
                      f"{mixed['hits']['total']} = the oracle's {n_both}, "
                      f"equal to geo4h's answer")
                geo[name] = {"total": n_want, "beside_match": n_both,
                             "prefilter_ms": split["shape_prefilter"] * 1000,
                             "relation_ms": split["shape_relation"] * 1000}
                log(f"[phase 23] 23a {name}: {json.dumps(geo[name])}")
        bbox_bytes = sum(
            tensor_bytes(t) for sh in range(4) for key, t in
            g.indices["geo4"].shards[sh].engine.segments[0].dev_cache.items()
            if key.startswith("shape.region."))
        report["geo"] = {"cases": geo, "bbox_table_bytes": bbox_bytes,
                         "shapes": int(counts.sum())}
        log(f"[phase 23] 23a bbox tables staged: {bbox_bytes} bytes "
            f"(float64 [nd_pad, 4] and the exists mask, 4 segments)")
        check(0.004 <= geo["env_intersects"]["total"] / counts.sum() <= 0.03,
              f"23a the envelope matches about 1% of the docs "
              f"({geo['env_intersects']['total']})")

        step("23a")
        # ---- 23b: index sorting ------------------------------------------
        t0 = time.perf_counter()
        # the one index with the request cache on (the port's default):
        # 23c measures it
        g.create_index("logs-a", {"settings": {
            "number_of_shards": 4, "refresh_interval": "-1",
            "requests.cache.enable": True, "search": {"mesh": False}},
            "mappings": dv_mapping})
        g.create_index("logs-sorted", {"settings": {
            "number_of_shards": 4, "refresh_interval": "-1",
            "requests.cache.enable": False,
            "sort": {"field": ["ts"], "order": ["desc"]}},
            "mappings": dv_mapping})
        with no_cycle_collection():
            for sh, seg in enumerate(dv_segs):
                g.indices["logs-a"].shards[sh].engine.adopt_segment(seg)
        t1 = time.perf_counter()
        # phase 12's arrays in the index sort (the port's
        # index_sort_permutation; tests/test_torch_index_sort.py holds the
        # route against SegmentBuilder.seal), a segment a shard, each
        # shard's beside the others' (the sorts release the interpreter)
        spec = g.indices["logs-sorted"].shards[0].engine.index_sort

        def sorted_segment(sh):
            fields = index_sorted_fields(
                torch, isort, _segment_fields(dv_segs[sh]), spec, device)
            seg = Segment.from_arrays(f"logs-sorted_{sh}_seg_1",
                                      device=device, **fields)
            g.indices["logs-sorted"].shards[sh].engine.adopt_segment(seg)
            return seg

        with timing_calls(isort, ("index_sort_permutation",), sync) as \
                spent, ThreadPoolExecutor(4) as pool, no_cycle_collection():
            sorted_segs = list(pool.map(sorted_segment, range(4)))
        report["sort_build_s"] = time.perf_counter() - t1
        report["sort_permutation_s"] = spent["index_sort_permutation"]
        ts_sorted = all(
            bool(np.all(np.diff(s.numeric_columns["ts"].first_value[
                : s.num_docs]) <= 0)) for s in sorted_segs)
        same_docs = all(sorted(s.doc_ids) == sorted(d.doc_ids)
                        for s, d in zip(sorted_segs, dv_segs))
        check(ts_sorted and same_docs,
              "23b logs-sorted's segments hold logs-a's docs in ts desc")
        log(f"[phase 23] 23b logs-sorted: 4 x {dv_segs[0].num_docs} docs "
            f"sorted and adopted in {report['sort_build_s']:.1f} s (the four "
            f"permutations {report['sort_permutation_s']:.1f} s of thread "
            f"time); logs-a's adopted in {t1 - t0:.1f} s")
        disc = discover_body(queries)
        # (three samples: the median leaves out the first answer, which
        # stages the index's segments)
        a = item("23b Discover on logs-a", lambda: g.search(
            "logs-a", dict(disc)), reps=3)
        s = item("23b Discover on logs-sorted", lambda: g.search(
            "logs-sorted", dict(disc)), reps=3)

        def by_ties(r):
            groups = {}
            for h in r["hits"]["hits"]:
                groups.setdefault(tuple(h["sort"]), set()).add(h["_id"])
            return ([tuple(h["sort"]) for h in r["hits"]["hits"]], groups)

        check(s.get("terminated_early") is True
              and a.get("terminated_early") is None
              and s["hits"]["total"] == a["hits"]["total"]
              and by_ties(s) == by_ties(a)
              and s["aggregations"] == a["aggregations"]
              and len(s["hits"]["hits"]) == min(500, s["hits"]["total"]),
              f"23b logs-sorted terminates early with the exact total "
              f"({s['hits']['total']}) and logs-a's hits and buckets")
        decisions = g.indices["logs-sorted"].search_stats()["planes"][
            "decisions"]
        check(decisions.get("host.index_sorted", 0) >= 3,
              f"23b the mesh plane declines logs-sorted ({decisions})")
        report["sort"] = {"total": s["hits"]["total"],
                          "p50_sorted_ms": report["items"][
                              "23b Discover on logs-sorted"]["p50_ms"],
                          "p50_unsorted_ms": report["items"][
                              "23b Discover on logs-a"]["p50_ms"]}

        step("23b")
        # ---- 23c: the request cache ----------------------------------------
        ctl = RestController(g)
        panel = {"size": 0, "query": {"range": {"ts": {
            "gte": AGG_T0 + 30 * AGG_DAY, "lte": AGG_T0 + 120 * AGG_DAY}}},
            "aggs": {"venues": {"terms": {"field": "venue", "size": 10}},
                     "per_day": {"date_histogram": {"field": "ts",
                                                    "interval": "1d"}}}}
        svc = g.indices["logs-a"]
        svc.request_cache.clear()
        miss = item("23c panel on logs-a (miss)",
                    lambda: g.search("logs-a", dict(panel)))
        hit = item("23c panel on logs-a (hit)",
                   lambda: g.search("logs-a", dict(panel)), reps=5)
        rows = report["items"]
        check(rows["23c panel on logs-a (miss)"]["launches"].get(
            "segment_sum", 0) > 0 or not on_card,
            "23c the miss launches kernel 2")
        check(not rows["23c panel on logs-a (hit)"]["launches"]
              and hit["hits"] == miss["hits"]
              and hit["aggregations"] == miss["aggregations"],
              f"23c a hit launches nothing "
              f"({rows['23c panel on logs-a (hit)']['launches']}) and "
              f"answers the miss's hits and buckets")
        g.index_doc("logs-a", "late-1", {
            "venue": "v0001", "year": 2023,
            "ts": AGG_T0 + 60 * AGG_DAY, "citations": 1}, refresh=True)
        after = item("23c panel after a write and a refresh",
                     lambda: g.search("logs-a", dict(panel)))
        stats = svc.stats()["total"]["request_cache"]
        check(after["hits"]["total"] == miss["hits"]["total"] + 1
              and stats["miss_count"] == 2 and stats["hit_count"] == 5
              and (rows["23c panel after a write and a refresh"][
                  "launches"].get("segment_sum", 0) > 0 or not on_card),
              f"23c the write makes the next request a miss ({stats})")
        st, rest_stats = ctl.dispatch("GET", "/logs-a/_stats/request_cache",
                                      {}, b"", "application/json")
        st2, cleared = ctl.dispatch("POST", "/logs-a/_cache/clear", {}, b"",
                                    "application/json")
        check(st == 200 and st2 == 200 and cleared == {"_shards": {
            "total": 0, "successful": 0, "failed": 0}}
            and svc.request_cache.stats()["entries"] == 0,
            f"23c _stats ({st}) and _cache/clear ({st2}: {cleared})")
        report["request_cache"] = {
            "stats": rest_stats["indices"]["logs-a"]["total"][
                "request_cache"] if st == 200 else stats,
            "cache_clear": cleared,
            "miss_ms": rows["23c panel on logs-a (miss)"]["p50_ms"],
            "hit_ms": rows["23c panel on logs-a (hit)"]["p50_ms"]}
        log(f"[phase 23] 23c {json.dumps(report['request_cache'])}")

        step("23c")
        # ---- 23d: percolate ------------------------------------------------
        g.create_index("alerts", {"settings": {
            "number_of_shards": 1, "refresh_interval": "-1",
            "requests.cache.enable": False},
            "mappings": {"_doc": {"properties": {
                "q": {"type": "percolator"}, "title": {"type": "text"},
                "year": {"type": "long"}, "venue": {"type": "keyword"}}}}})
        rules = alert_queries(PERC23_QUERIES, seed=51)
        g.bulk([("index", {"_index": "alerts", "_id": rid}, src)
                for rid, src in rules], refresh=True)
        crng = np.random.RandomState(52)
        cands = [{"title": " ".join(crng.choice(PERC23_WORDS, 12)),
                  "year": int(crng.randint(1990, 2024)),
                  "venue": f"v{int(crng.randint(0, 20)):04d}"}
                 for _ in range(PERC23_CANDIDATES)]
        before = cuda_kernels.LAUNCHES.get("tile_scoring", 0)
        t0 = time.perf_counter()
        ok = True
        for doc in cands:
            r = g.search("alerts", {"query": {"percolate": {
                "field": "q", "document": doc}}, "size": PERC23_QUERIES})
            want = {rid for rid, src in rules if alert_match(src["q"], doc)}
            ok = ok and {h["_id"] for h in r["hits"]["hits"]} == want \
                and r["hits"]["total"] == len(want)
        sync()
        perc_ms = (time.perf_counter() - t0) * 1000 / len(cands)
        perc_1a = cuda_kernels.LAUNCHES.get("tile_scoring", 0) - before
        check(ok, "23d every candidate's matched rules equal the plain "
                  "evaluation")
        check(perc_1a > 0 or not on_card,
              f"23d 1a launched on the one-doc segments ({perc_1a})")
        report["percolate"] = {"ms_per_candidate": perc_ms,
                               "launches_1a": perc_1a,
                               "candidates": len(cands),
                               "stored_queries": len(rules)}
        log(f"[phase 23] 23d percolate: {json.dumps(report['percolate'])} "
            f"({smi})")

        step("23d")
        # ---- 23e: suggest --------------------------------------------------
        srng = np.random.RandomState(53)
        sugs = []
        for q in queries[:2]:
            words = [tok(t) for t in q]
            text = " ".join(misspell(w, srng) if srng.rand() < 0.7 else w
                            for w in words)
            sugs.append({"size": 0, "suggest": {
                "t": {"text": text, "term": {"field": "title"}},
                "p": {"text": text, "phrase": {"field": "title"}}}})
        for i, body in enumerate(sugs):
            gr = item(f"23e term+phrase suggest {i} on pmcq",
                      lambda: gq.search("pmcq", dict(body)))
            cr = cq.search("pmcq", dict(body))
            check(gr["suggest"] == cr["suggest"],
                  f"23e suggestions {i} equal the cpu twin's "
                  f"({body['suggest']['t']['text']})")
        step("23e term and phrase")
        g.create_index("places", {"settings": {
            "number_of_shards": 1, "refresh_interval": "-1",
            "requests.cache.enable": False},
            "mappings": {"_doc": {"properties": {"suggest": {
                "type": "completion", "contexts": [
                    {"name": "cat", "type": "category"},
                    {"name": "loc", "type": "geo", "precision": 4}]}}}}})
        crng = np.random.RandomState(54)
        stems = ["star", "stack", "stamp", "steam", "stone", "store",
                 "storm", "strap", "straw", "stream"]
        places = []
        for i in range(COMPL23_DOCS):
            name = f"{crng.choice(stems)}{crng.choice(stems)} {i}"
            lat, lon = crng.uniform(40, 50), crng.uniform(-10, 10)
            places.append((f"pl{i}", {"suggest": {
                "input": [name], "weight": int(crng.randint(1, 100)),
                "contexts": {"cat": [str(crng.choice(["cafe", "shop",
                                                      "bar"]))],
                             "loc": [{"lat": float(lat),
                                      "lon": float(lon)}]}}}))
        t0 = time.perf_counter()
        r = g.bulk([("index", {"_index": "places", "_id": pid}, src)
                    for pid, src in places], refresh=True)
        bulk_s = time.perf_counter() - t0
        check(not r["errors"], "23e the completion bulk without errors")
        compl = [("st", None), ("stor", {"cat": ["cafe"]}),
                 ("strea", {"loc": [{"context": {"lat": 45.0, "lon": 0.0},
                                     "precision": 2}]})]
        for prefix, ctx in compl:
            cfg = {"field": "suggest", "size": 10}
            if ctx:
                cfg["contexts"] = ctx
            body = {"size": 0, "suggest": {"c": {"prefix": prefix,
                                                 "completion": cfg}}}
            gr = item(f"23e completion {prefix!r} "
                      f"{'with ' + next(iter(ctx)) if ctx else 'plain'}",
                      lambda: g.search("places", dict(body)), reps=3)
            want = []
            for d, (pid, src) in enumerate(places):
                s_ = src["suggest"]
                text = s_["input"][0]
                if not text.startswith(prefix):
                    continue
                if ctx and "cat" in ctx and s_["contexts"]["cat"][0] not in \
                        ctx["cat"]:
                    continue
                if ctx and "loc" in ctx:
                    p = s_["contexts"]["loc"][0]
                    want_prefix = encode(45.0, 0.0, 2)
                    if not encode(p["lat"], p["lon"], 12).startswith(
                            want_prefix):
                        continue
                want.append((-float(s_["weight"]), text, d, pid))
            want = [(pid, -w) for w, text, d, pid in sorted(want)[:10]]
            got = [(o["_id"], o["_score"])
                   for o in gr["suggest"]["c"][0]["options"]]
            check(got == want, f"23e completion {prefix!r} equals the plain "
                               f"evaluation ({got[:3]} vs {want[:3]})")
        report["completion"] = {"docs": COMPL23_DOCS,
                                "bulk_docs_per_s": COMPL23_DOCS / bulk_s}

        step("23e completion")
        # ---- 23f: spans, type, _size -----------------------------------------
        # terms of ranks 201-221 (about 8,000 positions a shard): a top
        # term's span lists would be millions of host tuples a shard
        t1, t2, t3 = "t00200", "t00210", "t00220"
        span_kinds = {
            "span_term": {"span_term": {"title": t1}},
            "span_or": {"span_or": {"clauses": [
                {"span_term": {"title": t1}}, {"span_term": {"title": t2}}]}},
            "span_near": {"span_near": {"clauses": [
                {"span_term": {"title": t1}},
                {"span_term": {"title": t2}}], "slop": 5,
                "in_order": False}},
            "span_first": {"span_first": {"match": {"span_term": {
                "title": t2}}, "end": 5}},
            "span_multi": {"span_multi": {"match": {"prefix": {
                "title": "t0310"}}}},
            "span_not": {"span_not": {"include": {"span_term": {
                "title": t1}}, "exclude": {"span_term": {
                    "title": t2}}, "dist": 1}},
            "span_containing": {"span_containing": {
                "little": {"span_term": {"title": t3}},
                "big": {"span_near": {"clauses": [
                    {"span_term": {"title": t1}},
                    {"span_term": {"title": t2}}], "slop": 8,
                    "in_order": False}}}},
            "span_within": {"span_within": {
                "little": {"span_term": {"title": t3}},
                "big": {"span_near": {"clauses": [
                    {"span_term": {"title": t1}},
                    {"span_term": {"title": t2}}], "slop": 8,
                    "in_order": False}}}},
            "field_masking_span": {"span_near": {"clauses": [
                {"span_term": {"abstract": t1}},
                {"field_masking_span": {"query": {"span_term": {
                    "abstract": t2}}, "field": "abstract"}}],
                "slop": 5, "in_order": False}},
        }
        span_ms = {}
        mt = {"match": {"title": " ".join(tok(t) for t in queries[4])}}
        with timing_calls(S, ("enumerate_spans",), sync) as spent:
            for kind, q in span_kinds.items():
                spent["enumerate_spans"] = 0.0
                hr = item(f"23f {kind} alone on pmcqh", lambda: gq.search(
                    "pmcqh", {"query": q, "size": 10}))
                span_ms[kind] = {"host_enumeration_ms":
                                 spent["enumerate_spans"] * 1000}
                cr = cq.search("pmcq", {"query": q, "size": 10})
                same_response(hr, cr, f"23f {kind} alone",
                              "pmcqh's answer equals the cpu twin's")
                check(hr["_plane"] == "host" and (
                    hr["hits"]["total"] > 0
                    or kind in ("span_containing", "span_within")),
                    f"23f {kind} alone: host rung, "
                    f"{hr['hits']['total']} hits")
                body = {"query": {"bool": {"must": [mt, q]}}, "size": 10}
                spent["enumerate_spans"] = 0.0
                mr = item(f"23f {kind} beside a match on pmcq",
                          lambda: gq.search("pmcq", dict(body)))
                span_ms[kind]["beside_match_enumeration_ms"] = \
                    spent["enumerate_spans"] * 1000
                cr = cq.search("pmcq", dict(body))
                same_response(mr, cr, f"23f {kind} beside a match",
                              "pmcq's answer equals the cpu twin's")
                span_ms[kind]["beside_match_plane"] = mr["_plane"]
                span_ms[kind]["total"] = hr["hits"]["total"]
        report["spans"] = span_ms
        log(f"[phase 23] 23f span enumeration host ms: "
            f"{json.dumps(span_ms)}")
        check(sum(v["beside_match_plane"] == "mesh_pallas"
                  for v in span_ms.values()) >= 5,
              f"23f span kinds beside a match on mesh_pallas "
              f"({ {k: v['beside_match_plane'] for k, v in span_ms.items()} })")
        step("23f spans")
        ty = item("23f type on pmcq", lambda: gq.search("pmcq", {
            "query": {"type": {"value": "_doc"}}, "size": 0}))
        ma = gq.search("pmcq", {"query": {"match_all": {}}, "size": 0})
        check(ty["hits"]["total"] == ma["hits"]["total"] > 0,
              "23f type answers as match_all")
        g.create_index("sized", {"settings": {
            "number_of_shards": 1, "refresh_interval": "-1",
            "requests.cache.enable": False},
            "mappings": {"_doc": {"_size": {"enabled": True},
                                  "properties": {"title": {
                                      "type": "text"}}}}})
        zrng = np.random.RandomState(55)
        sized = [(f"z{i}", {"title": " ".join(tok(int(t)) for t in
                                              zrng.randint(0, 500, int(
                                                  zrng.randint(1, 60))))})
                 for i in range(SIZE23_DOCS)]
        g.bulk([("index", {"_index": "sized", "_id": sid}, src)
                for sid, src in sized], refresh=True)
        nbytes = {sid: len(json.dumps(src, separators=(",", ":")))
                  for sid, src in sized}
        rng_hit = item("23f _size range", lambda: g.search("sized", {
            "query": {"range": {"_size": {"gt": 200}}}, "size": 0}))
        srt = item("23f _size sort", lambda: g.search("sized", {
            "query": {"match_all": {}}, "size": 5,
            "sort": [{"_size": "desc"}]}))
        mx = item("23f _size max", lambda: g.search("sized", {
            "size": 0, "aggs": {"m": {"max": {"field": "_size"}}}}))
        top = sorted(nbytes.values(), reverse=True)[:5]
        check(rng_hit["hits"]["total"] == sum(v > 200 for v in
                                              nbytes.values())
              and [h["sort"][0] for h in srt["hits"]["hits"]] == top
              and mx["aggregations"]["m"]["value"] == max(nbytes.values()),
              "23f _size's range, sort and max equal the sources' byte "
              "counts")
        step("23f type and _size")
    sync()
    p23 = dict(cuda_kernels.LAUNCHES)
    report["main_s"] = time.perf_counter() - t_main
    log(f"[phase 23] kernel launches: {p23}")
    t0 = time.perf_counter()
    held, report["max_abs_err"] = ({}, {})
    if on_card:
        held, report["max_abs_err"] = hold_recovered_path(
            torch, tsc, ssum, knn, kept, p23, errs, "phase 23")
        for k in ("tile_scoring", "segment_sum"):
            check(p23.get(k, 0) > 0, f"phase 23 launched {k}")
    del kept
    report["hold_s"] = time.perf_counter() - t0
    report["held"] = held
    report["launches"] = p23
    fails = plane_failures(*(g.indices[i] for i in ("geo4", "geo4h",
                                                    "logs-a", "logs-sorted")),
                           gq.indices["pmcq"], gq.indices["pmcqh"])
    check(not any(fails), f"phase 23 zero plane faults ({fails})")
    g.close()
    gq.close()
    cq.close()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 23] {report['seconds']:.1f} s (geo build "
        f"{report['geo_build_s']:.1f}, shape columns "
        f"{report['shape_columns_s']:.1f}, main path {report['main_s']:.1f}, "
        f"hold {report['hold_s']:.1f}); main path by item "
        f"{json.dumps({k: round(v, 2) for k, v in steps.items()})}; held "
        f"{json.dumps(held)} ({smi})")
    return report


# ----------------------------------------------------------------------
# phase 24: the device-side infrastructure (telemetry, admission and the
# drain, the warm replay, the device fault schemes, the scrubber)
# ----------------------------------------------------------------------


def infrastructure_phase(torch, HttpServer, cuda_kernels, tsc, ssum, knn,
                         g7, c7, reqs, knn_body, rest_report, errs, smi,
                         device="cuda"):
    """Phase 24: the device-side infrastructure on pmc-4x256k (phase 7's
    ``pmc4``, ``mesh_pallas``, and ``pmc4h``, the same segments on the host
    rung), over REST through an ``HttpServer`` on phase 7's node; every
    answer against phase 7's cpu node with ``_shards.failed == 0``.

    24a. Telemetry: phase 3's requests (matches, a bool filter, a terms
         aggregation) and phase 9's kNN body, each with its own
         ``X-Opaque-Id``, at a 0 ms slowlog threshold: ``_stats``'
         ``search.phases`` and ``_nodes/stats``' ``indices.search.phases``
         count every request (``queries_recorded``, the fetch span's
         histogram counts), the slowlog has one line a request carrying
         its id, ``GET /_nodes/hot_threads`` answers 200.
    24b. Admission: a burst of 24 HTTP clients (two tenants, 16 and 8)
         against ``search.queue.size: 6`` and ``max_concurrent: 2`` (PUT
         ``_cluster/settings``): the admission counters and the search
         pool's rejections partition what was sent, every 429 carries
         ``Retry-After``, both tenants are admitted; the admitted p50
         beside the serial p50 and phase 11's HTTP p50. Then synthetic
         pressure (``QueuePressureScheme``): at the first brownout step a
         match runs the pruned kernel (1e) marked ``_degraded``; at the
         third a terms aggregation is shed; at the second a concurrent
         aggregation burst forms batches under the widened window (1b).
    24c. The drain: clients searching in a loop, ``POST
         /_nodes/_local/_drain`` in the middle: the searches in flight
         finish, new ones answer 503 with ``Retry-After``, a compaction
         aborts (``draining``); ``DELETE`` ends it and the same body
         answers the same hits as before. The drain's seconds.
    24e. Faults over REST: ``PlaneFailScheme`` on ``mesh_pallas`` serves
         from the scatter mesh and benches the plane;
         ``KernelLaunchFailScheme`` on the 1a launch and on ``knn``
         (kernel 3) raises ``KernelError`` as a real launch failure does:
         a 500, no rung serves in the kernel's place, nothing benched;
         ``EvictionStormScheme`` evicts the coldest staging and the plane
         restages; each answer equals the cpu node's, each scheme's
         decisions and restages counted, and the kernel serves the next
         request.
    24f. The scrubber on pmc4h: a pass over the staged base tables
         (``block_docs``, ``block_tfs``, ``norms`` copied back and hashed):
         bytes verified, drift 0, seconds per GB; one byte flipped in a
         staged ``block_docs`` on the card: drift 1, the segment restaged
         with the ``scrub`` reason, the next answer equal.

    24d (the warm reopen) runs inside phase 13c, on its durable index.
    Every launch is held against its plain version. Returns the report."""
    import copy
    import logging

    from elasticsearch_tpu_torch.common.memory import memory_accountant
    from elasticsearch_tpu_torch.rest.handlers import _render_total_hits
    from elasticsearch_tpu_torch.testing import disruption as tdis

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    report = {}
    acc = {}
    gsvc, hsvc = g7.indices["pmc4"], g7.indices["pmc4h"]
    srv = HttpServer(g7, port=0)
    srv.start()
    client = HttpClient(srv.port)
    match = reqs[0][1]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def held(label):
        return held_block(torch, cuda_kernels, tsc, ssum, knn, errs, label,
                          acc, on_card=on_card)

    def sound(r, what):
        check(isinstance(r, dict) and r["_shards"]["failed"] == 0,
              f"{what}: answered with no failed shard ({str(r)[:200]})")

    def stats(path="/pmc4/_stats"):
        st, _h, r = client.request("GET", path)
        check(st == 200, f"24: GET {path} answered {st}")
        if path.startswith("/_nodes"):
            return next(iter(r["nodes"].values()))["indices"]["search"]
        return r["indices"]["pmc4"]["total"]["search"]

    def reset_health(*svcs):
        for svc in svcs:
            ms = svc._mesh_search
            if ms is not None:
                with ms.plane_health._lock:
                    ms.plane_health._quarantined_until.clear()
                    ms.plane_health._probe_until.clear()

    try:
        # -------- 24a: telemetry --------
        t0 = time.perf_counter()
        lines = []

        class Lines(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        slog = logging.getLogger("elasticsearch_tpu_torch.index.search.slowlog")
        handler, level0 = Lines(), slog.level
        slog.addHandler(handler)
        slog.setLevel(logging.INFO)
        g7.update_index_settings("pmc4", {
            "index.search.slowlog.threshold.query.info": "0ms"})
        # one request of each kind of phase 3's, and phase 9's kNN body
        bodies = list({k: b for k, b, _t in reversed(reqs)}.values())
        bodies.append(dict(knn_body))
        base_i, base_n = stats(), stats("/_nodes/stats")
        with held("phase 24a") as mine:
            for i, body in enumerate(bodies):
                st, _h, r = client.request("POST", "/pmc4/_search", body,
                                           headers={"X-Opaque-Id": f"t24-{i}"})
                check(st == 200, f"24a request {i} answered {st}")
                sound(r, f"24a request {i}")
                same_response(r, c7.search("pmc4", dict(body)),
                              f"24a request {i}")
        after_i, after_n = stats(), stats("/_nodes/stats")
        g7.update_index_settings("pmc4", {
            "index.search.slowlog.threshold.query.info": "-1"})
        slog.removeHandler(handler)
        slog.setLevel(level0)

        def fetch_count(block):
            return sum(sum(per["fetch"].values()) for per in
                       block["phases"]["histogram_us"].values()
                       if "fetch" in per)

        n = len(bodies)
        rec_i = (after_i["phases"]["queries_recorded"]
                 - base_i["phases"]["queries_recorded"])
        rec_n = (after_n["phases"]["queries_recorded"]
                 - base_n["phases"]["queries_recorded"])
        fetch_i = fetch_count(after_i) - fetch_count(base_i)
        check(rec_i == rec_n == fetch_i == n,
              f"24a search.phases counts every request ({rec_i} index, "
              f"{rec_n} node, {fetch_i} fetch spans; {n} sent)")
        ids = [f"t24-{i}" for i in range(n)]
        tagged = {i: [ln for ln in lines if f"id[{i}]" in ln] for i in ids}
        check(all(len(v) == 1 for v in tagged.values()),
              f"24a one slowlog line a request with its X-Opaque-Id "
              f"({ {k: len(v) for k, v in tagged.items()} })")
        st, _h, text = client.request("GET", "/_nodes/hot_threads")
        check(st == 200 and "Hot threads sampled" in (text or ""),
              f"24a hot_threads answered {st}")
        report["24a"] = {
            "sent": n, "queries_recorded": rec_i, "node_queries_recorded":
            rec_n, "fetch_spans": fetch_i, "slowlog_lines": len(lines),
            "planes": sorted(after_i["phases"]["histogram_us"]),
            "decisions": {k: v - base_i["phases"]["decisions"].get(k, 0)
                          for k, v in after_i["phases"]["decisions"].items()
                          if v != base_i["phases"]["decisions"].get(k, 0)},
            "launches": dict(mine), "seconds": time.perf_counter() - t0}
        log(f"[phase 24a] {json.dumps(report['24a'])} ({smi})")

        # -------- 24b: admission --------
        t0 = time.perf_counter()
        want = c7.search("pmc4", dict(match))
        serial = []
        for _ in range(8):
            t1 = time.perf_counter()
            st, _h, r = client.request("POST", "/pmc4/_search", match)
            serial.append((time.perf_counter() - t1) * 1000)
        # the cpu node's answer under brownout step 1 (forced pruning):
        # what a browned-out answer of the burst must equal
        qsize = gsvc.admission._queue_size()
        qp = tdis.QueuePressureScheme(occupancy=int(0.3 * qsize),
                                      indices=["pmc4"]).install()
        try:
            c7.indices["pmc4"].admission.refresh_level()
            want_pruned = c7.search("pmc4", dict(match))
        finally:
            qp.remove()
        c7.indices["pmc4"].admission.refresh_level()
        gsvc.admission.refresh_level()
        # as REST renders it: the pruned total is a lower bound
        want_pruned_http = copy.deepcopy(want_pruned)
        _render_total_hits(want_pruned_http, match)
        check(want_pruned.get("_degraded") == ["forced_pruned"]
              and want_pruned.get("_pruned") is not None,
              f"24b the cpu node's browned-out answer is marked and pruned "
              f"({want_pruned.get('_degraded')}, "
              f"{want_pruned.get('_pruned')})")
        client.call("PUT", "/_cluster/settings", {"transient": {
            "search.queue.size": 6, "search.admission.max_concurrent": 2}})
        adm0 = gsvc.admission.stats_dict()
        pool0 = g7.thread_pool.stats()["search"]["rejected"]
        n_clients, per_client = 24, 2
        go = threading.Barrier(n_clients)
        out, lock = [], threading.Lock()

        def burst_client(i):
            cl = HttpClient(srv.port)
            tenant = "tenant-a" if i < 16 else "tenant-b"
            try:
                go.wait(300)
                for _ in range(per_client):
                    t1 = time.perf_counter()
                    st, hdrs, r = cl.request(
                        "POST", "/pmc4/_search", match,
                        headers={"X-Opaque-Id": tenant})
                    ms = (time.perf_counter() - t1) * 1000
                    with lock:
                        out.append((tenant, st, hdrs.get("Retry-After"), r,
                                    ms))
            finally:
                cl.close()

        with held("phase 24b burst") as mine_b:
            threads = [threading.Thread(target=burst_client, args=(i,))
                       for i in range(n_clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
        check(not any(th.is_alive() for th in threads), "24b clients done")
        adm1 = gsvc.admission.stats_dict()
        pool1 = g7.thread_pool.stats()["search"]["rejected"]
        client.call("PUT", "/_cluster/settings", {"transient": {
            "search.queue.size": None,
            "search.admission.max_concurrent": None}})
        sent = n_clients * per_client
        oks = [o for o in out if o[1] == 200]
        rej = [o for o in out if o[1] == 429]
        d = {k: adm1[k] - adm0[k] for k in (
            "admitted_total", "rejected_total", "expired_in_queue_total")}
        pool_rej = pool1 - pool0
        check(len(out) == sent and len(oks) + len(rej) == sent,
              f"24b every request answered 200 or 429 ({len(oks)} + "
              f"{len(rej)} of {sent}: "
              f"{sorted({o[1] for o in out})})")
        check(d["admitted_total"] + d["rejected_total"]
              + d["expired_in_queue_total"] + pool_rej == sent,
              f"24b admitted {d['admitted_total']} + rejected "
              f"{d['rejected_total']} + shed {d['expired_in_queue_total']} "
              f"+ pool-rejected {pool_rej} == sent {sent}")
        check(all(o[2] is not None and int(o[2]) >= 1 for o in rej),
              "24b every 429 carries Retry-After")
        tenants = {t: {k: b[k] - adm0["tenants"].get(t, {}).get(k, 0)
                       for k in ("admitted_total", "rejected_total")}
                   for t, b in adm1["tenants"].items()
                   if t.startswith("tenant-")}
        check(all(tenants.get(t, {}).get("admitted_total", 0) > 0
                  for t in ("tenant-a", "tenant-b")),
              f"24b both tenants admitted ({tenants})")
        degraded = 0
        for o in oks:
            sound(o[3], "24b admitted answer")
            marked = o[3].get("_degraded") == ["forced_pruned"]
            pruned = o[3].get("_pruned") is not None
            check(not o[3].get("_degraded") or marked,
                  f"24b a browned-out answer is marked forced_pruned "
                  f"({o[3].get('_degraded')})")
            # the burst's own queue pressure may reach the brownout: the
            # request's admission token decides both the marker and the
            # pruning, so a marked answer is pruned and a pruned one marked
            check(marked == pruned,
                  f"24b marked {marked} and pruned {pruned} agree "
                  f"({o[3].get('_degraded')}, {o[3].get('_pruned')})")
            if pruned:
                degraded += 1
                same_response(o[3], want_pruned_http,
                              "24b browned-out admitted answer")
            else:
                same_response(o[3], want, "24b admitted answer")
        p11 = (rest_report.get("latency", {}).get("match_or pmc4", {})
               .get("http_p50_ms"))
        b_row = {"sent": sent, "ok": len(oks), "rejected_429": len(rej),
                 "ok_browned_out": degraded,
                 "admission": d, "pool_rejected": pool_rej,
                 "tenants": tenants,
                 "admitted_p50_ms": (float(np.median([o[4] for o in oks]))
                                     if oks else None),
                 "serial_p50_ms": float(np.median(serial)),
                 "phase11_http_p50_ms": p11,
                 "retry_after_s": sorted({int(o[2]) for o in rej}),
                 "launches": dict(mine_b)}
        # the brownout: step 1 forces the pruned kernel (1e)
        qp = tdis.QueuePressureScheme(occupancy=int(0.3 * qsize),
                                      indices=["pmc4"]).install()
        try:
            gsvc.admission.refresh_level()
            c7.indices["pmc4"].admission.refresh_level()
            with held("phase 24b brownout") as mine_p:
                pr = g7.search("pmc4", dict(match))
                sync()
            cr = c7.search("pmc4", dict(match))
        finally:
            qp.remove()
        sound(pr, "24b forced pruning")
        check(pr.get("_degraded") == ["forced_pruned"]
              and pr.get("_pruned") is not None
              and pr["_pruned"] == cr.get("_pruned"),
              f"24b the first brownout step ran the pruned program on both "
              f"({pr.get('_degraded')}, {pr.get('_pruned')}, "
              f"{cr.get('_pruned')})")
        same_response(pr, cr, "24b forced pruning")
        check(not on_card or mine_p.get("tile_scoring_topk_sel", 0)
              + mine_p.get("tile_scoring_topk_sel_packed", 0) > 0,
              f"24b forced pruning launched 1e ({mine_p})")
        agg = next(b for k, b, _t in reqs if k == "terms_agg")
        qp = tdis.QueuePressureScheme(occupancy=int(0.8 * qsize),
                                      indices=["pmc4"]).install()
        try:
            gsvc.admission.refresh_level()
            shed = g7.search("pmc4", dict(agg))
            cshed = c7.search("pmc4", dict(agg))
        finally:
            qp.remove()
        check("aggs" in (shed.get("_degraded") or [])
              and "aggregations" not in shed
              and shed.get("_degraded") == cshed.get("_degraded"),
              f"24b the third step shed the aggregation "
              f"({shed.get('_degraded')})")
        same_response(shed, cshed, "24b shed aggregation")
        # the second step: a concurrent aggregation burst under the
        # widened window (the batched dense agg program, 1b)
        base_w = gsvc._batcher.window_s
        qp = tdis.QueuePressureScheme(occupancy=int(0.55 * qsize),
                                      indices=["pmc4"]).install()
        aggs = [b for k, b, _t in reqs if k == "terms_agg"]
        got = {}
        go2 = threading.Barrier(len(aggs))

        def agg_client(i):
            go2.wait(300)
            got[i] = g7.search("pmc4", dict(aggs[i]))

        try:
            gsvc.admission.refresh_level()
            window = gsvc.admission.effective_batch_window_s(base_w)
            batches0 = gsvc.batch_stats.as_dict()["batched_query_total"]
            with held("phase 24b window") as mine_w:
                threads = [threading.Thread(target=agg_client, args=(i,))
                           for i in range(len(aggs))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(600)
        finally:
            qp.remove()
        gsvc.admission.refresh_level()
        c7.indices["pmc4"].admission.refresh_level()
        for i, b in enumerate(aggs):
            sound(got.get(i), f"24b window member {i}")
            same_response(got[i], c7.search("pmc4", dict(b)),
                          f"24b window member {i}")
        bstats = gsvc.batch_stats.as_dict()
        check(window > base_w and bstats["batch_window_effective_ms"]
              >= window * 1000 * 0.999,
              f"24b the window widened under pressure ({base_w} -> "
              f"{window} s, gauge {bstats['batch_window_effective_ms']} ms)")
        check((not on_card or mine_w.get("tile_scoring_batched", 0)
               + mine_w.get("tile_scoring_batched_packed", 0) > 0)
              and bstats["batched_query_total"] > batches0,
              f"24b the burst ran batched (1b) under the widened window "
              f"({mine_w})")
        b_row.update(brownout_pruned=pr["_pruned"],
                     brownout_launches=dict(mine_p),
                     window_ms={"base": base_w * 1000,
                                "effective": window * 1000},
                     window_batched_members=(bstats["batched_query_total"]
                                             - batches0),
                     window_launches=dict(mine_w),
                     brownout=gsvc.admission.stats_dict()["brownout"],
                     seconds=time.perf_counter() - t0)
        report["24b"] = b_row
        log(f"[phase 24b] {json.dumps(b_row)} ({smi})")

        # -------- 24c: the drain --------
        t0 = time.perf_counter()
        before = g7.search("pmc4", dict(match))
        stop, started = threading.Event(), threading.Event()
        statuses, lock = [], threading.Lock()

        def loop_client():
            cl = HttpClient(srv.port)
            try:
                while not stop.is_set():
                    st, hdrs, r = cl.request("POST", "/pmc4/_search", match)
                    with lock:
                        statuses.append((st, hdrs.get("Retry-After"), r))
                    started.set()
            finally:
                cl.close()

        d0 = gsvc.admission.stats_dict()["drain_rejected_total"]
        with held("phase 24c") as mine_c:
            threads = [threading.Thread(target=loop_client)
                       for _ in range(6)]
            for th in threads:
                th.start()
            check(started.wait(300), "24c clients searching")
            t1 = time.perf_counter()
            st, _h, rep = client.request("POST", "/_nodes/_local/_drain")
            drain_s = time.perf_counter() - t1
            check(st == 200 and rep["drained"] and
                  rep["in_flight_remaining"] == 0,
                  f"24c the drain answered {st} {rep}")
            compacted = gsvc.compact_now()
            st503, hdrs, body503 = client.request("POST", "/pmc4/_search",
                                                  match)
            stop.set()
            for th in threads:
                th.join(600)
            st_un, _h, un = client.request("DELETE", "/_nodes/_local/_drain")
            after = g7.search("pmc4", dict(match))
            sync()
        check(compacted == {"ran": False, "reason": "draining"},
              f"24c a compaction aborts while draining ({compacted})")
        check(st503 == 503 and hdrs.get("Retry-After") is not None
              and body503["error"]["type"] == "node_draining_exception",
              f"24c a search while drained answered {st503} "
              f"{str(body503)[:200]}")
        check(st_un == 200 and un == {"draining": False},
              f"24c the undrain answered {st_un} {un}")
        refused = [s for s in statuses if s[0] == 503]
        served = [s for s in statuses if s[0] == 200]
        check(len(refused) + len(served) == len(statuses)
              and all(s[1] is not None for s in refused),
              f"24c every search answered 200, or 503 with Retry-After "
              f"({sorted({s[0] for s in statuses})})")
        for s in served:
            sound(s[2], "24c in-flight answer")
            same_response(s[2], want, "24c in-flight answer")
        d1 = gsvc.admission.stats_dict()["drain_rejected_total"]
        check(d1 - d0 == len(refused) + 1,
              f"24c every refused search counted ({d1 - d0}, "
              f"{len(refused)} + 1)")
        check(_same_exact(after, before),
              "24c after the undrain the same body answers the same hits")
        same_response(after, want, "24c after the undrain")
        report["24c"] = {"drain_s": drain_s, "drain_report": rep,
                         "served": len(served), "refused_503": len(refused),
                         "compaction": compacted, "launches": dict(mine_c),
                         "seconds": time.perf_counter() - t0}
        log(f"[phase 24c] {json.dumps(report['24c'])} ({smi})")

        # -------- 24e: the device fault schemes --------
        # a plane fault benches the plane and the next rung serves; a
        # kernel launch fault (KernelError) answers a 500 over REST, no
        # rung serves in the kernel's place and nothing is benched; the
        # eviction storm restages. ``plane`` None: the 500 is wanted.
        t0 = time.perf_counter()
        cases = [
            ("plane_fail_mesh_pallas", dict(match), "mesh",
             lambda: tdis.PlaneFailScheme(planes=["mesh_pallas"],
                                          indices=["pmc4"])),
            ("kernel_launch_fail_1a", dict(match), None,
             lambda: tdis.KernelLaunchFailScheme(
                 rungs=["mesh_pallas"], times=1, indices=["pmc4"])),
            ("kernel_launch_fail_knn", dict(knn_body), None,
             lambda: tdis.KernelLaunchFailScheme(
                 rungs=["knn"], times=1, indices=["pmc4"])),
            ("eviction_storm", dict(match), "mesh_pallas",
             lambda: tdis.EvictionStormScheme(period=1, scopes=1,
                                              indices=["pmc4"])),
        ]
        e_rows = {}
        with held("phase 24e") as mine_e:
            for name, body, plane, make in cases:
                want_e = c7.search("pmc4", dict(body))
                g7.search("pmc4", dict(body))  # warm: staged, healthy
                f0 = gsvc._mesh_search.plane_health.stats()
                dec0 = dict(gsvc.telemetry.phases_dict()["decisions"])
                mark = int(time.time() * 1000)
                restage0 = gsvc._mesh_search.restage_total
                scheme = make().install()
                try:
                    st, _h, r = client.request("POST", "/pmc4/_search",
                                               dict(body))
                    sync()
                finally:
                    scheme.remove()
                f1 = gsvc._mesh_search.plane_health.stats()
                dec1 = gsvc.telemetry.phases_dict()["decisions"]
                if plane is None:
                    check(st == 500 and "kernel launch" in json.dumps(r),
                          f"24e {name}: the launch failure answers 500 "
                          f"({st}, {str(r)[:200]})")
                    check(f1["plane_quarantined"] == [],
                          f"24e {name}: no plane benched "
                          f"({f1['plane_quarantined']})")
                else:
                    check(st == 200, f"24e {name} answered {st}")
                    sound(r, f"24e {name}")
                    same_response(r, want_e, f"24e {name}")
                    check(r["_plane"] == plane,
                          f"24e {name} served from {r['_plane']} "
                          f"(want {plane})")
                reset_health(gsvc)
                back = g7.search("pmc4", dict(body))
                check(back["_plane"] == "mesh_pallas",
                      f"24e {name}: the kernel serves the next request "
                      f"({back['_plane']})")
                same_response(back, want_e, f"24e {name} after")
                e_rows[name] = {
                    "status": st,
                    "plane": r.get("_plane") if st == 200 else None,
                    "hits": scheme.hits,
                    "failures": {
                        k: v - f0["plane_failures_total"].get(k, 0)
                        for k, v in f1["plane_failures_total"].items()},
                    "decisions": {k: v - dec0.get(k, 0)
                                  for k, v in dec1.items()
                                  if v != dec0.get(k, 0)},
                    "staging_events": len(staging_events_since(
                        memory_accountant(), None, mark)),
                    "restages": gsvc._mesh_search.restage_total - restage0,
                    "evicted_bytes": getattr(scheme, "evicted_bytes", None)}
                check(scheme.hits >= 1, f"24e {name} fired ({scheme.hits})")
        check(e_rows["plane_fail_mesh_pallas"]["failures"].get(
                  "mesh_pallas", 0) == 1
              and all(e_rows[k]["failures"].get("mesh_pallas", 0) == 0
                      and e_rows[k]["hits"] == 1
                      for k in ("kernel_launch_fail_1a",
                                "kernel_launch_fail_knn")),
              f"24e the plane fault benched mesh_pallas once, each launch "
              f"fault fired once and benched nothing ({e_rows})")
        check(e_rows["eviction_storm"]["evicted_bytes"] > 0,
              "24e the eviction storm evicted a staging")
        report["24e"] = {"cases": e_rows, "launches": dict(mine_e),
                         "seconds": time.perf_counter() - t0}
        log(f"[phase 24e] {json.dumps(report['24e'])} ({smi})")

        # -------- 24f: the scrubber --------
        t0 = time.perf_counter()
        want_h = c7.search("pmc4h", dict(match))
        with held("phase 24f") as mine_f:
            g7.search("pmc4h", dict(match))  # the base tables staged
            t1 = time.perf_counter()
            clean = hsvc.scrub_now()
            clean_s = time.perf_counter() - t1
            seg = next(s for sh in hsvc.shards.values()
                       for s in sh.engine.segments if s._device)
            # one byte flipped in a copy of the staged table on the card
            # (on the CPU the staged tensor may share the host array)
            table = seg._device["block_docs"].clone()
            flat = table.view(torch.uint8).view(-1)
            flat[flat.numel() // 3] ^= 1
            seg._device["block_docs"] = table
            sync()
            drifted = hsvc.scrub_now()
            mark = int(time.time() * 1000)
            r = g7.search("pmc4h", dict(match))
            sync()
        events = staging_events_since(memory_accountant(), None, mark)
        check(clean["drift"] == 0 and clean["bytes_verified"] > 0,
              f"24f the clean pass ({clean})")
        check(drifted["drift"] == 1 and seg.stage_reason_initial == "scrub",
              f"24f the flipped byte drifted ({drifted})")
        check(any(e.get("reason") == "scrub" for e in events),
              f"24f the restage is recorded with the scrub reason "
              f"({[e.get('reason') for e in events]})")
        sound(r, "24f after the scrub")
        same_response(r, want_h, "24f after the scrub")
        report["24f"] = {
            "clean": clean, "clean_s": clean_s,
            "s_per_gb": clean_s / (clean["bytes_verified"] / 1e9),
            "drifted": drifted, "restage_reasons": sorted(
                {e.get("reason") for e in events}),
            "launches": dict(mine_f), "seconds": time.perf_counter() - t0}
        log(f"[phase 24f] {json.dumps(report['24f'])} ({smi})")
    finally:
        tdis.clear_search_disruptions()
        client.close()
        srv.stop()
    report["launches"] = acc
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 24] {report['seconds']:.1f} s, launches {acc}")
    return report


def staging_events_since(acct, index, mark_ms):
    """The ledger's staging events (of ``index``, or all) stamped at or
    after ``mark_ms``: the ring is bounded, so a count by length would
    drift once it is full."""
    return [e for e in acct.stats(index)["staging_events"]
            if e["timestamp_ms"] >= mark_ms]


def warm_reopen(torch, Node, cuda_kernels, tsc, ssum, knn, path, repo_root,
                bodies, before, cold_ms, errs, smi, device="cuda"):
    """Phase 24d, on phase 13c's durable pmc-4x256k after its cold reopen
    closed: reopen it with ``search.compile.warm_on_start``. The warm
    thread replays the bodies the first life recorded
    (``compile_variants.json`` under ``_state``) under ``warming()``: the
    staging and each variant's first launch happen there. Then the first
    answer (13c's first body) on the host clock beside 13c's cold first
    answer; every answer equal to the index's before the close; the
    ``compile`` block's warmed and query-path counts (the first-run table
    emptied first, as a restarted process has it); every launch, warm
    replay included, held against plain."""
    from elasticsearch_tpu_torch.common import compile_cache as cc
    from elasticsearch_tpu_torch.common.settings import Settings

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    acc = {}
    # a restarted process has run no variant yet; this script is one
    # process, so the reopen starts from an empty first-run table as a new
    # process would (the kernel library stays loaded)
    cc._PROGRAMS.clear()
    c0 = cc.compile_stats().stats()
    with held_block(torch, cuda_kernels, tsc, ssum, knn, errs, "phase 24d",
                    acc, on_card=on_card) as mine:
        t0 = time.perf_counter()
        g3 = Node(Settings({"path.repo": [repo_root],
                            "search.compile.warm_on_start": True}),
                  data_path=path, device=device)
        load_s = time.perf_counter() - t0
        specs = len(cc.variant_registry().warm_entries("dur4"))
        check(g3._warm_thread is not None and specs > 0,
              f"24d the reopen started the warm replay ({specs} specs)")
        t0 = time.perf_counter()
        g3._warm_thread.join()
        sync()
        warm_s = time.perf_counter() - t0
        c1 = cc.compile_stats().stats()
        first_label, first_body = bodies[0]
        first, first_ms, first_spans = _first_answer(
            torch, lambda: g3.search("dur4", dict(first_body)))
        c2 = cc.compile_stats().stats()
        after = {first_label: _no_took(first)}
        for label, body in bodies[1:]:
            after[label] = _no_took(g3.search("dur4", dict(body)))
        sync()
    same = [k for k in after if after[k] == before[k]]
    check(len(same) == len(bodies),
          f"24d {len(same)} of {len(bodies)} answers after the warm reopen "
          f"equal those before the close")
    warmed = c1["programs_warmed_total"] - c0["programs_warmed_total"]
    check(warmed > 0, f"24d the replay warmed {warmed} first runs")
    check(c2["query_path_first_compile_total"]
          == c1["query_path_first_compile_total"],
          "24d the first answer met no first run on the query path")
    t0 = time.perf_counter()
    g3.close()
    sync()
    out = {"load_s": load_s, "warm_s": warm_s, "warm_specs": specs,
           "programs_warmed": warmed,
           "warm_events": [e for e in c1["first_compile_events"]
                           if e["warmed"]][-8:],
           "first_answer_ms": first_ms, "first_answer_spans_ms":
           first_spans, "cold_first_answer_ms": cold_ms,
           "query_path_first_runs": (c2["query_path_first_compile_total"]
                                     - c1["query_path_first_compile_total"]),
           "answers_equal": len(same), "close_s": time.perf_counter() - t0,
           "launches": dict(mine), "seconds": time.perf_counter() - t_phase}
    log(f"[phase 24d] {json.dumps(out)} ({smi})")
    return out



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from elasticsearch_tpu_torch.index.index_service import IndexService
    from elasticsearch_tpu_torch.index.segment import Segment
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import cuda_kernels
    from elasticsearch_tpu_torch.ops import segment_sum as ssum
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc
    from elasticsearch_tpu_torch.search import query_dsl as Q

    t_start = time.perf_counter()
    install_soundness_guard(Node, IndexService)

    def clock(phase: str) -> None:
        """Where the script's time goes: the elapsed seconds as a phase
        starts."""
        log(f"[clock] {phase} starts at "
            f"{time.perf_counter() - t_start:.1f} s")

    dev = torch.device("cuda", 0)
    # full float32 products everywhere (the kNN host rung refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---------------- phase 1: device ----------------
    clock("phase 1")
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
    clock("phase 2")
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
    clock("phase 2d")
    packed_entries, packed_errs = packed_kernels_phase(
        torch, dev, gseg, gdev, timer, corpus, queries)
    batch_errs.update(packed_errs)

    # ---------------- phase 2c: kernel 3 vs plain --------------------------
    clock("phase 2c")
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
    clock("phase 3")
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
    clock("phase 4")
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
    clock("phase 7")
    (g7, c7, g7segs, c7segs, shard_arrays, seg_held["phase 7"],
     title_streams) = mesh_phase(
        torch, Node, Segment, cuda_kernels, queries, top_rank_term, lat,
        launches, knn_vecs, knn_exists, batch_errs)

    # ---------------- phase 8: bursts on both batched rungs --------------
    clock("phase 8")
    burst_phase(torch, cuda_kernels, tsc, queries, lat, launches,
                [(g7, "pmc4", "mesh_pallas"), (gnode, "docs", "host")],
                batch_errs)
    fails = plane_failures(g7.indices["pmc4"], g7.indices["pmc4h"],
                           c7.indices["pmc4"], gnode.indices["docs"])
    check(not any(fails), f"zero plane faults (got {fails})")

    # ---------------- phase 9: kNN and hybrid through Node ---------------
    clock("phase 9")
    knn_staging, knn_bodies = knn_phase(
        torch, cuda_kernels, g7, c7, g7segs, c7segs, knn_vecs, knn_exists,
        knn_rng, lat, launches, batch_errs)

    # ---------------- phase 10: packed + pruning through Node ------------
    clock("phase 10")
    pruned_report, gP, cP = pruned_phase(
        torch, Node, Segment, cuda_kernels, tsc, queries, lat, launches,
        batch_errs, shard_arrays, (g7, c7, g7segs), gnode)

    # ---------------- phase 11: REST on the card -------------------------
    clock("phase 11")
    rest_report = rest_phase(
        torch, Node, cuda_kernels, ops, INGEST_DOCS / ingest_s, reqs, g7, c7,
        gP, queries, top_rank_term, knn_bodies, launches)

    # ---------------- phase 12: aggregations on the card -----------------
    clock("phase 12")
    aggs_report, p12_nodes = aggs_phase(
        torch, Node, Segment, cuda_kernels, tsc, queries, lat, launches,
        batch_errs, shard_arrays)
    seg_held["phase 12"] = (aggs_report["launches"]["segment_sum_mask_form"]
                            + aggs_report["launches"]
                            ["segment_sum_gather_form"])

    # ---------------- phase 19: the rest of the search request ------------
    # (over phase 12's, 7's and 10's indices, before phase 13 needs the
    # card's memory back)
    clock("phase 19")
    from elasticsearch_tpu_torch.ops import knn_scoring as knn

    request_report = search_request_phase(
        torch, cuda_kernels, tsc, ssum, knn, p12_nodes, g7, c7, gP, cP,
        knn_bodies[0][1], queries, batch_errs)
    seg_held["phase 19"] = request_report["held"].get("segment_sum", 0)
    for k, v in request_report["launches"].items():
        launches[k] += v

    # ---------------- phase 20: scripting, update and mget ----------------
    # (over phase 12's and phase 3's indices; closes phase 12's nodes)
    clock("phase 20")
    dv_segs, dv_mapping = p12_nodes[2], p12_nodes[4]
    script_report = scripting_phase(
        torch, cuda_kernels, tsc, ssum, knn, p12_nodes, gnode, cnode, ops,
        queries, batch_errs)
    del p12_nodes
    seg_held["phase 20"] = script_report["held"].get("segment_sum", 0)
    for k, v in script_report["launches"].items():
        launches[k] += v

    # ---------------- phase 21: cluster metadata -------------------------
    # (over phase 7's node and phase 12's doc-values segments, adopted
    # again; before phase 13 needs the card's memory back)
    clock("phase 21")
    from elasticsearch_tpu_torch.rest.http_server import HttpServer

    pk_segs = [list(sh.engine.segments) for _sid, sh in
               sorted(gP.indices["pmc4p"].shards.items())]
    meta_report = cluster_metadata_phase(
        torch, Node, HttpServer, cuda_kernels, tsc, ssum, knn, g7, pk_segs,
        dv_segs, dv_mapping, queries, knn_bodies[0][1], batch_errs, smi)
    seg_held["phase 21"] = meta_report["held"].get("segment_sum", 0)
    for k, v in meta_report["launches"].items():
        launches[k] += v

    # ---------------- phase 22: data movement -----------------------------
    # (over phase 7's node; 22e, the snapshot and restore, runs in 13c)
    clock("phase 22")
    move_report = data_movement_phase(
        torch, Node, HttpServer, cuda_kernels, tsc, ssum, knn, g7,
        shard_arrays, title_streams, ops, queries, batch_errs, smi)
    seg_held["phase 22"] = move_report["launches"].get("segment_sum", 0)
    for k, v in move_report["launches"].items():
        launches[k] += v

    # ---------------- phase 24: the device-side infrastructure -----------
    # (over phase 7's node; 24d, the warm reopen, runs in 13c)
    clock("phase 24")
    infra_report = infrastructure_phase(
        torch, HttpServer, cuda_kernels, tsc, ssum, knn, g7, c7, reqs,
        knn_bodies[0][1], rest_report, batch_errs, smi)
    for k, v in infra_report["launches"].items():
        launches[k] += v

    # ---------------- phase 13: durability on the card -------------------
    clock("phase 13")
    durability_report = durability_phase(
        torch, Node, cuda_kernels, tsc, ops, INGEST_DOCS / ingest_s, reqs,
        reqs, knn_bodies, shard_arrays, knn_vecs, knn_exists, queries,
        batch_errs, smi)
    seg_held["phase 13"] = (durability_report["13a"]["held"]["segment_sum"]
                            + durability_report["13c"]["held"]
                            ["segment_sum"])
    for part in ("13a", "13c"):
        for k, v in durability_report[part]["launches"].items():
            launches[k] += v
    move_report["22e"] = durability_report["13c"].pop("22e")
    for k, v in move_report["22e"]["launches"].items():
        launches[k] += v
    infra_report["24d"] = durability_report["13c"].pop("24d")
    for k, v in infra_report["24d"]["launches"].items():
        launches[k] += v
        infra_report["launches"][k] = infra_report["launches"].get(k, 0) + v
    seg_held["phase 24"] = infra_report["launches"].get("segment_sum", 0)

    # ---------------- phase 14: the staging lifecycle on the card --------
    clock("phase 14")
    staging_report = staging_phase(
        torch, Segment, cuda_kernels, tsc, ssum, knn, reqs, knn_bodies,
        shard_arrays, knn_vecs, knn_exists, queries, ops, batch_errs)
    seg_held["phase 14"] = staging_report["held"].get("segment_sum", 0)
    for k, v in staging_report["launches"].items():
        launches[k] += v

    # ---------------- phase 15: the query DSL on the card -----------------
    clock("phase 15")
    qdsl_report, pmcq_nodes = query_dsl_phase(
        torch, Node, Segment, cuda_kernels, tsc, ssum, queries, shard_arrays,
        title_streams, knn_vecs, knn_exists, ops, INGEST_DOCS / ingest_s,
        batch_errs)
    seg_held["phase 15"] = qdsl_report["held"].get("segment_sum", 0)
    for k, v in qdsl_report["launches"].items():
        launches[k] += v

    # ---------------- phase 23: the field-type and query remainder -------
    # (over phase 15's pmcq, which it closes, and phase 12's doc-values
    # segments)
    clock("phase 23")
    remainder_report = remainder_phase(
        torch, Node, Segment, cuda_kernels, tsc, ssum, knn, pmcq_nodes,
        dv_segs, dv_mapping, queries, batch_errs, smi)
    del pmcq_nodes, dv_segs
    seg_held["phase 23"] = remainder_report["held"].get("segment_sum", 0)
    for k, v in remainder_report["launches"].items():
        launches[k] += v

    # ---------------- phase 16: sort and paging on the card --------------
    clock("phase 16")
    sort_report = sort_paging_phase(
        torch, Node, Segment, cuda_kernels, tsc, ssum, queries, shard_arrays,
        title_streams, gnode, batch_errs)
    seg_held["phase 16"] = sort_report["held"].get("segment_sum", 0)
    for k, v in sort_report["launches"].items():
        launches[k] += v

    # ---------------- phase 17: field types and fielddata on the card ----
    clock("phase 17")
    geo_report = geo_fields_phase(
        torch, Node, Segment, cuda_kernels, tsc, ssum, queries, shard_arrays,
        title_streams, ops[:GEO_INGEST_DOCS], batch_errs)
    seg_held["phase 17"] = geo_report["held"].get("segment_sum", 0)
    for k, v in geo_report["launches"].items():
        launches[k] += v

    # ---------------- phase 18: nested documents and the join field -------
    clock("phase 18")
    nested_report = nested_phase(
        torch, Node, Segment, cuda_kernels, tsc, ssum, knn, queries,
        shard_arrays, batch_errs)
    seg_held["phase 18"] = nested_report["held"].get("segment_sum", 0)
    for k, v in nested_report["launches"].items():
        launches[k] += v

    # ---------------- phase 5: latency summary ---------------------------
    clock("phase 5")
    for kind, xs in sorted(lat.items()):
        log(f"[phase 5] p50 phase {kind}: {float(np.median(xs)):.3f} ms over "
            f"{len(xs)} requests ({smi})")
    log(f"[phase 5] terms_agg p50 beside the other kinds: " + json.dumps({
        kind: float(np.median(xs)) for kind, xs in sorted(lat.items())
        if "terms_agg" in kind or "match_or" in kind}))
    log(f"[phase 5] host copy: phase 3 {json.dumps(copy3)}, "
        f"phase 4 {json.dumps(copy4)}")

    # ---------------- phase 6: kernel summary ----------------------------
    clock("phase 6")
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
    ], "rest": rest_report, "aggs": aggs_report,
        "durability": durability_report, "staging": staging_report,
        "query_dsl": qdsl_report, "sort_paging": sort_report,
        "field_types": geo_report, "nested": nested_report,
        "search_request": request_report, "scripting": script_report,
        "cluster_metadata": meta_report, "data_movement": move_report,
        "remainder": remainder_report, "infrastructure": infra_report,
        "sound_answers_checked": SOUND["checked"]}
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


def _segment_fields(seg):
    """A segment's Segment.from_arrays fields over its host arrays: the
    columns, routings, legacy parents and nested sub-segments too."""
    return dict(
        term_keys=seg.term_keys, term_block_start=seg.term_block_start,
        term_block_count=seg.term_block_count,
        term_doc_freq=seg.term_doc_freq, block_docs=seg.block_docs,
        block_tfs=seg.block_tfs, norms=seg.norms, live=seg.live,
        field_stats=seg.field_stats, field_norm_idx=seg.field_norm_idx,
        doc_ids=seg.doc_ids, sources=seg.sources, routings=seg.routings,
        parents=seg.parents,
        numeric_columns={f: vars(c) for f, c in seg.numeric_columns.items()},
        ordinal_columns={f: vars(c) for f, c in seg.ordinal_columns.items()},
        geo_columns={f: vars(c) for f, c in seg.geo_columns.items()},
        vector_columns={f: vars(c) for f, c in seg.vector_columns.items()},
        nested={path: dict(_segment_fields(nctx.segment),
                           parent_of=nctx.parent_of,
                           offset_of=nctx.offset_of)
                for path, nctx in seg.nested.items()},
        seqnos=seg.seqnos, versions=seg.versions, positions=seg.positions)


def _adopt_copies(gnode, cnode, index, Segment, device="cpu",
                  index_to=None):
    """Give another node (the cpu node by default) the cuda node's sealed
    segments as new segments over the same host arrays, on ``device``, in
    index ``index_to`` (the same name by default)."""
    for sid, shard in gnode.indices[index].shards.items():
        engine = cnode.indices[index_to or index].shards[sid].engine
        for seg in shard.engine.segments:
            engine.adopt_segment(Segment.from_arrays(
                seg.name, device=device, **_segment_fields(seg)))
        engine.mapper_service.merge(shard.engine.mapper_service.mapping_dict())


if __name__ == "__main__":
    sys.exit(main())
