"""Point-in-time scroll on the port, against the JAX package.

Mirrors tests/test_scroll_pit.py on a JAX ``Node`` (tile kernel in
interpret mode, ``ES_TPU_PALLAS=interpret``) and a port
``Node(device="cpu")`` fed the same operations: a scroll pins every
shard's segment set and live masks when it opens, so concurrent indexing,
updates, deletes, refreshes and force merges neither skip nor repeat a
doc, and every page carries the value a doc had at open. The pages of
both packages are equal, page by page (ids and sort values exact).
``clear_scroll`` and keep-alive expiry drop the context and its pinned
views; the keep-alive reaper runs on its own thread, and ``close`` stops
and joins it. Every test closes both nodes.
"""

import gc
import threading
import time
import weakref

import pytest

from elasticsearch_tpu.common.errors import (
    IllegalArgumentException as JIllegalArgument,
)
from elasticsearch_tpu.common.errors import (
    ResourceNotFoundException as JResourceNotFound,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.node import Node as JNode
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ResourceNotFoundException,
)
from elasticsearch_tpu_torch.index.segment import PinnedSegmentView
from elasticsearch_tpu_torch.node import Node

INDEX_BODY = {"settings": {"number_of_shards": 2},
              "mappings": {"properties": {
                  "n": {"type": "integer"},
                  "kind": {"type": "keyword"},
                  "title": {"type": "text"}}}}


@pytest.fixture()
def nodes():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PALLAS", "interpret")
    jn, tn = JNode(JSettings.EMPTY), Node(device="cpu")
    for n in (jn, tn):
        n.create_index("src", INDEX_BODY)
        for i in range(30):
            n.index_doc("src", f"d{i}", {"n": i, "kind": "orig",
                                         "title": f"w{i % 3} w{i % 5}"})
        n.indices["src"].refresh()
    yield jn, tn
    jn.close()
    tn.close()
    mp.undo()


def both(nodes, fn):
    return [fn(n) for n in nodes]


def page_view(resp):
    return [(h["_id"], h.get("sort"), h["_source"].get("kind"))
            for h in resp["hits"]["hits"]]


def drain(node, first):
    pages = [page_view(first)]
    sid = first["_scroll_id"]
    while True:
        page = node.scroll(sid)
        if not page["hits"]["hits"]:
            break
        pages.append(page_view(page))
    return pages


@pytest.mark.parametrize("query", [{"match_all": {}},
                                   {"match": {"title": "w0 w1"}}])
def test_docs_indexed_after_open_are_invisible(nodes, query):
    firsts = both(nodes, lambda n: n.search(
        "src", {"query": query, "size": 7}, scroll="1m"))
    for n in nodes:
        for i in range(30, 40):
            n.index_doc("src", f"late{i}", {"n": i, "kind": "late",
                                            "title": "w0 w1"})
        n.indices["src"].refresh()
    jpages, tpages = (drain(n, f) for n, f in zip(nodes, firsts))
    assert [[i for i, _, _ in p] for p in tpages] == \
        [[i for i, _, _ in p] for p in jpages]
    ids = [i for p in tpages for i, _, _ in p]
    assert len(ids) == len(set(ids)) == firsts[1]["hits"]["total"]
    assert not any(i.startswith("late") for i in ids)


@pytest.mark.parametrize("query", [{"match_all": {}},
                                   {"match": {"title": "w0 w1 w2"}}])
def test_updates_and_deletes_do_not_shift_pages(nodes, query):
    """Updates (a delete and a reinsert into a new segment) and deletes
    between every page: no doc skipped or repeated, every doc at its
    value at open; with a match query the tile kernel reads the pinned
    live tiles, not the segment's current ones."""
    out = []
    for n in nodes:
        first = n.search("src", {"query": query, "size": 5}, scroll="1m")
        seen = {h["_id"]: h["_source"] for h in first["hits"]["hits"]}
        pages = [page_view(first)]
        sid, step = first["_scroll_id"], 0
        while True:
            for i in range(step * 3, step * 3 + 3):
                n.index_doc("src", f"d{i % 30}",
                            {"n": 1000 + i, "kind": "updated",
                             "title": "w0 w1 w2"})
            n.delete_doc("src", f"d{(step * 2 + 1) % 30}")
            n.indices["src"].refresh()
            step += 1
            page = n.scroll(sid)
            if not page["hits"]["hits"]:
                break
            pages.append(page_view(page))
            for h in page["hits"]["hits"]:
                assert h["_id"] not in seen, "a doc repeated across pages"
                seen[h["_id"]] = h["_source"]
        assert len(seen) == first["hits"]["total"]
        assert all(src["kind"] == "orig" for src in seen.values())
        out.append(pages)
    assert out[1] == out[0]


def test_force_merge_mid_scroll_keeps_fetching(nodes):
    firsts = both(nodes, lambda n: n.search(
        "src", {"query": {"match": {"title": "w1"}}, "size": 4},
        scroll="1m"))
    for n in nodes:
        n.index_doc("src", "x1", {"n": 99, "kind": "late", "title": "w1"})
        n.delete_doc("src", "d1")
        n.indices["src"].force_merge()  # replaces the segment objects
    jpages, tpages = (drain(n, f) for n, f in zip(nodes, firsts))
    assert tpages == jpages
    ids = [i for p in tpages for i, _, _ in p]
    assert len(ids) == len(set(ids)) == firsts[1]["hits"]["total"]
    assert "d1" in ids and "x1" not in ids


@pytest.mark.parametrize("sort", [[{"n": "desc"}], [{"kind": "asc"}],
                                  [{"kind": "asc"}, {"n": "asc"}]])
def test_lazy_pages_exact_under_sort_and_ties(nodes, sort):
    firsts = both(nodes, lambda n: n.search(
        "src", {"query": {"match_all": {}}, "size": 4, "sort": sort},
        scroll="1m"))
    jpages, tpages = (drain(n, f) for n, f in zip(nodes, firsts))
    assert tpages == jpages
    ids = [i for p in tpages for i, _, _ in p]
    assert len(ids) == len(set(ids)) == 30
    if sort == [{"n": "desc"}]:
        assert ids == [f"d{i}" for i in range(29, -1, -1)]


def test_open_does_not_materialize_whole_corpus(nodes):
    for n in nodes:
        n.create_index("big", {"settings": {"number_of_shards": 3}})
        for i in range(200):
            n.index_doc("big", f"b{i}", {"n": i})
        n.indices["big"].refresh()
    firsts = both(nodes, lambda n: n.search(
        "big", {"query": {"match_all": {}}, "size": 3}, scroll="1m"))
    _jn, tn = nodes
    ctx = tn.scrolls[firsts[1]["_scroll_id"]]
    assert len(ctx["entries"]) < 200  # only a prefix at open
    jpages, tpages = (drain(n, f) for n, f in zip(nodes, firsts))
    assert tpages == jpages
    ids = [i for p in tpages for i, _, _ in p]
    assert sorted(ids) == sorted(f"b{i}" for i in range(200))
    assert len(ctx["entries"]) == 200


def test_sliced_scroll_partitions(nodes):
    _jn, tn = nodes
    union = []
    for sid in range(3):
        firsts = both(nodes, lambda n: n.search(
            "src", {"query": {"match_all": {}}, "size": 4,
                    "slice": {"id": sid, "max": 3}}, scroll="1m"))
        jpages, tpages = (drain(n, f) for n, f in zip(nodes, firsts))
        assert tpages == jpages
        union.extend(i for p in tpages for i, _, _ in p)
    assert sorted(union) == sorted(f"d{i}" for i in range(30))


def test_first_page_carries_aggs_and_total(nodes):
    body = {"query": {"match": {"title": "w0"}}, "size": 2,
            "aggs": {"k": {"terms": {"field": "kind"}}}}
    jr, tr = both(nodes, lambda n: n.search("src", dict(body), scroll="1m"))
    assert tr["aggregations"] == jr["aggregations"]
    assert tr["hits"]["total"] == jr["hits"]["total"]
    assert tr["_plane"] == jr["_plane"] == "host"
    assert page_view(tr) == page_view(jr)
    page = nodes[1].scroll(tr["_scroll_id"], "2m")
    assert page["hits"]["total"] == tr["hits"]["total"]
    assert set(page) == set(nodes[0].scroll(jr["_scroll_id"], "2m"))


def test_clear_scroll_frees_context_and_views(nodes):
    jn, tn = nodes
    jfirst = jn.search("src", {"query": {"match": {"title": "w1"}},
                               "size": 4}, scroll="1m")
    first = tn.search("src", {"query": {"match": {"title": "w1"}},
                              "size": 4}, scroll="1m")
    sid = first["_scroll_id"]
    views = [weakref.ref(v) for vs in tn.scrolls[sid]["pinned"].values()
             for v in vs]
    assert views and all(isinstance(r(), PinnedSegmentView) for r in views)
    assert tn.clear_scroll([sid]) == jn.clear_scroll([jfirst["_scroll_id"]])
    assert tn.clear_scroll([sid])["num_freed"] == 0
    with pytest.raises(ResourceNotFoundException):
        tn.scroll(sid)
    with pytest.raises(JResourceNotFound):
        jn.scroll(jfirst["_scroll_id"])
    del first
    gc.collect()
    assert all(r() is None for r in views)
    for n in nodes:
        n.search("src", {"query": {"match_all": {}}, "size": 4}, scroll="1m")
        n.search("src", {"query": {"match_all": {}}, "size": 4}, scroll="1m")
    assert tn.clear_scroll(["_all"]) == jn.clear_scroll(["_all"]) == {
        "succeeded": True, "num_freed": 2}


def test_keep_alive_expiry_reaps_context(nodes):
    for n, err in zip(nodes, (JResourceNotFound, ResourceNotFoundException)):
        first = n.search("src", {"query": {"match_all": {}}, "size": 4},
                         scroll="1ms")
        sid = first["_scroll_id"]
        time.sleep(0.05)
        with pytest.raises(err):
            n.scroll(sid)
        # opening another scroll sweeps the expired context out entirely
        n.search("src", {"query": {"match_all": {}}, "size": 4},
                 scroll="1m")
        assert sid not in n.scrolls


def test_background_reaper_frees_expired_pins(nodes):
    for n in nodes:
        first = n.search("src", {"query": {"match_all": {}}, "size": 4},
                         scroll="1ms")
        time.sleep(0.05)
        assert n._reaper.is_alive()
        assert n._reap_expired_scrolls() == 1  # the sweep the loop runs
        assert first["_scroll_id"] not in n.scrolls


def test_close_stops_and_joins_the_reaper():
    before = {t for t in threading.enumerate()
              if t.name.startswith("scroll-reaper")}
    tn = Node(device="cpu")
    reaper = tn._reaper
    assert reaper.is_alive()
    tn.create_index("src", INDEX_BODY)
    tn.index_doc("src", "a", {"n": 1})
    tn.indices["src"].refresh()
    tn.search("src", {"query": {"match_all": {}}}, scroll="1m")
    tn.close()
    assert not reaper.is_alive()
    assert tn.scrolls == {}
    after = {t for t in threading.enumerate()
             if t.name.startswith("scroll-reaper")}
    assert after <= before


def test_scroll_rejections(nodes):
    for n, err in zip(nodes, (JIllegalArgument, IllegalArgumentException)):
        with pytest.raises(err, match="from"):
            n.search("src", {"query": {"match_all": {}}, "size": 4,
                             "from": 5}, scroll="1m")
        with pytest.raises(err, match="collapse"):
            n.search("src", {"query": {"match_all": {}},
                             "collapse": {"field": "kind"}}, scroll="1m")
