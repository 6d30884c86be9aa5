"""The port's memory circuit breakers (``common/breaker.py``) against the
JAX package's (``tests/test_breakers.py``).

The same add and release sequences run through both packages' breaker
services and must give the same trips, the same exception messages and
statuses, and the same ``stats()``. Over whole nodes, the request breaker
around ``run_aggregations`` trips (HTTP 429) and releases as the JAX one
does, and the in-flight breaker answers 429 over the port's REST surface.
Each node made here is closed, the JAX package's device-memory ledger ends
no larger than it began, and both packages' breaker limits are reset
after each test.
"""

import re

import pytest

from elasticsearch_tpu.common import breaker as jbreaker
from elasticsearch_tpu.common.errors import (
    CircuitBreakingException as JCircuitBreakingException,
)
from elasticsearch_tpu.common.memory import memory_accountant as jaccountant
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu_torch.common import breaker as tbreaker
from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingException as TCircuitBreakingException,
)
from elasticsearch_tpu_torch.common.memory import memory_accountant
from elasticsearch_tpu_torch.common.settings import Settings


@pytest.fixture(autouse=True)
def _restore_breakers():
    jbytes = jaccountant().staged_bytes()
    yield
    jbreaker.configure_breaker_service(JSettings.EMPTY)
    tbreaker.configure_breaker_service(Settings.EMPTY)
    # no JAX staging outlives the test (other files' JAX indices may
    # release theirs meanwhile, so the total may only shrink)
    assert jaccountant().staged_bytes() <= jbytes


def _run(mod, exc_type, limits, steps):
    """Apply ``steps`` ((child, bytes) adds; negative bytes release) to a
    fresh service; returns the outcome of each step and the stats."""
    svc = mod.CircuitBreakerService(*limits)
    out = []
    for child, nbytes in steps:
        b = svc.get_breaker(child)
        if nbytes < 0:
            out.append(("released", b.add_without_breaking(nbytes)))
            continue
        try:
            out.append(("ok", b.add_estimate_bytes_and_maybe_break(
                nbytes, f"<{child}>")))
        except exc_type as e:
            out.append(("trip", str(e), e.status_code, e.to_dict()["error"]))
    return out, svc.stats()


SEQUENCES = {
    "parent_sums_children": ((100, 90, 90), [
        ("request", 60), ("fielddata", 60), ("fielddata", 30),
        ("request", -60), ("fielddata", 60)]),
    "child_limit": ((0, 50, 0), [
        ("request", 40), ("request", 20), ("request", -40),
        ("request", 45)]),
    "accounting_outside_parent": ((100, 0, 0), [
        ("accounting", 500), ("request", 80), ("in_flight_requests", 30)]),
    "in_flight": ((64, 0, 0), [
        ("in_flight_requests", 60), ("in_flight_requests", 10),
        ("in_flight_requests", -60), ("in_flight_requests", 10)]),
    "unlimited": ((0, 0, 0), [
        ("request", 10 ** 12), ("fielddata", 10 ** 12)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_trips_messages_and_stats(name):
    limits, steps = SEQUENCES[name]
    jout, jstats = _run(jbreaker, JCircuitBreakingException, limits, steps)
    tout, tstats = _run(tbreaker, TCircuitBreakingException, limits, steps)
    assert tout == jout
    assert tstats == jstats


def test_configured_limits_follow_the_settings():
    settings = {"indices.breaker.total.limit": "5kb",
                "indices.breaker.request.limit": "2kb"}
    def limits(svc):
        # the limits (each package's accounting child mirrors its own
        # device ledger, so its used bytes differ)
        return {k: v["limit_size_in_bytes"] for k, v in svc.stats().items()}

    jsvc = jbreaker.configure_breaker_service(JSettings(settings))
    tsvc = tbreaker.configure_breaker_service(Settings(settings))
    assert limits(tsvc) == limits(jsvc)
    assert tsvc.get_breaker("fielddata").limit_bytes == int(5 * 1024 * 0.6)
    jsvc = jbreaker.configure_breaker_service(JSettings.EMPTY)
    tsvc = tbreaker.configure_breaker_service(Settings.EMPTY)
    assert limits(tsvc) == limits(jsvc)


def _nodes(settings):
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu_torch.node import Node

    jn = JNode(JSettings(settings) if settings else JSettings.EMPTY)
    tn = Node(Settings(settings) if settings else Settings.EMPTY,
              device="cpu")
    for n in (jn, tn):
        # the host rung: every aggregation runs run_aggregations
        n.create_index("tbrk_logs", {"settings": {"index": {"search": {
            "mesh": False}}}, "mappings": {"_doc": {"properties": {
            "tag": {"type": "keyword"}, "msg": {"type": "text"}}}}})
        for i in range(50):
            n.index_doc("tbrk_logs", str(i), {"tag": f"t{i % 5}",
                                         "msg": f"event {i}"})
        (n.refresh("tbrk_logs") if hasattr(n, "refresh")
         else n.indices["tbrk_logs"].refresh())
    return jn, tn


AGG = {"size": 0, "aggs": {"tags": {"terms": {"field": "tag"}}}}


def test_request_breaker_trips_aggregations_as_429():
    jn, tn = _nodes({"indices.breaker.total.limit": "5kb",
                     "indices.breaker.request.limit": "2kb"})
    try:
        # each package's request breaker is process-wide: another test
        # file in this worker may have left bytes on either one, so each
        # message is read against its own breaker's bytes before the trip
        ju = jn.breaker_service.get_breaker("request").used_bytes
        tu = tn.breaker_service.get_breaker("request").used_bytes
        with pytest.raises(JCircuitBreakingException) as je:
            jn.search("tbrk_logs", dict(AGG))
        with pytest.raises(TCircuitBreakingException) as te:
            tn.search("tbrk_logs", dict(AGG))
        assert te.value.status_code == je.value.status_code == 429
        wanted = [int(re.search(r"would be \[(\d+)/", str(e.value))[1])
                  for e in (je, te)]
        # the same estimate, the same message
        assert wanted[1] - tu == wanted[0] - ju
        assert str(te.value) == str(je.value).replace(
            f"[{wanted[0]}/{wanted[0]}b]", f"[{wanted[1]}/{wanted[1]}b]")
        assert te.value.to_dict()["error"]["type"] == \
            "circuit_breaking_exception"
        # the failed reservation held nothing
        assert tn.breaker_service.get_breaker("request").used_bytes == 0
    finally:
        jn.close()
        tn.close()


def test_request_breaker_releases_after_the_request():
    jn, tn = _nodes(None)
    trips = tbreaker.breaker_service().get_breaker("request").trip_count
    try:
        jr = jn.search("tbrk_logs", dict(AGG))
        tr = tn.search("tbrk_logs", dict(AGG))
        assert tr["aggregations"] == jr["aggregations"]
        for n in (jn, tn):
            assert n.breaker_service.get_breaker("request").used_bytes == 0
        assert tn.breaker_service.get_breaker("request").trip_count == trips
    finally:
        jn.close()
        tn.close()


def test_in_flight_breaker_answers_429_over_rest():
    from elasticsearch_tpu.rest.controller import (
        RestController as JRestController,
    )
    from elasticsearch_tpu_torch.rest.controller import RestController

    jn, tn = _nodes({"indices.breaker.total.limit": "100mb"})
    try:
        big = b'{"query": {"match": {"msg": "' + b"x" * 200 + b'"}}}'
        got = []
        for n, ctrl in ((jn, JRestController(jn)), (tn, RestController(tn))):
            n.breaker_service.get_breaker("in_flight_requests").limit_bytes = 64
            got.append(ctrl.dispatch("POST", "/tbrk_logs/_search", {}, big))
        (jst, jbody), (tst, tbody) = got
        assert tst == jst == 429
        assert tbody["error"]["type"] == jbody["error"]["type"] == \
            "circuit_breaking_exception"
        assert tbody["error"]["reason"] == jbody["error"]["reason"]
        # the rejected body held nothing; a small one passes
        inflight = tn.breaker_service.get_breaker("in_flight_requests")
        assert inflight.used_bytes == 0
        st, body = RestController(tn).dispatch(
            "POST", "/tbrk_logs/_search", {}, b'{"size": 1}')
        assert st == 200 and body["hits"]["total"] == 50
    finally:
        jn.close()
        tn.close()


def test_accounting_child_mirrors_the_device_ledger():
    acct = memory_accountant()
    accounting = tbreaker.breaker_service().get_breaker("accounting")
    before = accounting.used_bytes
    acct.register("brk-ledger", "s", "postings_raw", "t", 4096)
    assert accounting.used_bytes == before + 4096
    # the parent leaves the device bytes out of its host sum
    svc = tbreaker.breaker_service()
    svc.get_breaker("request").add_estimate_bytes_and_maybe_break(1, "x")
    svc.get_breaker("request").add_without_breaking(-1)
    acct.release_index("brk-ledger")
    assert accounting.used_bytes == before
