"""Translog and sequence numbers: the port against the JAX package.

Every case of the JAX package's torn-tail and corrupt-generation tests
(``tests/test_crash_recovery.py``) runs once per package, through the
package's own ``Translog``, ``TranslogOp`` and exception. The same op
sequence, run through both, must leave identical generation files and
checkpoints, and a translog one package wrote must replay in the other.
``GlobalCheckpointTracker`` and ``check_active_shards`` follow the same
steps in both packages and must agree at every step.
"""

import json
import logging
import os

import numpy as np
import pytest

from elasticsearch_tpu.common import errors as jerrors
from elasticsearch_tpu.index import seqno as jseqno
from elasticsearch_tpu.index import translog as jtranslog
from elasticsearch_tpu_torch.common import errors as terrors
from elasticsearch_tpu_torch.index import seqno as tseqno
from elasticsearch_tpu_torch.index import translog as ttranslog

PKGS = {
    "jax": (jtranslog, jerrors.TranslogCorruptedException),
    "torch": (ttranslog, terrors.TranslogCorruptedException),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    mod, exc = PKGS[request.param]
    return mod, exc


def _add_ops(mod, tl, seqnos):
    for s in seqnos:
        tl.add(mod.TranslogOp(mod.TranslogOp.INDEX, s, doc_id=f"d{s}",
                              source={"n": s}))


def _gen_file(tl, gen):
    return os.path.join(tl.directory, f"translog-{gen}.log")


# ----------------------------------------------------------------------
# torn tails (test_crash_recovery.TestTornTail, per package)
# ----------------------------------------------------------------------


def test_torn_final_line_tolerated(pkg, tmp_path, caplog):
    mod, _ = pkg
    tl = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, tl, range(5))
    tl._writer.flush()
    with open(_gen_file(tl, tl.generation), "a", encoding="utf-8") as f:
        f.write('{"op": "index", "seq_no": 5, "id": "d5", "sour')
    with caplog.at_level(logging.WARNING, mod.logger.name):
        reopened = mod.Translog(str(tmp_path / "t"))
        ops = reopened.snapshot()
    assert [op.seqno for op in ops] == [0, 1, 2, 3, 4]
    assert any("truncated final line" in r.message for r in caplog.records)


def test_write_after_torn_tail_not_merged(pkg, tmp_path):
    mod, _ = pkg
    tl = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, tl, range(3))
    tl._writer.flush()
    with open(_gen_file(tl, tl.generation), "a", encoding="utf-8") as f:
        f.write('{"op": "index", "seq_no": 3, "id": "d3", "sou')
    restarted = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, restarted, [3])
    restarted._writer.flush()
    again = mod.Translog(str(tmp_path / "t"))
    assert [op.seqno for op in again.snapshot()] == [0, 1, 2, 3]


def test_complete_tail_missing_newline_kept(pkg, tmp_path):
    mod, _ = pkg
    tl = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, tl, range(3))
    tl._writer.flush()
    path = _gen_file(tl, tl.generation)
    data = open(path, "rb").read()
    open(path, "wb").write(data.rstrip(b"\n"))
    restarted = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, restarted, [3])
    restarted._writer.flush()
    again = mod.Translog(str(tmp_path / "t"))
    assert [op.seqno for op in again.snapshot()] == [0, 1, 2, 3]


def test_mid_file_corruption_raises(pkg, tmp_path):
    mod, exc = pkg
    tl = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, tl, range(5))
    tl.close()
    path = _gen_file(tl, tl.generation)
    lines = open(path, encoding="utf-8").read().splitlines()
    lines[2] = lines[2][: len(lines[2]) // 2]
    open(path, "w", encoding="utf-8").write("\n".join(lines) + "\n")
    reopened = mod.Translog(str(tmp_path / "t"))
    with pytest.raises(exc, match="mid-file"):
        reopened.snapshot()


def test_torn_tail_below_checkpoint_raises(pkg, tmp_path):
    mod, exc = pkg
    tl = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, tl, range(6))
    tl.committed_seqno = 5
    tl.sync()
    tl.close()
    path = _gen_file(tl, tl.generation)
    lines = open(path, encoding="utf-8").read().splitlines()
    torn = lines[:4] + [lines[4][:10]]
    open(path, "w", encoding="utf-8").write("\n".join(torn) + "\n")
    reopened = mod.Translog(str(tmp_path / "t"))
    with pytest.raises(exc, match="checkpointed seqno"):
        reopened.snapshot()


# ----------------------------------------------------------------------
# corrupt generations (test_crash_recovery.TestCorruptGeneration)
# ----------------------------------------------------------------------


def _corrupted(mod, tmp_path):
    tl = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, tl, range(3))
    tl.roll_generation()
    _add_ops(mod, tl, range(3, 6))
    path = _gen_file(tl, 1)
    lines = open(path, encoding="utf-8").read().splitlines()
    lines[1] = "{corrupt"
    open(path, "w", encoding="utf-8").write("\n".join(lines) + "\n")
    return tl, path


def test_corrupt_generation_surfaced_and_retained(pkg, tmp_path, caplog):
    mod, _ = pkg
    tl, path = _corrupted(mod, tmp_path)
    with caplog.at_level(logging.WARNING, mod.logger.name):
        tl.mark_committed(2)
    assert os.path.exists(path)
    assert tl.corrupt_generations == {1}
    assert any("corrupt" in r.message for r in caplog.records)
    stats = tl.stats()
    assert stats["corrupt_generations"] == [1]
    assert stats["earliest_retained_generation"] == 1
    assert stats["operations"] == 4
    tl.close()


def test_corrupt_generation_deleted_once_fully_committed(pkg, tmp_path):
    mod, _ = pkg
    tl, path = _corrupted(mod, tmp_path)
    tl.mark_committed(2)
    assert os.path.exists(path)
    tl.mark_committed(tl.max_seqno)
    assert not os.path.exists(path)
    assert tl.corrupt_generations == set()
    stats = tl.stats()
    assert stats["corrupt_generations"] == []
    assert stats["earliest_retained_generation"] == tl.generation
    tl.close()


def test_healthy_trim_unaffected(pkg, tmp_path):
    mod, _ = pkg
    tl = mod.Translog(str(tmp_path / "t"))
    _add_ops(mod, tl, range(3))
    tl.roll_generation()
    _add_ops(mod, tl, range(3, 6))
    tl.mark_committed(2)
    assert not os.path.exists(_gen_file(tl, 1))
    assert tl.stats()["earliest_retained_generation"] == 2
    tl.close()


# ----------------------------------------------------------------------
# the same ops, the same bytes
# ----------------------------------------------------------------------


def _seeded_ops(mod, seed=3, n=40):
    """Index and delete ops with routings, versions, unicode and nested
    sources, drawn from a seed."""
    rng = np.random.RandomState(seed)
    ops = []
    for s in range(n):
        doc = f"d{int(rng.randint(12))}"
        if rng.rand() < 0.25:
            ops.append(mod.TranslogOp(mod.TranslogOp.DELETE, s, doc,
                                      version=int(rng.randint(1, 4))))
        else:
            src = {"title": " ".join(f"w{int(x)}" for x in
                                     rng.randint(0, 50, rng.randint(1, 6))),
                   "n": int(rng.randint(1000)), "f": float(rng.rand()),
                   "u": "é€😀", "tags": ["a", {"b": [1, 2.5, None]}]}
            ops.append(mod.TranslogOp(
                mod.TranslogOp.INDEX, s, doc, src,
                routing=f"r{s}" if s % 7 == 0 else None,
                version=int(rng.randint(1, 5))))
    return ops


def _drive(mod, directory, durability):
    """Adds, a roll, a commit that trims a generation, more adds, close."""
    tl = mod.Translog(directory, durability)
    ops = _seeded_ops(mod)
    for op in ops[:15]:
        tl.add(op)
    tl.roll_generation()
    for op in ops[15:30]:
        tl.add(op)
    tl.mark_committed(14)
    tl.roll_generation()
    for op in ops[30:]:
        tl.add(op)
    stats = tl.stats()
    tl.close()
    return stats


def _files(directory):
    return {fn: open(os.path.join(directory, fn), "rb").read()
            for fn in sorted(os.listdir(directory))}


@pytest.mark.parametrize("durability", ["request", "async"])
def test_same_ops_same_files_and_checkpoint(tmp_path, durability):
    js = _drive(jtranslog, str(tmp_path / "j"), durability)
    ts = _drive(ttranslog, str(tmp_path / "t"), durability)
    jf, tf = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert sorted(jf) == sorted(tf) == ["translog-2.log", "translog-3.log",
                                        "translog.ckp"]
    assert jf == tf
    ckp = json.loads(tf["translog.ckp"])
    assert ckp == {"generation": 3, "max_seqno": 39, "committed_seqno": 14}
    assert js == ts


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_translog_written_by_one_replays_in_the_other(tmp_path, writer,
                                                      reader):
    wmod, rmod = PKGS[writer][0], PKGS[reader][0]
    d = str(tmp_path / "t")
    tl = wmod.Translog(d)
    ops = _seeded_ops(wmod)
    for op in ops[:20]:
        tl.add(op)
    tl.roll_generation()
    for op in ops[20:]:
        tl.add(op)
    tl.mark_committed(9)
    tl._writer.flush()  # a kill: no close
    back = rmod.Translog(d)
    got = [op.to_dict() for op in back.uncommitted_ops()]
    assert got == [op.to_dict() for op in ops[10:]]
    assert back.max_seqno == 39 and back.committed_seqno == 9
    back.close()


# ----------------------------------------------------------------------
# sequence numbers
# ----------------------------------------------------------------------


def _tracker_steps(mod):
    """The same replication history on one package's tracker; the global
    checkpoint and stats after every step."""
    t = mod.GlobalCheckpointTracker("p")
    out = [t.global_checkpoint]
    t.update_local_checkpoint("p", 10)
    out.append(t.global_checkpoint)
    t.initiate_tracking("r1")
    out.append(t.global_checkpoint)
    t.mark_in_sync("r1", 4)
    out.append((t.global_checkpoint, sorted(t.in_sync),
                sorted(t.pending_in_sync)))
    t.update_local_checkpoint("r1", 7)
    out.append(t.global_checkpoint)
    t.mark_in_sync("r2", 2)
    out.append((t.global_checkpoint, sorted(t.in_sync),
                sorted(t.pending_in_sync)))
    t.update_local_checkpoint("r2", 9)
    t.update_local_checkpoint("r1", 12)
    out.append(t.global_checkpoint)
    t.remove("r2")
    out.append(t.global_checkpoint)
    t.seed_global_checkpoint(20)
    out.append(t.global_checkpoint)
    t.mark_in_sync("r3", 1, force=True)
    t.prune({"r1"})
    out.append(t.stats())
    return out


def test_global_checkpoint_tracker_same_as_jax():
    assert _tracker_steps(tseqno) == _tracker_steps(jseqno)
    assert tseqno.NO_OPS_PERFORMED == jseqno.NO_OPS_PERFORMED
    assert tseqno.UNASSIGNED_SEQ_NO == jseqno.UNASSIGNED_SEQ_NO


@pytest.mark.parametrize("wanted,active,total", [
    ("all", 1, 1), ("all", 1, 2), (1, 1, 2), ("1", 1, 2), (2, 1, 3),
    ("3", 1, 3), ("0", 1, 1), ("two", 1, 2), (None, 1, 2)])
def test_check_active_shards_same_as_jax(wanted, active, total):
    def outcome(mod):
        try:
            mod.check_active_shards(wanted, active, total, "[idx]")
            return None
        except Exception as e:  # noqa: BLE001 — compared across packages
            return type(e).__name__, str(e), e.status_code

    assert outcome(tseqno) == outcome(jseqno)
