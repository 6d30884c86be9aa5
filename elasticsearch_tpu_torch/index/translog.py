"""Per-shard write-ahead log with generations.

Counterpart of ``elasticsearch_tpu/index/translog.py``, with the same
on-disk format, so a translog one package wrote replays in the other:

- one JSON line per operation in ``translog-<gen>.log`` (compact
  separators, keys ``op``, ``seq_no``, ``primary_term``, ``version``, then
  ``id``, ``source``, ``routing``, ``parent`` where set);
- ``translog.ckp``, written atomically (tmp + fsync + rename), holding
  ``generation``, ``max_seqno`` and ``committed_seqno``.

Durability ``request`` fsyncs the log and rewrites the checkpoint on every
``add`` before the op is acknowledged; ``async`` leaves both to the next
``sync`` (flush, close). Generations roll at flush and are trimmed once
every op in them is committed; a generation that cannot be read is kept
(and reported in ``stats``) until everything ever logged is committed. A
torn final line of the newest generation (a crash mid-append, never
acknowledged) is trimmed at open; any other unreadable line raises
``TranslogCorruptedException``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Iterator, List, Optional

from elasticsearch_tpu_torch.common.errors import TranslogCorruptedException

logger = logging.getLogger("elasticsearch_tpu_torch.index.translog")


class TranslogOp:
    INDEX = "index"
    DELETE = "delete"
    NO_OP = "no_op"

    def __init__(self, op_type: str, seqno: int, doc_id: Optional[str] = None,
                 source: Optional[dict] = None, routing: Optional[str] = None,
                 version: int = 1, primary_term: int = 1,
                 parent: Optional[str] = None):
        self.op_type = op_type
        self.seqno = seqno
        self.doc_id = doc_id
        self.source = source
        self.routing = routing
        self.version = version
        self.primary_term = primary_term
        # legacy _parent metadata value — persisted alongside routing so
        # the registry survives restart (ParentFieldMapper stores it)
        self.parent = parent

    def to_dict(self) -> dict:
        d = {"op": self.op_type, "seq_no": self.seqno, "primary_term": self.primary_term,
             "version": self.version}
        if self.doc_id is not None:
            d["id"] = self.doc_id
        if self.source is not None:
            d["source"] = self.source
        if self.routing is not None:
            d["routing"] = self.routing
        if self.parent is not None:
            d["parent"] = self.parent
        return d

    @staticmethod
    def from_dict(d: dict) -> "TranslogOp":
        return TranslogOp(
            d["op"], d["seq_no"], d.get("id"), d.get("source"), d.get("routing"),
            d.get("version", 1), d.get("primary_term", 1),
            parent=d.get("parent"),
        )


class Translog:
    DURABILITY_REQUEST = "request"
    DURABILITY_ASYNC = "async"

    def __init__(self, directory: str, durability: str = DURABILITY_REQUEST):
        self.directory = directory
        self.durability = durability
        os.makedirs(directory, exist_ok=True)
        ckp = self._read_checkpoint()
        self.generation: int = ckp.get("generation", 1)
        self.max_seqno: int = ckp.get("max_seqno", -1)
        # ops at or below this seqno are in a committed segment set
        self.committed_seqno: int = ckp.get("committed_seqno", -1)
        # generations found unreadable below their tail (see _read_gen):
        # surfaced in stats(), retained until fully committed
        self.corrupt_generations: set = set()
        self._trim_torn_tail()
        self._writer = open(self._gen_path(self.generation), "a", encoding="utf-8")
        self._ops_since_sync = 0

    # ------------------------------------------------------------------

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.directory, f"translog-{gen}.log")

    def _ckp_path(self) -> str:
        return os.path.join(self.directory, "translog.ckp")

    def _read_checkpoint(self) -> dict:
        try:
            with open(self._ckp_path(), encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _write_checkpoint(self) -> None:
        tmp = self._ckp_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "generation": self.generation,
                    "max_seqno": self.max_seqno,
                    "committed_seqno": self.committed_seqno,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ckp_path())  # atomic, like MetaDataStateFormat

    # ------------------------------------------------------------------

    def add(self, op: TranslogOp) -> None:
        """Append one op; fsync per the durability policy (Translog.add:488)."""
        self._writer.write(json.dumps(op.to_dict(), separators=(",", ":")) + "\n")
        self.max_seqno = max(self.max_seqno, op.seqno)
        if self.durability == self.DURABILITY_REQUEST:
            self.sync()
        else:
            self._ops_since_sync += 1

    def sync(self) -> None:
        self._writer.flush()
        os.fsync(self._writer.fileno())
        self._ops_since_sync = 0
        self._write_checkpoint()

    def roll_generation(self) -> None:
        """Start a new generation file (rolled at flush)."""
        self.sync()
        self._writer.close()
        self.generation += 1
        self._writer = open(self._gen_path(self.generation), "a", encoding="utf-8")
        self._write_checkpoint()

    def mark_committed(self, seqno: int) -> None:
        """Engine flushed a commit covering ops <= seqno; trim old generations
        whose ops are all committed (CombinedDeletionPolicy analog).

        A generation that cannot be READ is never silently skipped (the
        old behavior retained it forever, masking the corruption): it is
        recorded in ``corrupt_generations`` / stats() with a warning, and
        deleted only once EVERYTHING ever logged is committed — an
        unreadable file can hide ops, so the conservative bound is the
        checkpoint's own max_seqno."""
        self.committed_seqno = max(self.committed_seqno, seqno)
        self.sync()
        # trim: delete generations strictly older than current whose max op
        # seqno <= committed_seqno
        for gen in range(1, self.generation):
            path = self._gen_path(gen)
            if not os.path.exists(path):
                continue
            try:
                ops = list(self._read_gen(gen))
            except OSError:
                continue
            except TranslogCorruptedException:
                if gen not in self.corrupt_generations:
                    self.corrupt_generations.add(gen)
                    logger.warning(
                        "[%s] translog generation [%d] is corrupt; "
                        "retained until its seqno range is fully committed",
                        self.directory, gen)
                if self.committed_seqno >= self.max_seqno:
                    os.remove(path)
                    self.corrupt_generations.discard(gen)
                continue
            if not ops or all(op.seqno <= self.committed_seqno for op in ops):
                os.remove(path)
                self.corrupt_generations.discard(gen)

    def _trim_torn_tail(self) -> None:
        """Cut a benign torn final line off the newest generation BEFORE
        reopening it for append: the writer opens in append mode, so a
        crash-cut fragment left in place would have the next acked op
        CONCATENATED onto it — one unparseable merged line that silently
        swallows the new op (or, once buried mid-file, fails recovery of
        everything). Only the case _read_gen would tolerate is trimmed;
        a tear that could hide checkpointed ops, or any unreadable line
        before the tail, is left intact so recovery raises
        TranslogCorruptedException instead of destroying the evidence."""
        path = self._gen_path(self.generation)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        if not data or data.endswith(b"\n"):
            return
        head, _sep, tail = data.rpartition(b"\n")
        try:
            json.loads(tail.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
        else:
            # a COMPLETE op missing only its newline (crash between the
            # json write and the terminator): finish the line instead of
            # dropping a durable op
            with open(path, "ab") as f:
                f.write(b"\n")
                f.flush()
                os.fsync(f.fileno())
            return
        last_seqno = -1
        any_read = False
        intact = True
        for line in head.split(b"\n"):
            if not line.strip():
                continue
            try:
                d = json.loads(line.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                intact = False  # damage before the tail: don't touch
                break
            last_seqno = d.get("seq_no", -1)
            any_read = True
        if not (intact and self._benign_torn_tail(self.generation,
                                                  last_seqno, any_read)):
            return
        with open(path, "ab") as f:
            f.truncate(len(head) + len(_sep))
            f.flush()
            os.fsync(f.fileno())
        logger.warning(
            "[%s] translog generation [%d] had a truncated final line "
            "(crash mid-append); trimmed, replay resumes at seqno [%d]",
            self.directory, self.generation, last_seqno)

    def _benign_torn_tail(self, gen: int, last_seqno: int,
                          any_read: bool) -> bool:
        """THE safety invariant shared by trim-at-open and replay: a torn
        final line is benign only when nothing checkpointed can sit
        beyond the tear — every op at or below the committed seqno was
        already read from this generation, or the generation holds no
        readable op at all (a rolled file whose only append was the torn,
        never-acked one)."""
        return (last_seqno >= self.committed_seqno
                or (not any_read and gen > 1))

    def _read_gen(self, gen: int,
                  tolerate_tail: bool = False) -> Iterator[TranslogOp]:
        """Ops of one generation file, in log order.

        ``tolerate_tail`` (the NEWEST generation during recovery): a
        crash mid-append leaves a partial final JSON line — replay stops
        there with a warning, because the torn op was never acked. Any
        OTHER unreadable line — mid-file, an older generation, or a tail
        whose loss would swallow ops at or below the checkpointed
        committed seqno — raises ``TranslogCorruptedException``: acked
        data is gone and recovery must not pretend otherwise."""
        with open(self._gen_path(gen), encoding="utf-8") as f:
            lines = f.read().split("\n")
        last_seqno = -1
        any_read = False
        for i, raw in enumerate(lines):
            line = raw.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                is_tail = all(not rest.strip() for rest in lines[i + 1:])
                if tolerate_tail and is_tail and self._benign_torn_tail(
                        gen, last_seqno, any_read):
                    logger.warning(
                        "[%s] translog generation [%d] has a truncated "
                        "final line (crash mid-append); replay stops at "
                        "seqno [%d]", self.directory, gen, last_seqno)
                    return
                raise TranslogCorruptedException(
                    f"translog generation [{gen}] unreadable at line "
                    f"[{i + 1}]"
                    + ("" if is_tail else " (mid-file)")
                    + (f"; ops at or below the checkpointed seqno "
                       f"[{self.committed_seqno}] may be lost"
                       if last_seqno < self.committed_seqno else ""))
            op = TranslogOp.from_dict(d)
            last_seqno = op.seqno
            any_read = True
            yield op

    def snapshot(self, from_seqno: int = 0,
                 on_corruption: str = "raise") -> List[TranslogOp]:
        """All retained ops with seqno >= from_seqno, in log order.
        (Translog.newSnapshot — used by recovery phase2 and resync.)
        ``on_corruption``: "raise" (recovery must fail loudly) or "skip"
        (observability paths keep serving the readable generations)."""
        self._writer.flush()
        out: List[TranslogOp] = []
        for gen in range(1, self.generation + 1):
            if not os.path.exists(self._gen_path(gen)):
                continue
            try:
                for op in self._read_gen(
                        gen, tolerate_tail=gen == self.generation):
                    if op.seqno >= from_seqno:
                        out.append(op)
            except TranslogCorruptedException:
                self.corrupt_generations.add(gen)
                if on_corruption == "raise":
                    raise
        return out

    def uncommitted_ops(self) -> List[TranslogOp]:
        return self.snapshot(self.committed_seqno + 1)

    def stats(self) -> dict:
        ops = self.snapshot(0, on_corruption="skip")
        size = sum(
            os.path.getsize(self._gen_path(g))
            for g in range(1, self.generation + 1)
            if os.path.exists(self._gen_path(g))
        )
        retained = [g for g in range(1, self.generation + 1)
                    if os.path.exists(self._gen_path(g))]
        return {
            "operations": len(ops),
            "size_in_bytes": size,
            "uncommitted_operations": len(
                [op for op in ops if op.seqno > self.committed_seqno]),
            "generation": self.generation,
            # retention observability: a corrupt old generation must be
            # VISIBLE, not silently pinned (mark_committed docstring)
            "earliest_retained_generation": min(retained,
                                                default=self.generation),
            "corrupt_generations": sorted(self.corrupt_generations),
        }

    def close(self) -> None:
        try:
            self.sync()
        finally:
            self._writer.close()
