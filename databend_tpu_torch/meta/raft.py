"""Raft consensus for the meta service.

The reference replicates its meta service with raft (`databend-meta`,
reference Cargo.toml:170 — openraft under the hood; the query side only
sees the KV API). This module is a compact, complete Raft core for the
TPU-native meta process: leader election with randomized timeouts, log
replication with per-peer nextIndex backtracking, majority commit, a
deterministic KV apply, and durable term/vote/log state (sqlite) so a
restarted node catches up from its own log before pulling the rest from
the leader.

Hardening (round 4): log compaction with snapshot install (the state
machine dump is persisted atomically with the log truncation in the
same sqlite transaction; a follower whose nextIndex precedes the
leader's first retained entry receives InstallSnapshot and resets its
log to the snapshot point), and linearizable reads via read-index
backed by a leader lease — a read captures commit_index, confirms
leadership (a majority heartbeat round, amortized through the lease
that every successful replication round refreshes), waits for apply to
reach the captured index, then serves. A deposed leader's lease expires
before any new leader can be elected (lease = election_timeout_min,
measured from the start of the confirming round), so stale reads are
ruled out up to local monotonic-clock correctness.

Scope notes (documented simplifications vs a production raft):
* static membership (the --raft-peers list), no joint consensus

Every mutation is a log entry ``{op, body}``; CAS failures are
legitimate *applied results* (no state change), so replicas stay
identical and the proposing client gets the TableVersionMismatched it
would have gotten from the embedded store.
"""

from __future__ import annotations

import json
import os
import random
import sqlite3
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class RaftLog:
    """Durable raft state: log entries + (term, votedFor) + the latest
    state-machine snapshot. 1-based absolute indexing; the in-memory
    list starts with a sentinel holding (snap_term, None) at absolute
    index ``snap_index`` (0 before any compaction)."""

    def __init__(self, path: Optional[str] = None):
        self._lock = threading.RLock()
        self.snap_index = 0
        self.snap_term = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._db = sqlite3.connect(path, check_same_thread=False,
                                       timeout=30.0)
            self._db.execute("PRAGMA busy_timeout=30000")
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            self._db.execute("CREATE TABLE IF NOT EXISTS raft_log "
                             "(idx INTEGER PRIMARY KEY, term INTEGER, "
                             "op TEXT)")
            self._db.execute("CREATE TABLE IF NOT EXISTS raft_meta "
                             "(k TEXT PRIMARY KEY, v TEXT)")
            self._db.commit()
            tv = dict(self._db.execute(
                "SELECT k, v FROM raft_meta").fetchall())
            self.term = int(tv.get("term", 0))
            self.voted_for = tv.get("voted_for") or None
            self.snap_index = int(tv.get("snap_index", 0))
            self.snap_term = int(tv.get("snap_term", 0))
            rows = self._db.execute(
                "SELECT idx, term, op FROM raft_log WHERE idx > ? "
                "ORDER BY idx", (self.snap_index,)).fetchall()
            self._entries = [(self.snap_term, None)] + [
                (t, json.loads(op)) for _, t, op in rows]
        else:
            self._db = None
            self._entries = [(0, None)]
            self.term = 0
            self.voted_for = None
        self._pending: list = []

    def _set_meta(self, pairs):
        for k, v in pairs:
            self._db.execute(
                "INSERT INTO raft_meta (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v=?", (k, str(v), str(v)))

    def save_term_vote(self, term: int, voted_for: Optional[str]):
        with self._lock:
            self.term = term
            self.voted_for = voted_for
            if self._db is not None:
                self._db.execute(
                    "INSERT INTO raft_meta (k, v) VALUES ('term', ?) "
                    "ON CONFLICT(k) DO UPDATE SET v=?", (str(term), str(term)))
                self._db.execute(
                    "INSERT INTO raft_meta (k, v) VALUES ('voted_for', ?) "
                    "ON CONFLICT(k) DO UPDATE SET v=?",
                    (voted_for or "", voted_for or ""))
                self._db.commit()

    def last_index(self) -> int:
        return self.snap_index + len(self._entries) - 1

    def term_at(self, idx: int) -> int:
        return self._entries[idx - self.snap_index][0]

    def entry(self, idx: int):
        return self._entries[idx - self.snap_index]

    def append(self, term: int, op: dict) -> int:
        """In-memory append; rows buffer until :meth:`flush` — the
        leader flushes ONCE per replication round (group fsync), so N
        concurrent proposals cost one sqlite transaction, not N
        (reference: databend-meta batches raft-log IO the same way)."""
        with self._lock:
            self._entries.append((term, op))
            idx = self.last_index()
            if self._db is not None:
                self._pending.append((idx, term, json.dumps(op)))
            return idx

    def flush(self):
        """Persist buffered appends in one transaction. Must run before
        an entry is acknowledged (leader: before counting itself in the
        majority; follower: before answering AppendEntries)."""
        with self._lock:
            if self._db is None or not self._pending:
                return
            rows, self._pending = self._pending, []
            self._db.executemany(
                "INSERT OR REPLACE INTO raft_log (idx, term, op)"
                " VALUES (?, ?, ?)", rows)
            self._db.commit()

    def truncate_from(self, idx: int):
        """Drop entries >= idx (conflict resolution on followers)."""
        with self._lock:
            self._pending = [r for r in self._pending if r[0] < idx]
            del self._entries[idx - self.snap_index:]
            if self._db is not None:
                self._db.execute("DELETE FROM raft_log WHERE idx >= ?",
                                 (idx,))
                self._db.commit()

    def save_snapshot(self, state, idx: int, term: int):
        self.flush()
        """Leader-side compaction: persist the state-machine snapshot at
        ``idx`` and drop every log entry <= idx, atomically (one sqlite
        transaction — a crash leaves either the old log or the new
        snapshot+tail, never neither)."""
        with self._lock:
            if idx <= self.snap_index:
                return
            del self._entries[1: idx - self.snap_index + 1]
            self._entries[0] = (term, None)
            self.snap_index, self.snap_term = idx, term
            if self._db is not None:
                self._db.execute("DELETE FROM raft_log WHERE idx <= ?",
                                 (idx,))
                self._set_meta([("snap_index", idx), ("snap_term", term),
                                ("snapshot", json.dumps(state))])
                self._db.commit()
            else:
                self._snapshot_mem = state

    def install_snapshot(self, state, idx: int, term: int):
        self._pending = []
        """Follower-side install: the whole log is superseded by the
        leader's snapshot — reset to the snapshot point."""
        with self._lock:
            self._entries = [(term, None)]
            self.snap_index, self.snap_term = idx, term
            if self._db is not None:
                self._db.execute("DELETE FROM raft_log")
                self._set_meta([("snap_index", idx), ("snap_term", term),
                                ("snapshot", json.dumps(state))])
                self._db.commit()
            else:
                self._snapshot_mem = state

    def load_snapshot(self):
        """The persisted state-machine snapshot (None before the first
        compaction)."""
        with self._lock:
            if self._db is not None:
                row = self._db.execute(
                    "SELECT v FROM raft_meta WHERE k='snapshot'").fetchone()
                return json.loads(row[0]) if row else None
            return getattr(self, "_snapshot_mem", None)

    def close(self):
        if self._db is not None:
            self._db.close()


class RaftNode:
    """One raft participant. ``apply_fn(op_dict) -> result`` is the
    deterministic state-machine apply (the meta KV mutation)."""

    def __init__(self, node_id: str, peers: Dict[str, str],
                 apply_fn: Callable[[dict], Any],
                 log_path: Optional[str] = None,
                 election_timeout: Tuple[float, float] = (0.4, 0.8),
                 heartbeat: float = 0.12,
                 snapshot_fn: Optional[Callable[[], Any]] = None,
                 restore_fn: Optional[Callable[[Any], None]] = None,
                 compact_threshold: int = 1024,
                 learner: bool = False):
        self.id = node_id
        self.peers = {k: v for k, v in peers.items() if k != node_id}
        self.self_endpoint = peers.get(node_id)
        # a learner replicates but never starts elections until a
        # committed __add_voter names it (the databend-meta --join flow)
        self.learner = learner
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.compact_threshold = compact_threshold
        self.log = RaftLog(log_path)
        self.role = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self._lease_until = 0.0  # leader lease (read-index fast path)
        if self.log.snap_index > 0 and restore_fn is not None:
            state = self.log.load_snapshot()
            if state is not None:
                restore_fn(state)
                self.commit_index = self.last_applied = self.log.snap_index
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        self._results: Dict[int, Any] = {}
        self._lock = threading.RLock()
        self._apply_cv = threading.Condition(self._lock)
        self._election_timeout = election_timeout
        self._heartbeat = heartbeat
        self._deadline = time.monotonic() + self._rand_timeout()
        self._stopped = False
        self._repl_wake = threading.Event()
        self._threads = [
            threading.Thread(target=self._ticker, daemon=True),
            threading.Thread(target=self._replicator, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- helpers
    def _rand_timeout(self) -> float:
        lo, hi = self._election_timeout
        return random.uniform(lo, hi)

    def _majority(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def _rpc(self, peer_ep: str, path: str, body: dict,
             timeout: float = 0.5) -> Optional[dict]:
        req = urllib.request.Request(
            f"{peer_ep}/v1/raft/{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read())
        except Exception:
            return None

    # ------------------------------------------------------------ lifecycle
    def stop(self):
        with self._lock:
            self._stopped = True
            self._apply_cv.notify_all()
        self._repl_wake.set()

    def _ticker(self):
        while True:
            time.sleep(self._heartbeat / 2)
            with self._lock:
                if self._stopped:
                    return
                role = self.role
                expired = time.monotonic() >= self._deadline
            if role == LEADER:
                self._replicate_all()
            elif expired and not self.learner:
                self._start_election()

    def _replicator(self):
        """Group-commit replication: every wake batches ALL entries
        appended since the last round into one AppendEntries per peer, so
        N concurrent proposes cost one round, not N."""
        while True:
            self._repl_wake.wait(timeout=0.5)
            self._repl_wake.clear()
            with self._lock:
                if self._stopped:
                    return
                if self.role != LEADER:
                    continue
            self._replicate_all()

    # ------------------------------------------------------------- election
    def _start_election(self):
        with self._lock:
            self.role = CANDIDATE
            term = self.log.term + 1
            self.log.save_term_vote(term, self.id)
            self.leader_id = None
            self._deadline = time.monotonic() + self._rand_timeout()
            last_idx = self.log.last_index()
            last_term = self.log.term_at(last_idx)
        votes = [1]  # self
        done = threading.Event()

        def ask(pid, ep):
            out = self._rpc(ep, "request_vote", {
                "term": term, "candidate": self.id,
                "last_log_index": last_idx, "last_log_term": last_term})
            if out is None:
                return
            with self._lock:
                if out["term"] > self.log.term:
                    self._become_follower(out["term"], None)
                    done.set()
                    return
                if out.get("granted") and self.role == CANDIDATE \
                        and self.log.term == term:
                    votes[0] += 1
                    if votes[0] >= self._majority():
                        self._become_leader()
                        done.set()

        ts = [threading.Thread(target=ask, args=(p, ep), daemon=True)
              for p, ep in self.peers.items()]
        for t in ts:
            t.start()
        done.wait(timeout=self._election_timeout[0])

    def _become_follower(self, term: int, leader: Optional[str]):
        self.role = FOLLOWER
        if term > self.log.term:
            self.log.save_term_vote(term, None)
        self.leader_id = leader
        self._deadline = time.monotonic() + self._rand_timeout()

    def _become_leader(self):
        self.role = LEADER
        self.leader_id = self.id
        nxt = self.log.last_index() + 1
        self.next_index = {p: nxt for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        # no-op barrier entry: commits everything from prior terms once
        # replicated (raft §8's first-log-entry-of-term rule)
        self.log.append(self.log.term, {"op": "noop"})
        threading.Thread(target=self._replicate_all, daemon=True).start()

    # ---------------------------------------------------------- replication
    def _replicate_all(self):
        round_start = time.monotonic()
        with self._lock:
            if self.role != LEADER:
                return
            peers = list(self.peers.items())
        # group fsync: ALL entries appended since the last round persist
        # in one transaction before the leader acknowledges itself
        self.log.flush()
        acks = [1]  # self
        ts = [threading.Thread(target=self._replicate_one,
                               args=(p, ep, acks), daemon=True)
              for p, ep in peers]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=1.0)
        with self._lock:
            if self.role == LEADER and acks[0] >= self._majority():
                # lease measured from the START of the confirming round:
                # no new leader can have been elected before round_start
                # + election_timeout_min, so reads under the lease are
                # linearizable (given local monotonic clocks)
                self._lease_until = max(
                    self._lease_until,
                    round_start + self._election_timeout[0])
        self._advance_commit()

    def _replicate_one(self, pid: str, ep: str, acks: Optional[list] = None):
        with self._lock:
            if self.role != LEADER:
                return
            term = self.log.term
            nxt = self.next_index.get(pid, self.log.last_index() + 1)
            if nxt <= self.log.snap_index:
                # peer is behind the compaction horizon: InstallSnapshot
                peers_map = dict(self.peers)
                peers_map[self.id] = self.self_endpoint or ""
                body = {"term": term, "leader": self.id,
                        "last_included_index": self.log.snap_index,
                        "last_included_term": self.log.snap_term,
                        "state": self.log.load_snapshot(),
                        "peers": peers_map}
                rpc = "install_snapshot"
            else:
                prev = nxt - 1
                prev_term = self.log.term_at(prev) \
                    if prev <= self.log.last_index() else 0
                entries = [[self.log.term_at(i), self.log.entry(i)[1]]
                           for i in range(nxt, self.log.last_index() + 1)]
                peers_map = dict(self.peers)
                peers_map[self.id] = self.self_endpoint or ""
                body = {"term": term, "leader": self.id,
                        "prev_log_index": prev, "prev_log_term": prev_term,
                        "entries": entries,
                        "leader_commit": self.commit_index,
                        "peers": peers_map}
                rpc = "append_entries"
        out = self._rpc(ep, rpc, body)
        if out is None:
            return
        with self._lock:
            if out["term"] > self.log.term:
                self._become_follower(out["term"], None)
                return
            if self.role != LEADER or self.log.term != term:
                return
            if acks is not None:
                acks[0] += 1  # peer answered at our term: leadership ack
            if rpc == "install_snapshot":
                if out.get("success"):
                    self.match_index[pid] = body["last_included_index"]
                    self.next_index[pid] = self.match_index[pid] + 1
                return
            if out.get("success"):
                self.match_index[pid] = body["prev_log_index"] \
                    + len(body["entries"])
                self.next_index[pid] = self.match_index[pid] + 1
            else:
                # conflict backtracking (follower hints its log length)
                hint = out.get("conflict_index")
                self.next_index[pid] = max(
                    1, hint if hint is not None else nxt - 1)

    def _advance_commit(self):
        with self._lock:
            if self.role != LEADER:
                return
            for n in range(self.log.last_index(), self.commit_index, -1):
                if self.log.term_at(n) != self.log.term:
                    break  # only current-term entries commit by counting
                count = 1 + sum(1 for p in self.peers
                                if self.match_index.get(p, 0) >= n)
                if count >= self._majority():
                    self.commit_index = n
                    self._apply_committed()
                    break

    def _apply_committed(self):
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            _, op = self.log.entry(self.last_applied)
            if op is None or op.get("op") == "noop":
                result = None
            elif op.get("op") in ("__add_voter", "__remove_voter"):
                result = {"ok": True}
            else:
                try:
                    result = {"ok": self.apply_fn(op)}
                except Exception as e:  # CAS failures are applied results
                    result = {"error": e}
            self._results[self.last_applied] = result
            if len(self._results) > 1024:  # followers never pop results
                for k in sorted(self._results)[:-512]:
                    self._results.pop(k, None)
        self._apply_cv.notify_all()
        if self.snapshot_fn is not None and \
                self.last_applied - self.log.snap_index \
                >= self.compact_threshold:
            self.log.save_snapshot(self.snapshot_fn(), self.last_applied,
                                   self.log.term_at(self.last_applied))

    # -------------------------------------------------------------- RPC in
    def handle_request_vote(self, body: dict) -> dict:
        with self._lock:
            term = body["term"]
            if term > self.log.term:
                self._become_follower(term, None)
            granted = False
            if term == self.log.term and \
                    self.log.voted_for in (None, body["candidate"]):
                last_idx = self.log.last_index()
                last_term = self.log.term_at(last_idx)
                up_to_date = (body["last_log_term"], body["last_log_index"]) \
                    >= (last_term, last_idx)
                if up_to_date:
                    granted = True
                    self.log.save_term_vote(term, body["candidate"])
                    self._deadline = time.monotonic() + self._rand_timeout()
            return {"term": self.log.term, "granted": granted}

    def handle_append_entries(self, body: dict) -> dict:
        with self._lock:
            term = body["term"]
            if term < self.log.term:
                return {"term": self.log.term, "success": False}
            self._become_follower(term, body["leader"])
            # adopt the leader's membership view (a joiner knows no
            # peer endpoints until told; removals propagate the same way)
            bp = body.get("peers")
            if bp:
                self.peers = {k: v for k, v in bp.items() if k != self.id}
                if self.id in bp:
                    self.learner = False
            prev = body["prev_log_index"]
            entries = body["entries"]
            if prev < self.log.snap_index:
                # entries at/below the snapshot horizon are already part
                # of our installed snapshot: skip that prefix
                skip = self.log.snap_index - prev
                if skip >= len(entries):
                    return {"term": self.log.term, "success": True}
                entries = entries[skip:]
                prev = self.log.snap_index
            if prev > self.log.last_index() or \
                    self.log.term_at(prev) != body["prev_log_term"]:
                return {"term": self.log.term, "success": False,
                        "conflict_index": min(prev,
                                              self.log.last_index() + 1)}
            idx = prev
            for eterm, eop in entries:
                idx += 1
                if idx <= self.log.last_index():
                    if self.log.term_at(idx) == eterm:
                        continue
                    self.log.truncate_from(idx)
                self.log.append(eterm, eop)
                if eop is not None and isinstance(eop, dict) \
                        and eop.get("op") in ("__add_voter",
                                              "__remove_voter"):
                    self._apply_config(eop)
            self.log.flush()  # durable before the success reply
            if body["leader_commit"] > self.commit_index:
                self.commit_index = min(body["leader_commit"],
                                        self.log.last_index())
                self._apply_committed()
            return {"term": self.log.term, "success": True}

    def handle_install_snapshot(self, body: dict) -> dict:
        with self._lock:
            term = body["term"]
            if term < self.log.term:
                return {"term": self.log.term, "success": False}
            self._become_follower(term, body["leader"])
            idx = body["last_included_index"]
            if idx <= self.commit_index:
                # stale snapshot: we already have everything in it
                return {"term": self.log.term, "success": True}
            if self.restore_fn is not None:
                self.restore_fn(body["state"])
            for nid, ep in (body.get("peers") or {}).items():
                if nid == self.id:
                    self.learner = False
                elif nid not in self.peers:
                    self.peers[nid] = ep
            self.log.install_snapshot(body["state"], idx,
                                      body["last_included_term"])
            self.commit_index = self.last_applied = idx
            self._results.clear()
            self._apply_cv.notify_all()
            return {"term": self.log.term, "success": True}

    # ---------------------------------------------------------------- reads
    def read_index(self, timeout: float = 5.0) -> int:
        """Linearizable read barrier (raft §6.4 read-index with a leader
        lease): capture commit_index, confirm leadership — served from
        the lease when a majority heartbeat round completed within
        election_timeout_min, otherwise by forcing a round — then wait
        until the state machine has applied up to the captured index."""
        deadline = time.monotonic() + timeout
        with self._lock:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            term = self.log.term
            ri = self.commit_index
        while True:
            with self._lock:
                if self.role != LEADER or self.log.term != term \
                        or self._stopped:
                    raise NotLeader(self.leader_id)
                # the no-op barrier entry must have committed: counting
                # commits is only valid for current-term entries, and a
                # fresh leader's commit_index may lag its predecessor's
                current_term_committed = (
                    self.commit_index >= self.log.snap_index
                    and (self.commit_index == self.log.snap_index
                         and self.log.snap_term == term
                         or self.commit_index > self.log.snap_index
                         and self.log.term_at(self.commit_index) == term))
                leased = time.monotonic() < self._lease_until
                if leased and current_term_committed:
                    ri = max(ri, self.commit_index)
                    break
            if time.monotonic() >= deadline:
                raise TimeoutError("read_index: no majority reachable")
            self._replicate_all()  # heartbeat round refreshes the lease
            time.sleep(0.005)
        with self._lock:
            while self.last_applied < ri:
                if self._stopped or self.role != LEADER \
                        or self.log.term != term:
                    raise NotLeader(self.leader_id)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("read_index: apply lagged")
                self._apply_cv.wait(timeout=min(remaining, 0.1))
        return ri

    # ----------------------------------------------------------- membership
    def _apply_config(self, op: dict) -> None:
        """Single-server membership change (raft §6): the NEW config is
        used as soon as the entry is APPENDED, on leader and followers
        alike. Caller holds the lock or is in a handler that does."""
        if op.get("op") == "__add_voter":
            nid, ep = op["id"], op["ep"]
            if ep and not ep.startswith("http"):
                ep = f"http://{ep}"
            if nid == self.id:
                self.learner = False  # promoted to voter
            else:
                self.peers[nid] = ep
                self.next_index.setdefault(nid, self.log.last_index() + 1)
                self.match_index.setdefault(nid, 0)
        elif op.get("op") == "__remove_voter":
            nid = op["id"]
            self.peers.pop(nid, None)
            self.next_index.pop(nid, None)
            self.match_index.pop(nid, None)
            if nid == self.id and self.role == LEADER:
                # a removed leader finishes committing the entry via the
                # normal round, then steps down (raft §4.2.2); stepping
                # down here is safe because propose() already appended
                self._become_follower(self.log.term, None)

    def add_voter(self, node_id: str, endpoint: str, timeout: float = 5.0):
        """Leader-only: add a voting member. The joiner needs no prior
        config — it learns membership from replicated config entries or
        the peer map carried by InstallSnapshot."""
        return self.propose({"op": "__add_voter", "id": node_id,
                             "ep": endpoint}, timeout=timeout)

    def remove_voter(self, node_id: str, timeout: float = 5.0):
        return self.propose({"op": "__remove_voter", "id": node_id},
                            timeout=timeout)

    # ------------------------------------------------------------- propose
    def propose(self, op: dict, timeout: float = 5.0):
        """Leader-only: append, replicate, wait for apply, return the
        state-machine result (re-raising CAS errors). Raises
        NotLeader on followers."""
        with self._lock:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            term = self.log.term
            idx = self.log.append(term, op)
            if op.get("op") in ("__add_voter", "__remove_voter"):
                self._apply_config(op)  # latest config applies at append
        self._repl_wake.set()  # group commit: ride the next batch round
        deadline = time.monotonic() + timeout
        with self._lock:
            while self.last_applied < idx:
                if self._stopped or self.role != LEADER \
                        or self.log.term != term:
                    raise NotLeader(self.leader_id)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"raft commit timeout at index {idx} "
                        f"(no majority reachable)")
                self._apply_cv.wait(timeout=min(remaining, 0.1))
            # idx <= snap_index: the entry committed and was already
            # compacted into a snapshot — it can only be OURS, since an
            # overwrite requires a higher term and the wait loop above
            # raises NotLeader on any term change
            if idx > self.log.snap_index and self.log.term_at(idx) != term:
                raise NotLeader(self.leader_id)  # entry was overwritten
            result = self._results.pop(idx, None)
        if result and "error" in result:
            raise result["error"]
        return result["ok"] if result else None

    def status(self) -> dict:
        with self._lock:
            return {"id": self.id, "role": self.role, "term": self.log.term,
                    "leader": self.leader_id,
                    "commit_index": self.commit_index,
                    "last_applied": self.last_applied,
                    "log_len": self.log.last_index(),
                    "snap_index": self.log.snap_index}


class NotLeader(Exception):
    def __init__(self, leader_id: Optional[str]):
        super().__init__(f"not the raft leader (leader: {leader_id})")
        self.leader_id = leader_id
