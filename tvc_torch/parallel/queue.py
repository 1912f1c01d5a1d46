"""A work queue on a shared filesystem for sweeps over several processes
(counterpart of ``tvc/parallel/queue.py``, with the same semantics and the
same files, so a queue directory is read alike by both packages).

Per-(video, quality) sweep work varies widely (a threshold walk stops at
bpp >= 1, and the fallback-keyframe count differs per chain), so a static
partition (``tvc_torch.parallel.mesh.partition_work``) leaves processes idle
behind the slowest share. Workers instead pull units from a directory:

- enqueue  : one atomic ``jobs.json`` rename, the first creator wins;
- claim    : an ``O_CREAT|O_EXCL`` create of ``claims/<id>``; the atomicity
             is the filesystem's, no coordinator process is needed;
- complete : write a temporary file and publish it as ``done/<id>.json``;
- recover  : a claim whose mtime is older than ``stale_after`` seconds with
             no done file belongs to a dead worker and can be stolen (a
             rename into ``stale/``: one thief wins).

Workers renew their claim's mtime with ``heartbeat()``; a worker that lost
its claim to a thief has its late ``mark_done`` ignored as a duplicate
(results are idempotent per unit id).

Filesystem: a local POSIX filesystem or NFSv4+, where ``O_CREAT|O_EXCL`` and
``link(2)`` are atomic (NFSv3 does not guarantee ``O_EXCL``). Staleness
compares the claim's mtime with the stealing host's clock, so hosts that
share a queue should be NTP-synced; the default ``stale_after`` of 900 s
leaves a wide margin for ordinary clock skew.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

__all__ = ["WorkQueue"]

# a no-hardlink loser waits this long for the lock holder's rename before it
# concludes that the holder died (20 polls of 50 ms, as the JAX package waits)
GRACE_POLLS = 20
GRACE_POLL_S = 0.05


def _atomic_write_json(path: str, obj: Any) -> None:
    tmp = f"{path}.tmp.{uuid.uuid4().hex}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)  # atomic on POSIX


class WorkQueue:
    """A directory-backed work queue of JSON-able units shared by any number
    of processes and hosts. Every unit is a dict with a unique string under
    ``id_key``; every method may be called concurrently."""

    def __init__(self, root: str, stale_after: float = 900.0, id_key: str = "id"):
        self.root = root
        self.stale_after = float(stale_after)
        self.id_key = id_key
        self._jobs_path = os.path.join(root, "jobs.json")
        self._claims = os.path.join(root, "claims")
        self._done = os.path.join(root, "done")
        self._graveyard = os.path.join(root, "stale")

    @classmethod
    def create_or_open(cls, root: str, jobs: Optional[List[Dict[str, Any]]] = None,
                       stale_after: float = 900.0, id_key: str = "id") -> "WorkQueue":
        """Open the queue at ``root``, enqueueing ``jobs`` if it is new.
        Processes racing this with the same list leave exactly one
        ``jobs.json`` (an atomic rename), so every claim refers to one list."""
        q = cls(root, stale_after=stale_after, id_key=id_key)
        for d in (root, q._claims, q._done, q._graveyard):
            os.makedirs(d, exist_ok=True)
        if not os.path.exists(q._jobs_path):
            if jobs is None:
                raise FileNotFoundError(f"no jobs.json at {root} and none supplied")
            ids = [j[id_key] for j in jobs]
            if len(set(ids)) != len(ids):
                raise ValueError("duplicate work-unit ids")
            _atomic_write_json(q._jobs_path, jobs)
        return q

    def jobs(self) -> List[Dict[str, Any]]:
        with open(self._jobs_path) as f:
            return json.load(f)

    def _claim_path(self, jid: str) -> str:
        return os.path.join(self._claims, jid)

    def _done_path(self, jid: str) -> str:
        return os.path.join(self._done, f"{jid}.json")

    def _try_create_claim(self, jid: str, owner: str) -> bool:
        try:
            fd = os.open(self._claim_path(jid), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump({"owner": owner, "t": time.time()}, f)
        return True

    def _try_steal(self, jid: str, owner: str) -> bool:
        """Steal a stale claim: exactly one thief wins the graveyard rename."""
        path = self._claim_path(jid)
        try:
            age = time.time() - os.path.getmtime(path)
        except OSError:
            return self._try_create_claim(jid, owner)  # the claim vanished
        if age < self.stale_after:
            return False
        grave = os.path.join(self._graveyard, f"{jid}.{uuid.uuid4().hex}")
        try:
            os.rename(path, grave)  # one concurrent thief succeeds
        except OSError:
            return False
        return self._try_create_claim(jid, owner)

    def claim(self, owner: str) -> Optional[Dict[str, Any]]:
        """The next available unit, or None when every unit is claimed or
        done: fresh units first, then stale claims of dead owners."""
        jobs = self.jobs()
        for j in jobs:
            jid = j[self.id_key]
            if not os.path.exists(self._done_path(jid)) and self._try_create_claim(jid, owner):
                return j
        for j in jobs:
            jid = j[self.id_key]
            if not os.path.exists(self._done_path(jid)) and self._try_steal(jid, owner):
                return j
        return None

    def heartbeat(self, jid: str) -> None:
        """Renew a held claim (one utime call)."""
        try:
            os.utime(self._claim_path(jid), None)
        except OSError:
            pass  # the claim was stolen; the late mark_done will be a duplicate

    def mark_done(self, jid: str, result: Any) -> bool:
        """Record a unit's result; True for exactly one caller per unit. A
        duplicate completion (a stolen unit finished by both owners) keeps
        the first result and returns False.

        The result is written and fsynced to a temporary file, then
        ``os.link``ed to the done path: link fails with EEXIST if another
        writer got there first, so one caller returns True
        (``run_sweep_queued`` picks its single merger so)."""
        path = self._done_path(jid)
        if os.path.exists(path):
            return False
        tmp = f"{path}.tmp.{uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            json.dump(result, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)  # an atomic publish that never overwrites
            return True
        except FileExistsError:
            return False
        except OSError:
            # No hardlinks on this filesystem: an O_EXCL ``.lock`` sidecar
            # picks the one True caller, which renames its complete tmp file
            # right after taking the lock, so the bytes that persist are its
            # own. A loser discards its tmp, except when the lock exists and
            # the done file does not appear within the grace window: the
            # winner died between lock and rename, and the loser publishes
            # its own complete result so the unit cannot wedge (it still
            # returns False). The lock is never removed: it is the lasting
            # record of the single winner.
            lock = f"{path}.lock"
            try:
                os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                won = True
            except FileExistsError:
                won = False
            if won:
                os.rename(tmp, path)
            elif not os.path.exists(path):
                for _ in range(GRACE_POLLS):
                    time.sleep(GRACE_POLL_S)
                    if os.path.exists(path):
                        break
                else:
                    os.rename(tmp, path)
            return won
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def pending(self) -> List[str]:
        return [j[self.id_key] for j in self.jobs()
                if not os.path.exists(self._done_path(j[self.id_key]))]

    def all_done(self) -> bool:
        return not self.pending()

    def results(self) -> Dict[str, Any]:
        """The results of the listed units that are done (merge markers are
        not units)."""
        out: Dict[str, Any] = {}
        for j in self.jobs():
            jid = j[self.id_key]
            path = self._done_path(jid)
            if os.path.exists(path):
                with open(path) as f:
                    out[jid] = json.load(f)
        return out

    def drain(self, owner: str, fn: Callable[[Dict[str, Any]], Any]) -> int:
        """Claim and run units until none is left; returns how many this
        worker completed. An exception releases nothing: the claim goes
        stale and another worker recovers the unit after ``stale_after``."""
        n = 0
        while True:
            job = self.claim(owner)
            if job is None:
                return n
            self.mark_done(job[self.id_key], fn(job))
            n += 1
