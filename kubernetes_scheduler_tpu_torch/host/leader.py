"""Lease-based leader election: active/passive scheduler replicas.

The reference gets HA from upstream kube-scheduler's lease leader election
(deploy/yoda-scheduler.yaml:10-17: leaderElect on resourceLock
"endpointsleases" in kube-system). This module provides the same
active/passive failover contract with a pluggable lease backend:

- `FileLease` (here) — a shared-filesystem lease for simulation, tests,
  and single-host pod pairs (atomic claim via O_EXCL + fsync'd renew
  records).
- `kube.lease.KubeLease` — the Kubernetes coordination.k8s.io/v1 backend
  behind the same `Lease` protocol (resourceVersion CAS on the cluster
  Lease object), selected with `--lease-kube`.

Semantics mirror k8s.io/client-go leaderelection: a lease carries (holder
identity, acquire time, renew time, duration); a candidate acquires when
the lease is unheld or expired; the holder renews every `retry_period`
and loses leadership when renewal fails or the lease was stolen.

The port's copy of kubernetes_scheduler_tpu/host/leader.py.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import threading
import time
from typing import Protocol

log = logging.getLogger("yoda_tpu.leader")


@dataclasses.dataclass
class LeaseRecord:
    holder: str
    acquired_at: float
    renewed_at: float
    duration: float

    def expired(self, now: float) -> bool:
        return now > self.renewed_at + self.duration


class Lease(Protocol):
    def read(self) -> LeaseRecord | None: ...
    def try_claim(self, record: LeaseRecord, previous: LeaseRecord | None) -> bool: ...
    def clear(self, holder: str) -> None: ...


class FileLease:
    """Lease on a shared filesystem. Claims are atomic: a new lease file is
    written to a temp path and linked into place only if the current
    content still matches `previous` (compare-and-swap under an O_EXCL
    lock file)."""

    def __init__(self, path: str):
        self.path = path
        self._lock_path = path + ".lock"

    def read(self) -> LeaseRecord | None:
        try:
            with open(self.path) as f:
                return LeaseRecord(**json.load(f))
        except (FileNotFoundError, json.JSONDecodeError, TypeError):
            return None

    def _locked(self):
        class _Lock:
            def __enter__(inner):
                deadline = time.monotonic() + 5.0
                while True:
                    try:
                        inner.fd = os.open(
                            self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
                        )
                        return inner
                    except FileExistsError:
                        if time.monotonic() > deadline:
                            # stale lock (holder died mid-claim): break it
                            try:
                                os.unlink(self._lock_path)
                            except FileNotFoundError:
                                pass
                        time.sleep(0.05)

            def __exit__(inner, *exc):
                os.close(inner.fd)
                try:
                    os.unlink(self._lock_path)
                except FileNotFoundError:
                    pass

        return _Lock()

    def try_claim(
        self, record: LeaseRecord, previous: LeaseRecord | None
    ) -> bool:
        with self._locked():
            current = self.read()
            cur_key = (current.holder, current.renewed_at) if current else None
            prev_key = (previous.holder, previous.renewed_at) if previous else None
            if cur_key != prev_key:
                return False
            tmp = f"{self.path}.{record.holder}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(dataclasses.asdict(record), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            return True

    def clear(self, holder: str) -> None:
        with self._locked():
            current = self.read()
            if current and current.holder == holder:
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass


class LeaderElector:
    """client-go leaderelection.LeaderElector analog.

    acquire_blocking() returns once this identity holds the lease; a
    daemon thread renews it every `retry_period`. is_leader() flips False
    if renewal is lost (a standby stole an expired lease) — the scheduler
    loop must check it each cycle and stop binding when not leading.
    """

    def __init__(
        self,
        lease: Lease,
        *,
        identity: str | None = None,
        lease_duration: float = 15.0,
        retry_period: float = 2.0,
        renew_deadline: float | None = None,
    ):
        self.lease = lease
        self.identity = identity or f"{os.uname().nodename}-{os.getpid()}"
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        # client-go keeps renewDeadline (10s) strictly below leaseDuration
        # (15s): the holder declares itself non-leader BEFORE the instant
        # a standby may steal the expired lease, so there is no
        # dual-leader window. Default 2/3; the clamp below holds for
        # explicit values too — a deadline >= the lease duration would
        # reopen the window the deadline exists to close.
        if renew_deadline is None:
            renew_deadline = max(lease_duration * (2.0 / 3.0), retry_period * 1.5)
        self.renew_deadline = min(renew_deadline, lease_duration * 0.9)
        self._leading = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def is_leader(self) -> bool:
        return self._leading.is_set()

    def _try_acquire_once(self) -> bool:
        now = time.time()
        current = self.lease.read()
        if current and current.holder == self.identity:
            acquired = current.acquired_at
        elif current and not current.expired(now):
            return False
        else:
            acquired = now
        record = LeaseRecord(
            holder=self.identity,
            acquired_at=acquired,
            renewed_at=now,
            duration=self.lease_duration,
        )
        return self.lease.try_claim(record, current)

    def _try_acquire_safe(self) -> bool:
        """Acquire/renew attempt that treats backend errors as failure.

        Network-backed leases (kube.lease.KubeLease) can raise on a
        transient API outage; an exception must not kill the renew thread
        while is_leader() still reads True (silent split-brain)."""
        try:
            return self._try_acquire_once()
        except Exception as e:
            log.warning("lease backend error (%s): %s", self.identity, e)
            return False

    def acquire_blocking(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            if self._try_acquire_safe():
                self._leading.set()
                log.info("acquired leadership as %s", self.identity)
                self._thread = threading.Thread(target=self._run_loop, daemon=True)
                self._thread.start()
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(self.retry_period)
        return False

    def _run_loop(self) -> None:
        """Renew while leading; on loss, keep trying to re-acquire.

        Loss is TIME-based, like client-go: one failed renew (a transient
        API hiccup) keeps leadership until `renew_deadline` — strictly
        shorter than the lease duration, so this holder stops scheduling
        before the instant a standby may steal the expired lease (no
        dual-leader window). The loop then stays in candidate mode so a
        recovered replica resumes scheduling without a process restart
        (the caller's loop pauses on is_leader()==False rather than
        exiting)."""
        # monotonic: the deadline measures LOCAL elapsed time since the
        # last successful renew; wall-clock (time.time) would stretch the
        # window across an NTP step-back, reopening the dual-leader gap
        last_renew = time.monotonic()
        while not self._stop.wait(self.retry_period):
            if self._try_acquire_safe():
                last_renew = time.monotonic()
                if not self._leading.is_set():
                    log.info("re-acquired leadership as %s", self.identity)
                    self._leading.set()
            elif self._leading.is_set() and (
                time.monotonic() - last_renew > self.renew_deadline
            ):
                log.warning("lost leadership (%s)", self.identity)
                self._leading.clear()

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.retry_period * 2)
        if self._leading.is_set():
            self.lease.clear(self.identity)
            self._leading.clear()


# distinct default identities for memberships created within one
# process (see ReplicaMembership.__init__)
_MEMBERSHIP_SEQ = itertools.count()


class ReplicaMembership:
    """Elected MEMBERSHIP for the replicated fleet: N slots, each an
    ordinary fenced lease, where the slot index IS the queue partition
    index (host/queue.pod_partition with n_partitions == n_slots).

    This generalizes the single active/passive pair to N active
    replicas: instead of one lease everyone contends for, a joining
    replica claims the first free slot (scanning 0..N-1, one-shot
    acquire per slot, then backing off). Holding slot i means "I own
    partition i" — renewal, renew-deadline fencing, and loss semantics
    are exactly LeaderElector's, so a crashed replica's partition
    becomes claimable after its lease expires and the successor resumes
    that partition's queue. Safety does NOT rest on the lease: even a
    zombie replica that schedules past its deadline cannot double-bind,
    because every bind runs the bind-table CAS (host/replica.BindTable)
    — the lease bounds unowned-partition downtime, the CAS guards
    correctness. `yoda-tpu scheduler --replicas N` joins one membership
    per in-process replica.
    """

    def __init__(
        self,
        make_lease,
        n_slots: int,
        *,
        identity: str | None = None,
        lease_duration: float = 15.0,
        retry_period: float = 2.0,
        renew_deadline: float | None = None,
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self._make_lease = make_lease
        self.n_slots = n_slots
        # the default identity carries a per-instance sequence number:
        # nodename-pid alone would make two memberships in ONE process
        # (the in-process fleet runner) look like the same holder, and
        # a slot lease re-acquires for its own identity — both would
        # "win" slot 0
        self.identity = identity or (
            f"{os.uname().nodename}-{os.getpid()}"
            f"-m{next(_MEMBERSHIP_SEQ)}"
        )
        self._kw = dict(
            lease_duration=lease_duration,
            retry_period=retry_period,
            renew_deadline=renew_deadline,
        )
        self.retry_period = retry_period
        self.slot: int | None = None
        self.elector: LeaderElector | None = None

    @classmethod
    def on_files(cls, path: str, n_slots: int, **kw) -> "ReplicaMembership":
        """Membership over FileLease slot files `<path>.slot<i>`."""
        return cls(
            lambda i: FileLease(f"{path}.slot{i}"), n_slots, **kw
        )

    def join(self, timeout: float | None = None) -> int | None:
        """Claim the first free slot; block up to `timeout` (None =
        forever). Returns the slot index — the partition this replica
        now owns — or None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for i in range(self.n_slots):
                elector = LeaderElector(
                    self._make_lease(i),
                    # filesystem-safe separator: FileLease embeds the
                    # identity in its tmp-file name, so "/" would point
                    # the write at a nonexistent directory
                    identity=f"{self.identity}.slot{i}",
                    **self._kw,
                )
                # one-shot: timeout=0 tries the slot once and moves on
                if elector.acquire_blocking(timeout=0):
                    self.slot = i
                    self.elector = elector
                    log.info(
                        "joined membership as %s: slot %d of %d",
                        self.identity, i, self.n_slots,
                    )
                    return i
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(self.retry_period)

    def is_member(self) -> bool:
        """True while this replica's slot lease is held (same fencing
        as LeaderElector.is_leader — flips False before the slot is
        stealable)."""
        return self.elector is not None and self.elector.is_leader()

    def leave(self) -> None:
        if self.elector is not None:
            self.elector.release()
            self.elector = None
            self.slot = None
