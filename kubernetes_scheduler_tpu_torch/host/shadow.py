"""Shadow-mode serving: score production traffic through a candidate
config, live, without owning a single bind.

The ShadowScheduler TAILS a flight-recorder journal as the primary
writes it (trace/recorder.JournalTailer: rotation boundaries followed,
truncated tails re-polled, resume by seq) and re-dispatches every
device-path cycle through a CANDIDATE engine/config. What comes out is
a decision diff (bindings changed, candidate score deltas, gangs whose
admission diverged) and a latency diff (candidate step time against the
recorded engine_seconds), exported on the shadow's OWN /metrics
endpoint and span stream — the continuous rollout gate: run the
candidate beside the fleet instead of before it, and promote when the
divergence and latency series say so.

Isolation contract, by construction rather than convention:
- zero writes to the bind path — this module never imports the
  Scheduler, never opens the journal for writing, never talks to the
  cluster; its only inputs are journal bytes and its only outputs are
  its own metrics/span files.
- a wedged candidate cannot stall the shadow, let alone the primary:
  every candidate dispatch is guarded by a CircuitBreaker — failures
  count, the breaker opens, tailing continues (records still fold into
  the reconstruction so the delta chain stays anchored), and scoring
  resumes on the half-open probe.

Reconstruction reuses the replay primitives (trace/replay.py): the
recorded PodBatch and folded SnapshotArrays are bit-exact copies of
what the live cycle dispatched, so a candidate configured identically
to the primary MUST diff to zero, and the determinism tests pin it for
the serial and pipelined sources.

The port's copy of kubernetes_scheduler_tpu/host/shadow.py: the default
candidate engine is TorchEngine (cuda unless the caller passes `device=`
or an engine), and the candidate's result comes back through
device.to_host, one read per cycle.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from kubernetes_scheduler_tpu_torch.device import to_host
from kubernetes_scheduler_tpu_torch.host.observe import (
    Counter,
    Gauge,
    Histogram,
    HttpMetricsServer,
    PREFIX,
    SpanRecorder,
)
from kubernetes_scheduler_tpu_torch.host.resilience import CircuitBreaker
from kubernetes_scheduler_tpu_torch.trace.recorder import JournalTailer, TraceError
from kubernetes_scheduler_tpu_torch.trace.replay import (
    engine_kw_from_record,
    pod_batch_from_record,
)

log = logging.getLogger("yoda_tpu.shadow")

MODES = ("serial", "pipelined")


def candidate_kw(recorded_kw: dict, config) -> dict:
    """The candidate cycle options: the RECORDED kw (affinity/soft
    probes are properties of the traffic, not the config under test)
    with the scoring surface swapped for the candidate's — policy,
    assigner, normalizer, score plugins, auction knobs. `fused` is kept
    only inside the candidate's fusable domain; the engine falls back
    silently anyway, but the shadow should not claim a kernel the
    candidate config could never run."""
    kw = dict(recorded_kw)
    kw["policy"] = config.policy
    kw["assigner"] = config.assigner
    kw["normalizer"] = config.normalizer
    sp = config.score_plugins_tuple()
    if sp is None:
        kw.pop("score_plugins", None)
    else:
        kw["score_plugins"] = sp
    if "auction_rounds" in kw:
        kw["auction_rounds"] = config.auction_rounds
        kw["auction_price_frac"] = config.auction_price_frac
    kw["fused"] = bool(
        kw.get("fused")
        and sp is None
        and config.policy == "balanced_cpu_diskio"
        and config.normalizer in ("none", "min_max")
    )
    return kw


def _gang_admissions(gang_id, gang_size, idx) -> dict:
    """gang_id -> fully-admitted? over the window's real rows. A gang
    is admitted all-or-nothing (ops/gang.py), so 'every member bound'
    is the admission bit the shadow diffs."""
    out: dict = {}
    gid = np.asarray(gang_id).reshape(-1)[: len(idx)]
    gsz = np.asarray(gang_size).reshape(-1)[: len(idx)]
    for g in np.unique(gid):
        if g < 0:
            continue
        rows = gid == g
        if not int(np.asarray(gsz)[rows].max(initial=0)):
            continue
        out[int(g)] = bool((np.asarray(idx)[rows] >= 0).all())
    return out


class ShadowScheduler:
    """Tail a journal, re-score each cycle through a candidate config,
    export the decision/latency diff. Read-only by construction."""

    def __init__(
        self,
        journal_path: str,
        config,
        *,
        engine=None,
        mode: str = "serial",
        resume_seq: int | None = None,
        span_path: str | None = None,
        device=None,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown shadow mode {mode!r}; expected {MODES}")
        self.config = config
        self.mode = mode
        self.tailer = JournalTailer(journal_path, resume_seq=resume_seq)
        if engine is None:
            from kubernetes_scheduler_tpu_torch.engine import TorchEngine

            engine = TorchEngine(device=device)
        self.engine = engine
        self.breaker = CircuitBreaker(
            "shadow-candidate",
            failure_threshold=config.breaker_failure_threshold,
            recovery_window_s=config.breaker_recovery_window_s,
        )
        self.spans = (
            SpanRecorder(span_path, process="shadow")
            if span_path is not None
            else None
        )
        self._server: HttpMetricsServer | None = None
        # reconstruction state: the previous device record's snapshot
        # (delta folding base) — None until the first full snapshot,
        # and again after a resume lands mid-chain
        self._prev_snapshot = None
        self._unanchored_skips = 0
        # latency accumulation for the ratio gauge
        self._recorded_engine_s = 0.0
        self._candidate_engine_s = 0.0
        self._score_delta_sum = 0.0
        self._score_delta_n = 0
        self._rot_seen = 0
        self._rec_seen = 0
        self.ctr_records = Counter(
            "shadow_records_applied_total",
            "Journal records the shadow tailer decoded and applied",
        )
        self.ctr_cycles = Counter(
            "shadow_cycles_total",
            "Shadow re-score outcomes (scored / skipped / unanchored / "
            "breaker_open / error)",
            labels=("result",),
        )
        self.ctr_bindings_changed = Counter(
            "shadow_bindings_changed_total",
            "Window rows the candidate placed differently than the primary",
        )
        self.ctr_pods_compared = Counter(
            "shadow_pods_compared_total",
            "Window rows diffed between candidate and primary decisions",
        )
        self.ctr_gangs_diverged = Counter(
            "shadow_gangs_diverged_total",
            "Gangs whose all-or-nothing admission diverged from the primary",
        )
        self.ctr_candidate_errors = Counter(
            "shadow_candidate_errors_total",
            "Candidate dispatches that raised (counted into the breaker)",
        )
        self.ctr_breaker_skips = Counter(
            "shadow_breaker_skips_total",
            "Cycles not re-scored because the candidate breaker was open",
        )
        self.ctr_rotations = Counter(
            "shadow_rotations_followed_total",
            "Journal rotation boundaries the tailer crossed live",
        )
        self.ctr_tail_recoveries = Counter(
            "shadow_tail_recoveries_total",
            "Truncated-tail-then-grew recoveries while tailing",
        )
        self.g_divergence = Gauge(
            "shadow_divergence_ratio",
            "bindings_changed / pods_compared over the shadow's lifetime",
        )
        self.g_latency = Gauge(
            "shadow_latency_ratio",
            "Candidate engine seconds / recorded engine seconds (cumulative)",
        )
        self.g_score_delta = Gauge(
            "shadow_score_delta_mean",
            "Mean candidate-score gain over the primary's placement on "
            "rows the candidate moved",
        )
        self.g_lag = Gauge(
            "shadow_lag_seconds",
            "Wall-clock age of the last applied journal record",
        )
        self.h_step = Histogram(
            "shadow_candidate_step_duration_seconds",
            "Candidate engine dispatch wall time per shadow cycle",
        )
        self.collectors = (
            self.ctr_records, self.ctr_cycles, self.ctr_bindings_changed,
            self.ctr_pods_compared, self.ctr_gangs_diverged,
            self.ctr_candidate_errors, self.ctr_breaker_skips,
            self.ctr_rotations, self.ctr_tail_recoveries,
            self.g_divergence, self.g_latency, self.g_score_delta,
            self.g_lag, self.h_step,
        )
        self._resident_state: dict = {}

    # ---- exporter ----------------------------------------------------------

    def _render(self) -> str:
        lines: list[str] = []
        for c in self.collectors:
            lines.extend(c.render(prefix=PREFIX))
        return "\n".join(lines) + "\n"

    def serve(self, port: int, host: str = "127.0.0.1") -> int:
        self._server = HttpMetricsServer(self._render)
        return self._server.serve(port, host=host)

    # ---- candidate dispatch ------------------------------------------------

    def _candidate_result(self, snapshot, pods, kw, batch_window: int):
        """One candidate engine call -> (flat node_idx, [p, n] scores).
        Mirrors trace/replay's dispatch surface so the shadow exercises
        the same serial/pipelined paths the replayer pins."""
        if batch_window > 0:
            from kubernetes_scheduler_tpu_torch.engine import stack_windows

            windows = stack_windows(pods, batch_window)
            res = self.engine.schedule_windows(snapshot, windows, **kw)
        elif self.mode == "pipelined" and hasattr(
            self.engine, "schedule_batch_async"
        ):
            res = self.engine.schedule_batch_async(snapshot, pods, **kw).result()
        else:
            res = self.engine.schedule_batch(snapshot, pods, **kw)
        idx, scores = to_host(res.node_idx, res.scores)
        idx = idx.reshape(-1)
        scores = scores.reshape(-1, scores.shape[-1])
        return idx, scores

    # ---- record processing -------------------------------------------------

    def _fold(self, rec: dict):
        """Fold the record into the reconstruction; None for records
        that carry no snapshot (scalar cycles) or that cannot anchor
        (resume landed mid-chain — wait for the next full snapshot,
        which the recorder guarantees at every rotation boundary)."""
        from kubernetes_scheduler_tpu_torch.engine import (
            SnapshotArrays,
            SnapshotDelta,
            apply_snapshot_delta_np,
        )

        if "snapshot" in rec:
            snap = SnapshotArrays(**rec["snapshot"])
        elif "delta" in rec:
            if self._prev_snapshot is None:
                return None
            snap = apply_snapshot_delta_np(
                self._prev_snapshot, SnapshotDelta(**rec["delta"])
            )
        else:
            return None
        self._prev_snapshot = snap
        return snap

    def process_record(self, rec: dict) -> None:
        """Apply one journal record: fold state, re-score through the
        candidate (breaker permitting), account the diff. Never raises
        for a candidate failure — tailing must outlive the candidate."""
        t_cycle = time.perf_counter()
        self.ctr_records.inc()
        wall = rec.get("wall_time")
        if wall is not None:
            self.g_lag.set(max(0.0, time.time() - float(wall)))
        ss = self.spans.begin() if self.spans is not None else None
        unanchored = "delta" in rec and self._prev_snapshot is None
        snapshot = self._fold(rec)
        if ss is not None:
            ss.add("reconstruct", t_cycle, time.perf_counter())
        result = "scored"
        try:
            if (
                snapshot is None
                or "pods" not in rec
                or rec.get("path") not in ("device", "backlog")
            ):
                result = "unanchored" if unanchored else "skipped"
                if unanchored:
                    self._unanchored_skips += 1
            elif not self.breaker.allow():
                self.ctr_breaker_skips.inc()
                result = "breaker_open"
            else:
                self._score_cycle(rec, snapshot, ss)
        except TraceError:
            # malformed record content (e.g. a backlog record with no
            # batch_window): not a candidate fault, not breaker food
            log.exception("shadow: unusable record seq=%s", rec.get("seq"))
            result = "skipped"
        except Exception:
            log.exception(
                "shadow: candidate dispatch failed seq=%s", rec.get("seq")
            )
            self.ctr_candidate_errors.inc()
            self.breaker.record_failure()
            result = "error"
        self.ctr_cycles.inc(result=result)
        if ss is not None:
            ss.add(
                "cycle", t_cycle, time.perf_counter(),
                path=rec.get("path", "scalar"), result=result,
            )
            self.spans.flush(ss, seq=rec.get("seq"))

    def _score_cycle(self, rec: dict, snapshot, ss) -> None:
        recorded_idx = np.asarray(
            (rec.get("assign") or {}).get("node_idx", np.zeros(0, np.int32))
        ).reshape(-1)
        pods = pod_batch_from_record(rec["pods"])
        kw = candidate_kw(engine_kw_from_record(rec), self.config)
        bw = 0
        if rec["path"] == "backlog":
            bw = int(rec.get("batch_window") or 0)
            if bw <= 0:
                raise TraceError(
                    f"backlog record seq={rec.get('seq')} lacks batch_window"
                )
        t_eng = time.perf_counter()
        idx, scores = self._candidate_result(snapshot, pods, kw, bw)
        cand_s = time.perf_counter() - t_eng
        self.breaker.record_success()
        self.h_step.observe(cand_s)
        if ss is not None:
            ss.add(
                "candidate_step", t_eng, time.perf_counter(),
                backlog=rec["path"] == "backlog",
            )
        t_diff = time.perf_counter()
        pod_keys = rec.get("pod_keys") or []
        n_real = len(pod_keys) if pod_keys else recorded_idx.shape[0]
        want = recorded_idx[:n_real]
        cand = idx[:n_real].astype(np.int32)
        n = min(want.shape[0], cand.shape[0])
        changed = int((want[:n] != cand[:n]).sum()) + abs(
            want.shape[0] - cand.shape[0]
        )
        self.ctr_pods_compared.inc(n_real)
        if changed:
            self.ctr_bindings_changed.inc(changed)
        # candidate's own scoring margin on the rows it moved: how much
        # better the candidate believes its placement is than what the
        # primary did (its normalized score units — a decision-quality
        # signal, not a latency one)
        moved = np.flatnonzero(want[:n] != cand[:n])
        for i in moved:
            ci, wi = int(cand[i]), int(want[i])
            if 0 <= ci < scores.shape[1] and 0 <= wi < scores.shape[1]:
                self._score_delta_sum += float(
                    scores[i, ci] - scores[i, wi]
                )
                self._score_delta_n += 1
        if self._score_delta_n:
            self.g_score_delta.set(
                self._score_delta_sum / self._score_delta_n
            )
        gangs_rec = _gang_admissions(
            pods.gang_id, pods.gang_size, want[:n]
        )
        gangs_cand = _gang_admissions(
            pods.gang_id, pods.gang_size, cand[:n]
        )
        diverged = sum(
            1
            for g in set(gangs_rec) | set(gangs_cand)
            if gangs_rec.get(g) != gangs_cand.get(g)
        )
        if diverged:
            self.ctr_gangs_diverged.inc(diverged)
        compared = self.ctr_pods_compared.value()
        if compared:
            self.g_divergence.set(
                self.ctr_bindings_changed.value() / compared
            )
        rec_s = float((rec.get("metrics") or {}).get("engine_seconds", 0.0))
        self._recorded_engine_s += rec_s
        self._candidate_engine_s += cand_s
        if self._recorded_engine_s > 0:
            self.g_latency.set(
                self._candidate_engine_s / self._recorded_engine_s
            )
        if ss is not None:
            ss.add(
                "decision_diff", t_diff, time.perf_counter(),
                changed=changed, gangs_diverged=diverged,
            )

    # ---- loop --------------------------------------------------------------

    def _sync_tail_counters(self) -> None:
        t = self.tailer
        if t.rotations_followed > self._rot_seen:
            self.ctr_rotations.inc(t.rotations_followed - self._rot_seen)
            self._rot_seen = t.rotations_followed
        if t.truncations_recovered > self._rec_seen:
            self.ctr_tail_recoveries.inc(
                t.truncations_recovered - self._rec_seen
            )
            self._rec_seen = t.truncations_recovered

    def catch_up(self, *, limit: int | None = None) -> int:
        """Drain every record currently readable; returns the count."""
        done = 0
        while True:
            budget = None if limit is None else limit - done
            if budget is not None and budget <= 0:
                return done
            recs = self.tailer.poll(max_records=budget or 256)
            if not recs:
                self._sync_tail_counters()
                return done
            for rec in recs:
                self.process_record(rec)
            done += len(recs)
            self._sync_tail_counters()

    def run(
        self,
        *,
        follow: bool = False,
        poll_interval_s: float = 0.25,
        idle_timeout_s: float | None = None,
        limit: int | None = None,
        sleep=time.sleep,
    ) -> dict:
        """Tail until caught up (follow=False), or until the journal
        goes idle for idle_timeout_s (follow=True). Returns summary()."""
        applied = 0
        idle_since = time.monotonic()
        while True:
            got = self.catch_up(
                limit=None if limit is None else limit - applied
            )
            applied += got
            if limit is not None and applied >= limit:
                break
            if got:
                idle_since = time.monotonic()
                continue
            if not follow:
                break
            if (
                idle_timeout_s is not None
                and time.monotonic() - idle_since >= idle_timeout_s
            ):
                break
            sleep(poll_interval_s)
        return self.summary()

    def summary(self) -> dict:
        compared = int(self.ctr_pods_compared.value())
        changed = int(self.ctr_bindings_changed.value())
        return {
            "records_applied": int(self.ctr_records.value()),
            "cycles": {
                ("".join(k)): int(v)
                for k, v in self.ctr_cycles.breakdown().items()
            },
            "pods_compared": compared,
            "bindings_changed": changed,
            "divergence_ratio": (changed / compared) if compared else 0.0,
            "gangs_diverged": int(self.ctr_gangs_diverged.value()),
            "score_delta_mean": (
                self._score_delta_sum / self._score_delta_n
                if self._score_delta_n
                else 0.0
            ),
            "candidate_errors": int(self.ctr_candidate_errors.value()),
            "breaker_skips": int(self.ctr_breaker_skips.value()),
            "breaker_state": self.breaker.state(),
            "unanchored_skips": self._unanchored_skips,
            "recorded_engine_seconds": round(self._recorded_engine_s, 6),
            "candidate_engine_seconds": round(self._candidate_engine_s, 6),
            "latency_ratio": (
                self._candidate_engine_s / self._recorded_engine_s
                if self._recorded_engine_s > 0
                else 0.0
            ),
            "tail": self.tailer.stats(),
        }

    def close(self) -> None:
        if self.spans is not None:
            self.spans.close()
        if self._server is not None:
            self._server.close()
            self._server = None
