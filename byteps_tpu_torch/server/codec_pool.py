"""Worker-side codec pipeline engine.

Counterpart of ``byteps_tpu/server/codec_pool.py`` (a copy: the port
imports nothing of the JAX package).  Its jobs are host work on numpy
arrays (the wire codec); its metrics go to the port's telemetry registry
and its non-finite events to the port's flight recorder.

The reference runs COMPRESS and DECOMPRESS as dedicated pipeline loop
threads, so codec work overlaps wire transfer instead of serializing on
the caller or receiver threads (reference: core_loops.cc COMPRESS /
DECOMPRESS stages of the 13-loop state machine).  This is the host
analog: a small priority thread pool shared by both directions.

  - ENCODE jobs are drained in (priority desc, key asc) order — the same
    control law as the dispatcher's ScheduledQueue
    (scheduled_queue.cc:26-46) — so the encoder works *ahead of* the
    dispatcher: while partition k's bytes are on the wire, partition k+1
    is being compressed.
  - DECODE jobs carry the partition's scheduling priority too, so a
    high-priority tensor's pull leg is decoded before a backlog of
    low-priority ones.

Jobs are plain callables and must do their own error containment (the
session's jobs resolve the partition's handle with the exception); the
pool's catch-all only guards against a job that leaks — a dead codec
thread would silently wedge every waiter behind it.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, List

from ..common.logging import get_logger


class CompressionPool:
    """Priority thread pool for wire encode/decode jobs.

    `threads == 0` is the inline fallback: callers must not construct a
    pool at all (the session keeps the pre-pipeline inline paths); this
    class always owns at least one thread.
    """

    # Canonical stats schema — the single source for the all-zero shape
    # returned by PSSession.codec_stats / bps.get_codec_stats when no
    # pool exists, so the three surfaces can never drift apart.
    ZERO_STATS = {"threads": 0, "pending": 0, "encoded_parts": 0,
                  "decoded_parts": 0, "encode_busy_us": 0,
                  "decode_busy_us": 0}

    def __init__(self, threads: int, name: str = "bps-ps-codec"):
        if threads < 1:
            raise ValueError("CompressionPool needs >= 1 thread; "
                             "use threads=0 at the session level for the "
                             "inline fallback")
        self._cv = threading.Condition()
        self._heap: list = []    # (-priority, key, seq, job)
        self._seq = 0            # FIFO tiebreak for equal (priority, key)
        self._closed = False
        # Telemetry counters (read via stats(); exposed through
        # bps.get_codec_stats).
        self._counts = {"ENCODE": 0, "DECODE": 0}
        self._busy_us = {"ENCODE": 0, "DECODE": 0}
        # Registry histograms for per-job codec latency (the busy-time
        # counters above only expose totals; operators alerting on a codec
        # regression need the distribution).  Resolved once; observe() is
        # lock-free.
        from ..common import telemetry as _tm
        reg = _tm.get_registry()
        self._m_lat = {
            "ENCODE": reg.histogram(
                "bps_codec_encode_seconds",
                help="per-partition wire-compressor encode latency"),
            "DECODE": reg.histogram(
                "bps_codec_decode_seconds",
                help="per-partition wire-compressor decode latency"),
        }
        self.num_threads = threads
        self._name = name
        self._spawned = threads   # lifetime thread counter (names only)
        self._retire = 0         # threads asked to exit at their next pick
        self._threads: List[threading.Thread] = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"{name}-{i}")
            for i in range(threads)]
        for t in self._threads:
            t.start()

    def resize(self, threads: int) -> int:
        """Grow/shrink the pool to `threads` workers WITHOUT dropping
        staged work — the COMPRESS_THREADS knob's actuation point.

        Growing starts fresh threads immediately.  Shrinking marks the
        surplus for retirement: each retiring thread exits at its next
        queue pick, never mid-job, and queued jobs stay in the heap for
        the survivors — so a switch can never lose an encode (whose
        partition's ready event the dispatcher waits on) or a decode
        (whose handle nothing else would resolve).  Clamped to >= 1: the
        pool always owns a thread (0 <-> N is a launch-only transition,
        documented in docs/performance.md "Knob plane").  Returns the
        applied size."""
        threads = max(1, int(threads))
        with self._cv:
            if self._closed:
                return self.num_threads
            # Outstanding retirements still count against the live total:
            # resize(1) -> resize(4) on a pool that hasn't drained its
            # retiring threads yet must only top up the difference.
            live = len([t for t in self._threads if t.is_alive()]) \
                - self._retire
            if threads > live:
                for _ in range(threads - live):
                    t = threading.Thread(
                        target=self._loop, daemon=True,
                        name=f"{self._name}-{self._spawned}")
                    self._spawned += 1
                    self._threads.append(t)
                    t.start()
            elif threads < live:
                self._retire += live - threads
                self._cv.notify_all()
            self.num_threads = threads
        return threads

    def submit(self, priority: int, key: int, job: Callable[[], None]) -> None:
        """Queue `job`; higher priority first, then ascending key, then
        submission order."""
        with self._cv:
            if self._closed:
                raise RuntimeError("CompressionPool closed")
            self._seq += 1
            heapq.heappush(self._heap, (-priority, key, self._seq, job))
            self._cv.notify()

    def record(self, stage: str, dur_us: int) -> None:
        """Count one finished codec job.  Only pool-owning sessions count
        anything: with compress_threads=0 there is no pool and codec_stats
        stays all-zero — zeros mean "nothing measured", not "no codec
        work" (inline mode does its codec work uncounted on the
        caller/receiver threads).  The receiver-thread fallback decode
        during shutdown is the one non-pool-thread path that records."""
        m = self._m_lat.get(stage)
        if m is not None:
            m.observe(max(0, int(dur_us)) / 1e6)
        with self._cv:
            self._counts[stage] = self._counts.get(stage, 0) + 1
            self._busy_us[stage] = self._busy_us.get(stage, 0) + max(
                0, int(dur_us))

    def stats(self) -> dict:
        with self._cv:
            s = dict(self.ZERO_STATS)
            s.update(
                threads=self.num_threads,
                pending=len(self._heap),
                encoded_parts=self._counts.get("ENCODE", 0),
                decoded_parts=self._counts.get("DECODE", 0),
                encode_busy_us=self._busy_us.get("ENCODE", 0),
                decode_busy_us=self._busy_us.get("DECODE", 0),
            )
            return s

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._heap and not self._closed
                       and not self._retire):
                    self._cv.wait()
                if self._retire:
                    # A resize() shrink claimed this thread: exit between
                    # jobs.  Queued work stays in the heap for the
                    # survivors — nothing staged is ever dropped.
                    self._retire -= 1
                    try:
                        self._threads.remove(threading.current_thread())
                    except ValueError:
                        pass
                    return
                if not self._heap:          # closed and drained
                    return
                _, _, _, job = heapq.heappop(self._heap)
            try:
                job()
            except Exception:   # pragma: no cover - jobs contain their own
                get_logger().exception("codec pipeline job failed")

    def close(self) -> None:
        """Drain queued jobs, then stop the threads.

        Draining (not dropping) matters: queued DECODE jobs hold pull
        payloads whose handles nothing else will ever resolve, and queued
        ENCODE jobs must still set their partition's ready event or the
        dispatcher would wait on it forever during shutdown.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in list(self._threads):
            t.join(timeout=10)


class HealthMonitor:
    """Gradient value-health sampler (``BYTEPS_TPU_HEALTH_SAMPLE_ROUNDS``
    > 0; docs/monitoring.md "Auditing & postmortem").

    The time-domain planes (metrics/traces) say nothing about the
    VALUES riding the wire: an fp16 overflow turning a codec's output
    into a NaN storm, or an error-feedback residual growing without
    bound, is invisible until the loss curve goes sideways hours later.
    This monitor samples every Nth round per key on the push path (the
    staged gradient, before the wire) and the pull path (the landed
    sum), exporting ``bps_grad_*`` gauges through the telemetry registry and
    firing a structured ERROR — key, round, worker, membership/ring
    epoch — the moment a non-finite value appears.

    The sampling pass is O(n) numpy over the staged buffer; push-side
    samples run on the codec pool when the session has one, so the
    caller thread never pays it.  ``sample_rounds`` gates the cadence —
    with the knob at 0 the session never constructs a monitor and the
    hot path carries zero new work.
    """

    def __init__(self, sample_rounds: int, context=None):
        import numpy as _np  # noqa: F401  (fail construction early)
        self.sample_rounds = max(1, int(sample_rounds))
        self._context = context          # () -> {"worker", "ring_epoch"}
        self._lock = threading.Lock()
        self._snap: dict = {}            # label -> last sample record
        self.nonfinite_total = 0
        from ..common import telemetry as _tm
        self._reg = _tm.get_registry()
        self._m_nonfinite = self._reg.counter(
            "bps_grad_nonfinite_total",
            help="sampled tensors containing NaN/Inf values")

    def _ctx(self) -> dict:
        try:
            return dict(self._context()) if self._context else {}
        except Exception:
            return {}

    def sample_push(self, label: str, arr, rnd: int,
                    pool: "CompressionPool" = None, comp=None) -> bool:
        """Maybe-sample one staged (push-side) tensor; returns True when
        round ``rnd`` (the key's actual sync round — so push and pull
        samples land on the same rounds and survive a failover rebase)
        was due.  The numpy pass runs on ``pool`` when given, over a
        SNAPSHOT of the buffer: the caller's zero-copy no-mutate
        contract ends when the handle resolves, which does not wait for
        a deferred observer job — sampling the live buffer late would
        attribute round N+1's values (and NaNs) to round N."""
        if rnd % self.sample_rounds:
            return False
        if pool is not None:
            import numpy as np
            snap = np.array(arr, copy=True)
            try:
                pool.submit(0, 0, lambda: self._compute(
                    label, snap, "push", rnd, comp))
                return True
            except RuntimeError:
                pass                     # pool closing: sample inline
        self._compute(label, arr, "push", rnd, comp)
        return True

    def pull_due(self, rnd: int) -> bool:
        """True when round ``rnd`` is a sampled round — the session uses
        this when it issues the pull to skip the zero-copy sink for sampled
        rounds, so the check below runs on a codec-pool thread over the
        pooled buffer instead of stalling the receiver thread."""
        return rnd % self.sample_rounds == 0

    def check_pull(self, part_label: str, rnd: int, arr,
                   worker: int = 0) -> None:
        """Maybe-check one landed (pull-side) partition for non-finite
        values — the sum a NaN storm on ANY worker poisons.  Gated by
        the round id so every worker samples the same rounds."""
        if not self.pull_due(rnd):
            return
        import numpy as np
        a = np.asarray(arr)
        nonfinite = int(a.size - np.isfinite(a).sum())
        if nonfinite:
            label = part_label.rsplit(".part", 1)[0]
            self._flag_nonfinite(label, "pull", rnd, nonfinite, a.size)

    # -- internals ----------------------------------------------------------
    def _compute(self, label: str, arr, direction: str, rnd: int,
                 comp=None) -> None:
        import numpy as np
        try:
            a = np.asarray(arr, dtype=np.float32).ravel()
            finite_mask = np.isfinite(a)
            n_bad = int(a.size - finite_mask.sum())
            vals = a if n_bad == 0 else a[finite_mask]
            norm = float(np.sqrt(float(np.dot(vals, vals)))) \
                if vals.size else 0.0
            absmax = float(np.max(np.abs(vals))) if vals.size else 0.0
            ef = None
            if comp is not None and hasattr(comp, "ef_residual_norm"):
                ef = float(comp.ef_residual_norm())
            rec = {"direction": direction, "round": int(rnd),
                   "norm": norm, "absmax": absmax, "nonfinite": n_bad,
                   "size": int(a.size), "ts": time.time()}
            lbl = {"key": label}
            self._reg.gauge(
                "bps_grad_norm", labels=lbl,
                help="l2 norm of the last sampled gradient "
                     "(finite values)").set(norm)
            self._reg.gauge(
                "bps_grad_absmax", labels=lbl,
                help="largest |value| in the last sampled gradient "
                     "(finite values)").set(absmax)
            self._reg.gauge(
                "bps_grad_nonfinite", labels=lbl,
                help="NaN/Inf count in the last sampled gradient"
                ).set(n_bad)
            if ef is not None:
                rec["ef_residual_norm"] = ef
                self._reg.gauge(
                    "bps_grad_ef_residual_norm", labels=lbl,
                    help="l2 norm of the worker-side error-feedback "
                         "residual carried for this key").set(ef)
            with self._lock:
                self._snap[label] = rec
            if n_bad:
                self._flag_nonfinite(label, direction, rnd, n_bad,
                                     int(a.size))
        except Exception:
            get_logger().exception("gradient-health sample failed")

    def _flag_nonfinite(self, label: str, direction: str, rnd: int,
                        n_bad: int, size: int) -> None:
        ctx = self._ctx()
        with self._lock:
            self.nonfinite_total += 1
            rec = self._snap.setdefault(label, {})
            rec["nonfinite"] = n_bad
            rec["nonfinite_round"] = int(rnd)
        self._m_nonfinite.inc()
        get_logger().error(
            "GRADIENT HEALTH: non-finite values in %s tensor %r round %d "
            "(%d of %d elements NaN/Inf; worker %s, membership epoch %s, "
            "ring epoch %s) — overflowing codec, fp16 blowup, or a "
            "poisoned sum from a peer; see docs/troubleshooting.md "
            "\"My loss diverged\"",
            direction, label, rnd, n_bad, size,
            ctx.get("worker", "?"), ctx.get("epoch", "?"),
            ctx.get("ring_epoch", "?"))
        from ..common import flightrec as _fr
        _fr.record("nonfinite", key=label, direction=direction,
                   round=int(rnd), count=n_bad, size=size, **ctx)

    def snapshot(self) -> dict:
        """Last sample per key + the running non-finite total — the
        ``bps.get_health()`` payload."""
        with self._lock:
            return {"sample_rounds": self.sample_rounds,
                    "nonfinite_total": self.nonfinite_total,
                    "keys": {k: dict(v) for k, v in self._snap.items()}}
