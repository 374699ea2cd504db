"""BackgroundTune: tuning under live traffic, off the request path.

The port of ``repro.core.bgtune``. The :class:`BackgroundTune` policy
answers a resolution miss with the heuristic config at once (tier
``"bgtune"``, uncached) and hands the bucket to a :class:`BackgroundTuner`,
a bounded-queue worker thread that runs the autotune loop and puts the
winning record into the live database under the request's own key. Since a
bgtune resolution is never cached, the next resolve of that bucket
consults :class:`~.runtime.ExactHit` first and takes the record the moment
it lands.

Failure is a steady state, as in the dispatch guard:

* the queue is bounded: a full queue *sheds* the offer (counted) and
  releases its key, so a later resolve offers it again;
* the worker retries a job with backoff, and a job that exhausts its
  attempts is parked (``bgtune.job_failed`` warned once, counted);
* a worker *crash* (anything escaping the per-job ``except Exception``,
  such as the fault plane's ``InjectedWorkerCrash``) ends the worker loop:
  ``accepting`` turns False, the policy steps aside, and resolution falls
  through to the heuristic. Resolve never blocks on the tuner.

Each attempt is the fault site ``bgtune.worker:<kernel>``. With
``export_path`` set, every promotion rewrites a standalone database of the
promoted records through the database's atomic write.

Obs: ``bgtune.queue_depth`` gauge, ``bgtune.promotions`` counter,
``bgtune.promote_latency_s`` histogram (offer to record live),
``bgtune.shed`` and ``bgtune.failures`` counters, and the warnings
``bgtune.worker_dead`` and ``bgtune.job_failed``. The worker thread starts
with a fresh context, so the collector active at offer time travels with
the job and is entered around its execution.

Differences from ``repro.core.bgtune``, on purpose:

* the worker materializes a job's tensors with the campaign's
  :func:`~repro_torch.campaign.runner.materialize_args` and times the
  variants with the call's keyword arguments read back from the key extra
  (:func:`~repro_torch.campaign.runner.call_kwargs`, ``act=``,
  ``causal=``, ``window=``), as the port's campaign does, so a promoted
  record measures what the live call runs; the JAX worker times the
  positional arguments alone;
* ``device`` is a torch device (default: the device of the request's
  tensors), and the worker launches on a CUDA stream of its own
  (``tuner.stream``, made at its first job on the card). One card has no
  spare accelerator: the worker's kernels run beside the serving engine's and its Python shares the GIL, so
  its trials are timed under load and serving slows while it runs;
* :meth:`BackgroundTuner.drain` reads the worker's death and the in-flight
  count together, under the lock the worker sets them under, so a worker
  that dies holding a job is never reported as drained (the JAX worker
  records the death before its in-flight count falls, and its ``drain``
  tests for idle first).
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional, Tuple

import torch

from ..obs.collect import ObsCollector, current_collector as _obs_collector
from ..testing.faults import fault_point as _fault_point
from .database import Record, TuningDatabase, now, split_key
from .runtime import (
    CoverSet,
    ExactHit,
    Heuristic,
    Reference,
    Resolution,
    ResolutionPolicy,
    ResolutionRequest,
    TunedRuntime,
    _as_tunable,
)
from .tuner import dtype_name, first_device


@dataclasses.dataclass
class _BgJob:
    """One queued tuning task, self-contained for the worker thread."""

    kernel: str
    key: str
    key_extra: str
    arg_shapes: Tuple[Tuple[int, ...], ...]
    arg_dtypes: Tuple[str, ...]
    db: TuningDatabase
    device: torch.device
    collector: ObsCollector
    enqueued: float                    # monotonic stamp (promote latency)


class BackgroundTuner:
    """Bounded async tuner: a worker thread promoting records off the
    request path.

    ``budget`` is a job's search budget (coordinate descent unless
    ``search_factory(job)`` gives a search). ``device`` is where the
    worker materializes and times a job (default: the request's device);
    ``stream`` is the CUDA stream it launches on there, its own, made at
    its first job on the card. ``max_attempts``/``backoff_s``
    bound a job's retries, ``max_queue`` the queue. ``export_path`` keeps a
    standalone database of the promoted records current on disk.

    The worker starts at the first :meth:`offer`; :meth:`drain` waits for
    the queue to empty; :meth:`stop` ends the worker. ``accepting`` is
    False once the worker died or was stopped.
    """

    def __init__(
        self,
        budget: int = 16,
        evaluator: Optional[Any] = None,
        search_factory: Optional[Callable[[_BgJob], Any]] = None,
        max_queue: int = 64,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        export_path: Optional[str] = None,
        device: Optional[Any] = None,
        arg_seed: int = 0,
        name: str = "bgtune",
    ):
        self.budget = int(budget)
        self.evaluator = evaluator
        self.search_factory = search_factory
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.export_path = export_path
        self.device = torch.device(device) if device is not None else None
        self.stream: Optional[Any] = None
        self.arg_seed = int(arg_seed)
        self.name = name
        self._q: "queue.Queue[_BgJob]" = queue.Queue(maxsize=max(1, int(max_queue)))
        self._lock = threading.Lock()
        self._seen: set = set()        # keys queued, running, or finished
        self._inflight = 0             # queued + running jobs
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._death: Optional[str] = None
        self._promoted: list = []      # Records, in promotion order
        self.promotions = 0
        self.failures = 0
        self.shed = 0

    # -- lifecycle -----------------------------------------------------------
    @property
    def accepting(self) -> bool:
        """Whether offers will be worked: not stopped, the worker not dead.
        True before the first start."""
        if self._stopped.is_set() or self._death is not None:
            return False
        t = self._thread
        return t is None or t.is_alive()

    @property
    def stopped(self) -> bool:
        """Whether :meth:`stop` was called."""
        return self._stopped.is_set()

    def _ensure_started(self) -> None:
        if self._thread is not None:
            return
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=f"repro_torch-{self.name}", daemon=True)
                self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stopped.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every offered job has finished. True when the queue
        drained within ``timeout``; False on a timeout, or as soon as the
        worker is dead or stopped, even if it died on its last job."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                # read together: the worker records its death and drops its
                # in-flight count in one step under this lock
                dead, idle = self._death is not None, self._inflight == 0
            if dead or self._stopped.is_set():
                return False
            if idle:
                return True
            t = self._thread
            if t is not None and not t.is_alive():
                return False
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    # -- intake ---------------------------------------------------------------
    def offer(self, req: ResolutionRequest) -> bool:
        """Queue one bucket for tuning (once a key). Never blocks: a full
        queue sheds the offer and releases the key. False only when the
        tuner no longer accepts."""
        if not self.accepting:
            return False
        key = req.key
        with self._lock:
            if key in self._seen:
                return True
            self._seen.add(key)
        col = _obs_collector()
        job = _BgJob(
            kernel=req.tunable.name,
            key=key,
            key_extra=req.key_extra,
            # the key's shapes are bucketed already: materializing at these
            # shapes derives this key again, so the record is an exact hit
            arg_shapes=split_key(key)[2],
            arg_dtypes=tuple(dtype_name(a.dtype) for a in req.args
                             if isinstance(a, torch.Tensor)),
            db=req.db,
            device=self.device or first_device(req.args) or torch.device("cpu"),
            collector=col,
            enqueued=time.monotonic(),
        )
        try:
            self._q.put_nowait(job)
        except queue.Full:
            with self._lock:
                self._seen.discard(key)
                self.shed += 1
            if col.enabled:
                col.counter("bgtune.shed", kernel=job.kernel)
            return True
        with self._lock:
            self._inflight += 1
        if col.enabled:
            col.gauge("bgtune.queue_depth", float(self._q.qsize()))
        self._ensure_started()
        return True

    # -- worker ---------------------------------------------------------------
    def _stream_for(self, device: torch.device):
        """The worker's CUDA stream on ``device`` (made at its first job
        there), or no stream scope off the card."""
        if device.type != "cuda":
            return contextlib.nullcontext()
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=device)
        return torch.cuda.stream(self.stream)

    def _run(self) -> None:
        while not self._stopped.is_set():
            try:
                job = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                with job.collector, self._stream_for(job.device):
                    self._run_job(job)
            except BaseException as e:  # noqa: BLE001 — crash isolation
                # Anything past the per-job retries (an injected crash, a
                # MemoryError) ends this worker only. The death is recorded
                # in the same step as the in-flight count falls, so
                # `accepting` flips and drain() reports it.
                with self._lock:
                    self._death = f"{type(e).__name__}: {e}"
                    self._inflight -= 1
                job.collector.warn_once("bgtune.worker_dead", key=self.name,
                                        kernel=job.kernel, error=self._death)
                return
            with self._lock:
                self._inflight -= 1

    def _run_job(self, job: _BgJob) -> None:
        col = job.collector
        last: Optional[Exception] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                _fault_point(f"bgtune.worker:{job.kernel}", attempt=attempt)
                self._tune_one(job)
            except Exception as e:
                last = e
                time.sleep(self.backoff_s * attempt)
                continue
            latency = time.monotonic() - job.enqueued
            with self._lock:
                self.promotions += 1
            if col.enabled:
                col.counter("bgtune.promotions", kernel=job.kernel)
                col.observe("bgtune.promote_latency_s", latency, kernel=job.kernel)
                col.gauge("bgtune.queue_depth", float(self._q.qsize()))
            self._export_delta()
            return
        # Attempts spent: park the key (it stays claimed, so the bucket keeps
        # the heuristic config without queueing a job that cannot succeed).
        with self._lock:
            self.failures += 1
        if col.enabled:
            col.counter("bgtune.failures", kernel=job.kernel)
        col.warn_once("bgtune.job_failed", key=job.key, kernel=job.kernel,
                      attempts=self.max_attempts,
                      error=f"{type(last).__name__}: {last}" if last else "unknown")

    def _tune_one(self, job: _BgJob) -> None:
        # upward imports are lazy: the campaign layer imports core
        from ..campaign.planner import TuningJob
        from ..campaign.runner import call_kwargs, materialize_args
        from .search import CoordinateDescent
        from .tuner import autotune

        tunable = _as_tunable(job.kernel)
        tjob = TuningJob(kernel=job.kernel, arg_shapes=job.arg_shapes,
                         arg_dtypes=job.arg_dtypes, key_extra=job.key_extra)
        args = materialize_args(tjob, seed=self.arg_seed, device=job.device)
        search = (self.search_factory(job) if self.search_factory
                  else CoordinateDescent(budget=self.budget))
        # a scoped runtime, as the campaign runner's: nested dispatches in a
        # variant or the reference resolve against the job's database, never
        # the serving scope (the worker's context starts at the root)
        with TunedRuntime(db=job.db, name=f"{self.name}-worker"):
            res = autotune(tunable, args, search=search, evaluator=self.evaluator,
                           db=job.db, key_extra=job.key_extra, save=False,
                           platform=split_key(job.key)[1], call_kwargs=call_kwargs(tjob))
        del args
        rec = Record(
            key=job.key,
            config=dict(res.best_config),
            objective=res.best_objective,
            evaluator=(getattr(self.evaluator, "name", type(self.evaluator).__name__)
                       if self.evaluator is not None else "wallclock"),
            evaluations=res.evaluations,
            timestamp=now(),
            meta={"source": "bgtune", "default_objective": res.default_objective},
        )
        # the hot swap: db.put is locked, and atomic on disk for a file db
        job.db.put(rec)
        with self._lock:
            self._promoted.append(rec)

    def _export_delta(self) -> None:
        """Rewrite the standalone database of the promoted records."""
        if not self.export_path:
            return
        with self._lock:
            recs = list(self._promoted)
        delta = TuningDatabase(None)
        for r in recs:
            delta.put(r, save=False)
        delta.path = self.export_path
        delta.save()

    @property
    def promoted(self) -> list:
        """The promoted records, in promotion order."""
        with self._lock:
            return list(self._promoted)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "accepting": self.accepting,
                "queue_depth": self._q.qsize(),
                "inflight": self._inflight,
                "promotions": self.promotions,
                "failures": self.failures,
                "shed": self.shed,
                "death": self._death,
            }

    def __repr__(self) -> str:
        return (f"<BackgroundTuner {self.name} accepting={self.accepting} "
                f"promotions={self.promotions} failures={self.failures}>")


class BackgroundTune(ResolutionPolicy):
    """Resolution tier: the heuristic config now, tuning in the background.

    Sits between ExactHit and CoverSet in :func:`background_policy`: a cover
    hit would cache a transferred config, while this tier keeps the bucket
    uncached until the worker promotes a measured exact record. Returns
    None (passing the bucket on) once the tuner stops accepting.
    """

    name = "bgtune"

    def __init__(self, tuner: BackgroundTuner):
        self.tuner = tuner

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        if not self.tuner.offer(req):
            return None
        # cache=False is the hot-swap hook: ExactHit wins the first resolve
        # after the record lands
        return Resolution(req.tunable.default_config(*req.args), self.name, cache=False)


def background_policy(tuner: BackgroundTuner) -> Tuple[ResolutionPolicy, ...]:
    """``(ExactHit, BackgroundTune, CoverSet, Heuristic, Reference)``: no
    TuneNow, since nothing tunes on the request path; CoverSet and
    Heuristic end the chain once the tuner steps aside."""
    return (ExactHit(), BackgroundTune(tuner), CoverSet(), Heuristic(), Reference())
