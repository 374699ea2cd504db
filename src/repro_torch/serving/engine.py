"""Continuous-batching serving engine: slot pool, in-flight admission,
per-slot completion. The port of ``repro.serving.engine.ServingEngine``.

The engine owns ``max_batch`` slots: batch rows of one cache allocated once
at ``max_seq`` on the parameters' device, plus host-side state per slot
(the request, its absolute position, its sampling RNG, its tokens). The
serve loop:

    admit   — while a slot is free and a request has arrived, right-pad its
              prompt to a power-of-two bucket (an arch with a Mamba mixer
              prefills at the exact prompt length: its state integrates
              every token, pads included), prefill it at batch 1 and copy
              the fresh cache over the slot's whole region;
    decode  — one step over the whole pool per tick, with a position per
              slot; empty slots decode a dummy token that is never read;
    retire  — a slot whose request reached its ``max_new_tokens`` is freed
              and the next arrival is admitted while the others decode.

Sampling is on the host with ``np.random.default_rng(req.seed)``, exactly
as in the JAX engine, so seeded requests give the same tokens in both
packages. Any arrival pattern gives the same tokens as serving each
request alone, with one exception carried over from the JAX engine: an MoE
layer's expert capacity is shared by the rows of a batch. A bucketed
prefill passes ``true_len``, so its pads take no capacity; decode passes no
mask, so the pool's free slots route and take capacity too (8 slots, top-2
of 8 experts: capacity 2 an expert). Tokens over capacity are dropped, and
for MoE the property holds only with capacity headroom.

``stats`` counts steps and tokens as the JAX engine does; ``timings``
holds each prefill's seconds by bucket and each decode step's seconds,
taken on the host clock around work that ends in a copy of the logits to
the host (which waits for the device).

Graceful degradation, as in the JAX engine: an exception that escapes a
prefill or a decode step (one the dispatch guard did not absorb: an
unguarded runtime, or a fault outside any dispatch site) marks the engine
``degraded`` and reruns that call, and every later one until
:meth:`ServingEngine.reset_degraded`, under a reference-mode runtime
inherited from the engine's scope. The rerun reads the same inputs: a
prefill builds a fresh cache that only a returned call inserts, and a
decode step rewrites its attention rows and commits the recurrent states
only once its logits are computed (``lm.decode_step``), so a request
completes with the tokens a fault-free reference engine gives it. What no
guard absorbs is not demoted either: a kernel that does not exist on this
host (``KernelUnavailable``) or a launch the card refused (``CudaError``)
raises out of :meth:`ServingEngine.serve` (``runtime.raises_through``).

Under an enabled :mod:`repro_torch.obs` collector the engine records the
``serve.admit`` and ``serve.admit.prefill`` spans, ``serve.admission_s``,
``serve.latency_s``, ``serve.per_token_s``, ``serve.requests``,
``serve.tokens``, ``serve.shed`` and ``serve.degraded``, and the tick
gauges ``serve.queue_depth``, ``serve.slots_active`` and
``serve.tokens_per_s``.

:meth:`ServingEngine.warmup` resolves every slot-pool bucket's kernel
configs up front, typically against a campaign's exported database.
:class:`LockStepEngine` is the JAX package's static batcher, kept as the
baseline the slot pool is measured against.

On a mesh (JAX's ``mesh`` and ``layout`` arguments, keyword and optional
here) each process is one rank of the tensor axis: it holds its pieces of
the parameters (``lm.rank_params``) and a cache pool of the kv heads its
attention computes, runs every prefill and decode step in the mesh's
context, and gets the whole vocabulary's logits back (``lm.prefill`` and
``lm.decode_step`` gather them). Every rank runs the same admission
schedule, which ticks count, not the host clock, and samples from the same
logits; rank 0 of the axis then broadcasts the tokens it sampled, and every
rank takes them, so a difference in a host's arithmetic can never split
the ranks. A mesh whose data axes hold more than one rank raises
``NotImplementedError`` (serving with a data axis is a later slice), as do
the archs ``tensor_parallel.check_supported`` refuses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.database import TuningDatabase, shape_bucket
from ..core.runtime import TunedRuntime, current_runtime, raises_through
from ..distributed import sharding as shd
from ..distributed import tensor_parallel as tp
from ..launch import steps
from ..models import lm
from ..models.transformer import RunConfig
from ..obs.collect import current_collector as _obs_collector
from ..obs.trace import span as _obs_span


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # [len] int32
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0
    arrival_time: float = 0.0       # engine ticks (decode steps); 0 = already here
    # filled by the engine:
    output: Optional[np.ndarray] = None
    latency_s: float = 0.0          # admission -> this request's last token (wall)
    latency_steps: int = 0
    queue_steps: int = 0
    admitted_step: int = -1
    finished_step: int = -1
    slot: int = -1
    shed: bool = False              # refused at submit: the queue was full
    shed_reason: str = ""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8              # slot-pool width
    max_seq: int = 256              # per-slot cache capacity (prefill + decode)
    min_prefill_bucket: int = 16    # smallest admission-prefill seq bucket
    max_queue: int = 0              # bounded admission queue (0 = unbounded)


def _sample_one(logits_row: np.ndarray, req: Request, rng) -> int:
    if req.temperature <= 0:
        return int(np.argmax(logits_row))
    z = logits_row / req.temperature
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


@dataclasses.dataclass
class _Slot:
    req: Request
    rng: Any
    cur: int                        # next token to feed
    pos: int                        # absolute position `cur` will occupy
    max_new: int
    emitted: List[int]
    t_admit: float


class _MeshRank:
    """A serving rank's mesh: its pieces of the parameters and the tensor
    axis over which rank 0 decides the sampled tokens."""

    def __init__(self, cfg: ArchConfig, params, mesh, layout):
        if layout is None:
            from ..launch.defaults import default_layout

            layout = default_layout(cfg)
        sizes = shd.mesh_axis_sizes(mesh)
        data = [a for a in sizes if a != layout.tensor_axis and sizes[a] > 1]
        if data:
            raise NotImplementedError(f"serving on mesh {sizes}: a data axis of more than one "
                                      "rank is a later slice; the engine runs the tensor axis")
        tp.check_supported(cfg, sizes, layout)
        self.mesh, self.layout = mesh, layout
        self.params = lm.rank_params(params, cfg, mesh, layout)
        with self.scope():
            self.axis = tp.model_axis()

    def scope(self):
        return shd.mesh_context(self.mesh, self.layout)

    def agree(self, tokens: List[int]) -> List[int]:
        """Rank 0's tokens, on every rank of the tensor axis."""
        if self.axis.size <= 1:
            return tokens
        import torch.distributed as dist

        from ..distributed.collectives import comm_device

        group = self.axis.group
        dev = comm_device(self.params["embed"]["table"].device, group)
        t = torch.tensor(tokens, dtype=torch.int64, device=dev)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t.tolist()


class ServingEngine:
    """Slot-pool continuous-batching engine (see module docstring).

    Runs on the device the parameters live on. ``runtime`` pins the
    dispatch scope (database, mode, telemetry) of every prefill and decode;
    ``mesh`` and ``layout`` make this process one rank of a tensor axis
    (the module docstring).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        run: RunConfig,
        params,
        ecfg: EngineConfig = EngineConfig(),
        clock: Callable[[], float] = time.perf_counter,
        runtime: Optional[TunedRuntime] = None,
        *,
        mesh=None,
        layout=None,
    ):
        if cfg.frontend is not None:
            raise NotImplementedError("the engine serves token-in/token-out archs")
        self.cfg, self.run, self.ecfg = cfg, run, ecfg
        self._mesh = _MeshRank(cfg, params, mesh, layout) if mesh is not None else None
        self.mesh = mesh
        self.layout = self._mesh.layout if self._mesh is not None else layout
        self.params = self._mesh.params if self._mesh is not None else params
        self.device = self.params["embed"]["table"].device
        self.clock = clock
        self.runtime = runtime
        self._has_ssm = any(spec.mixer != "attn" for seg in cfg.segments()
                            for spec in seg.pattern)
        self._caches = lm.init_cache(cfg, ecfg.max_batch, ecfg.max_seq, self.device,
                                     params=self.params)
        self._prefill = steps.make_prefill_step(cfg, run, cache_len=ecfg.max_seq)
        self._decode = steps.make_serve_step(cfg, run)
        self._slots: List[Optional[_Slot]] = [None] * ecfg.max_batch
        self.queue: List[Request] = []
        self._order = 0
        # sticky until reset_degraded(); the reference runtime is made at
        # the first fault
        self.degraded = False
        self._ref_rt: Optional[TunedRuntime] = None
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats: Dict[str, int] = {
            "decode_steps": 0,
            "prefill_calls": 0,
            "prefill_tokens": 0,      # prefill tokens, bucket padding included
            "slot_steps_active": 0,
            "slot_steps_idle": 0,
            "tokens_out": 0,
            "requests_shed": 0,
            "degraded_calls": 0,      # prefills and decode steps the fallback served
        }
        self.timings: Dict[str, Any] = {"prefill_s": {}, "decode_s": []}

    def _scope(self):
        stack = contextlib.ExitStack()
        if self.runtime is not None:
            stack.enter_context(self.runtime)
        if self._mesh is not None:
            stack.enter_context(self._mesh.scope())
        return stack

    def _agree(self, tokens: List[int]) -> List[int]:
        return tokens if self._mesh is None else self._mesh.agree(tokens)

    # --------------------------------------------------------- degraded path
    def reset_degraded(self) -> None:
        """Re-arm the kernel path after the fault was fixed."""
        self.degraded = False

    def _note_degraded(self, site: str, exc: Exception) -> None:
        self.degraded = True
        col = _obs_collector()
        if col.enabled:
            col.counter("serve.degraded", site=site)
        # fires with collection off too: a silently degraded engine is the hazard
        col.warn_once("serve.degraded", key=site, site=site,
                      error=f"{type(exc).__name__}: {exc}")

    def _ref_scope(self) -> TunedRuntime:
        """The fallback's reference-mode runtime, inheriting the engine
        runtime's database and platform."""
        if self._ref_rt is None:
            with self._scope():
                self._ref_rt = TunedRuntime(mode="reference", name="engine-degraded")
        return self._ref_rt

    def _run(self, site: str, fn):
        """``fn()`` under the engine's scope; on an exception there, and at
        every call once degraded, under the reference runtime."""
        if not self.degraded:
            try:
                with self._scope():
                    return fn()
            except Exception as e:      # a fault mid-admission or mid-tick: demote, complete
                if raises_through(e):   # no kernel here, a refused launch: never demoted
                    raise
                self._note_degraded(site, e)
        self.stats["degraded_calls"] += 1
        with self._scope(), self._ref_scope():
            return fn()

    def _run_prefill(self, toks: torch.Tensor, L: int):
        """(logits on the host as fp32 numpy, cache) of one admission."""
        def prefill():
            with _obs_span("serve.admit.prefill"), torch.inference_mode():
                logits, cache = self._prefill(self.params, {"tokens": toks}, true_len=L)
                return logits.float().cpu().numpy(), cache

        return self._run("prefill", prefill)

    def _run_decode(self, tokens: torch.Tensor, pos: torch.Tensor) -> np.ndarray:
        """The pool's logits on the host as fp32 numpy; the pool updated."""
        def decode():
            with torch.inference_mode():
                logits, self._caches = self._decode(self.params, self._caches, tokens, pos)
                return logits.float().cpu().numpy()

        return self._run("decode", decode)

    def submit(self, req: Request) -> bool:
        """Queue a request; False (with ``shed`` set on it) when the queue is
        at ``max_queue``."""
        L = len(req.prompt)
        if not 1 <= L < self.ecfg.max_seq:
            raise ValueError(f"prompt length {L} not in [1, max_seq={self.ecfg.max_seq})")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.ecfg.max_queue > 0 and len(self.queue) >= self.ecfg.max_queue:
            req.shed = True
            req.shed_reason = (f"queue_full: depth {len(self.queue)} at "
                               f"max_queue={self.ecfg.max_queue}")
            self.stats["requests_shed"] += 1
            col = _obs_collector()
            if col.enabled:
                col.counter("serve.shed", reason="queue_full")
            return False
        req._order = self._order
        self._order += 1
        self.queue.append(req)
        return True

    def _bucket_len(self, prompt_len: int) -> int:
        if self._has_ssm:
            # pad tokens would step the recurrent state: exact length
            return prompt_len
        b = max(self.ecfg.min_prefill_bucket, shape_bucket((prompt_len,))[0])
        return min(b, self.ecfg.max_seq)

    def _admit(self, req: Request, slot: int, now: int, done: List[Request]) -> None:
        L = len(req.prompt)
        sb = self._bucket_len(L)
        toks = np.zeros((1, sb), np.int64)
        toks[0, :L] = req.prompt
        t0 = time.perf_counter()
        with _obs_span("serve.admit", slot=slot, prompt_len=L):
            logits_np, cache = self._run_prefill(torch.from_numpy(toks).to(self.device), L)
        self.timings["prefill_s"].setdefault(sb, []).append(time.perf_counter() - t0)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += sb

        req.admitted_step = now
        req.queue_steps = max(0, now - int(np.ceil(req.arrival_time)))
        req.slot = slot
        rng = np.random.default_rng(req.seed)
        first = self._agree([_sample_one(logits_np[0], req, rng)])[0]
        col = _obs_collector()
        if col.enabled:
            # admission -> first token: the prefill and the first sample
            col.observe("serve.admission_s", time.perf_counter() - t0)
            col.counter("serve.requests")
        max_new = min(req.max_new_tokens, self.ecfg.max_seq - L)
        state = _Slot(req=req, rng=rng, cur=first, pos=L, max_new=max_new,
                      emitted=[first], t_admit=self.clock())
        if len(state.emitted) >= max_new:
            self._finish(state, now)      # one-token request: never occupies
            done.append(req)
            return
        with torch.inference_mode():
            lm.insert_cache(self._caches, cache, slot)
        self._slots[slot] = state

    def _finish(self, state: _Slot, now: int) -> None:
        req = state.req
        req.output = np.asarray(state.emitted, np.int32)
        req.finished_step = now
        req.latency_steps = now - req.admitted_step
        req.latency_s = self.clock() - state.t_admit
        self.stats["tokens_out"] += len(state.emitted)
        col = _obs_collector()
        if col.enabled:
            n = len(state.emitted)
            col.observe("serve.latency_s", req.latency_s)
            if n:
                col.observe("serve.per_token_s", req.latency_s / n)
                col.counter("serve.tokens", n)

    def serve(self) -> List[Request]:
        """Run until the queue drains; return requests in submission order."""
        pending = sorted(self.queue, key=lambda r: r.arrival_time)
        self.queue = []
        done: List[Request] = []
        now = 0
        B = self.ecfg.max_batch
        col = _obs_collector()
        t_serve0 = time.perf_counter()
        tok0 = self.stats["tokens_out"]

        def active() -> int:
            return sum(s is not None for s in self._slots)

        while pending or active():
            if not active() and pending and pending[0].arrival_time > now:
                now = int(np.ceil(pending[0].arrival_time))
            free = [i for i in range(B) if self._slots[i] is None]
            while free and pending and pending[0].arrival_time <= now:
                i = free.pop(0)
                self._admit(pending.pop(0), i, now, done)
                if self._slots[i] is None:   # finished at admission: reusable
                    free.append(i)
            if not active():
                continue

            tokens = np.zeros((B, 1), np.int64)
            pos = np.zeros((B,), np.int64)
            for i, s in enumerate(self._slots):
                if s is not None:
                    tokens[i, 0] = s.cur
                    pos[i] = s.pos
            t0 = time.perf_counter()
            logits_np = self._run_decode(torch.from_numpy(tokens).to(self.device),
                                         torch.from_numpy(pos).to(self.device))
            self.timings["decode_s"].append(time.perf_counter() - t0)
            n_act = active()
            self.stats["decode_steps"] += 1
            self.stats["slot_steps_active"] += n_act
            self.stats["slot_steps_idle"] += B - n_act
            # the tick gauges go through the sampler (the engine's most
            # frequent site; a gauge keeps the last value anyway)
            if col.enabled and col.sample():
                col.gauge("serve.queue_depth", len(pending))
                col.gauge("serve.slots_active", n_act)
            now += 1
            sampled = self._agree([_sample_one(logits_np[i], s.req, s.rng) if s is not None
                                   else 0 for i, s in enumerate(self._slots)])
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                nxt = sampled[i]
                s.emitted.append(nxt)
                s.pos += 1
                s.cur = nxt
                if len(s.emitted) >= s.max_new:
                    self._finish(s, now)
                    done.append(s.req)
                    self._slots[i] = None     # freed: next arrival admits here
        if col.enabled:
            wall = time.perf_counter() - t_serve0
            if wall > 0:
                col.gauge("serve.tokens_per_s", (self.stats["tokens_out"] - tok0) / wall)
        return sorted(done, key=lambda r: r._order)

    # ---------------------------------------------------------------- warmup
    def serving_buckets(self) -> List[tuple]:
        """The (batch, seq bucket) pairs this engine runs."""
        from ..campaign.planner import serving_buckets

        return serving_buckets(self.ecfg.max_batch, self.ecfg.max_seq,
                               min_seq=self.ecfg.min_prefill_bucket)

    def warmup(self, db: Optional[TuningDatabase] = None, allow_tune: bool = False,
               install: bool = True, max_tokens: int = 65536,
               **tune_kwargs) -> Dict[str, Optional[Dict]]:
        """Resolve the kernel configs of every slot-pool bucket up front.

        Every admission-prefill and decode-pool site the engine will
        dispatch (``plan_serving_jobs``) resolves through the engine's
        runtime, so its resolution cache is hot and its telemetry shows
        which tier serves each bucket before the first request. With
        ``allow_tune`` a missing bucket is tuned on the spot (on seeded
        tensors); otherwise resolution needs only shapes, dtypes and the
        device, and runs on uninitialized tensors.

        ``db``: with an engine runtime, the database is pinned on it (its
        cached resolutions dropped). Without one, ``install=True`` gives the
        engine a runtime of its own on ``db``, so serving reads the database
        that was warmed; ``install=False`` resolves against ``db`` on a
        throwaway runtime and leaves serving as it was.

        Returns ``{db key: config}`` (``None`` where a policy chose the
        reference).
        """
        from ..campaign.planner import plan_serving_jobs
        from ..campaign.runner import materialize_args
        from ..core.annotate import get_tunable

        rt = self.runtime
        if rt is not None:
            if db is not None and db is not rt.db:
                rt.db = db
                rt.clear_cache()
        elif db is not None and install:
            rt = self.runtime = TunedRuntime(db=db, name="serve")
        elif db is not None:
            rt = TunedRuntime(db=db, name="warmup")
        else:
            rt = current_runtime()
        if allow_tune:
            rt.clear_cache()       # cached resolutions would shadow TuneNow
        jobs = plan_serving_jobs(self.cfg, self.ecfg.max_batch, self.ecfg.max_seq,
                                 max_tokens=max_tokens,
                                 mesh_axes=None if self.mesh is None else
                                 shd.mesh_axis_sizes(self.mesh), layout=self.layout)
        resolved: Dict[str, Optional[Dict]] = {}
        for job in jobs:
            if allow_tune:
                args = materialize_args(job, device=self.device)
            else:
                args = tuple(torch.empty(shape, dtype=getattr(torch, dtype), device=self.device)
                             for shape, dtype in zip(job.arg_shapes, job.arg_dtypes))
            key = job.db_key(rt.platform_for(args))
            if key in resolved:
                continue
            res = rt.resolve(get_tunable(job.kernel), args, key_extra=job.key_extra,
                             allow_tune=allow_tune or None, tune_kwargs=tune_kwargs or None)
            resolved[key] = res.config
        return resolved


class LockStepEngine:
    """The JAX package's static batcher, kept as the slot pool's baseline.

    Packs up to ``max_batch`` queued requests, left-pads them to a shared
    prefill length (with no pad mask: the pads are attended to, as in the
    reference), then decodes the batch in lock step until its longest
    member finishes; new traffic waits for the whole batch.
    ``stats["decode_steps"]`` counts the same unit as
    :class:`ServingEngine`'s, so the two compare directly. It dispatches
    through whichever runtime is active when it serves. ``mesh`` and
    ``layout`` make it a rank of a tensor axis, as :class:`ServingEngine`'s
    do.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        run: RunConfig,
        params,
        ecfg: EngineConfig = EngineConfig(),
        clock: Callable[[], float] = time.perf_counter,
        *,
        mesh=None,
        layout=None,
    ):
        if cfg.frontend is not None:
            raise NotImplementedError("token-in/token-out archs only")
        self.cfg, self.run, self.ecfg = cfg, run, ecfg
        self._mesh = _MeshRank(cfg, params, mesh, layout) if mesh is not None else None
        self.params = self._mesh.params if self._mesh is not None else params
        self.device = self.params["embed"]["table"].device
        self.clock = clock
        self.queue: List[Request] = []
        self.stats: Dict[str, int] = {"decode_steps": 0, "tokens_out": 0}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _scope(self):
        return self._mesh.scope() if self._mesh is not None else contextlib.nullcontext()

    def _sample(self, logits_np, reqs, rngs) -> np.ndarray:
        toks = [_sample_one(logits_np[i], r, rngs[i]) for i, r in enumerate(reqs)]
        return np.asarray(toks if self._mesh is None else self._mesh.agree(toks), np.int64)

    def run_batch(self, reqs: List[Request]) -> List[Request]:
        with self._scope():
            return self._run_batch(reqs)

    def _run_batch(self, reqs: List[Request]) -> List[Request]:
        t0 = self.clock()
        B = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt       # left-pad
        with torch.inference_mode():
            logits, caches = lm.prefill(self.params,
                                        {"tokens": torch.from_numpy(toks).to(self.device)},
                                        self.cfg, self.run, cache_len=self.ecfg.max_seq)
            logits_np = logits.float().cpu().numpy()
        max_new = min(max(r.max_new_tokens for r in reqs), self.ecfg.max_seq - plen)

        outs = np.zeros((B, max_new), np.int32)
        rngs = [np.random.default_rng(r.seed) for r in reqs]
        cur = self._sample(logits_np, reqs, rngs)
        done_at = np.zeros((B,), np.float64)
        for step in range(max_new):
            outs[:, step] = cur
            t_now = self.clock() - t0
            for i, r in enumerate(reqs):
                if r.max_new_tokens == step + 1:
                    done_at[i] = t_now
            pos = torch.tensor(plen + step, dtype=torch.long, device=self.device)
            with torch.inference_mode():
                logits, caches = lm.decode_step(
                    self.params, torch.from_numpy(cur[:, None]).to(self.device), caches, pos,
                    self.cfg, self.run)
                logits_np = logits.float().cpu().numpy()
            self.stats["decode_steps"] += 1
            cur = self._sample(logits_np, reqs, rngs)

        dt = self.clock() - t0
        for i, r in enumerate(reqs):
            r.output = outs[i, : r.max_new_tokens]
            r.latency_s = float(done_at[i]) if done_at[i] > 0 else dt
            self.stats["tokens_out"] += len(r.output)
        return reqs

    def serve(self) -> List[Request]:
        """Drain the queue in ``max_batch`` groups (arrival times ignored)."""
        done: List[Request] = []
        while self.queue:
            batch, self.queue = (self.queue[: self.ecfg.max_batch],
                                 self.queue[self.ecfg.max_batch:])
            done.extend(self.run_batch(batch))
        return done
