"""Intent-affinity serving cluster: N engine replicas behind a router.

Port of the JAX package's ``serving/cluster.py``: the same routers, the
same placement hash, tick clock and statistics, over the port's
``InferenceEngine``. The replicas share one ``Model`` (its weights sit
on the device once, and with speculative decoding one draft); each has
its own slot pool, KV cache and prefix cache. The device of the model
decides which attention runs, so there is no ``backend`` argument.

The paper's platform is "a massively parallel Copilot platform with
over 100 GPT-4-Turbo nodes"; a single ``InferenceEngine`` models its
token economics but not its fleet shape. ``EngineCluster`` owns N
replicas — each with its own slot pool and prompt-prefix cache — and
places every request through a pluggable router:

  * ``round_robin``        — cycle replicas in submission order;
  * ``least_loaded``       — min (busy slots + queue depth), ties to the
                             lowest replica index;
  * ``intent_affinity``    — consistent-hash (rendezvous) the request's
    ``prefix_key`` onto the replica that registered that intent's
    prompt prefix, so same-intent traffic lands where the prefix
    prefill is already cached — the serving-side analogue of GeckOpt's
    token savings. Optionally spills to least-loaded when the home
    replica's load crosses ``spill_load``; keyless requests fall back
    to least-loaded.

``register_prefix`` installs an intent prefix on its rendezvous *home*
replica only: affinity keeps hitting that cache while oblivious
policies pay a full prefill on every other replica — per-replica
prefix-hit rates in ``ClusterStats`` quantify the gap
(the JAX package's benchmarks/cluster_bench.py tabulates it).

Time is the deterministic tick clock of ``step()`` (one continuous-
batching iteration on every replica per tick); ``run_workload`` drives
a ``serving/workload.py`` schedule through the cluster and collects
TTFT / E2E / queue-wait percentiles, per-replica utilization and SLA
attainment — no wall-clock anywhere, so runs are exactly reproducible.

Outputs are bit-identical across routing policies when requests carry
sampler seeds: a request's logits do not depend on its replica, its slot
or its co-tenants (every replica decodes at the same fixed batch
width), and prefix-extend logits match full-prefill logits bitwise
(tests/test_torch_cluster.py holds the parity; chip_smoke.py on the
card).

The cluster is interface-compatible with the single engine where the
serving pipeline needs it (``register_prefix`` / ``prefixes`` /
``open_session`` / ``step`` / ``run_until_done`` /
``throughput_stats``), so ``GeckOptPipeline(engine=cluster)`` works
unchanged — sessions get replica affinity by their intent prefix.
"""
from __future__ import annotations

import hashlib
import heapq
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.models.model import Model
from repro_torch.obs import MetricsRegistry, NULL_TRACER, percentile
from repro_torch.serving.engine import EngineSession, InferenceEngine, \
    Request
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.workload import WorkloadRequest

ROUTER_POLICIES = ("round_robin", "least_loaded", "intent_affinity")


def rendezvous_hash(key: str, indices) -> int:
    """Highest-random-weight (rendezvous) placement of ``key`` over the
    replica ``indices``. Deterministic across processes (sha256, not the
    salted builtin hash) and stable under replica-set growth: adding a
    replica only remaps the keys the new replica wins."""
    return max(indices, key=lambda i: int.from_bytes(
        hashlib.sha256(f"{key}|{i}".encode()).digest()[:8], "big"))


@dataclass(frozen=True)
class ReplicaView:
    """Router-visible snapshot of one replica's occupancy."""
    index: int
    busy_slots: int
    queue_depth: int
    holds_prefix: bool = False

    @property
    def load(self) -> int:
        return self.busy_slots + self.queue_depth


def _least_loaded(views: Sequence[ReplicaView]) -> int:
    return min(views, key=lambda v: (v.load, v.index)).index


class Router:
    name = "base"

    def select(self, views: Sequence[ReplicaView],
               prefix_key: Optional[str] = None,
               slack: Optional[int] = None) -> int:
        """Place one request. ``slack`` is its SLA budget in ticks
        (``sla_ticks``) at arrival, None when it carries no deadline —
        policies may use it to keep tight-deadline traffic off loaded
        replicas; the stateless policies ignore it."""
        raise NotImplementedError

    def reset(self):
        """Drop routing state (the cluster's reset() calls this)."""


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._next = 0

    def select(self, views, prefix_key=None, slack=None) -> int:
        i = views[self._next % len(views)].index
        self._next += 1
        return i

    def reset(self):
        self._next = 0


class LeastLoadedRouter(Router):
    name = "least_loaded"

    def select(self, views, prefix_key=None, slack=None) -> int:
        return _least_loaded(views)


class IntentAffinityRouter(Router):
    name = "intent_affinity"

    def __init__(self, spill_load: Optional[int] = None,
                 sla_spill: bool = False):
        # spill_load: home-replica load (busy+queued) at which keyed
        # traffic overflows to least-loaded; None = never spill (keeps
        # placement a pure function of the key, the parity-test mode).
        # sla_spill: additionally spill a deadline-carrying request
        # whose slack is smaller than the home replica's load — the
        # queue ahead of it would eat its whole SLA budget before it
        # even admits, so prefix affinity can't be worth the miss
        self.spill_load = spill_load
        self.sla_spill = sla_spill

    def select(self, views, prefix_key=None, slack=None) -> int:
        if prefix_key is None:
            return _least_loaded(views)
        holders = [v.index for v in views if v.holds_prefix]
        home = rendezvous_hash(prefix_key,
                               holders or [v.index for v in views])
        by_index = {v.index: v for v in views}
        if (self.spill_load is not None
                and by_index[home].load >= self.spill_load):
            return _least_loaded(views)
        if (self.sla_spill and slack is not None
                and by_index[home].load > slack):
            return _least_loaded(views)
        return home


def make_router(policy, spill_load: Optional[int] = None,
                sla_spill: bool = False) -> Router:
    if isinstance(policy, Router):
        return policy
    if policy == "round_robin":
        return RoundRobinRouter()
    if policy == "least_loaded":
        return LeastLoadedRouter()
    if policy == "intent_affinity":
        return IntentAffinityRouter(spill_load=spill_load,
                                    sla_spill=sla_spill)
    raise ValueError(f"unknown router {policy!r}; "
                     f"choose from {ROUTER_POLICIES}")


@dataclass
class RequestTrace:
    """Cluster-side lifecycle record of one routed request (ticks)."""
    index: int                     # workload index (-1: ad-hoc submit)
    replica: int
    request_id: int
    intent: Optional[str]
    prefix_key: Optional[str]
    arrival_tick: int
    sla_ticks: Optional[int]
    session_id: Optional[int]
    turn: int
    admit_tick: Optional[int] = None
    # tick the request's FIRST TOKEN was sampled (the engine's
    # first_token_step) — true TTFT; admit_tick only measures queue wait
    first_token_tick: Optional[int] = None
    finish_tick: Optional[int] = None
    request: Optional[Request] = None   # engine object (output, reason)


def _pct(values: List[int], q: float) -> Optional[float]:
    """Percentile, or None for an empty series — 0.0 would read as a
    perfect latency for a run that finished nothing (the bench renders
    None as "n/a"). One implementation for the whole serving stack:
    obs.metrics.percentile."""
    return percentile(values, q)


@dataclass
class ClusterStats:
    """End-of-run metrics: request latency distributions (ticks) plus
    per-replica engine counters and slot utilization."""
    ticks: int
    traces: List[RequestTrace]
    per_replica: List[Dict]

    def outputs(self) -> Dict[int, Tuple[int, ...]]:
        """Workload index -> generated tokens (parity comparisons)."""
        return {t.index: tuple(t.request.output) for t in self.traces
                if t.request is not None and t.index >= 0}

    def summary(self) -> Dict:
        done = [t for t in self.traces if t.finish_tick is not None]
        # sla_expired requests were dropped from the queue without ever
        # producing a token: they count as requests and SLA misses, but
        # latency percentiles are over requests actually served
        served = [t for t in done
                  if not (t.request is not None
                          and t.request.finish_reason == "sla_expired")]
        # TRUE time-to-first-token: the tick the first token was
        # sampled, which includes queue wait AND prefill time. (+1 so a
        # same-tick arrival-to-token costs one tick, not zero.) The old
        # admit-proxy metric — which saw none of the prefill — survives
        # as admit_wait_*.
        ttft = [t.first_token_tick - t.arrival_tick + 1 for t in served
                if t.first_token_tick is not None]
        awt = [t.admit_tick - t.arrival_tick + 1 for t in served
               if t.admit_tick is not None]
        e2e = [t.finish_tick - t.arrival_tick + 1 for t in served]
        qwait = [t.admit_tick - t.arrival_tick for t in served
                 if t.admit_tick is not None]
        # a deadline-carrying request still in flight at cutoff has
        # missed its SLA by construction — count it, don't drop it;
        # sla_expired drops finish past their deadline, so they are
        # automatic misses under the same formula
        sla = [t.finish_tick is not None
               and (t.finish_tick - t.arrival_tick + 1) <= t.sla_ticks
               for t in self.traces if t.sla_ticks is not None]
        expired = sum(1 for t in done
                      if t.request is not None
                      and t.request.finish_reason == "sla_expired")
        adm = sum(r["admissions"] for r in self.per_replica)
        hits = sum(r["prefix_hits"] for r in self.per_replica)
        # speculative decoding: fleet accept rate and tokens per target
        # forward (== mean busy slots without spec; grows with accepted
        # drafts when spec decode is on)
        steps = sum(r["decode_steps"] for r in self.per_replica)
        toks = sum(r["tokens_generated"] for r in self.per_replica)
        drafted = sum(r.get("spec_drafted", 0)
                      for r in self.per_replica)
        accepted = sum(r.get("spec_accepted", 0)
                       for r in self.per_replica)
        # KV-memory accounting (engine.kv_memory_stats per replica):
        # fleet-wide peak bytes, preemption pressure and the
        # shared-vs-owned block split of the paged pools — peak-based,
        # since a drained run's instantaneous shared count is ~0
        shared = sum(r.get("kv_blocks_shared_peak", 0)
                     for r in self.per_replica)
        used = sum(r.get("kv_blocks_used_peak", 0)
                   for r in self.per_replica)
        # toolset-retrieval prefixes (core/retriever.py): requests whose
        # prompt prefix is a retrieved toolset ("toolset:<sha1>") rather
        # than an intent — distinct keys vs turns served shows how much
        # co-retrieval sharing the router preserved
        toolset_turns = [t for t in self.traces
                         if t.prefix_key is not None
                         and t.prefix_key.startswith("toolset:")]
        toolset_keys = {t.prefix_key for t in toolset_turns}
        return {
            "ticks": self.ticks,
            "requests": len(self.traces),
            "finished": len(served),
            "sla_expired": expired,
            "ttft_p50": _pct(ttft, 50), "ttft_p95": _pct(ttft, 95),
            "ttft_p99": _pct(ttft, 99),
            "admit_wait_p50": _pct(awt, 50),
            "admit_wait_p95": _pct(awt, 95),
            "e2e_p50": _pct(e2e, 50), "e2e_p95": _pct(e2e, 95),
            "queue_wait_p50": _pct(qwait, 50),
            "queue_wait_p95": _pct(qwait, 95),
            "prefix_hit_ratio": round(hits / max(adm, 1), 4),
            "sla_attainment": (round(sum(sla) / len(sla), 4)
                               if sla else 1.0),
            "tokens_out": sum(len(t.request.output) for t in done
                              if t.request is not None),
            "tokens_decoded": toks,
            "decode_steps": steps,
            "tokens_per_step": round(toks / max(steps, 1), 4),
            "spec_rounds": sum(r.get("spec_rounds", 0)
                               for r in self.per_replica),
            "spec_accept_rate": round(accepted / max(drafted, 1), 4),
            "kv_bytes_allocated": sum(r.get("kv_bytes_allocated", 0)
                                      for r in self.per_replica),
            "kv_bytes_peak": sum(r.get("kv_bytes_peak", 0)
                                 for r in self.per_replica),
            "preemptions": sum(r.get("preemptions", 0)
                               for r in self.per_replica),
            "resumes": sum(r.get("resumes", 0)
                           for r in self.per_replica),
            "prefix_evictions": sum(r.get("prefix_evictions", 0)
                                    for r in self.per_replica),
            "kv_blocks_shared_peak": shared,
            "kv_shared_frac": round(shared / max(used, 1), 4),
            "toolset_prefixes": len(toolset_keys),
            "toolset_turns": len(toolset_turns),
            "per_replica": self.per_replica,
        }


class EngineCluster:
    """N ``InferenceEngine`` replicas behind a routing policy."""

    def __init__(self, cfg=None, model: Optional[Model] = None,
                 n_replicas: int = 2, *,
                 engines: Optional[List[InferenceEngine]] = None,
                 router="round_robin", spill_load: Optional[int] = None,
                 sla_spill: bool = False,
                 max_batch: Optional[int] = None,
                 cache_len: Optional[int] = None,
                 seed: Optional[int] = None,
                 kv_mode: Optional[str] = None,
                 kv_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 spec_decode=None,
                 prefill_budget: Optional[int] = None,
                 interleave: Optional[bool] = None,
                 admission: Optional[str] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None):
        # one shared registry for the fleet: each replica publishes
        # through a replica=i facade, the cluster's own counters and
        # latency histograms sit unlabeled beside them. One shared
        # tracer: replicas stamp their replica index as the track
        # group, so exported traces are keyed (replica, slot).
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if engines is not None:
            # prebuilt replicas keep their own configuration; sizing
            # kwargs would be silently dropped, so refuse them
            if any(v is not None for v in (cfg, model, max_batch,
                                           cache_len, seed, kv_mode,
                                           kv_blocks,
                                           block_size, spec_decode,
                                           prefill_budget, interleave,
                                           admission)):
                raise ValueError(
                    "engines= is mutually exclusive with cfg/model/"
                    "max_batch/cache_len/seed/kv_mode/"
                    "kv_blocks/block_size/spec_decode/prefill_budget/"
                    "interleave/admission (prebuilt replicas keep "
                    "their own configuration)")
            self.replicas = list(engines)
            for i, e in enumerate(self.replicas):
                # prebuilt replicas keep their own registries; the
                # shared tracer (when given) still replaces their
                # default NullTracer so the fleet records one trace
                e.trace_group = i
                if tracer is not None:
                    e.tracer = tracer
        else:
            if cfg is None or model is None:
                raise ValueError("EngineCluster needs cfg and model, or "
                                 "engines=")
            max_batch = 8 if max_batch is None else max_batch
            cache_len = 512 if cache_len is None else cache_len
            seed = 0 if seed is None else seed
            kv_mode = "dense" if kv_mode is None else kv_mode
            self.replicas = []
            for i in range(n_replicas):
                e = InferenceEngine(cfg, model, max_batch=max_batch,
                                    cache_len=cache_len, seed=seed + i,
                                    kv_mode=kv_mode,
                                    kv_blocks=kv_blocks,
                                    block_size=block_size,
                                    spec_decode=spec_decode,
                                    prefill_budget=prefill_budget,
                                    interleave=(True if interleave
                                                is None else interleave),
                                    admission=admission or "fifo",
                                    tracer=self.tracer,
                                    metrics=self.metrics.labeled(
                                        replica=i))
                e.trace_group = i
                self.replicas.append(e)
        self.router = make_router(router, spill_load=spill_load,
                                  sla_spill=sla_spill)
        self.device = self.replicas[0].device
        self.kv_mode = self.replicas[0].kv_mode
        self.spec_k = self.replicas[0].spec_k
        self.tick = 0
        self.traces: Dict[Tuple[int, int], RequestTrace] = {}
        self._next_session = 0
        self._prefix_home: Dict[str, int] = {}
        self._util_ticks = [0] * len(self.replicas)
        self._finished_traces: List[RequestTrace] = []
        # cluster-level registry slice: routed submissions plus the
        # served-request latency distributions in ticks (the same
        # numbers ClusterStats.summary percentiles — one storage)
        self._c_routed = self.metrics.counter("cluster_requests_routed")
        self._h_ttft = self.metrics.histogram("cluster_ttft_ticks")
        self._h_e2e = self.metrics.histogram("cluster_e2e_ticks")

    def reset(self, seed: Optional[int] = None):
        """Recycle the whole cluster between workloads: reset every
        replica (slots, queues, stats, prefix caches; cache storage is
        kept), zero the tick clock, drop traces and routing state. Prefixes must be re-registered afterwards."""
        # full-registry sweep first (zeroes the cluster histograms and
        # every replica facade's slice in one pass), then per-replica
        # resets re-publish their fresh pool gauges
        self.metrics.reset()
        for i, e in enumerate(self.replicas):
            e.reset(None if seed is None else seed + i)
        self.router.reset()
        self.tick = 0
        self.traces = {}
        self._next_session = 0
        self._prefix_home = {}
        self._util_ticks = [0] * len(self.replicas)
        self._finished_traces = []

    # ----------------------------------------------------- prefixes ----
    @property
    def prefixes(self) -> Dict[str, int]:
        """Registered prefix key -> home replica index (``in``-compatible
        with the single engine's ``prefixes`` dict)."""
        return dict(self._prefix_home)

    def register_prefix(self, key: str, prefix_text_or_ids,
                        replicate: bool = False) -> int:
        """Prefill the shared prefix on its rendezvous home replica (or
        on every replica with ``replicate=True`` — which erases the
        affinity advantage but serves hot intents from all replicas).
        Returns the prefix length in tokens."""
        home = rendezvous_hash(key, range(len(self.replicas)))
        self._prefix_home[key] = home
        if replicate:
            return max(e.register_prefix(key, prefix_text_or_ids)
                       for e in self.replicas)
        return self.replicas[home].register_prefix(key,
                                                   prefix_text_or_ids)

    # ------------------------------------------------------ routing ----
    def _views(self, prefix_key: Optional[str] = None
               ) -> List[ReplicaView]:
        return [ReplicaView(i, e.busy_slots(), e.queue_depth(),
                            holds_prefix=(prefix_key is not None
                                          and prefix_key in e.prefixes))
                for i, e in enumerate(self.replicas)]

    def route(self, prefix_key: Optional[str] = None,
              slack: Optional[int] = None) -> int:
        return self.router.select(self._views(prefix_key), prefix_key,
                                  slack)

    def submit(self, prompt, max_new_tokens: int = 32,
               sampler: SamplerConfig = SamplerConfig(),
               prefix_key: Optional[str] = None,
               session_id: Optional[int] = None, *,
               intent: Optional[str] = None,
               sla_ticks: Optional[int] = None,
               index: int = -1, turn: int = 0) -> Tuple[int, int]:
        """Route one request; returns (replica index, request id)."""
        r = self.route(prefix_key, slack=sla_ticks)
        self._c_routed.inc()
        rid = self.replicas[r].add_request(
            prompt, max_new_tokens, sampler, prefix_key=prefix_key,
            session_id=session_id, sla_ticks=sla_ticks)
        self.traces[(r, rid)] = RequestTrace(
            index=index, replica=r, request_id=rid, intent=intent,
            prefix_key=prefix_key, arrival_tick=self.tick,
            sla_ticks=sla_ticks, session_id=session_id, turn=turn)
        return r, rid

    def open_session(self, prefix_key: Optional[str] = None
                     ) -> EngineSession:
        """Pin a conversation to one replica (chosen by the router, so
        an intent-keyed session lands on its prefix's home replica).
        Session ids are cluster-unique: replicas' engine-local request
        ids collide, so ``EngineSession.collect`` disambiguates by
        session id."""
        sid = self._next_session
        self._next_session += 1
        return self.replicas[self.route(prefix_key)].open_session(
            prefix_key, session_id=sid)

    # ------------------------------------------------------ stepping ----
    def step(self) -> List[Request]:
        """One cluster tick: every replica admits + decodes once.
        Returns newly finished requests across all replicas."""
        finished: List[Request] = []
        self._finished_traces = []
        for i, e in enumerate(self.replicas):
            done = e.step()
            # slots active during this tick's decode = still occupied
            # after the step + finishers that actually held a slot.
            # Terminal-at-admission requests (len(output) == 1) never
            # did — a slot finisher always has its admission token plus
            # >= 1 decoded token
            decoded = sum(1 for r in done if len(r.output) > 1)
            self._util_ticks[i] += e.busy_slots() + decoded
            for req in done:
                t = self.traces.get((i, req.request_id))
                if t is not None:
                    # engine step numbers advance in lockstep with the
                    # cluster tick clock (both count the same step()
                    # calls), so the engine's stamps ARE cluster ticks
                    if t.admit_tick is None:
                        t.admit_tick = (req.admit_step
                                        if req.admit_step is not None
                                        else self.tick)
                    t.first_token_tick = req.first_token_step
                    t.finish_tick = self.tick
                    t.request = req
                    self._finished_traces.append(t)
                    if req.finish_reason != "sla_expired":
                        # served requests only — expired drops never
                        # produced a token and would poison the
                        # latency distributions (summary() applies
                        # the same exclusion)
                        if t.first_token_tick is not None:
                            self._h_ttft.observe(t.first_token_tick
                                                 - t.arrival_tick + 1)
                        self._h_e2e.observe(t.finish_tick
                                            - t.arrival_tick + 1)
            for s in e.slots:
                if s is not None:
                    t = self.traces.get((i, s.request_id))
                    if t is not None and t.admit_tick is None:
                        t.admit_tick = (s.admit_step
                                        if s.admit_step is not None
                                        else self.tick)
            finished.extend(done)
        self.tick += 1
        return finished

    def is_idle(self) -> bool:
        return all(e.is_idle() for e in self.replicas)

    def run_until_done(self, max_iters: int = 10_000) -> List[Request]:
        out: List[Request] = []
        it = 0
        while not self.is_idle() and it < max_iters:
            out.extend(self.step())
            it += 1
        return out

    # ----------------------------------------------------- workloads ----
    def run_workload(self, requests: Sequence[WorkloadRequest],
                     max_ticks: int = 100_000) -> ClusterStats:
        """Drive a synthetic workload: submit turn-0 requests at their
        arrival ticks, release follow-up turns ``turn_gap`` ticks after
        the previous turn of their session finishes, step until drained.

        Requires a fresh cluster clock (stats and traces are cumulative;
        ``reset()`` — then re-register prefixes — between workloads)."""
        if self.tick != 0 or self.traces:
            raise RuntimeError(
                "run_workload on a used cluster would mix runs in "
                "ClusterStats; call cluster.reset() (and re-register "
                "prefixes) between workloads")
        openers = deque(sorted((w for w in requests if w.turn == 0),
                               key=lambda w: (w.arrival_tick, w.index)))
        followups = {(w.session_id, w.turn): w
                     for w in requests if w.turn > 0}
        ready: List[Tuple[int, int, WorkloadRequest]] = []   # heap

        def _submit(w: WorkloadRequest):
            self.submit(w.prompt, w.max_new_tokens,
                        SamplerConfig(temperature=w.temperature,
                                      seed=w.sampler_seed),
                        prefix_key=w.prefix_key,
                        session_id=w.session_id, intent=w.intent,
                        sla_ticks=w.sla_ticks, index=w.index,
                        turn=w.turn)

        while ((openers or ready or followups or not self.is_idle())
               and self.tick < max_ticks):
            while openers and openers[0].arrival_tick <= self.tick:
                _submit(openers.popleft())
            while ready and ready[0][0] <= self.tick:
                _, _, w = heapq.heappop(ready)
                _submit(w)
            if (followups and not openers and not ready
                    and self.is_idle()):
                # nothing in flight can ever release these turns — fail
                # fast instead of spinning max_ticks no-op iterations
                raise ValueError(
                    "workload has follow-up turns whose predecessor "
                    f"turn never runs: {sorted(followups)}")
            self.step()
            for t in self._finished_traces:
                if t.session_id is None:
                    continue
                nxt = followups.pop((t.session_id, t.turn + 1), None)
                if nxt is not None:
                    heapq.heappush(ready, (t.finish_tick
                                           + nxt.arrival_tick,
                                           nxt.index, nxt))
        # a max_ticks cutoff can leave requests never submitted (late
        # openers, unreleased follow-up turns): record them as traces
        # with no admit/finish so `requests` and sla_attainment still
        # account for the whole workload (they count as SLA misses)
        leftovers = (list(openers) + [w for _, _, w in ready]
                     + list(followups.values()))
        for w in leftovers:
            self.traces[(-1, w.index)] = RequestTrace(
                index=w.index, replica=-1, request_id=-1,
                intent=w.intent, prefix_key=w.prefix_key,
                arrival_tick=(w.arrival_tick if w.turn == 0
                              else self.tick),
                sla_ticks=w.sla_ticks, session_id=w.session_id,
                turn=w.turn)
        per_replica = [
            dict(e.stats, **e.kv_memory_stats(), replica=i,
                 hit_ratio=round(e.stats["prefix_hits"]
                                 / max(e.stats["admissions"], 1), 4),
                 utilization=round(self._util_ticks[i]
                                   / max(self.tick * e.max_batch, 1), 4))
            for i, e in enumerate(self.replicas)]
        return ClusterStats(ticks=self.tick,
                            traces=sorted(self.traces.values(),
                                          key=lambda t: t.index),
                            per_replica=per_replica)

    # -------------------------------------------------------- stats ----
    def throughput_stats(self) -> Dict:
        """Engine-stat aggregate (single-engine-compatible keys, KV
        byte/block counters summed fleet-wide) plus a ``per_replica``
        breakdown."""
        keys = self.replicas[0].stats.keys()
        agg: Dict = {k: sum(e.stats[k] for e in self.replicas)
                     for k in keys}
        kv = [e.kv_memory_stats() for e in self.replicas]
        # every numeric kv counter sums fleet-wide; the schema lives in
        # engine.kv_memory_stats alone (no key list to keep in sync)
        agg.update({k: sum(m[k] for m in kv) for k in kv[0]
                    if k not in ("kv_mode", "kv_shared_frac")})
        agg["kv_mode"] = self.kv_mode
        agg["kv_shared_frac"] = round(
            sum(m["kv_blocks_shared_peak"] for m in kv)
            / max(sum(m["kv_blocks_used_peak"] for m in kv), 1), 4)
        agg["tokens_per_step"] = round(
            agg["tokens_generated"] / max(agg["decode_steps"], 1), 4)
        agg["spec_accept_rate"] = round(
            agg["spec_accepted"] / max(agg["spec_drafted"], 1), 4)
        agg["spec_k"] = self.spec_k
        agg["per_replica"] = [dict(e.stats, **m, replica=i)
                              for i, (e, m) in enumerate(
                                  zip(self.replicas, kv))]
        return agg
