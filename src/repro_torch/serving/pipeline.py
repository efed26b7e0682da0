"""Concurrent GeckOpt request pipeline: gate → plan → execute for many
Copilot sessions at once.

Port of the JAX package's ``serving/pipeline.py``: the same stages, the
same statistics and the same engine mirroring, over the port's agent,
retriever, metrics and ``InferenceEngine`` or multi-replica
``EngineCluster`` (serving/cluster.py: a session lands on its intent
prefix's home replica under the ``intent_affinity`` router).

The paper's setting is a massively parallel Copilot platform ("over 100
GPT-4-Turbo nodes"); the sequential Table-2 loop (one task to
completion, then the next) models its *token* economics but not its
*serving* shape. This module runs N sessions through the three stages
concurrently, the way a real fleet does:

  1. **Admission.** Pending tasks are admitted in arrival order until
     ``max_concurrent`` sessions are in flight (a fresh wave whenever
     slots free up).
  2. **Batched gating.** Each admission wave is classified in ONE
     batched gate call (``IntentGate.batch``): with a
     ``BatchedNeuralIntentClassifier`` that is a single ``(Q*8, L)``
     forward pass over every (query, intent) pair instead of Q*8
     sequential B=1 calls.
  3. **Interleaved planning.** Active sessions advance round-robin, one
     planner step per pipeline tick — continuous batching at the agent
     level. Per-session state (workspace rng, planner rng, ledger) is
     isolated and the World is read-only, so results are bit-identical
     to the sequential harness at the same seed
     (tests/test_torch_pipeline.py asserts this; DESIGN.md §Pipeline
     concurrency has the argument).

Optionally the pipeline mirrors its LLM traffic onto a real
``InferenceEngine``: every session's planner prompt shares a per-intent
prefix (the gated system prompt + catalog, see
``ScriptedPlanner.serialize_prompt_prefix``), which the engine prefills
once per intent and reuses across all sessions via its prompt-prefix
cache — launch/serve_pipeline.py drives this path, on one engine or on
an ``EngineCluster``. The engine's turns run at T=0.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.agent import Agent, AgentSession, TaskResult
from repro_torch.core.planner import CompiledStep
from repro_torch.env.evaluator import EvalReport, evaluate_results
from repro_torch.env.tasks import Task
from repro_torch.env.tools_impl import execute_graph_batch
from repro_torch.obs import MetricsRegistry, NULL_TRACER
from repro_torch.serving.sampling import SamplerConfig


@dataclass
class PipelineConfig:
    max_concurrent: int = 16     # in-flight session cap (slot pool)
    gate_batch: int = 32         # max queries per batched gate call
    # engine mirroring: serve each session's first planner turn through
    # the InferenceEngine with per-intent prefix caching
    engine_turns: bool = True
    engine_max_new_tokens: int = 8
    # cross-session fusion: when the agent's planner compiles plans
    # (PlannerConfig.compile_plans), merge every active session's
    # round-trip DAG into ONE batched tool execution per tick
    # (env/tools_impl.execute_graph_batch). Per-session outcomes are
    # bitwise identical either way (disjoint workspaces + fixed
    # (session, node) reconciliation order); this just makes the wave
    # the execution unit, the way a fleet batches its tool backends.
    fuse_sessions: bool = True


# registry-backed PipelineStats fields (attribute surface preserved as
# properties reading/writing the underlying metric objects):
#   admitted/gate_batches/ticks/engine_turns — stage throughput;
#   fused_batches/fused_calls/plan_round_trips/plan_virtual_steps — the
#     tool-graph compiler's cross-session fused execution;
#   peak_concurrent/fused_sessions_peak — high-water gauges.
_PIPE_COUNTERS = ("admitted", "gate_batches", "ticks", "engine_turns",
                  "fused_batches", "fused_calls", "plan_round_trips",
                  "plan_virtual_steps", "retrievals", "retrieval_widens")
_PIPE_GAUGES = ("peak_concurrent", "fused_sessions_peak")


class PipelineStats:
    """Pipeline stage counters, now views over an obs metrics registry
    (``pipeline_*`` metrics) — the attribute surface of the old
    dataclass is preserved via properties, so existing readers
    (`stats.admitted += 1`, benches, tests) are untouched. The engine_*
    descriptor fields stay plain attributes: they describe the serving
    configuration, not the run."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = (metrics if metrics is not None
                        else MetricsRegistry())
        self._c = {k: self.metrics.counter("pipeline_" + k)
                   for k in _PIPE_COUNTERS}
        self._g = {k: self.metrics.gauge("pipeline_" + k)
                   for k in _PIPE_GAUGES}
        self._h_gate = self.metrics.histogram("pipeline_gate_batch_size")
        # device of the mirrored engine: the port has no backend switch,
        # its device picks the Hopper kernels (cuda) or their plain
        # versions (cpu)
        self.engine_backend = ""
        self.engine_replicas = 0     # 1 = single engine, N = cluster
        self.engine_kv_mode = ""     # "dense" | "paged"
        self.engine_spec_k = 0       # draft tokens/round (0 = spec off)
        self.engine_prefill_budget = 0   # chunked-prefill tokens (0=off)
        self.engine_admission = ""   # "fifo" | "slack"

    @property
    def gate_batch_sizes(self) -> List[int]:
        return [int(v) for v in self._h_gate.values]

    def observe_gate_batch(self, n: int):
        self._h_gate.observe(n)

    def summary(self) -> Dict[str, float]:
        # mean_gate_batch follows the empty-series convention: None
        # (rendered "n/a"), never a fabricated 0.0
        return {"admitted": self.admitted,
                "gate_batches": self.gate_batches,
                "mean_gate_batch": self._h_gate.mean(),
                "ticks": self.ticks,
                "peak_concurrent": self.peak_concurrent,
                "engine_turns": self.engine_turns,
                "engine_backend": self.engine_backend,
                "engine_replicas": self.engine_replicas,
                "engine_kv_mode": self.engine_kv_mode,
                "engine_spec_k": self.engine_spec_k,
                "engine_prefill_budget": self.engine_prefill_budget,
                "engine_admission": self.engine_admission,
                "fused_batches": self.fused_batches,
                "fused_calls": self.fused_calls,
                "fused_sessions_peak": self.fused_sessions_peak,
                "plan_round_trips": self.plan_round_trips,
                "plan_virtual_steps": self.plan_virtual_steps,
                "retrievals": self.retrievals,
                "retrieval_widens": self.retrieval_widens}


def _metric_prop(store: str, key: str) -> property:
    return property(
        lambda self: getattr(self, store)[key].value,
        lambda self, v: setattr(getattr(self, store)[key], "value", v))


for _k in _PIPE_COUNTERS:
    setattr(PipelineStats, _k, _metric_prop("_c", _k))
for _k in _PIPE_GAUGES:
    setattr(PipelineStats, _k, _metric_prop("_g", _k))


class GeckOptPipeline:
    """Drives many agent sessions through gate → plan → execute.

    ``engine`` is optional: without it the pipeline is the pure
    agent-level scheduler the Table-2 harness uses; with it, planner
    turns are additionally served by the continuous-batching engine so
    prefix-cache reuse and tokens/s are measurable.
    """

    def __init__(self, agent: Agent, config: Optional[PipelineConfig]
                 = None, engine=None, *, tracer=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.agent = agent
        self.config = config or PipelineConfig()
        self.engine = engine
        # observability is injected like the engine's: pass the engine's
        # tracer/metrics to correlate pipeline-level gate/plan/execute
        # spans with the per-request engine spans in one trace
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None and agent.tracer is NULL_TRACER:
            # surface the agent's retrieve/widen spans in the same trace
            agent.tracer = tracer
        self.stats = PipelineStats(metrics)
        if engine is not None:
            self.stats.engine_backend = engine.device.type
            # an EngineCluster carries .replicas; a bare engine is 1
            replicas = getattr(engine, "replicas", None) or [engine]
            self.stats.engine_replicas = len(replicas)
            self.stats.engine_kv_mode = engine.kv_mode
            self.stats.engine_spec_k = engine.spec_k
            # scheduling knobs live on the engine; a cluster's replicas
            # are homogeneous, so replica 0 speaks for the fleet
            self.stats.engine_prefill_budget = \
                replicas[0].prefill_budget or 0
            self.stats.engine_admission = replicas[0].admission
        self._engine_sessions = []

    # ---------------------------------------------------------- stages ----
    def _admit(self, queue: deque, active: List[AgentSession]
               ) -> List[AgentSession]:
        wave: List[AgentSession] = []
        while queue and len(active) + len(wave) < \
                self.config.max_concurrent:
            index, task = queue.popleft()
            session = self.agent.start_session(task, task_seed=index)
            session.index = index
            wave.append(session)
        self.stats.admitted += len(wave)
        return wave

    def _gate_wave(self, wave: List[AgentSession]):
        """One batched gate call per admission wave (chunked to
        ``gate_batch``), in task order — so a stateful classifier (the
        scripted one draws from one rng stream) sees the exact same
        call sequence as the sequential harness."""
        if self.agent.gate is None or not wave:
            return
        cb = self.config.gate_batch
        for lo in range(0, len(wave), cb):
            chunk = wave[lo:lo + cb]
            h = self.tracer.begin("gate", tick=self.stats.ticks,
                                  group="pipeline", lane="gate",
                                  batch=len(chunk))
            decisions = self.agent.gate.batch(
                [s.task.query for s in chunk],
                [s.ledger for s in chunk])
            self.stats.gate_batches += 1
            self.stats.observe_gate_batch(len(chunk))
            for session, (intent, libs) in zip(chunk, decisions):
                self.agent.apply_gate_result(session, intent, libs)
            self.tracer.end(h, tick=self.stats.ticks)

    def _retrieve_wave(self, wave: List[AgentSession]):
        """One batched retrieval per admission wave (the analogue of
        ``_gate_wave``): every query's full-catalog ranking is computed
        in ONE scoring call, fused with the per-session gated
        intent prior."""
        ag = self.agent
        if ag.exposure != "retrieved" or not wave:
            return
        h = self.tracer.begin("retrieve", tick=self.stats.ticks,
                              group="pipeline", lane="retrieve",
                              batch=len(wave))
        exposures = ag.retriever.retrieve_batch(
            [s.task.query for s in wave], [s.intent for s in wave])
        for session, exposure in zip(wave, exposures):
            ag.apply_retrieval_result(session, exposure)
        self.stats.retrievals += len(wave)
        self.tracer.end(h, tick=self.stats.ticks)

    def _mirror_to_engine(self, session: AgentSession):
        """Serve the session's first planner turn on the engine. All
        sessions gated to the same intent share one cached prefix
        prefill (the gated system prompt + catalog) — and with toolset
        retrieval on, sessions retrieving the same toolset share one
        prefix keyed by the canonical ``toolset_key`` (rendezvous-routed
        across a cluster like an intent prefix)."""
        if self.engine is None or not self.config.engine_turns:
            return
        if session.exposure is not None:
            key = session.exposure.key_str
        else:
            key = f"planner:{session.intent or 'full-catalog'}"
        prefix_text = session.planner.serialize_prompt_prefix(
            session.catalog)
        if key not in self.engine.prefixes:
            self.engine.register_prefix(key, prefix_text)
        es = self.engine.open_session(prefix_key=key)
        es.submit_turn(f"{prefix_text}\nTask: {session.task.query}",
                       max_new_tokens=self.config.engine_max_new_tokens,
                       sampler=SamplerConfig(temperature=0.0))
        self._engine_sessions.append(es)
        self.stats.engine_turns += 1

    def _tick_sessions(self, active: List[AgentSession]
                       ) -> List[AgentSession]:
        """Advance every active session one planner round-trip; returns
        the sessions that finished this tick.

        With the tool-graph compiler on (and ``fuse_sessions``), the
        tick is three phases instead of per-session loops: every session
        plans its compiled round-trip, ALL their DAGs execute in one
        fused ``execute_graph_batch`` wave run, and observations
        reconcile back per session in (session, node id) order — the
        pipeline's cross-session execution path. Outcomes are bitwise
        identical to stepping each session alone (disjoint workspaces).
        """
        fusing = (self.config.fuse_sessions
                  and self.agent.planner_cfg.compile_plans)
        tick = self.stats.ticks
        if not fusing:
            h = self.tracer.begin("plan", tick=tick, group="pipeline",
                                  lane="plan", sessions=len(active))
            done = [s for s in active if self.agent.step_session(s)]
            self.tracer.end(h, tick=tick, finished=len(done))
            return done
        h = self.tracer.begin("plan", tick=tick, group="pipeline",
                              lane="plan", sessions=len(active))
        planned = [(s, self.agent.plan_step(s)) for s in active]
        self.tracer.end(h, tick=tick, round_trips=len(planned))
        entries = [(s.index, s.workspace, step.graph)
                   for s, step in planned
                   if isinstance(step, CompiledStep) and step.graph.nodes]
        n_calls = sum(len(g.nodes) for _, _, g in entries)
        hx = self.tracer.begin("execute_wave", tick=tick,
                               group="pipeline", lane="execute",
                               sessions=len(entries), calls=n_calls)
        observations = execute_graph_batch(entries) if entries else {}
        self.tracer.end(hx, tick=tick)
        if entries:
            self.stats.fused_batches += 1
            self.stats.fused_calls += n_calls
            self.stats.fused_sessions_peak = max(
                self.stats.fused_sessions_peak, len(entries))
        self.stats.plan_round_trips += len(planned)
        self.stats.plan_virtual_steps += sum(
            step.n_virtual for _, step in planned
            if isinstance(step, CompiledStep))
        return [s for s, step in planned
                if self.agent.apply_step(s, step,
                                         observations.get(s.index))]

    # ------------------------------------------------------------- run ----
    def run(self, tasks: Sequence[Task]) -> List[TaskResult]:
        """Run every task to completion; TaskResults in task order."""
        queue = deque(enumerate(tasks))
        active: List[AgentSession] = []
        results: List[Optional[TaskResult]] = [None] * len(tasks)
        finished_turns = []
        while queue or active:
            wave = self._admit(queue, active)
            self._gate_wave(wave)
            self._retrieve_wave(wave)
            for session in wave:
                self._mirror_to_engine(session)
            active.extend(wave)
            self.stats.peak_concurrent = max(self.stats.peak_concurrent,
                                             len(active))
            self.stats.ticks += 1
            if self.engine is not None:
                # overlap engine decode with agent ticks
                finished_turns.extend(self.engine.step())
            finished = self._tick_sessions(active)
            for session in finished:
                results[session.index] = session.result()
                if session.exposure is not None:
                    self.stats.retrieval_widens += session.exposure.widens
            done_ids = {id(s) for s in finished}
            active = [s for s in active if id(s) not in done_ids]
        if self.engine is not None:
            finished_turns.extend(self.engine.run_until_done())
            for es in self._engine_sessions:
                es.collect(finished_turns)
        return [r for r in results if r is not None]


def run_pipeline(agent: Agent, tasks: Sequence[Task],
                 max_concurrent: int = 16, engine=None,
                 config: Optional[PipelineConfig] = None
                 ) -> List[TaskResult]:
    cfg = config or PipelineConfig(max_concurrent=max_concurrent)
    return GeckOptPipeline(agent, cfg, engine=engine).run(tasks)


def evaluate_pipeline(agent: Agent, tasks: Sequence[Task],
                      name: str = "run", max_concurrent: int = 16,
                      engine=None) -> EvalReport:
    """Drop-in concurrent replacement for env.evaluator.evaluate —
    same metrics, N sessions in flight."""
    return evaluate_results(
        run_pipeline(agent, tasks, max_concurrent, engine=engine), name)
