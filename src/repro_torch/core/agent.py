"""The multi-step agent loop: (optional GeckOpt gate) → planner → tools.

Implements the paper's runtime exactly:
  1. with gating on, one extra LLM call classifies intent and narrows the
     catalog to the mapped libraries;
  2. compositional planning proceeds over the (possibly narrowed) catalog,
     each step = one LLM request whose prompt carries the serialized
     catalog + history (all token-counted for real);
  3. fallback: if the planner reports TOOL_NOT_FOUND (the gate was too
     narrow), the agent reverts to the FULL toolset for this task and
     continues — "the agent being instructed via prompting to revert".

The loop is factored into a resumable ``AgentSession`` so the serving
pipeline (serving/pipeline.py) can interleave many sessions — gate a
whole admission wave in one batched classifier call, then advance the
sessions round-robin like continuous batching at the agent level.
``run_task`` remains the sequential entry point and is exactly
equivalent: per-session state (workspace rng, planner rng, ledger) is
isolated, so the interleaving order cannot change any task's outcome
(see DESIGN.md §Pipeline concurrency).

At serving scale the pipeline mirrors each session's planner turns onto
an inference engine — a single ``InferenceEngine`` or a multi-replica
``EngineCluster`` whose intent-affinity router keeps every session on
the replica caching its gated intent's prompt prefix (DESIGN.md
§Cluster serving). Session isolation is what makes that safe: a
session's outcome is independent of which replica serves its turns.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.accounting import TokenLedger
from repro_torch.core.gate import IntentGate
from repro_torch.core.planner import (CompiledStep, PlannerConfig, PlanStep,
                                ScriptedPlanner)
from repro_torch.core.retriever import ToolRetriever, ToolsetExposure
from repro_torch.core.tools import Tool, ToolRegistry
from repro_torch.obs import NULL_TRACER
from repro_torch.env.tasks import Task
from repro_torch.env.tools_impl import (NodeObservation, ToolError, Workspace,
                                  execute_graph, execute_tool)
from repro_torch.env.world import World


@dataclass
class TaskResult:
    task: Task
    workspace: Workspace
    ledger: TokenLedger
    completed_plan: bool
    fallback_used: bool
    intent_predicted: Optional[str]
    steps: int
    executed_tools: List[str] = field(default_factory=list)
    toolset: Optional[Tuple[str, ...]] = None  # initially exposed toolset
    widens: int = 0                            # miss-and-widen escalations


@dataclass
class AgentSession:
    """One task's in-flight state, advanced one planner step at a time."""
    task: Task
    workspace: Workspace
    ledger: TokenLedger
    planner: ScriptedPlanner
    visible: Dict[str, Tool]
    catalog: str
    history: List[str] = field(default_factory=list)
    executed: List[str] = field(default_factory=list)
    intent: Optional[str] = None
    gated: bool = False
    fallback_used: bool = False
    completed: bool = False
    done: bool = False
    steps: int = 0              # planner LLM round-trips issued
    virtual_steps: int = 0      # linear planner steps covered (== steps
    #                             without the compiler); the max_steps
    #                             budget is charged in virtual steps so
    #                             compilation cannot change which calls
    #                             the behaviour model gets to make
    index: int = 0              # arrival order (pipeline bookkeeping)
    exposure: Optional[ToolsetExposure] = None  # retrieved-toolset state
    exposed_initial: Optional[Tuple[str, ...]] = None

    def result(self) -> TaskResult:
        return TaskResult(task=self.task, workspace=self.workspace,
                          ledger=self.ledger,
                          completed_plan=self.completed,
                          fallback_used=self.fallback_used,
                          intent_predicted=self.intent, steps=self.steps,
                          executed_tools=self.executed,
                          toolset=self.exposed_initial,
                          widens=(self.exposure.widens
                                  if self.exposure else 0))


class Agent:
    def __init__(self, registry: ToolRegistry, world: World,
                 planner_cfg: PlannerConfig,
                 gate: Optional[IntentGate] = None, seed: int = 0,
                 retriever: Optional[ToolRetriever] = None,
                 exposure: str = "gated", tracer=NULL_TRACER):
        """``exposure`` picks what the serialized prompt catalog holds:

          * ``"gated"`` — the gate's library subset (the seed behaviour);
          * ``"all"`` — the full catalog text regardless of gating (the
            retrieval bench's baseline cell);
          * ``"retrieved"`` — the retriever's top-k toolset, widened
            deterministically on TOOL_NOT_RETRIEVED misses.

        ``visible`` — the behaviour model's input — is gate-driven in
        every mode, which is why task outcomes are bitwise identical
        across modes (DESIGN.md §Tool retrieval)."""
        assert exposure in ("gated", "all", "retrieved"), exposure
        if exposure == "retrieved" and retriever is None:
            raise ValueError("exposure='retrieved' needs a retriever")
        self.registry = registry
        self.world = world
        self.planner_cfg = planner_cfg
        self.gate = gate
        self.seed = seed
        self.retriever = retriever
        self.exposure = exposure
        self.tracer = tracer

    # ------------------------------------------------------- session API ----
    def start_session(self, task: Task, task_seed: int = 0) -> AgentSession:
        """Create the per-task state; does NOT run the gate yet (the
        pipeline gates whole admission waves in one batched call)."""
        rng = np.random.default_rng(hash((self.seed, task_seed)) % 2**32)
        ws = Workspace(world=self.world, rng=rng,
                       temperature=self.planner_cfg.temperature)
        planner = ScriptedPlanner(self.planner_cfg, self.registry,
                                  seed=int(rng.integers(0, 2**31)))
        planner.start_task(task)
        return AgentSession(task=task, workspace=ws, ledger=TokenLedger(),
                            planner=planner,
                            visible=dict(self.registry.tools),
                            catalog=self.registry.catalog_text())

    def apply_gate_result(self, session: AgentSession, intent: str,
                          libs: Tuple[str, ...]):
        """Install an (already ledger-charged) gate decision. ``visible``
        always narrows to the gated libraries; the serialized catalog
        only follows in ``"gated"`` exposure mode (``"all"`` keeps the
        full text, ``"retrieved"`` is set by apply_retrieval_result)."""
        session.intent = intent
        session.visible = {t.name: t
                           for t in self.registry.by_library(libs)}
        if self.exposure == "gated":
            session.catalog = self.registry.catalog_text(libs)
        session.gated = True

    def apply_retrieval_result(self, session: AgentSession,
                               exposure: ToolsetExposure):
        """Install an already-computed retrieval: the session's prompt
        catalog becomes the exposed top-k toolset text."""
        session.exposure = exposure
        session.exposed_initial = exposure.exposed
        session.catalog = exposure.catalog_text(self.registry)
        self.tracer.event("toolset_retrieved", tick=0, lane="retrieve",
                          session=session.index, k=exposure.k,
                          key=exposure.key_str)

    def retrieve_session(self, session: AgentSession):
        """Single-query retrieval (the sequential path; the pipeline
        retrieves whole admission waves in one batched scoring call)."""
        if self.exposure != "retrieved":
            return
        self.apply_retrieval_result(
            session,
            self.retriever.retrieve(session.task.query, session.intent))

    def gate_session(self, session: AgentSession):
        """Single-query gate call (the sequential path)."""
        if self.gate is not None:
            intent, libs = self.gate(session.task.query, session.ledger)
            self.apply_gate_result(session, intent, libs)
        self.retrieve_session(session)

    def plan_step(self, session: AgentSession):
        """One planner LLM round-trip: serialize the prompt, draw the
        next (linear or compiled) step, charge the ledger. Execution and
        reconciliation are separate (``execute_step``/``apply_step``) so
        the pipeline can fuse many sessions' round-trips into one
        batched tool execution."""
        s = session
        s.steps += 1
        prompt = s.planner.serialize_prompt(s.task, s.catalog, s.history)
        if self.planner_cfg.compile_plans:
            budget = self.planner_cfg.max_steps - s.virtual_steps
            step = s.planner.next_compiled_step(s.task, s.visible,
                                                s.history, budget)
            s.virtual_steps += step.n_virtual
            n_calls = len(step.graph.nodes)
        else:
            step = s.planner.next_step(s.task, s.visible, s.history)
            s.virtual_steps += 1
            n_calls = len(step.calls)
        s.ledger.record("plan", prompt,
                        s.planner.serialize_completion(step),
                        tool_calls=n_calls,
                        virtual_steps=(step.n_virtual
                                       if isinstance(step, CompiledStep)
                                       else 1))
        if s.exposure is not None and not step.tool_not_found:
            # TOOL_NOT_RETRIEVED miss-and-widen: the behaviour model may
            # emit a call outside the exposed toolset (it plans over
            # ``visible``, not the serialized catalog). Deterministically
            # double k until the calls are covered, charging each
            # re-serialization as a "widen" ledger entry (zero virtual
            # steps: round-trip metrics stay invariant). The loop bound
            # also terminates when a call is outside the FULL ranking
            # (truncated catalogs) — execution then raises the same
            # ToolError it would with all tools exposed.
            calls = (step.graph.nodes if isinstance(step, CompiledStep)
                     else step.calls)
            tools = {c.tool for c in calls}
            exp = s.exposure
            while (tools and not exp.covers(tools)
                   and exp.k < len(exp.ranking)):
                exp.widen_once()
                s.catalog = exp.catalog_text(self.registry)
                s.ledger.record(
                    "widen",
                    s.planner.serialize_prompt(s.task, s.catalog,
                                               s.history),
                    s.planner.serialize_completion(step))
                self.tracer.event("toolset_widen", tick=s.steps,
                                  lane="retrieve", session=s.index,
                                  k=exp.k)
        return step

    def execute_step(self, session: AgentSession, step
                     ) -> Optional[List[NodeObservation]]:
        """Run the step's tool calls against the session workspace.
        Linear steps execute in emission order; compiled steps execute
        their hazard DAG in topological waves (observation-equivalent,
        see env/tools_impl.execute_graph). Returns None when the step
        carries no calls (final / TOOL_NOT_FOUND / empty)."""
        s = session
        if isinstance(step, CompiledStep):
            if not step.graph.nodes:
                return None
            return execute_graph(s.workspace, step.graph)
        if not step.calls or step.tool_not_found:
            return None
        obs: List[NodeObservation] = []
        for i, call in enumerate(step.calls):
            try:
                out = execute_tool(s.workspace, call.tool, call.args)
                obs.append(NodeObservation(i, call.tool,
                                           f"{call.tool} -> {out}", True))
            except ToolError as e:
                obs.append(NodeObservation(i, call.tool,
                                           f"{call.tool} -> ERROR: {e}",
                                           False))
        return obs

    def apply_step(self, session: AgentSession, step,
                   observations: Optional[List[NodeObservation]]) -> bool:
        """Reconcile a round-trip's outcome into the session: fallback
        handling, observation/history append (observations arrive in
        node-id order — the documented reconciliation order), completion
        and the (virtual) step budget. Returns True when done."""
        s = session
        if step.tool_not_found and s.gated and not s.fallback_used:
            # GeckOpt fallback: revert to the full toolset
            s.fallback_used = True
            s.visible = dict(self.registry.tools)
            if s.exposure is not None:
                # jump the exposure straight to the full catalog (not a
                # retrieval miss — the gate was wrong, not the retriever);
                # at k == n the exposed text is byte-identical to
                # registry.catalog_text(), keeping the fallback exact
                s.exposure.widen_full()
                s.catalog = s.exposure.catalog_text(self.registry)
            else:
                s.catalog = self.registry.catalog_text()
            s.planner.note_fallback()
            s.history.append("Observation: TOOL_NOT_FOUND — reverting to "
                             "the full tool catalog.")
        else:
            if observations:
                ws = s.workspace
                s.executed.extend(o.tool for o in observations if o.ok)
                s.history.append("Observation: " + " | ".join(
                    o.text for o in observations))
                s.history.append(
                    f"Workspace: {len(ws.handles)} handles loaded, "
                    f"{len(ws.map_layers)} map layers, "
                    f"{len(ws.detections)} detection sets, "
                    f"{len(ws.artifacts)} artifacts; last tools: "
                    f"{', '.join(s.executed[-4:]) or 'none'}")
            elif step.final is None:
                s.history.append("Observation: (no action)")
            if step.final is not None:
                s.completed = True
                s.done = True

        if s.virtual_steps >= self.planner_cfg.max_steps:
            s.done = True
        return s.done

    def step_session(self, session: AgentSession) -> bool:
        """One planner round-trip (one LLM request). Returns True when
        the session has finished (plan complete or budget exhausted)."""
        if session.done:
            return True
        step = self.plan_step(session)
        observations = self.execute_step(session, step)
        return self.apply_step(session, step, observations)

    # ---------------------------------------------------- sequential API ----
    def run_task(self, task: Task, task_seed: int = 0) -> TaskResult:
        session = self.start_session(task, task_seed)
        self.gate_session(session)
        while not self.step_session(session):
            pass
        return session.result()
