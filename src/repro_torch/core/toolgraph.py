"""Tool-graph compiler: DAG representation, validation and deterministic
wave scheduling for fused parallel function calling.

Grounded in "An LLM-Tool Compiler for Fused Parallel Function Calling"
(PAPERS.md): instead of one linear wave of tool calls per planner
round-trip, the planner emits a DAG of ``{tool, args, deps}`` nodes and
the runtime executes *independent* nodes together in topological waves.
GeckOpt's gating narrows the catalog so the planner aggregates more
calls per step; compiling those calls into a DAG multiplies the win —
whole multi-stage programs collapse into one LLM round-trip.

Determinism contract (DESIGN.md §Tool-graph compiler):

  * dependencies are inferred from *workspace data-flow hazards* —
    read-after-write, write-after-read and write-after-write conflicts
    on named workspace resources (handles, map, detections, landcover,
    artifacts, answer, ui, rng). Two nodes whose relative order can
    affect workspace state or observations are ALWAYS ordered by a
    dependency chain; in particular the session rng is a write resource,
    so every stochastic tool is serialized against every other.
  * consequently ANY topological execution order — including the wave
    schedule — produces bitwise-identical workspace end-state and
    per-node observations to sequential emission-order execution.
  * ``wave_schedule`` itself is deterministic: wave k holds exactly the
    nodes whose longest dependency chain has length k, each wave sorted
    by node id. No dict-iteration order leaks into the schedule.

Validation rejects malformed graphs with *typed* errors (cycles,
unknown tools, dangling deps, duplicate ids) so callers can distinguish
planner bugs from environment failures.

This module is dependency-free w.r.t. the environment: callers supply
the per-tool effect table (``env.tools_impl.TOOL_EFFECTS`` is the
authoritative one) so core → env import direction stays acyclic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, FrozenSet, List, Mapping,
                    Optional, Sequence, Tuple)


# ----------------------------------------------------------- typed errors --

class ToolGraphError(Exception):
    """Base class for all tool-graph validation failures."""


class CycleError(ToolGraphError):
    """The dependency graph has a cycle (or a self-dependency)."""


class UnknownToolError(ToolGraphError):
    """A node names a tool with no known implementation/effects."""


class UnknownDepError(ToolGraphError):
    """A node depends on a node id that is not in the graph."""


class DuplicateNodeError(ToolGraphError):
    """Two nodes share the same node id."""


# ------------------------------------------------------------- data model --

#: The hazard alphabet: every named workspace resource dependency
#: inference may order on. ``env/tools_impl.WORKSPACE_RESOURCE_ATTRS``
#: maps each name to the concrete ``Workspace`` attribute it denotes;
#: the static analyzer (``repro.analysis``) and the import-time
#: ``core.tools.validate_effects`` check both directions against this
#: set, so an effects entry can never silently name a resource the
#: hazard analysis does not know.
WORKSPACE_RESOURCES: FrozenSet[str] = frozenset({
    "handles", "map", "detections", "landcover", "artifacts",
    "answer", "ui", "rng",
})


@dataclass(frozen=True)
class ToolEffects:
    """Workspace resources a tool reads/writes — the hazard alphabet.

    ``writes`` membership implies the tool conflicts with every earlier
    reader AND writer of that resource; ``reads`` only with earlier
    writers. The pseudo-resource ``"rng"`` marks tools that consume the
    workspace's seeded random stream: it is modelled as a *write* so all
    stochastic tools form a serial chain (their relative order changes
    draws, hence observations).
    """
    reads: FrozenSet[str] = frozenset()
    writes: FrozenSet[str] = frozenset()

    def resources(self) -> FrozenSet[str]:
        return self.reads | self.writes

    def unknown_resources(self, alphabet: FrozenSet[str] = WORKSPACE_RESOURCES
                          ) -> FrozenSet[str]:
        """Resource names this entry uses that ``alphabet`` lacks —
        non-empty means hazard inference would silently ignore them."""
        return self.resources() - alphabet


@dataclass(frozen=True)
class ToolNode:
    """One compiled call: ``deps`` are node ids that must execute first."""
    node_id: int
    tool: str
    args: Dict[str, Any] = field(default_factory=dict)
    deps: Tuple[int, ...] = ()

    def to_json(self) -> Dict[str, Any]:
        return {"id": self.node_id, "tool": self.tool, "args": self.args,
                "deps": list(self.deps)}


@dataclass
class ToolGraph:
    """A validated DAG of tool calls for one planner round-trip."""
    nodes: List[ToolNode] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def node_ids(self) -> List[int]:
        return [n.node_id for n in self.nodes]

    def node(self, node_id: int) -> ToolNode:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        raise UnknownDepError(f"no node with id {node_id}")

    # ------------------------------------------------------- validation ----
    def validate(self, known_tools: Optional[Sequence[str]] = None
                 ) -> "ToolGraph":
        """Raise a typed ``ToolGraphError`` subclass on the first defect;
        return self when the graph is a well-formed DAG."""
        seen: set = set()
        for n in self.nodes:
            if n.node_id in seen:
                raise DuplicateNodeError(
                    f"duplicate node id {n.node_id} ({n.tool})")
            seen.add(n.node_id)
        if known_tools is not None:
            known = set(known_tools)
            for n in self.nodes:
                if n.tool not in known:
                    raise UnknownToolError(
                        f"node {n.node_id}: unknown tool {n.tool!r}")
        for n in self.nodes:
            for d in n.deps:
                if d not in seen:
                    raise UnknownDepError(
                        f"node {n.node_id} ({n.tool}) depends on "
                        f"unknown node id {d}")
        self.wave_schedule()          # raises CycleError on cycles
        return self

    # -------------------------------------------------------- scheduling ----
    def wave_schedule(self) -> List[List[int]]:
        """Deterministic topological wave schedule.

        Wave k = node ids whose longest dependency chain has length k
        (so every node lands in the earliest wave its deps allow),
        sorted ascending within the wave. Raises ``CycleError`` if the
        graph is not a DAG. Depth is computed with Kahn's algorithm over
        sorted worklists — no dict/iteration order reaches the result.
        """
        deps = {n.node_id: tuple(n.deps) for n in self.nodes}
        dependents: Dict[int, List[int]] = {i: [] for i in deps}
        indeg = {i: 0 for i in deps}
        for nid, ds in deps.items():
            for d in ds:
                if d == nid:
                    raise CycleError(f"node {nid} depends on itself")
                dependents[d].append(nid)
                indeg[nid] += 1
        depth = {i: 0 for i in deps}
        ready = sorted(i for i, k in indeg.items() if k == 0)
        done = 0
        while ready:
            nid = ready.pop(0)
            done += 1
            for child in sorted(dependents[nid]):
                depth[child] = max(depth[child], depth[nid] + 1)
                indeg[child] -= 1
                if indeg[child] == 0:
                    ready.append(child)
            ready.sort()
        if done != len(deps):
            stuck = sorted(i for i, k in indeg.items() if k > 0)
            raise CycleError(f"dependency cycle through nodes {stuck}")
        waves: Dict[int, List[int]] = {}
        for nid in sorted(depth):
            waves.setdefault(depth[nid], []).append(nid)
        return [sorted(waves[k]) for k in sorted(waves)]

    def to_json(self) -> List[Dict[str, Any]]:
        return [n.to_json() for n in self.nodes]


# --------------------------------------------------------- dep inference ----

EffectsFn = Callable[[str], ToolEffects]


def _effects_fn(effects: "Mapping[str, ToolEffects] | EffectsFn"
                ) -> EffectsFn:
    if callable(effects):
        return effects
    table = effects

    def lookup(tool: str) -> ToolEffects:
        try:
            return table[tool]
        except KeyError:
            raise UnknownToolError(f"no effects entry for tool {tool!r}")
    return lookup


def infer_deps(calls: Sequence, effects: "Mapping[str, ToolEffects] | "
               "EffectsFn") -> ToolGraph:
    """Compile an emission-ordered call list into a hazard DAG.

    ``calls`` is any sequence of objects with ``.tool`` and ``.args``
    (e.g. ``env.tasks.ToolCall``); node ids are assigned 0..n-1 in
    emission order. Node j depends on:

      * the last prior writer of every resource j reads   (RAW)
      * the last prior writer of every resource j writes  (WAW)
      * every prior reader since that writer, for every
        resource j writes                                 (WAR)

    Unknown tools raise ``UnknownToolError`` at compile time — before
    anything executes.
    """
    lookup = _effects_fn(effects)
    last_writer: Dict[str, int] = {}
    readers_since: Dict[str, List[int]] = {}
    nodes: List[ToolNode] = []
    for i, call in enumerate(calls):
        eff = lookup(call.tool)
        deps = set()
        for r in eff.reads:
            if r in last_writer:
                deps.add(last_writer[r])
        for r in eff.writes:
            if r in last_writer:
                deps.add(last_writer[r])
            deps.update(readers_since.get(r, ()))
        deps.discard(i)
        nodes.append(ToolNode(i, call.tool, dict(call.args),
                              tuple(sorted(deps))))
        for r in eff.reads:
            readers_since.setdefault(r, []).append(i)
        for r in eff.writes:
            last_writer[r] = i
            readers_since[r] = []
    return ToolGraph(nodes)


def compile_calls(calls: Sequence, effects: "Mapping[str, ToolEffects] | "
                  "EffectsFn") -> ToolGraph:
    """infer_deps + validate: the planner's one-stop compile entry."""
    g = infer_deps(calls, effects)
    g.validate()
    return g
