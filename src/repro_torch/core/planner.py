"""Compositional planners: CoT / ReAct, zero/few-shot, ±GeckOpt.

``ScriptedPlanner`` is the GPT-4-Turbo proxy for the Table-2 harness: it
plans against the task's ground-truth stage list with a calibrated
competence/noise model (we cannot call the paper's GPT-4 fleet; the
*token accounting* is fully mechanical — real serialized prompts — while
planner quality is parameterized; see DESIGN.md §Assumption changes).

The paper's central empirical lever is reproduced mechanically:
the probability of aggregating a whole stage (multi-tool per step) rises
as the visible toolset shrinks — "a narrower selection of tools ...
encourages the aggregation of more tools per step".
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.toolgraph import ToolGraph, compile_calls
from repro_torch.core.tools import Tool, ToolRegistry
from repro_torch.env.tasks import Task, ToolCall
from repro_torch.env.tools_impl import tool_effects

SYSTEM_PROMPT = (
    "You are the planning agent of the GeoLLM-Engine geospatial Copilot "
    "platform. You complete user tasks by calling the API tools listed "
    "below. Emit one or more tool calls per step as a JSON array of "
    "{tool, args} objects; the platform executes them in order and "
    "returns one observation per call. Finish with a line starting with "
    "'Final:' containing the answer shown to the user. If a required tool "
    "is unavailable reply TOOL_NOT_FOUND and nothing else.\n"
    "Platform rules:\n"
    "- image handles are catalog ids (img_NNNNN); never invent handles — "
    "always obtain them from SQL_apis queries before loading;\n"
    "- workspace state persists across steps: loaded handles, map layers, "
    "detection results, classified rasters and exported artifacts remain "
    "available to subsequent tools;\n"
    "- visualization tools (map_apis) operate on the current workspace; "
    "call them after the data they render exists;\n"
    "- model-backed tools (detect_apis, landcover_apis, vqa_apis, "
    "vision_apis, speech_apis) are expensive: batch their inputs into a "
    "single call where possible;\n"
    "- argument values must be grounded in prior observations or the user "
    "query; quote dates as ISO yyyy-mm-dd; cloud cover is a 0-1 fraction;\n"
    "- if a tool call errors, read the error, correct the arguments or "
    "choose the right tool, and retry in the next step;\n"
    "- do not repeat a successful call; do not call tools outside the "
    "catalog; keep answers concise and grounded in observations.")

COT_INSTRUCTIONS = (
    "Think step by step about the sub-tasks required, then emit the tool "
    "calls for the next sub-task.")
REACT_INSTRUCTIONS = (
    "Use the Thought/Action/Observation format: write a Thought analyzing "
    "the current state, then an Action containing tool calls, then wait "
    "for the Observation.")

PLATFORM_CONTEXT = (
    "Platform reference (read before planning):\n"
    "Catalog sensors: xview1 (30cm pan-sharpened, object-detection grade), "
    "sentinel2 (10m multispectral, 13 bands B1-B12+B8A, 5-day revisit), "
    "landsat8 (30m, thermal B10/B11), naip (60cm aerial, CONUS only), "
    "worldview3 (31cm, SWIR capable). Imagery metadata columns: image_id, "
    "sensor, region, date (ISO-8601), cloud (0-1), footprint (WGS84 "
    "polygon), off_nadir_deg, sun_elevation_deg, processing_level.\n"
    "Supported CRS targets: EPSG:4326 (WGS84 geographic), EPSG:3857 (web "
    "mercator), UTM zones via EPSG:326xx. Reprojection resamples bilinear "
    "for continuous rasters and nearest for class maps.\n"
    "Detection checkpoints: dino-airplane-v2 (AP50 0.91 on xview1), "
    "dino-ship-v2 (AP50 0.88, handles wakes), dino-storage-tank-v1, "
    "yolo-vehicle-s (fast, use for >10 images), dino-helipad-v1, "
    "dino-bridge-v1, dino-crane-v1. Land-cover model: esa-worldcover-v2 "
    "(water/trees/crops/built/bare/grass, 10m). VQA/captioning backend: "
    "qwen2-vl-72b served on the inference mesh; speech backend: "
    "whisper-large-v3. Model-backed calls are billed per image — batch "
    "inputs whenever the plan allows.\n"
    "Workspace semantics: load_images materializes rasters into the "
    "session workspace; filters mutate the handle set in place; map state "
    "is additive (layers stack); export_geotiff and screenshot_map write "
    "to the artifact store; run_python executes in a sandbox with numpy "
    "and the workspace mounted read-only.\n"
    "Quota notes: SQL queries are free; raster loads count against the "
    "session raster budget (256 scenes); detector and classifier calls "
    "run on shared GPU pools and may queue under load; web and UI tools "
    "execute in an isolated browser profile.\n"
    "Output contract: every Action must be a JSON array; every Final line "
    "must summarize counts, classes or artifacts produced, and reference "
    "handles by id. Observations are authoritative — never contradict "
    "them.\n"
    "Error codes: E101 unknown handle (re-query the catalog), E102 empty "
    "workspace (load before processing), E103 CRS mismatch (reproject "
    "first), E201 detector queue timeout (retry once), E202 class not "
    "supported by checkpoint (consult suggest_model), E301 map has no "
    "layers (plot before screenshot), E401 article not found (search "
    "first), E402 page fetch blocked (use a result url from web_search), "
    "E501 sandbox limit exceeded (reduce input size). On any error, fix "
    "the root cause in the next step rather than repeating the call.\n"
    "Region glossary: named regions resolve through sql_query_regions to "
    "catalog region ids with WGS84 bounding boxes; coastal regions "
    "include a 12nm maritime buffer (relevant for ship detection); "
    "metropolitan regions clip to the administrative boundary; polar "
    "acquisitions may have low sun elevation — prefer sensors with SWIR "
    "when shadows matter. Dates filter on acquisition time in UTC; "
    "revisit gaps differ per sensor (see sensor list above).")

SESSION_DIGEST = (
    "Recent session digest (for continuity):\n"
    "- 09:12 user asked for sentinel2 coverage of the Rotterdam port "
    "expansion; 14 scenes loaded, NDVI computed, composite exported as "
    "workspace://ndvi_rotterdam_q2.tif; map centered on 51.95N 4.14E.\n"
    "- 09:31 ship detection over the maritime buffer: dino-ship-v2 on 9 "
    "scenes, 143 detections, heatmap layer saved; two scenes skipped for "
    "cloud cover 0.71 and 0.64 (threshold 0.4).\n"
    "- 09:47 land-cover comparison 2021 vs 2023 for the reclaimed area: "
    "built fraction 0.31 -> 0.38, water 0.22 -> 0.16; histogram artifact "
    "tabulated and pinned to the project dashboard.\n"
    "- 10:02 knowledge-base lookup on sentinel-2 band designations cited "
    "in the quarterly report draft; summary stored under notes/bands.md.\n"
    "- Active preferences: EPSG:3857 for web maps, bilinear resampling, "
    "detector confidence threshold 0.35, max 24 scenes per load, artifact "
    "names kebab-case with date suffix.\n"
    "- 10:18 UI session: dashboard panel rearranged, notes panel pinned "
    "left, detection review queue cleared (11 items approved, 2 flagged "
    "for re-inference at higher confidence).\n"
    "- 10:26 audio: two stand-up recordings transcribed and filed under "
    "notes/standups/; action items extracted to the project tracker.\n"
    "- 10:33 web research: three vendor pages on SAR tasking APIs "
    "captured to the evidence folder with citations.\n"
    "- Data dictionary reminders: 'cloud' is scene-average from the "
    "sensor QA mask, not AOI-clipped; 'off_nadir_deg' above 25 degrades "
    "detection recall; sentinel2 B10 is cirrus-only and excluded from "
    "surface composites; NAIP has no SWIR so NDVI uses B4/B1 mapping; "
    "detection results are immutable once written — re-run the detector "
    "rather than editing boxes; land-cover class 'bare' includes beaches "
    "and quarries; exports default to cloud-optimized GeoTIFF.")

FEW_SHOT_EXAMPLES = """Example task: Plot sentinel2 images of Rotterdam.
Thought: I need region + catalog query, then load and plot.
Action: [{"tool":"sql_query_regions","args":{"place":"Rotterdam"}},
{"tool":"sql_query_images","args":{"sensor":"sentinel2","region":"Rotterdam"}}]
Observation: {"regions":["Rotterdam"],"image_ids":["img_00031"]}
Action: [{"tool":"load_images","args":{"image_ids":["img_00031"]}},
{"tool":"plot_map","args":{"region":"Rotterdam"}}]
Observation: {"map":"rendered"}
Final: rendered 1 sentinel2 image of Rotterdam.

Example task: How many ships are docked near Singapore?
Thought: query catalog, load, detect ships, count.
Action: [{"tool":"sql_query_images","args":{"sensor":"xview1","region":"Singapore"}}]
Observation: {"image_ids":["img_00007","img_00104"]}
Action: [{"tool":"load_images","args":{"image_ids":["img_00007","img_00104"]}},
{"tool":"detect_objects","args":{"classes":["ship"]}},
{"tool":"count_objects","args":{"classes":["ship"]}}]
Observation: {"detections":{"ship":9}}
Final: 9 ships detected.
"""


@dataclass(frozen=True)
class PlannerConfig:
    mode: str = "cot"            # cot | react
    few_shot: bool = False
    temperature: float = 0.3
    # competence model (GPT-4-Turbo proxy calibration)
    p_wrong_tool_zs: float = 0.030
    p_wrong_tool_fs: float = 0.018
    p_task_derail_cot: float = 0.360
    p_task_derail_react: float = 0.310
    p_derail_recover: float = 0.35
    derail_fs_factor: float = 0.82   # few-shot derails less often
    p_skip_side_effect: float = 0.08
    max_steps: int = 12
    # tool-graph compiler: emit DAG-of-calls round-trips that fuse many
    # virtual planner steps into one LLM request (DESIGN.md §Tool-graph
    # compiler). The behaviour model is unchanged — the same next_step
    # rng stream drives both modes — so workspace outcomes are bitwise
    # identical to the linear planner; only round-trip/token accounting
    # moves.
    compile_plans: bool = False

    @property
    def name(self) -> str:
        shot = "few_shot" if self.few_shot else "zero_shot"
        return f"{self.mode}_{shot}"


@dataclass
class PlanStep:
    thought: str
    calls: List[ToolCall]
    final: Optional[str] = None
    tool_not_found: bool = False


@dataclass
class CompiledStep:
    """One compiled planner round-trip: a hazard-DAG of tool calls that
    fuses ``n_virtual`` consecutive linear planner steps, optionally
    terminated by the final answer. ``graph`` node ids are assigned in
    emission order, so ascending node id == the linear execution order.
    """
    thought: str
    graph: ToolGraph
    final: Optional[str] = None
    tool_not_found: bool = False
    n_virtual: int = 0

    @property
    def calls(self) -> List[ToolCall]:
        return [ToolCall(n.tool, n.args) for n in self.graph.nodes]


class ScriptedPlanner:
    """GPT-4-Turbo proxy planning against the ground-truth stage list."""

    def __init__(self, cfg: PlannerConfig, registry: ToolRegistry,
                 seed: int = 0):
        self.cfg = cfg
        self.registry = registry
        self.n_total_tools = len(registry.tools)
        self.rng = np.random.default_rng(seed)

    # -- behaviour model ----------------------------------------------------
    def p_aggregate(self, n_visible: int) -> float:
        """Multi-tool aggregation propensity vs toolset breadth — the
        paper's central observation, "a narrower selection of tools ...
        encourages the aggregation of more tools per step"."""
        frac = n_visible / max(self.n_total_tools, 1)
        return float(np.clip(0.54 - 0.37 * frac, 0.17, 0.54))

    # calls the proxy planner may forget without breaking the main answer
    # (outcome-critical filters are NOT skippable)
    _SKIPPABLE = {"draw_bboxes", "ui_scroll", "sql_count", "mosaic",
                  "screenshot_map", "add_layer", "plot_histogram"}

    def start_task(self, task: Task):
        self._remaining: List[List[ToolCall]] = [list(s) for s in task.plan]
        cfg = self.cfg
        derail = (cfg.p_task_derail_react if cfg.mode == "react"
                  else cfg.p_task_derail_cot)
        if cfg.few_shot:
            derail *= cfg.derail_fs_factor
        # pre-draw the task-level competence outcome, anchored to plan
        # PROGRESS (stage index), not step count — aggregation must not
        # change the planner's propensity to go off-plan
        n_stages = max(len(self._remaining), 1)
        self._derail_stage = (int(self.rng.integers(0, n_stages))
                              if self.rng.random() < derail else -1)
        self._stages_entered = 0
        # success-only slip: forget one non-critical side-effect call
        if self.rng.random() < cfg.p_skip_side_effect:
            for stage in self._remaining:
                drop = [c for c in stage if c.tool in self._SKIPPABLE]
                if drop:
                    stage.remove(drop[0])
                    break
        self._remaining = [s for s in self._remaining if s]
        self._steps_taken = 0

    def next_step(self, task: Task, visible_tools: Dict[str, Tool],
                  history: List[str]) -> PlanStep:
        cfg = self.cfg
        self._steps_taken += 1
        thought = ""
        if cfg.mode == "react":
            nxt = (self._remaining[0][0].tool if self._remaining
                   else "final answer")
            thought = (f"Thought: the task '{task.query[:80]}' has "
                       f"{len(self._remaining)} remaining sub-goals. The "
                       f"previous observations are consistent with the "
                       f"plan; the workspace holds the intermediate "
                       f"results I need. Next I should invoke {nxt} with "
                       f"arguments grounded in the latest observation, "
                       f"then verify the result before moving on.")

        if not self._remaining:
            return PlanStep(thought, [], final=self._final_text(task))

        # gating miss: a needed tool is not in the visible catalog. The
        # planner first probes the nearest-looking visible tool (wasted
        # step + error observation), then declares TOOL_NOT_FOUND.
        needed = self._remaining[0][0]
        if needed.tool not in visible_tools:
            if not getattr(self, "_miss_probed", False):
                self._miss_probed = True
                vis = sorted(visible_tools)
                probe = vis[int(self.rng.integers(0, len(vis)))]
                return PlanStep(thought, [ToolCall(probe, {})])
            return PlanStep(thought, [], tool_not_found=True)

        # derail event: the proxy planner goes off-plan irrecoverably when
        # it reaches the pre-drawn stage
        if self._derail_stage == self._stages_entered:
            # off-plan excursions are read-only in practice (queries,
            # lookups) — they waste steps without corrupting the workspace
            wrong = [t for t in self.registry.tools
                     if t.startswith(("sql_", "wiki_", "ui_read",
                                      "suggest_", "web_search"))]
            bad = wrong[int(self.rng.integers(0, len(wrong)))]
            self._derail_stage = -2
            if self.rng.random() < cfg.p_derail_recover:
                # wrong turn, but the planner recovers the plan afterwards
                self._remaining = [[ToolCall(bad, {})]] + self._remaining
            else:
                # irrecoverable: the rest of the plan is lost
                self._remaining = [[ToolCall(bad, {})]]

        # transient wrong-tool slip (retries next step)
        p_slip = (cfg.p_wrong_tool_fs if cfg.few_shot
                  else cfg.p_wrong_tool_zs)
        if self.rng.random() < p_slip:
            vis = list(visible_tools)
            bad = vis[int(self.rng.integers(0, len(vis)))]
            return PlanStep(thought, [ToolCall(bad, {})])

        # aggregation: how many calls of the current stage in one step?
        stage = self._remaining[0]
        if self.rng.random() < self.p_aggregate(len(visible_tools)):
            calls = stage
            self._remaining = self._remaining[1:]
            self._stages_entered += 1
            # strong aggregators sometimes merge the following stage too
            if (self._remaining and len(calls) +
                    len(self._remaining[0]) <= 4
                    and self.rng.random() < 0.30):
                calls = calls + self._remaining[0]
                self._remaining = self._remaining[1:]
                self._stages_entered += 1
        else:
            calls = [stage[0]]
            rest = stage[1:]
            self._remaining = ([rest] if rest else []) + self._remaining[1:]
            if not rest:
                self._stages_entered += 1
        return PlanStep(thought, list(calls))

    def next_compiled_step(self, task: Task, visible_tools: Dict[str, Tool],
                           history: List[str], max_virtual: int
                           ) -> CompiledStep:
        """Compile up to ``max_virtual`` consecutive linear planner steps
        into ONE round-trip: a hazard-DAG of their calls (deps inferred
        from workspace data-flow) plus the final answer when the plan
        completes inside the window.

        Determinism: this calls the SAME ``next_step`` the linear path
        uses, in the same order, so the competence-model rng stream
        (derail, slips, aggregation draws) is consumed identically —
        compilation changes round-trip structure, never behaviour.
        Collection stops at a TOOL_NOT_FOUND boundary: the fallback
        swaps the visible catalog between round-trips, so it must not
        share a completion with pre-fallback calls. The boundary peek is
        free — the TOOL_NOT_FOUND branch of ``next_step`` draws no rng
        and leaves the plan untouched, so the next round-trip re-emits
        it verbatim.
        """
        thought = ""
        final: Optional[str] = None
        tool_not_found = False
        calls: List[ToolCall] = []
        n_virtual = 0
        while n_virtual < max_virtual:
            step = self.next_step(task, visible_tools, history)
            if n_virtual == 0:
                thought = step.thought
            if step.tool_not_found:
                if not calls:           # a bare TOOL_NOT_FOUND round-trip
                    tool_not_found = True
                    n_virtual += 1
                break
            if step.final is not None:  # fold the final into this round
                final = step.final
                n_virtual += 1
                break
            calls.extend(step.calls)
            n_virtual += 1
        graph = compile_calls(calls, tool_effects)
        return CompiledStep(thought, graph, final=final,
                            tool_not_found=tool_not_found,
                            n_virtual=n_virtual)

    def note_fallback(self):
        """Called by the agent after a full-catalog fallback: the context
        switch occasionally confuses the proxy planner (paper: 'slight
        deviations')."""
        if self.rng.random() < 0.30:
            self._derail_stage = self._stages_entered

    def _final_text(self, task: Task) -> str:
        return (f"Final: task '{task.query[:50]}' completed; results are "
                f"in the workspace.")

    # -- prompt serialization (REAL tokens) ----------------------------------
    def serialize_prompt_prefix(self, catalog_text: str) -> str:
        """The task-independent head of every planner prompt: system +
        platform context + instructions + the (gated) catalog. Sessions
        sharing an intent share this text verbatim — it is what the
        engine's per-intent prefix cache prefills once (see DESIGN.md
        §Pipeline concurrency)."""
        cfg = self.cfg
        parts = [SYSTEM_PROMPT, PLATFORM_CONTEXT, SESSION_DIGEST,
                 REACT_INSTRUCTIONS if cfg.mode == "react"
                 else COT_INSTRUCTIONS,
                 "Available tools:", catalog_text]
        if cfg.few_shot:
            parts.append(FEW_SHOT_EXAMPLES)
        parts.append(
            "Session: geollm-engine v2.4 | project: default | mesh region "
            "cache warm | artifact store: workspace:// | time budget: "
            "standard | user tier: enterprise")
        return "\n".join(parts)

    def serialize_prompt(self, task: Task, catalog_text: str,
                         history: List[str]) -> str:
        parts = [self.serialize_prompt_prefix(catalog_text),
                 f"Task: {task.query}"]
        parts.extend(history)
        return "\n".join(parts)

    @staticmethod
    def serialize_completion(step) -> str:
        """Serialize a PlanStep or CompiledStep emission. Compiled
        round-trips emit the DAG itself — node ids and deps included —
        so the token accounting honestly prices the fused program the
        planner would have to write out."""
        parts = []
        if step.thought:
            parts.append(step.thought)
        if step.tool_not_found:
            parts.append("TOOL_NOT_FOUND")
        if isinstance(step, CompiledStep):
            if step.graph.nodes:
                parts.append("Action: " + json.dumps(step.graph.to_json()))
        elif step.calls:
            parts.append("Action: " + json.dumps(
                [{"tool": c.tool, "args": c.args} for c in step.calls]))
        if step.final:
            parts.append(step.final)
        return "\n".join(parts)
