"""Executable tool implementations over the synthetic world.

``Workspace`` is the per-task mutable state (loaded handles, map layers,
artifacts, answers). ``execute_tool`` is the single dispatch point the
agent loop calls; unknown tools or bad args raise ``ToolError`` — which is
what triggers GeckOpt's full-catalog fallback when gating was too narrow.

Model-backed tools (detection, land-cover, VQA) apply a *seeded noise
model* standing in for real model inference: detections have per-class
recall/precision, land-cover adds jitter, VQA answers pass through a
temperature-controlled word dropout (the paper attributes its VQA metric
wobble to non-zero temperature).

Fused execution (the tool-graph compiler, DESIGN.md §Tool-graph
compiler): ``execute_graph`` runs one session's compiled ``ToolGraph``
in topological waves; ``execute_graph_batch`` merges the graphs of many
co-resident sessions into shared waves — the pipeline's cross-session
execution path. ``TOOL_EFFECTS`` is the authoritative per-tool
read/write table the compiler's hazard analysis runs on; a tool
implementation may only touch workspace state its entry declares.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.catalog import FAMILIES, family_of
from repro_torch.core.toolgraph import ToolEffects, WORKSPACE_RESOURCES
from repro_torch.core.tools import DEFAULT_REGISTRY, ToolRegistry, validate_effects
from repro_torch.env.world import LANDCOVER_CLASSES, World


class ToolError(Exception):
    pass


class WorkspaceHazardError(ToolError):
    """A fused batch would execute two graphs against aliased state
    (shared Workspace object or duplicate session key): cross-session
    fusion is only sound when per-session workspaces are disjoint."""


@dataclass
class Workspace:
    world: World
    rng: np.random.Generator
    handles: List[str] = field(default_factory=list)
    map_layers: List[Dict] = field(default_factory=list)
    detections: Dict[str, Dict[str, int]] = field(default_factory=dict)
    landcover: Dict[str, Dict[str, float]] = field(default_factory=dict)
    artifacts: List[Dict] = field(default_factory=list)
    last_answer: Optional[str] = None
    ui_state: Dict[str, Any] = field(default_factory=dict)
    temperature: float = 0.3

    def obs(self, payload) -> str:
        """Render one tool observation. Ordering contract: batched/fused
        executions return observations sorted by ``(session id, node
        id)`` — never by dict or completion order — so reconciliation
        into session histories is reproducible (see
        ``execute_graph_batch``)."""
        s = str(payload)
        return s if len(s) < 900 else s[:900] + "…"


# per-class detector quality (seeded noise model)
_DET_RECALL = {"airplane": 0.96, "ship": 0.93, "storage tank": 0.91,
               "vehicle": 0.86, "helipad": 0.89, "bridge": 0.93,
               "crane": 0.87}
_DET_FP = {"airplane": 0.20, "ship": 0.28, "storage tank": 0.24,
           "vehicle": 0.64, "helipad": 0.16, "bridge": 0.12, "crane": 0.24}


def _resolve_ids(ws: Workspace, ids) -> List[str]:
    if isinstance(ids, str):
        ids = [ids]
    out = []
    for i in ids:
        if i in ws.world.images:
            out.append(i)
    return out


def execute_tool(ws: Workspace, name: str, args: Dict[str, Any]) -> str:
    w = ws.world
    if name == "sql_query_regions":
        place = args.get("place", "")
        hits = [c for c in w.regions if place.lower() in c.lower()
                or c.lower() in place.lower()]
        return ws.obs({"regions": hits, "bboxes": [w.regions[h]
                                                   for h in hits]})
    if name == "sql_query_images":
        rows = w.catalog_rows()
        sensor = args.get("sensor")
        region = args.get("region")
        if sensor:
            rows = [r for r in rows if r.sensor == sensor]
        if region:
            rows = [r for r in rows if region.lower() in r.region.lower()]
        if args.get("date_from"):
            rows = [r for r in rows if r.date >= args["date_from"]]
        if args.get("date_to"):
            rows = [r for r in rows if r.date <= args["date_to"]]
        if args.get("max_cloud") is not None:
            rows = [r for r in rows if r.cloud <= float(args["max_cloud"])]
        rows = rows[:24]
        ids = [r.image_id for r in rows]
        meta = [{"id": r.image_id, "date": r.date, "cloud": r.cloud,
                 "sensor": r.sensor} for r in rows[:12]]
        return ws.obs({"image_ids": ids, "count": len(ids), "rows": meta})
    if name == "sql_count":
        return ws.obs({"count": len(w.images)})
    if name == "sql_distinct":
        col = args.get("column", "sensor")
        vals = sorted({getattr(r, col, "") for r in w.catalog_rows()
                       if hasattr(r, col)})
        return ws.obs({"values": vals})
    if name == "sql_sample":
        n = int(args.get("n", 5))
        ids = sorted(w.images)[:n]
        return ws.obs({"image_ids": ids})

    if name == "load_images":
        ids = _resolve_ids(ws, args.get("image_ids", []))
        if not ids:
            raise ToolError("load_images: no valid image ids")
        ws.handles.extend(i for i in ids if i not in ws.handles)
        return ws.obs({"handles": ids})
    if name in ("filter_clouds", "filter_date"):
        hs = args.get("handles") or ws.handles
        if name == "filter_clouds":
            mx = float(args.get("max_cloud", 0.3))
            keep = [h for h in hs if w.images[h].cloud <= mx]
        else:
            keep = [h for h in hs
                    if (not args.get("date_from")
                        or w.images[h].date >= args["date_from"])
                    and (not args.get("date_to")
                         or w.images[h].date <= args["date_to"])]
        ws.handles = keep
        return ws.obs({"handles": keep, "kept": len(keep)})
    if name in ("mosaic", "reproject", "compute_ndvi", "band_math",
                "export_geotiff"):
        if not ws.handles:
            raise ToolError(f"{name}: workspace empty")
        ws.artifacts.append({"op": name, "inputs": list(ws.handles)})
        return ws.obs({"artifact": f"{name}_{len(ws.artifacts)}"})

    if name == "plot_map":
        hs = args.get("handles") or ws.handles
        if not hs:
            raise ToolError("plot_map: nothing to plot")
        ws.map_layers.append({"type": "images", "handles": list(hs),
                              "region": args.get("region", "")})
        return ws.obs({"map": "rendered", "layers": len(ws.map_layers)})
    if name in ("add_layer", "draw_bboxes", "heatmap", "plot_histogram",
                "plot_timeseries"):
        ws.map_layers.append({"type": name, "args": args})
        return ws.obs({"map": "updated", "layers": len(ws.map_layers)})
    if name == "screenshot_map":
        ws.artifacts.append({"op": "screenshot", "layers":
                             len(ws.map_layers)})
        return ws.obs({"artifact": "screenshot"})

    if name in ("detect_objects", "count_objects"):
        hs = args.get("handles") or ws.handles
        if not hs:
            raise ToolError(f"{name}: workspace empty")
        classes = args.get("classes") or list(_DET_RECALL)
        if isinstance(classes, str):
            classes = [classes]
        for h in hs:
            gt = w.images[h].objects
            det = {}
            for c in classes:
                n_gt = gt.get(c, 0)
                rec = _DET_RECALL.get(c, 0.85)
                tp = int(ws.rng.binomial(n_gt, rec)) if n_gt else 0
                fp = int(ws.rng.poisson(_DET_FP.get(c, 0.3)))
                det[c] = {"tp": tp, "fp": fp, "pred": tp + fp,
                          "gt": n_gt}
            ws.detections[h] = det
        total = {c: sum(ws.detections[h][c]["pred"] for h in hs
                        if c in ws.detections.get(h, {}))
                 for c in classes}
        return ws.obs({"detections": total, "images": len(hs)})
    if name == "change_detection":
        return ws.obs({"changes": int(ws.rng.poisson(4))})
    if name == "suggest_model":
        task = args.get("task", "")
        cls = next((c for c in _DET_RECALL if c in task), "airplane")
        return ws.obs({"model": f"dino-{cls.replace(' ', '-')}-v2"})

    if name == "classify_landcover":
        hs = args.get("handles") or ws.handles
        if not hs:
            raise ToolError("classify_landcover: workspace empty")
        for h in hs:
            gt = w.images[h].landcover
            noisy = {c: max(0.0, gt[c] + float(ws.rng.normal(0, 0.015)))
                     for c in LANDCOVER_CLASSES}
            z = sum(noisy.values())
            ws.landcover[h] = {c: v / z for c, v in noisy.items()}
        return ws.obs({"classified": len(hs)})
    if name == "landcover_stats":
        if not ws.landcover:
            raise ToolError("landcover_stats: classify first")
        agg = {c: float(np.mean([lc[c] for lc in ws.landcover.values()]))
               for c in LANDCOVER_CLASSES}
        ws.last_answer = max(agg, key=agg.get)
        return ws.obs({"fractions": {c: round(v, 4)
                                     for c, v in agg.items()}})
    if name == "compare_landcover":
        return ws.obs({"delta": "computed"})

    if name in ("visual_qa", "compare_images_qa", "caption_image",
                "describe_scene"):
        h = args.get("handle") or args.get("a") or (
            ws.handles[0] if ws.handles else None)
        if h is None or h not in w.images:
            raise ToolError(f"{name}: no image handle")
        # temperature-controlled generation noise (paper §2 attributes the
        # VQA metric wobble to non-zero temperature in function calling)
        base = w.images[h].caption
        words = base.split()
        kept = [wd for wd in words
                if ws.rng.random() > 0.34 + 0.3 * ws.temperature]
        filler = ["the", "image", "shows", "an", "area", "with",
                  "visible", "features"]
        n_fill = int(ws.rng.integers(2, 6))
        ans = " ".join(filler[:n_fill] + (kept or words[:3]))
        ws.last_answer = ans
        return ws.obs({"answer": ans})
    if name == "ground_phrase":
        return ws.obs({"box": [10, 20, 50, 60]})

    if name == "web_search":
        urls = sorted(w.web)[:5]
        return ws.obs({"results": [{"url": u, "title": w.web[u]["title"]}
                                   for u in urls]})
    if name == "open_url":
        url = args.get("url", "")
        if url not in w.web:
            url = sorted(w.web)[0]
        ws.ui_state["page"] = url
        ws.last_answer = w.web[url]["text"][:80]
        return ws.obs({"title": w.web[url]["title"],
                       "text": w.web[url]["text"][:120]})
    if name in ("download_file", "post_form"):
        ws.artifacts.append({"op": name})
        return ws.obs({"ok": True})

    if name in ("ui_click", "ui_type", "ui_scroll", "ui_read",
                "ui_open_panel"):
        ws.ui_state[name] = args
        return ws.obs({"ok": True, "state": name})

    if name == "wiki_search":
        q = args.get("query", "").lower()
        hits = [t for t in w.wiki if any(tok in t for tok in q.split())]
        hits = hits or sorted(w.wiki)[:3]
        return ws.obs({"titles": hits[:5]})
    if name in ("wiki_get", "wiki_summarize"):
        title = args.get("title", "")
        if title not in w.wiki:
            cand = [t for t in w.wiki if title.lower() in t]
            if not cand:
                raise ToolError(f"{name}: unknown article {title!r}")
            title = cand[0]
        body = w.wiki[title]
        # summarization keeps ~60% of the content (temperature-seeded)
        words = body.split()
        kept = [wd for wd in words if ws.rng.random() > 0.38]
        ws.last_answer = " ".join(kept) if kept else body[:80]
        return ws.obs({"article": title, "text": ws.last_answer[:300]})

    if name in ("transcribe_audio", "translate_audio"):
        clip = args.get("clip", "")
        if clip not in w.audio:
            clip = sorted(w.audio)[0]
        # ASR word-error noise
        words = w.audio[clip].split()
        kept = [wd for wd in words if ws.rng.random() > 0.12]
        ws.last_answer = " ".join(kept) if kept else w.audio[clip]
        return ws.obs({"transcript": ws.last_answer})

    if name == "run_python":
        ws.artifacts.append({"op": "run_python"})
        return ws.obs({"stdout": "ok"})
    if name == "tabulate":
        ws.artifacts.append({"op": "tabulate"})
        return ws.obs({"table": "rendered"})

    # generated-catalog tools (core/catalog.py) dispatch by family: one
    # real handler per family, uniform CATALOG_FAMILY_EFFECTS footprint
    family = family_of(name)
    if family is not None:
        return _execute_family(ws, family, name, args)

    raise ToolError(f"unknown tool: {name}")


def _execute_family(ws: Workspace, family: str, name: str,
                    args: Dict[str, Any]) -> str:
    """Dispatch for generated catalog tools (core/catalog.py): every
    member of a family shares one handler and one effects footprint
    (``CATALOG_FAMILY_EFFECTS[family]``), varying deterministically by
    tool name — no wall clock, no unseeded randomness, and only the
    declared workspace resources are touched (the family-table pass of
    the effects race detector checks this statically)."""
    w = ws.world
    if family == "catalogue":
        # pure metadata lookup — mirrors SQL_apis: no workspace effects
        rows = w.catalog_rows()
        n = sum(ord(c) for c in name) % 7 + 3
        meta = [{"id": r.image_id, "sensor": r.sensor} for r in rows[:n]]
        return ws.obs({"partition": name, "count": len(meta),
                       "rows": meta})
    if family == "ingest":
        hs = args.get("handles") or ws.handles
        if not hs:
            raise ToolError(f"{name}: workspace empty")
        keep = [h for h in hs if h in w.images]
        ws.handles = list(dict.fromkeys(keep))
        return ws.obs({"op": name, "handles": len(ws.handles)})
    if family == "carto":
        ws.map_layers.append({"type": name, "args": args})
        return ws.obs({"map": "updated", "layers": len(ws.map_layers)})
    if family == "detector":
        hs = args.get("handles") or ws.handles
        if not hs:
            raise ToolError(f"{name}: workspace empty")
        for h in hs:
            found = int(ws.rng.poisson(2.0))
            ws.detections.setdefault(h, {})[name] = {"pred": found}
        return ws.obs({"detector": name, "images": len(hs)})
    if family == "terrain":
        hs = args.get("handles") or ws.handles
        if not hs:
            raise ToolError(f"{name}: workspace empty")
        for h in hs:
            # full class-fraction dicts like classify_landcover (the
            # evaluator aggregates every class across all entries),
            # just coarser noise: generated terrain endpoints are the
            # catalog's lower-fidelity tier
            gt = w.images[h].landcover
            noisy = {c: max(0.0, gt[c] + float(ws.rng.normal(0, 0.05)))
                     for c in LANDCOVER_CLASSES}
            z = sum(noisy.values()) or 1.0
            ws.landcover[h] = {c: v / z for c, v in noisy.items()}
        return ws.obs({"classified": len(hs), "model": name})
    if family == "scene":
        h = args.get("handle") or (ws.handles[0] if ws.handles else None)
        if h is None or h not in w.images:
            raise ToolError(f"{name}: no image handle")
        words = w.images[h].caption.split()
        kept = [wd for wd in words if ws.rng.random() > 0.4]
        ws.last_answer = " ".join(kept or words[:3])
        return ws.obs({"answer": ws.last_answer})
    if family == "webnav":
        ws.ui_state[name] = args
        return ws.obs({"ok": True, "surface": name})
    if family == "corpus":
        titles = sorted(w.wiki)
        title = titles[sum(ord(c) for c in name) % len(titles)]
        words = w.wiki[title].split()
        kept = [wd for wd in words if ws.rng.random() > 0.45]
        ws.last_answer = " ".join(kept) if kept else title
        return ws.obs({"article": title, "text": ws.last_answer[:200]})
    if family == "audio":
        clips = sorted(w.audio)
        clip = clips[sum(ord(c) for c in name) % len(clips)]
        words = w.audio[clip].split()
        kept = [wd for wd in words if ws.rng.random() > 0.15]
        ws.last_answer = " ".join(kept) if kept else w.audio[clip]
        return ws.obs({"transcript": ws.last_answer})
    if family == "notebook":
        ws.artifacts.append({"op": name})
        return ws.obs({"artifact": f"{name}_{len(ws.artifacts)}"})
    raise ToolError(f"unknown tool family: {family}")


# ===================================================== fused execution =====
#
# Hazard alphabet — the named workspace resources the compiler's dep
# inference runs over. ``world`` state is read-only at execution time
# (no tool mutates it) so world reads never create hazards; ``rng`` is
# modelled as a WRITE because consuming the seeded stream reorders every
# later draw.
#
#   handles     ws.handles               (loaded image handle list)
#   map         ws.map_layers            (additive layer stack)
#   detections  ws.detections            (per-handle detection results)
#   landcover   ws.landcover             (per-handle class fractions)
#   artifacts   ws.artifacts             (export/screenshot/table store)
#   answer      ws.last_answer           (the user-visible answer)
#   ui          ws.ui_state              (browser/UI session state)
#   rng         ws.rng                   (seeded noise-model stream)

#: Resource name -> the ``Workspace`` attribute it denotes. This is the
#: structured form of the table above, consumed by the static effects
#: race detector (``repro.analysis.effects_check``): any handler access
#: to one of these attributes must be covered by the tool's declared
#: ``ToolEffects`` entry.
WORKSPACE_RESOURCE_ATTRS: Dict[str, str] = {
    "handles": "handles",
    "map": "map_layers",
    "detections": "detections",
    "landcover": "landcover",
    "artifacts": "artifacts",
    "answer": "last_answer",
    "ui": "ui_state",
    "rng": "rng",
}

#: Workspace attributes that are read-only configuration at tool-
#: execution time (no tool may write them), hence outside the hazard
#: alphabet: reads of these can never order two tools.
READONLY_WORKSPACE_ATTRS = frozenset({"world", "temperature"})

assert frozenset(WORKSPACE_RESOURCE_ATTRS) == WORKSPACE_RESOURCES


def _eff(reads: str = "", writes: str = "") -> ToolEffects:
    return ToolEffects(frozenset(reads.split()), frozenset(writes.split()))


TOOL_EFFECTS: Dict[str, ToolEffects] = {
    # SQL_apis: pure catalog reads — never hazard with anything
    "sql_query_images":   _eff(),
    "sql_query_regions":  _eff(),
    "sql_count":          _eff(),
    "sql_distinct":       _eff(),
    "sql_sample":         _eff(),
    # data_apis
    "load_images":        _eff(writes="handles"),
    "filter_clouds":      _eff(reads="handles", writes="handles"),
    "filter_date":        _eff(reads="handles", writes="handles"),
    "mosaic":             _eff(reads="handles", writes="artifacts"),
    "reproject":          _eff(reads="handles", writes="artifacts"),
    "compute_ndvi":       _eff(reads="handles", writes="artifacts"),
    "band_math":          _eff(reads="handles", writes="artifacts"),
    "export_geotiff":     _eff(reads="handles", writes="artifacts"),
    # map_apis
    "plot_map":           _eff(reads="handles", writes="map"),
    "add_layer":          _eff(writes="map"),
    "draw_bboxes":        _eff(writes="map"),
    "heatmap":            _eff(writes="map"),
    "plot_histogram":     _eff(writes="map"),
    "plot_timeseries":    _eff(writes="map"),
    "screenshot_map":     _eff(reads="map", writes="artifacts"),
    # detect_apis (model-backed: seeded noise => rng writers)
    "detect_objects":     _eff(reads="handles", writes="detections rng"),
    "count_objects":      _eff(reads="handles", writes="detections rng"),
    "change_detection":   _eff(writes="rng"),
    "suggest_model":      _eff(),
    # landcover_apis
    "classify_landcover": _eff(reads="handles", writes="landcover rng"),
    "landcover_stats":    _eff(reads="landcover", writes="answer"),
    "compare_landcover":  _eff(),
    # vqa_apis / vision_apis (model-backed)
    "visual_qa":          _eff(reads="handles", writes="answer rng"),
    "caption_image":      _eff(reads="handles", writes="answer rng"),
    "compare_images_qa":  _eff(reads="handles", writes="answer rng"),
    "describe_scene":     _eff(reads="handles", writes="answer rng"),
    "ground_phrase":      _eff(),
    # web_apis
    "web_search":         _eff(),
    "open_url":           _eff(writes="ui answer"),
    "download_file":      _eff(writes="artifacts"),
    "post_form":          _eff(writes="artifacts"),
    # UI_apis
    "ui_click":           _eff(writes="ui"),
    "ui_type":            _eff(writes="ui"),
    "ui_scroll":          _eff(writes="ui"),
    "ui_read":            _eff(writes="ui"),
    "ui_open_panel":      _eff(writes="ui"),
    # wiki_apis
    "wiki_search":        _eff(),
    "wiki_get":           _eff(writes="answer rng"),
    "wiki_summarize":     _eff(writes="answer rng"),
    # speech_apis
    "transcribe_audio":   _eff(writes="answer rng"),
    "translate_audio":    _eff(writes="answer rng"),
    # code_apis
    "run_python":         _eff(writes="artifacts"),
    "tabulate":           _eff(writes="artifacts"),
}


# Fail fast at import if the effects table drifts from the catalog:
# exact 1:1 registry<->effects coverage, alphabet-only resource names
# (the runtime mirror of repro.analysis RL004/RL005).
validate_effects(DEFAULT_REGISTRY, TOOL_EFFECTS)


#: Per-family effects for generated catalog tools (core/catalog.py):
#: every member of a family shares its footprint. The effects race
#: detector runs a second pass over ``_execute_family`` keyed on this
#: table (repro.analysis.effects_check with name_param="family"), so a
#: family handler that drifts from its declaration fails the analyzer
#: exactly like a hand-written tool would.
CATALOG_FAMILY_EFFECTS: Dict[str, ToolEffects] = {
    "catalogue": _eff(),
    "ingest":    _eff(reads="handles", writes="handles"),
    "carto":     _eff(writes="map"),
    "detector":  _eff(reads="handles", writes="detections rng"),
    "terrain":   _eff(reads="handles", writes="landcover rng"),
    "scene":     _eff(reads="handles", writes="answer rng"),
    "webnav":    _eff(writes="ui"),
    "corpus":    _eff(writes="answer rng"),
    "audio":     _eff(writes="answer rng"),
    "notebook":  _eff(writes="artifacts"),
}

# the family specs (core/catalog.py) and this literal must agree — the
# literal exists so the static analyzer can parse it, the spec so the
# catalog module stays self-describing
assert set(CATALOG_FAMILY_EFFECTS) == {f.name for f in FAMILIES}
for _fam in FAMILIES:
    assert CATALOG_FAMILY_EFFECTS[_fam.name] == _eff(_fam.reads,
                                                     _fam.writes), _fam.name


def tool_effects(name: str) -> ToolEffects:
    """Effects lookup for the compiler; generated catalog tools resolve
    through their family footprint; unknown tools raise ToolError
    (mirrors ``execute_tool`` semantics at compile time)."""
    eff = TOOL_EFFECTS.get(name)
    if eff is not None:
        return eff
    family = family_of(name)
    if family is not None:
        return CATALOG_FAMILY_EFFECTS[family]
    raise ToolError(f"unknown tool: {name}")


def catalog_effects(registry: ToolRegistry) -> Dict[str, ToolEffects]:
    """The exact per-tool effects table of a generated catalog registry
    (base entries + family footprints) — what
    ``core.tools.validate_effects`` checks 1:1 against the registry."""
    return {name: tool_effects(name) for name in registry.tools}


@dataclass(frozen=True)
class NodeObservation:
    """One executed node's result, addressed for reconciliation."""
    node_id: int
    tool: str
    text: str                 # "{tool} -> {obs}" or "{tool} -> ERROR: .."
    ok: bool


def _run_node(ws: Workspace, node) -> NodeObservation:
    try:
        out = execute_tool(ws, node.tool, node.args)
        return NodeObservation(node.node_id, node.tool,
                               f"{node.tool} -> {out}", True)
    except ToolError as e:
        # an erroring node does NOT cancel its dependents: the linear
        # agent loop executes every call of a step regardless of earlier
        # errors, and fused execution must be observation-equivalent.
        # Tools guard their own preconditions (E1xx errors).
        return NodeObservation(node.node_id, node.tool,
                               f"{node.tool} -> ERROR: {e}", False)


def execute_graph(ws: Workspace, graph) -> List[NodeObservation]:
    """Execute one session's compiled graph in topological waves.

    Within a wave nodes run in ascending node-id order; observations are
    returned sorted by node id (= planner emission order) regardless of
    wave placement, so reconciliation is schedule-independent. Hazard
    deps guarantee the end state is bitwise identical to sequential
    emission-order execution (DESIGN.md §Tool-graph compiler).
    """
    out: List[NodeObservation] = []
    for wave in graph.wave_schedule():
        for nid in wave:
            out.append(_run_node(ws, graph.node(nid)))
    out.sort(key=lambda o: o.node_id)
    return out


def execute_graph_batch(entries: Sequence[Tuple[int, Workspace, Any]]
                        ) -> Dict[int, List[NodeObservation]]:
    """Fused cross-session execution: one batched run over the graphs of
    many co-resident sessions.

    ``entries`` is ``(session_key, workspace, graph)`` triples. Wave w
    of the batch executes every session's wave-w nodes in ``(session
    key, node id)`` order — the documented, stable observation order; the
    returned dict maps each session key to its observations sorted by
    node id, bitwise identical to running ``execute_graph`` per session
    alone (workspaces are disjoint, so sessions cannot hazard with each
    other).

    Hazard detection on shared state: duplicate session keys or two
    entries aliasing one ``Workspace`` object raise
    ``WorkspaceHazardError`` before anything executes.
    """
    seen_keys: set = set()
    seen_ws: Dict[int, int] = {}
    for key, ws, _ in entries:
        if key in seen_keys:
            raise WorkspaceHazardError(
                f"duplicate session key {key} in fused batch")
        seen_keys.add(key)
        if id(ws) in seen_ws:
            raise WorkspaceHazardError(
                f"sessions {seen_ws[id(ws)]} and {key} share one "
                f"Workspace — fused waves would interleave hazards")
        seen_ws[id(ws)] = key

    ordered = sorted(entries, key=lambda e: e[0])
    schedules = [(key, ws, graph, graph.wave_schedule())
                 for key, ws, graph in ordered]
    results: Dict[int, List[NodeObservation]] = {
        key: [] for key, _, _, _ in schedules}
    n_waves = max((len(s) for _, _, _, s in schedules), default=0)
    for w in range(n_waves):
        for key, ws, graph, sched in schedules:
            if w < len(sched):
                for nid in sched[w]:
                    results[key].append(_run_node(ws, graph.node(nid)))
    for key in results:
        results[key].sort(key=lambda o: o.node_id)
    return results
