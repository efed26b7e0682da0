"""Tool registry: API libraries and tool schemas (GeoLLM-Engine-style).

Every tool carries a JSON-schema-ish signature; serializing a catalog into
a planner prompt is what costs tokens — the quantity GeckOpt's gating
shrinks. Library names follow the paper's Table 1 (`SQL_apis`, `data_apis`,
`map_apis`, `web_apis`, `UI_apis`, `wiki_apis`) plus the remote-sensing
task suites GeoLLM-Engine exposes (detection, land-cover, VQA) and the
platform's modality backends (speech via whisper, vision via qwen2-vl).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.toolgraph import ToolEffects, WORKSPACE_RESOURCES


class EffectsCoverageError(Exception):
    """The registry and an effects table disagree — a tool without an
    effects entry (hazard inference would reject it at compile time) or
    an effects entry for no registered tool (dead declaration that can
    mask a rename), or an entry naming resources outside the hazard
    alphabet (dependencies silently not inferred)."""


@dataclass(frozen=True)
class Tool:
    name: str
    library: str
    description: str
    params: Tuple[Tuple[str, str, str], ...]   # (name, type, doc)
    returns: str = "object"

    def schema(self) -> Dict:
        return {
            "name": self.name,
            "description": self.description,
            "parameters": {
                "type": "object",
                "properties": {
                    p: {"type": t, "description": d}
                    for p, t, d in self.params},
                "required": [p for p, _, _ in self.params],
            },
            "returns": self.returns,
        }

    def serialize(self, compact: bool = True) -> str:
        """Compact catalog form (what production function-calling sends):
        name(params) + one-line description."""
        if compact:
            ps = ",".join(f"{p}:{t}" for p, t, _ in self.params)
            return f"{self.name}({ps}) — {self.description}"
        return json.dumps(self.schema(), separators=(",", ":"))


@dataclass
class ToolRegistry:
    tools: Dict[str, Tool] = field(default_factory=dict)

    def register(self, tool: Tool):
        assert tool.name not in self.tools, tool.name
        self.tools[tool.name] = tool

    def libraries(self) -> List[str]:
        return sorted({t.library for t in self.tools.values()})

    def by_library(self, libs: Sequence[str]) -> List[Tool]:
        libset = set(libs)
        return [t for t in self.tools.values() if t.library in libset]

    def catalog_text(self, libs: Optional[Sequence[str]] = None) -> str:
        tools = (list(self.tools.values()) if libs is None
                 else self.by_library(libs))
        return "\n".join(t.serialize() for t in
                         sorted(tools, key=lambda t: t.name))

    def get(self, name: str) -> Optional[Tool]:
        return self.tools.get(name)

    def names(self) -> List[str]:
        """Sorted tool names — the known-tool universe the tool-graph
        compiler validates node references against."""
        return sorted(self.tools)

    def validate_graph(self, graph):
        """Validate a ToolGraph against this catalog: typed
        ToolGraphError on unknown tools, dangling deps, duplicate node
        ids or cycles (core/toolgraph.py)."""
        return graph.validate(known_tools=self.names())


def validate_effects(registry: "ToolRegistry",
                     effects: Mapping[str, ToolEffects],
                     alphabet=WORKSPACE_RESOURCES) -> None:
    """Fail-fast cross-check of a registry against its effects table
    (the runtime mirror of the static analyzer's RL004/RL005 rules;
    ``env/tools_impl.py`` runs it at import time so a drifted table
    breaks immediately, not just under lint).

    Raises :class:`EffectsCoverageError` when coverage is not exactly
    1:1 or an entry names a resource outside the hazard alphabet.
    """
    problems: List[str] = []
    missing = sorted(set(registry.tools) - set(effects))
    extra = sorted(set(effects) - set(registry.tools))
    if missing:
        problems.append(f"registry tools without effects entry: {missing}")
    if extra:
        problems.append(f"effects entries for unregistered tools: {extra}")
    for name in sorted(effects):
        unknown = sorted(effects[name].unknown_resources(alphabet))
        if unknown:
            problems.append(
                f"{name}: effects name unknown resources {unknown} "
                f"(alphabet: {sorted(alphabet)})")
    if problems:
        raise EffectsCoverageError("; ".join(problems))


def _t(name, lib, desc, params, returns="object"):
    return Tool(name, lib, desc, tuple(params), returns)


def build_default_registry() -> ToolRegistry:
    """The platform's hand-written base catalog (docstring counts are
    derived below — see N_TOOLS/N_LIBRARIES — so they can never go
    stale as tools are added)."""
    r = ToolRegistry()
    P = lambda *ps: list(ps)

    # --- SQL_apis: metadata catalog queries --------------------------------
    for t in [
        _t("sql_query_images", "SQL_apis",
           "Query the image metadata catalog with filters on sensor, region, "
           "time range, cloud cover and resolution; returns image ids.",
           P(("sensor", "string", "sensor/dataset name e.g. xview1, sentinel2"),
             ("region", "string", "named region or bounding box"),
             ("date_from", "string", "ISO start date"),
             ("date_to", "string", "ISO end date"),
             ("max_cloud", "number", "max cloud-cover fraction"))),
        _t("sql_query_regions", "SQL_apis",
           "Resolve a place name to catalog region ids and bounding boxes.",
           P(("place", "string", "free-text place name"))),
        _t("sql_count", "SQL_apis",
           "Count catalog rows matching a filter expression.",
           P(("filter", "string", "SQL-like boolean filter"))),
        _t("sql_distinct", "SQL_apis",
           "List distinct values of a metadata column.",
           P(("column", "string", "metadata column name"))),
        _t("sql_sample", "SQL_apis",
           "Sample N catalog rows matching a filter.",
           P(("filter", "string", "SQL-like filter"),
             ("n", "integer", "sample size"))),
    ]:
        r.register(t)

    # --- data_apis: loading / filtering / processing -----------------------
    for t in [
        _t("load_images", "data_apis",
           "Load images by id list into the workspace; returns handles.",
           P(("image_ids", "array", "catalog image ids"))),
        _t("filter_clouds", "data_apis",
           "Drop workspace images above a cloud-cover threshold.",
           P(("handles", "array", "image handles"),
             ("max_cloud", "number", "threshold 0-1"))),
        _t("filter_date", "data_apis",
           "Keep workspace images inside a date range.",
           P(("handles", "array", "image handles"),
             ("date_from", "string", "ISO date"),
             ("date_to", "string", "ISO date"))),
        _t("mosaic", "data_apis",
           "Mosaic several overlapping images into one composite.",
           P(("handles", "array", "image handles"))),
        _t("reproject", "data_apis",
           "Reproject images to a target CRS.",
           P(("handles", "array", "image handles"),
             ("crs", "string", "target CRS e.g. EPSG:4326"))),
        _t("compute_ndvi", "data_apis",
           "Compute NDVI rasters for multispectral images.",
           P(("handles", "array", "image handles"))),
        _t("band_math", "data_apis",
           "Evaluate a band-arithmetic expression over images.",
           P(("handles", "array", "image handles"),
             ("expr", "string", "e.g. (B8-B4)/(B8+B4)"))),
        _t("export_geotiff", "data_apis",
           "Export workspace rasters as GeoTIFF artifacts.",
           P(("handles", "array", "image handles"))),
    ]:
        r.register(t)

    # --- map_apis: visualization -------------------------------------------
    for t in [
        _t("plot_map", "map_apis",
           "Render images/layers on an interactive map centered on a region.",
           P(("handles", "array", "image or layer handles"),
             ("region", "string", "center region"))),
        _t("add_layer", "map_apis",
           "Add a vector/raster overlay layer to the current map.",
           P(("layer", "string", "layer handle or name"))),
        _t("draw_bboxes", "map_apis",
           "Draw detection bounding boxes on the map.",
           P(("detections", "array", "detection result handle"))),
        _t("heatmap", "map_apis",
           "Render a density heatmap from point detections.",
           P(("detections", "array", "detection handles"))),
        _t("screenshot_map", "map_apis",
           "Capture the current map view as an image artifact.",
           P()),
        _t("plot_histogram", "map_apis",
           "Plot a histogram of a raster band or metadata column.",
           P(("source", "string", "handle or column"))),
        _t("plot_timeseries", "map_apis",
           "Plot a time series over images or detections.",
           P(("source", "string", "handle set"),
             ("metric", "string", "what to aggregate"))),
    ]:
        r.register(t)

    # --- detect_apis: remote-sensing model inference ------------------------
    for t in [
        _t("detect_objects", "detect_apis",
           "Run an object detector over images; returns boxes and classes.",
           P(("handles", "array", "image handles"),
             ("classes", "array", "object classes e.g. airplane, ship"))),
        _t("count_objects", "detect_apis",
           "Count detected objects per class over images.",
           P(("handles", "array", "image handles"),
             ("classes", "array", "object classes"))),
        _t("change_detection", "detect_apis",
           "Detect changes between two co-registered images.",
           P(("before", "string", "image handle"),
             ("after", "string", "image handle"))),
        _t("suggest_model", "detect_apis",
           "Recommend the best detector checkpoint for a class/sensor.",
           P(("task", "string", "detection task description"))),
    ]:
        r.register(t)

    # --- landcover_apis ------------------------------------------------------
    for t in [
        _t("classify_landcover", "landcover_apis",
           "Per-pixel land-cover classification (ESA classes).",
           P(("handles", "array", "image handles"))),
        _t("landcover_stats", "landcover_apis",
           "Aggregate land-cover class fractions over a region.",
           P(("handles", "array", "classified raster handles"))),
        _t("compare_landcover", "landcover_apis",
           "Compare land-cover fractions between two dates.",
           P(("a", "string", "classified handle"),
             ("b", "string", "classified handle"))),
    ]:
        r.register(t)

    # --- vqa_apis -------------------------------------------------------------
    for t in [
        _t("visual_qa", "vqa_apis",
           "Answer a free-text question about an image.",
           P(("handle", "string", "image handle"),
             ("question", "string", "the question"))),
        _t("caption_image", "vqa_apis",
           "Generate a caption for an image.",
           P(("handle", "string", "image handle"))),
        _t("compare_images_qa", "vqa_apis",
           "Answer a question comparing two images.",
           P(("a", "string", "image handle"), ("b", "string", "image handle"),
             ("question", "string", "the question"))),
    ]:
        r.register(t)

    # --- web_apis -------------------------------------------------------------
    for t in [
        _t("web_search", "web_apis",
           "Search the web; returns result titles, urls and snippets.",
           P(("query", "string", "search query"))),
        _t("open_url", "web_apis",
           "Fetch a web page and return its readable text.",
           P(("url", "string", "absolute URL"))),
        _t("download_file", "web_apis",
           "Download a file from a URL into the workspace.",
           P(("url", "string", "absolute URL"))),
        _t("post_form", "web_apis",
           "Submit a form on the current page.",
           P(("fields", "object", "form field values"))),
    ]:
        r.register(t)

    # --- UI_apis ---------------------------------------------------------------
    for t in [
        _t("ui_click", "UI_apis",
           "Click a UI element by accessibility label.",
           P(("label", "string", "element label"))),
        _t("ui_type", "UI_apis",
           "Type text into a focused UI field.",
           P(("text", "string", "text to type"))),
        _t("ui_scroll", "UI_apis",
           "Scroll the active view.",
           P(("direction", "string", "up|down|left|right"))),
        _t("ui_read", "UI_apis",
           "Read the text content of a UI element.",
           P(("label", "string", "element label"))),
        _t("ui_open_panel", "UI_apis",
           "Open a named application panel.",
           P(("panel", "string", "panel name"))),
    ]:
        r.register(t)

    # --- wiki_apis ---------------------------------------------------------------
    for t in [
        _t("wiki_search", "wiki_apis",
           "Search the knowledge base; returns article titles.",
           P(("query", "string", "search query"))),
        _t("wiki_get", "wiki_apis",
           "Fetch a knowledge-base article body.",
           P(("title", "string", "article title"))),
        _t("wiki_summarize", "wiki_apis",
           "Summarize a knowledge-base article.",
           P(("title", "string", "article title"))),
    ]:
        r.register(t)

    # --- speech_apis (whisper backend) -------------------------------------------
    for t in [
        _t("transcribe_audio", "speech_apis",
           "Transcribe an audio clip (whisper backend).",
           P(("clip", "string", "audio clip id"))),
        _t("translate_audio", "speech_apis",
           "Translate foreign speech to English text (whisper backend).",
           P(("clip", "string", "audio clip id"))),
    ]:
        r.register(t)

    # --- vision_apis (qwen2-vl backend) --------------------------------------------
    for t in [
        _t("describe_scene", "vision_apis",
           "Detailed scene description via the VLM backend.",
           P(("handle", "string", "image handle"))),
        _t("ground_phrase", "vision_apis",
           "Locate a phrase in an image; returns a box (VLM backend).",
           P(("handle", "string", "image handle"),
             ("phrase", "string", "referring expression"))),
    ]:
        r.register(t)

    # --- code_apis --------------------------------------------------------------------
    for t in [
        _t("run_python", "code_apis",
           "Execute a short python snippet over workspace artifacts.",
           P(("code", "string", "python source"))),
        _t("tabulate", "code_apis",
           "Render a list of records as a table artifact.",
           P(("records", "array", "list of objects"))),
    ]:
        r.register(t)

    return r


DEFAULT_REGISTRY = build_default_registry()

#: registry counts, derived — the hand-maintained "12 libraries, 48
#: tools" literals this module (and the intents/serving docstrings)
#: used to carry went stale the moment the catalog grew; anything that
#: needs the numbers reads these
N_TOOLS = len(DEFAULT_REGISTRY.tools)
N_LIBRARIES = len(DEFAULT_REGISTRY.libraries())
build_default_registry.__doc__ = (
    f"The platform's base catalog: {N_LIBRARIES} libraries, "
    f"{N_TOOLS} tools (counts derived from the registry itself; "
    f"core/catalog.py scales past this with generated families).")
