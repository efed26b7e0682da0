"""Scalable synthetic tool catalog: seeded generation of 8–512-tool
registries.

The paper's platform carries a ~dozen-library catalog; production
copilots carry hundreds of tools. This module scales the registry the
way such platforms grow — by adding tool *families* (new API libraries
with many near-duplicate endpoints) around the hand-written core — so
retrieval (core/retriever.py) has a realistically crowded catalog to
narrow.

Construction is fully deterministic: ``build_catalog(n, seed)`` is a
pure function of its arguments (names/descriptions drawn from one
seeded numpy rng in a fixed order), so two runs — or the CI gate and a
committed baseline — see byte-identical catalog text.

Sizing semantics:

  * ``n <= 48`` (the base registry): the first ``n`` base tools in
    registration order. SQL_apis registers first, so the planner's
    read-only derail pool is non-empty at every size (the behaviour
    model never divides by an empty toolset).
  * ``n > 48``: the full base registry plus ``n - 48`` generated tools,
    round-robin across the ten families below so every catalog size
    exercises every family.

Every generated tool is *dispatchable*: ``env/tools_impl.py`` backs
each family with a real handler branch (``_execute_family``) and a
``CATALOG_FAMILY_EFFECTS`` entry, so the effects race detector and
the tool-graph compiler cover generated tools exactly like hand-written
ones. Family name prefixes deliberately avoid the planner's derail-pool
prefixes (``sql_``/``wiki_``/``ui_read``/``suggest_``/``web_search``) —
growing the catalog must not change which tools the scripted planner
can wander to relative to the seed registry semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.intents import INTENTS, TABLE1_MAP, IntentMap
from repro_torch.core.tools import DEFAULT_REGISTRY, Tool, ToolRegistry


@dataclass(frozen=True)
class ToolFamily:
    """One generated API library: a name prefix, its home intent, and
    the uniform effects footprint every member tool declares (mirrored
    literally in ``env/tools_impl.CATALOG_FAMILY_EFFECTS`` for the
    static analyzer; an import-time assert keeps the two in sync)."""
    name: str                     # tool-name prefix + handler family
    library: str                  # registry library (``{name}_apis``)
    intent: str                   # the intent this family serves
    reads: str                    # space-separated hazard reads
    writes: str                   # space-separated hazard writes
    verbs: Tuple[str, ...]
    nouns: Tuple[str, ...]
    quals: Tuple[str, ...]        # seeded description qualifiers
    blurb: str                    # template over {verb}/{noun}/{qual}
    params: Tuple[Tuple[str, str, str], ...]


_HANDLE_PARAM = (("handles", "array", "workspace image handles"),)

FAMILIES: Tuple[ToolFamily, ...] = (
    ToolFamily(
        "catalogue", "catalogue_apis", "load_filter_plot",
        reads="", writes="",
        verbs=("list", "probe", "count", "inspect", "resolve", "scan",
               "index", "audit"),
        nouns=("granules", "footprints", "orbits", "archives", "swaths",
               "revisits", "quicklooks", "manifests"),
        quals=("acquisition", "staging", "mission", "ingest-queue"),
        blurb="{verb} the {noun} partition of the {qual} metadata "
              "catalog and return matching identifiers",
        params=(("filter", "string", "metadata filter expression"),)),
    ToolFamily(
        "ingest", "ingest_apis", "load_filter_plot",
        reads="handles", writes="handles",
        verbs=("stage", "dedupe", "trim", "align", "refresh", "subset",
               "validate", "order"),
        nouns=("rasters", "scenes", "tiles", "stacks", "batches",
               "mosaics", "strips", "chips"),
        quals=("loaded", "pending", "calibrated", "co-registered"),
        blurb="{verb} the {qual} {noun} held in the session workspace, "
              "updating the active handle set in place",
        params=_HANDLE_PARAM),
    ToolFamily(
        "carto", "carto_apis", "load_filter_plot",
        reads="", writes="map",
        verbs=("style", "overlay", "annotate", "shade", "contour",
               "label", "cluster", "symbolize"),
        nouns=("basemap", "choropleth", "hillshade", "graticule",
               "legend", "viewport", "isolines", "callouts"),
        quals=("interactive", "print-ready", "web-mercator", "tiled"),
        blurb="{verb} a {qual} {noun} layer onto the current map view",
        params=(("layer", "string", "layer name or handle"),)),
    ToolFamily(
        "detector", "detector_apis", "detection_analysis",
        reads="handles", writes="detections rng",
        verbs=("localize", "screen", "flag", "triage", "score",
               "enumerate", "verify", "sweep"),
        nouns=("vessels", "aircraft", "structures", "vehicles",
               "containers", "pads", "spans", "derricks"),
        quals=("high-recall", "low-latency", "ensemble", "cascade"),
        blurb="{verb} {noun} in the loaded imagery with the {qual} "
              "detector checkpoint; results land in the detection store",
        params=_HANDLE_PARAM),
    ToolFamily(
        "terrain", "terrain_apis", "landcover_analysis",
        reads="handles", writes="landcover rng",
        verbs=("grade", "segment", "profile", "bin", "rate", "survey",
               "stratify", "partition"),
        nouns=("slopes", "canopy", "wetlands", "parcels", "surfaces",
               "basins", "ridgelines", "floodplains"),
        quals=("per-pixel", "regional", "seasonal", "multi-temporal"),
        blurb="{verb} {noun} cover with the {qual} terrain model and "
              "store class fractions per handle",
        params=_HANDLE_PARAM),
    ToolFamily(
        "scene", "scene_apis", "visual_qa",
        reads="handles", writes="answer rng",
        verbs=("narrate", "interpret", "summarize", "assess", "answer",
               "explain", "review", "brief"),
        nouns=("context", "activity", "layout", "condition", "usage",
               "composition", "changes", "anomalies"),
        quals=("grounded", "concise", "analyst-grade", "multi-image"),
        blurb="{verb} the {noun} of a workspace image in {qual} natural "
              "language via the vision-language backend",
        params=(("handle", "string", "image handle"),)),
    ToolFamily(
        "webnav", "webnav_apis", "ui_web_navigation",
        reads="", writes="ui",
        verbs=("focus", "toggle", "drag", "hover", "pin", "expand",
               "dismiss", "snap"),
        nouns=("sidebar", "workbench", "inspector", "breadcrumb",
               "modal", "toolbar", "minimap", "console"),
        quals=("application", "dashboard", "review", "browser"),
        blurb="{verb} the {noun} element of the {qual} surface and "
              "record the interaction in the UI session state",
        params=(("target", "string", "element label or selector"),)),
    ToolFamily(
        "corpus", "corpus_apis", "information_seeking",
        reads="", writes="answer rng",
        verbs=("digest", "excerpt", "cite", "collate", "trace",
               "cross_reference", "abstract", "curate"),
        nouns=("briefings", "glossaries", "bulletins", "datasheets",
               "advisories", "gazetteers", "almanacs", "dossiers"),
        quals=("curated", "versioned", "authoritative", "indexed"),
        blurb="{verb} {noun} from the {qual} knowledge corpus into a "
              "sourced textual answer",
        params=(("topic", "string", "lookup topic"),)),
    ToolFamily(
        "audio", "audio_apis", "speech_transcription",
        reads="", writes="answer rng",
        verbs=("segment", "diarize", "caption", "denoise", "timestamp",
               "summarize", "detect_language", "align"),
        nouns=("briefing", "standup", "interview", "broadcast",
               "voicemail", "fieldnote", "readout", "debrief"),
        quals=("multi-speaker", "noisy-channel", "long-form", "archived"),
        blurb="{verb} a {qual} {noun} recording through the speech "
              "backend and return the text",
        params=(("clip", "string", "audio clip id"),)),
    ToolFamily(
        "notebook", "notebook_apis", "code_analysis",
        reads="", writes="artifacts",
        verbs=("chart", "pivot", "export", "snapshot", "diff",
               "profile", "render", "bundle"),
        nouns=("metrics", "ledgers", "rollups", "matrices", "notebooks",
               "reports", "extracts", "summaries"),
        quals=("reproducible", "sandboxed", "scheduled", "pinned"),
        blurb="{verb} workspace {noun} into a {qual} analysis artifact",
        params=(("spec", "string", "analysis specification"),)),
)

FAMILY_NAMES: Tuple[str, ...] = tuple(f.name for f in FAMILIES)

#: intent -> generated libraries serving it (alongside TABLE1_MAP)
_FAMILY_LIBS_BY_INTENT: Dict[str, Tuple[str, ...]] = {
    intent: tuple(sorted(f.library for f in FAMILIES
                         if f.intent == intent))
    for intent in sorted({f.intent for f in FAMILIES})
}

N_BASE_TOOLS = len(DEFAULT_REGISTRY.tools)

# derail-pool prefixes the scripted planner wanders to
# (core/planner.py); generated names must never collide with them
_DERAIL_PREFIXES = ("sql_", "wiki_", "ui_read", "suggest_", "web_search")
assert not any(f"{f.name}_".startswith(p) or p.startswith(f"{f.name}_")
               for f in FAMILIES for p in _DERAIL_PREFIXES)
assert all(f.intent in INTENTS for f in FAMILIES)


def family_of(name: str) -> Optional[str]:
    """The generated family a tool name belongs to, else None (base
    tools and unknown names)."""
    for fam in FAMILIES:
        if name.startswith(fam.name + "_"):
            return fam.name
    return None


def _generated_tool(fam: ToolFamily, index: int,
                    rng: np.random.Generator) -> Tool:
    """The ``index``-th member of a family; the verb/noun grid gives 64
    distinct names per family, an index suffix extends past that."""
    verb = fam.verbs[index % len(fam.verbs)]
    noun = fam.nouns[(index // len(fam.verbs)) % len(fam.nouns)]
    name = f"{fam.name}_{verb}_{noun}"
    if index >= len(fam.verbs) * len(fam.nouns):
        name = f"{name}_{index:03d}"
    qual = fam.quals[int(rng.integers(0, len(fam.quals)))]
    desc = fam.blurb.format(verb=verb.replace("_", " "),
                            noun=noun, qual=qual)
    return Tool(name, fam.library, desc, fam.params)


def build_catalog(n_tools: int, seed: int = 0) -> ToolRegistry:
    """A deterministic registry of exactly ``n_tools`` tools (see the
    module docstring for sizing semantics). Same ``(n_tools, seed)`` ⇒
    byte-identical ``catalog_text()``."""
    if n_tools < 1:
        raise ValueError(f"build_catalog needs n_tools >= 1, "
                         f"got {n_tools}")
    base = list(DEFAULT_REGISTRY.tools.values())   # registration order
    reg = ToolRegistry()
    for tool in base[:n_tools]:
        reg.register(tool)
    if n_tools <= len(base):
        return reg
    rng = np.random.default_rng(seed)
    counts = [0] * len(FAMILIES)
    for j in range(n_tools - len(base)):
        fam_idx = j % len(FAMILIES)
        reg.register(_generated_tool(FAMILIES[fam_idx], counts[fam_idx],
                                     rng))
        counts[fam_idx] += 1
    return reg


def catalog_intent_libraries(registry: ToolRegistry
                             ) -> Dict[str, Tuple[str, ...]]:
    """Intent -> libraries *present in this registry*, extending the
    paper's Table-1 map with each generated family's home intent.
    Intents with no surviving library are omitted, so the gate falls
    back to the full catalog instead of emptying the visible toolset
    (a truncated registry must never make ``visible`` empty)."""
    present = set(registry.libraries())
    out: Dict[str, Tuple[str, ...]] = {}
    for intent in INTENTS:
        libs = (set(TABLE1_MAP.get(intent, ()))
                | set(_FAMILY_LIBS_BY_INTENT.get(intent, ()))) & present
        if libs:
            out[intent] = tuple(sorted(libs))
    return out


def catalog_intent_map(registry: ToolRegistry) -> IntentMap:
    """The ``IntentMap`` the gate and the retriever prior share for a
    generated catalog."""
    return IntentMap(catalog_intent_libraries(registry))
