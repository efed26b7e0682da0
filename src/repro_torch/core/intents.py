"""Intent taxonomy + offline intent→library mapping (paper Table 1).

The offline phase maps task intents to API-library subsets "with minimal
human involvement": ``build_intent_map`` mines a labeled task corpus (the
synthetic GeoLLM-Engine task generator provides one) and keeps every
library whose tools appear in ≥ coverage_q of that intent's ground-truth
plans — reproducing the paper's offline step rather than hard-coding it.
The hand-written Table-1 mapping is kept as ``TABLE1_MAP`` for reference
and asserted (in tests) to agree with the mined map on the paper's three
intent families.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

INTENTS = (
    "load_filter_plot",      # paper: "Load→Filter→Plot"
    "ui_web_navigation",     # paper: "UI/Web Navigation"
    "information_seeking",   # paper: "Information Seeking"
    "detection_analysis",    # GeoLLM-Engine detection/counting tasks
    "landcover_analysis",    # land-cover classification tasks
    "visual_qa",             # VQA tasks
    "speech_transcription",  # audio backend tasks
    "code_analysis",         # tabulation / scripting tasks
)

# Paper Table 1 (plus the additional GeoLLM-Engine families).
TABLE1_MAP: Dict[str, Tuple[str, ...]] = {
    "load_filter_plot": ("SQL_apis", "data_apis", "map_apis"),
    "ui_web_navigation": ("web_apis", "UI_apis"),
    "information_seeking": ("wiki_apis",),
    "detection_analysis": ("SQL_apis", "data_apis", "detect_apis",
                           "map_apis"),
    "landcover_analysis": ("SQL_apis", "data_apis", "landcover_apis"),
    "visual_qa": ("SQL_apis", "data_apis", "vqa_apis", "vision_apis"),
    "speech_transcription": ("speech_apis", "wiki_apis"),
    "code_analysis": ("code_apis", "SQL_apis"),
}


@dataclass
class IntentMap:
    intent_to_libs: Dict[str, Tuple[str, ...]]

    def libraries_for(self, intent: str,
                      full_fallback: Sequence[str] = ()) -> Tuple[str, ...]:
        return self.intent_to_libs.get(intent, tuple(full_fallback))


def build_intent_map(task_corpus, registry, coverage_q: float = 0.98
                     ) -> IntentMap:
    """Mine intent→library mapping from (intent, ground-truth plan) pairs.

    Keeps the smallest library set covering ≥ coverage_q of each intent's
    observed tool calls (the paper's offline phase).
    """
    lib_of = {name: t.library for name, t in registry.tools.items()}
    per_intent_calls: Dict[str, Counter] = defaultdict(Counter)
    per_intent_total: Dict[str, int] = defaultdict(int)
    for task in task_corpus:
        for stage in task.plan:
            for call in stage:
                lib = lib_of.get(call.tool)
                if lib:
                    per_intent_calls[task.intent][lib] += 1
                    per_intent_total[task.intent] += 1
    mapping = {}
    for intent, counts in per_intent_calls.items():
        total = per_intent_total[intent]
        libs: List[str] = []
        covered = 0
        for lib, c in counts.most_common():
            libs.append(lib)
            covered += c
            if covered >= coverage_q * total:
                break
        mapping[intent] = tuple(sorted(libs))
    return IntentMap(mapping)


INTENT_DESCRIPTIONS = {
    "load_filter_plot": "load imagery from the catalog, filter it, and "
                        "visualize on a map",
    "ui_web_navigation": "navigate the web or application UI",
    "information_seeking": "look up factual information in the knowledge "
                           "base",
    "detection_analysis": "detect, count or compare objects in imagery",
    "landcover_analysis": "classify or compare land cover",
    "visual_qa": "answer questions about image content",
    "speech_transcription": "transcribe or translate audio",
    "code_analysis": "tabulate results or run analysis code",
}
