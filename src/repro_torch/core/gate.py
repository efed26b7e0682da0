"""GeckOpt runtime intent gate.

One extra (cheap) LLM call per query classifies intent and selects the
relevant API libraries BEFORE any tool-specific prompting. The classifier
backend is pluggable:

  * ScriptedIntentClassifier — GPT-4-proxy with a calibrated accuracy
    (keyword-matching plus seeded confusion), used by the Table-2 harness;
  * NeuralIntentClassifier — our own served planner-proxy model with a
    constrained intent head;
  * BatchedNeuralIntentClassifier — same decisions, but all queries of a
    pipeline admission wave scored in ONE batched forward pass
    (serving/neural_planner.py).

Classifiers expose ``classify(query)`` and optionally
``classify_batch(queries)``; ``IntentGate.batch`` uses the batched
entry point when present so the serving pipeline amortizes the gate
model call across concurrent sessions. The gate prompt is real text and
is charged to each session's ledger either way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.accounting import TokenLedger
from repro_torch.core.intents import INTENT_DESCRIPTIONS, INTENTS, IntentMap

GATE_SYSTEM = (
    "You are the intent router of a geospatial Copilot platform. "
    "Classify the user query into exactly one intent and reply with the "
    "intent name only.\nIntents:\n" + "\n".join(
        f"- {k}: {v}" for k, v in INTENT_DESCRIPTIONS.items()))

_KEYWORDS = {
    "load_filter_plot": ("plot", "show", "map", "display", "visualize"),
    "detection_analysis": ("how many", "detect", "count", "detection",
                           "bounding"),
    "landcover_analysis": ("land cover", "landcover", "dominant",
                           "vegetation", "fraction"),
    "information_seeking": ("look up", "summarize what we know", "wiki",
                            "knowledge base"),
    "ui_web_navigation": ("search the web", "open", "browse", "click",
                          "navigate", "bing"),
    "visual_qa": ("describe", "what is shown", "is there", "question about"),
    "speech_transcription": ("transcribe", "audio", "speech", "recording"),
    "code_analysis": ("tabulate", "table", "script", "python"),
}


def keyword_intent(query: str) -> str:
    q = query.lower()
    best, score = "load_filter_plot", 0
    for intent, kws in _KEYWORDS.items():
        s = sum(1 for kw in kws if kw in q)
        if s > score:
            best, score = intent, s
    return best


@dataclass
class ScriptedIntentClassifier:
    accuracy: float = 0.97
    rng: np.random.Generator = None

    def __post_init__(self):
        if self.rng is None:
            self.rng = np.random.default_rng(0)

    def classify(self, query: str) -> Tuple[str, str]:
        """Returns (intent, completion_text)."""
        intent = keyword_intent(query)
        if self.rng.random() > self.accuracy:
            others = [i for i in INTENTS if i != intent]
            intent = others[int(self.rng.integers(0, len(others)))]
        return intent, intent

    def classify_batch(self, queries: Sequence[str]
                       ) -> List[Tuple[str, str]]:
        """Batched entry point; draws from the SAME rng stream in query
        order, so a wave-batched run reproduces the sequential one."""
        return [self.classify(q) for q in queries]


def gate_prompt(query: str) -> str:
    """The serialized gate request (what the ledger charges)."""
    return f"{GATE_SYSTEM}\n\nQuery: {query}\nIntent:"


class IntentGate:
    def __init__(self, intent_map: IntentMap, classifier,
                 all_libraries: Sequence[str]):
        self.intent_map = intent_map
        self.classifier = classifier
        self.all_libraries = tuple(all_libraries)

    def __call__(self, query: str, ledger: TokenLedger
                 ) -> Tuple[str, Tuple[str, ...]]:
        intent, completion = self.classifier.classify(query)
        ledger.record("gate", gate_prompt(query), completion)
        libs = self.intent_map.libraries_for(intent, self.all_libraries)
        return intent, libs

    def batch(self, queries: Sequence[str], ledgers: Sequence[TokenLedger]
              ) -> List[Tuple[str, Tuple[str, ...]]]:
        """Gate a whole admission wave. Uses the classifier's batched
        forward when it has one; token accounting is identical to the
        per-query path (each session is charged its own gate prompt)."""
        assert len(queries) == len(ledgers)
        if hasattr(self.classifier, "classify_batch"):
            decisions = self.classifier.classify_batch(queries)
        else:
            decisions = [self.classifier.classify(q) for q in queries]
        out = []
        for query, ledger, (intent, completion) in zip(queries, ledgers,
                                                       decisions):
            ledger.record("gate", gate_prompt(query), completion)
            out.append((intent,
                        self.intent_map.libraries_for(
                            intent, self.all_libraries)))
        return out
