"""Embedding-based tool retrieval: expose top-k relevant tools per
query, with the gated intent as a fused reranking prior.

GeckOpt narrows the prompt catalog by intent→library mapping; at
hundreds of tools even one intent's libraries are too wide to serialize
per request. This layer retrieves a small per-query toolset by text
similarity — a seeded-deterministic stand-in for the vector-store tool
selection of Semantic Tool Discovery / ITR — and fuses the gate's
intent decision as a score prior (*gate augmentation, not
replacement*: the gate still decides ``visible``; retrieval only
decides which tool schemas are serialized into the prompt).

Determinism: the embedder is a hash-feature char-n-gram featurizer
(``zlib.crc32``, not Python's salted ``hash``), scoring is one
cosine+prior product batched over the admission wave like
``IntentGate.batch``, and ranking ties break on tool id — so the full
ranking is a pure function of (catalog text, query, intent).

The port scores on the retriever's device (the card unless the caller
passes ``device="cpu"``) in fp32 with TF32 off for the product; the
ranking, its tool-id tie-break and everything after it run on the host,
as in the JAX package. The scores of a batched and a single-query call
may differ in the last bits (other product shapes), so the two rankings
can differ deep in the tail where scores are nearly equal; the exposed
top-k of a retrieval is what the serving path reads.

``ToolsetExposure`` is the serving object a retrieval produces: the
full ranking plus the current exposure width ``k``. Its sorted exposed
tool-id tuple is the canonical ``toolset_key``; ``key_str`` is the
stable engine prefix-cache key (sessions retrieving the same toolset
share one prefix prefill and its paged CoW blocks, and the cluster
rendezvous-routes the key like an intent prefix). ``widen_once`` is
the deterministic miss-and-widen fallback: if the planner emits a call
outside the exposed set (``TOOL_NOT_RETRIEVED``), the agent doubles
``k`` until the call is covered, charging each escalation to the
ledger — task outcomes stay bitwise identical to all-tools-exposed
because the planner's behaviour model never reads the catalog text
(DESIGN.md §Tool retrieval).
"""
from __future__ import annotations

import hashlib
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tools import ToolRegistry
from repro_torch.models.model import resolve_device


def _fused_scores(queries: torch.Tensor, tools: torch.Tensor,
                  prior: torch.Tensor, prior_weight: float
                  ) -> torch.Tensor:
    """(B, D) query feats × (N, D) tool feats -> (B, N) fused scores:
    cosine similarity plus the per-intent library prior, fp32 (TF32 off
    for the product)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qn = queries / torch.clamp(
        torch.linalg.vector_norm(queries, dim=-1, keepdim=True), min=1e-6)
    tn = tools / torch.clamp(
        torch.linalg.vector_norm(tools, dim=-1, keepdim=True), min=1e-6)
    return qn @ tn.T + prior_weight * prior


class HashedNgramEmbedder:
    """Character n-gram feature hashing into a fixed dim — the cheapest
    embedder that still separates tool schemas by vocabulary. crc32 is
    process-stable (Python's ``hash`` is salted per process, which
    would break cross-run determinism)."""

    def __init__(self, dim: int = 256, n: int = 3):
        assert dim > 0 and n > 0
        self.dim = dim
        self.n = n

    def featurize(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        s = f" {text.lower()} "
        for i in range(len(s) - self.n + 1):
            gram = s[i:i + self.n]
            v[zlib.crc32(gram.encode("utf-8")) % self.dim] += 1.0
        return v

    def featurize_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self.featurize(t) for t in texts])


@dataclass
class ToolsetExposure:
    """One query's retrieved toolset: the catalog-wide ranking plus the
    current exposure width (``k`` grows under miss-and-widen, never
    shrinks — sticky within a session)."""
    ranking: List[str]            # full deterministic catalog ranking
    k0: int                       # requested top-k
    k: int = field(init=False)    # current exposure width
    widens: int = 0               # miss-and-widen escalations taken

    def __post_init__(self):
        self.k0 = max(1, min(self.k0, len(self.ranking)))
        self.k = self.k0

    @property
    def exposed(self) -> Tuple[str, ...]:
        """Canonical toolset_key: the exposed tool ids, sorted — the
        identity the engine prefix cache and cluster router share."""
        return tuple(sorted(self.ranking[:self.k]))

    toolset_key = exposed

    @property
    def key_str(self) -> str:
        """Stable string form for engine/cluster prefix registries
        (sha1 of the sorted id tuple — identical across processes and
        machines, unlike ``hash``)."""
        digest = hashlib.sha1(
            ",".join(self.exposed).encode("utf-8")).hexdigest()[:16]
        return f"toolset:{digest}"

    def covers(self, tools) -> bool:
        exposed = set(self.ranking[:self.k])
        return all(t in exposed for t in tools)

    def widen_once(self) -> None:
        """One deterministic k-escalation (k doubles, capped at the
        catalog size)."""
        self.k = min(len(self.ranking), max(self.k * 2, self.k + 1))
        self.widens += 1

    def widen_full(self) -> None:
        """Jump straight to the full catalog (the TOOL_NOT_FOUND
        full-catalog fallback path; not counted as a retrieval miss)."""
        self.k = len(self.ranking)

    def catalog_text(self, registry: ToolRegistry) -> str:
        """Serialized exposed subset, sorted by tool name — at k == n
        this is byte-identical to ``registry.catalog_text()``, which is
        what makes the full-catalog fallback exact."""
        return "\n".join(registry.tools[n].serialize()
                         for n in self.exposed)


class ToolRetriever:
    """Top-k tool retrieval over one catalog registry.

    Scoring = cosine(query n-grams, tool schema n-grams) +
    ``prior_weight`` × per-intent library prior (1.0 for tools whose
    library serves the gated intent, else 0.0; unknown/ungated intents
    get a zero prior row). Ranking sorts the full catalog by
    ``(-score, tool id)`` — the tie-break keeps equal-scored tools in
    deterministic id order at any catalog size. ``device``: where the
    scores are computed (default cuda; no card raises).
    """

    def __init__(self, registry: ToolRegistry,
                 intent_libs: Mapping[str, Sequence[str]],
                 k: int = 16, prior_weight: float = 0.25,
                 embedder: Optional[HashedNgramEmbedder] = None,
                 device=None):
        assert k >= 1
        self.device = resolve_device(device)
        self.registry = registry
        self.k = k
        self.prior_weight = float(prior_weight)
        self.embedder = embedder or HashedNgramEmbedder()
        self.names: Tuple[str, ...] = tuple(registry.names())  # sorted
        texts = [registry.tools[n].serialize() for n in self.names]
        self._tool_feats = torch.as_tensor(
            self.embedder.featurize_batch(texts), device=self.device)
        self.intents: Tuple[str, ...] = tuple(sorted(intent_libs))
        self._intent_row: Dict[str, int] = {
            it: i for i, it in enumerate(self.intents)}
        prior = np.zeros((len(self.intents) + 1, len(self.names)),
                         dtype=np.float32)   # last row: no/unknown intent
        for i, intent in enumerate(self.intents):
            libs = set(intent_libs[intent])
            for j, name in enumerate(self.names):
                if registry.tools[name].library in libs:
                    prior[i, j] = 1.0
        self._prior = prior

    # ------------------------------------------------------- ranking ----
    def rank_batch(self, queries: Sequence[str],
                   intents: Sequence[Optional[str]]
                   ) -> List[List[str]]:
        """Full catalog rankings for a wave of queries in ONE scoring
        call (the retrieval analogue of ``IntentGate.batch``)."""
        assert len(queries) == len(intents)
        if not queries:
            return []
        feats = self.embedder.featurize_batch(queries)
        rows = np.array([self._intent_row.get(i, len(self.intents))
                         for i in intents])
        fused = self.scores(feats, rows)
        out: List[List[str]] = []
        for b in range(len(queries)):
            scores = fused[b]
            order = sorted(range(len(self.names)),
                           key=lambda j: (-float(scores[j]),
                                          self.names[j]))
            out.append([self.names[j] for j in order])
        return out

    def scores(self, feats: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """(B, N) fused scores on the host of (B, D) query features with
        prior rows ``rows`` (an intent's row, or the last: none)."""
        dev = self.device
        return _fused_scores(
            torch.as_tensor(feats, device=dev), self._tool_feats,
            torch.as_tensor(self._prior[rows], device=dev),
            self.prior_weight).cpu().numpy()

    def rank(self, query: str, intent: Optional[str] = None) -> List[str]:
        return self.rank_batch([query], [intent])[0]

    # ----------------------------------------------------- retrieval ----
    def retrieve(self, query: str, intent: Optional[str] = None,
                 k: Optional[int] = None) -> ToolsetExposure:
        return ToolsetExposure(self.rank(query, intent), k or self.k)

    def retrieve_batch(self, queries: Sequence[str],
                       intents: Sequence[Optional[str]],
                       k: Optional[int] = None) -> List[ToolsetExposure]:
        return [ToolsetExposure(r, k or self.k)
                for r in self.rank_batch(queries, intents)]
