"""Seeded synthetic traffic generator for the serving cluster.

A copy of the JAX package's ``serving/workload.py`` (numpy only) with
its import pointed at ``repro_torch.core.intents``: the same config gives
the same request list in both packages.

The paper measures GeckOpt on a live Copilot platform; we cannot replay
that traffic, so this module synthesizes it: a deterministic request
schedule drawn entirely from one ``numpy`` rng — NO wall-clock
randomness — so any two runs (or any two cluster configurations) see
the exact same traffic. Time is measured in abstract *ticks*: one tick
is one cluster step (one continuous-batching decode iteration per
replica), which keeps every latency metric reproducible.

A workload is a list of ``WorkloadRequest``:

  * **intents** are drawn from a configurable mix over
    ``core.intents.INTENTS`` (``uniform_mix`` / ``skewed_mix`` presets —
    the skewed mix is what makes intent-affinity routing measurably
    better than round-robin);
  * every request of an intent shares that intent's prompt prefix
    (``intent_prefix``), so replicas that registered the prefix serve it
    from the prompt-prefix cache;
  * **arrival profiles**: ``uniform`` (evenly spaced by the
    inter-arrival parameter), ``poisson`` (seeded exponential gaps) and
    ``bursty`` (bursts of ``burst_size`` simultaneous arrivals, spaced
    so the mean rate matches);
  * **multi-turn sessions**: a session draws 1..max_turns turns; turn 0
    carries an absolute ``arrival_tick``, later turns carry the gap
    after the previous turn finishes (the cluster releases them);
  * per-request **SLA deadlines** (ticks) and per-request sampler seeds
    (``SamplerConfig.seed``), so outputs are a pure function of the
    workload — the cluster parity tests depend on this.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.intents import INTENT_DESCRIPTIONS, INTENTS

PROFILES = ("uniform", "poisson", "bursty")

# single-word places: prompts stay one fixed token length per intent
_PLACES = ("Tampa", "Rotterdam", "Singapore", "Nairobi", "Oslo",
           "Lima", "Osaka", "Perth")

# One template per intent, fixed word count so prompt token lengths stay
# per-intent constant (a handful of prefill shapes per workload).
_QUERY_TEMPLATES = {
    "load_filter_plot": "plot filtered imagery tiles around {place} now",
    "ui_web_navigation": "open the catalog browser page for {place}",
    "information_seeking": "look up archive facts describing {place}",
    "detection_analysis": "count detected ships moored near {place}",
    "landcover_analysis": "compare dominant landcover classes at {place}",
    "visual_qa": "describe what is shown above {place}",
    "speech_transcription": "transcribe the field recording from {place}",
    "code_analysis": "tabulate the analysis results for {place}",
}


def intent_prefix(intent: str) -> str:
    """The shared per-intent system prompt (every request of the intent
    starts with it; the cluster registers it once on its home replica)."""
    return (f"System: you are the {intent} copilot of the platform. "
            f"Scope: {INTENT_DESCRIPTIONS[intent]}. Answer tersely.")


def prefix_key_for(intent: str) -> str:
    return f"intent:{intent}"


def uniform_mix(intents=INTENTS) -> Dict[str, float]:
    return {i: 1.0 / len(intents) for i in intents}


def skewed_mix(hot: str = "load_filter_plot", hot_frac: float = 0.7,
               intents=INTENTS) -> Dict[str, float]:
    """One hot intent takes ``hot_frac`` of traffic; the rest split the
    remainder evenly (the cluster-bench's affinity-vs-round-robin mix).
    ``hot_frac=1.0`` is the degenerate all-hot-intent workload."""
    if hot not in intents or not 0.0 < hot_frac <= 1.0 \
            or len(intents) < 2:
        raise ValueError(f"skewed_mix needs >= 2 intents, hot among "
                         f"them and 0 < hot_frac <= 1, got "
                         f"{hot!r}, {hot_frac}, {len(intents)} intents")
    cold = (1.0 - hot_frac) / (len(intents) - 1)
    return {i: (hot_frac if i == hot else cold) for i in intents}


@dataclass(frozen=True)
class WorkloadRequest:
    index: int                 # position in the generated workload
    session_id: int
    turn: int                  # 0-based turn within the session
    n_turns: int
    arrival_tick: int          # absolute (turn 0) / gap after the
    #                            previous turn finishes (turn > 0)
    intent: str
    prefix_key: Optional[str]
    prompt: str
    max_new_tokens: int
    sla_ticks: int             # e2e deadline in ticks from arrival
    sampler_seed: int
    temperature: float


@dataclass
class WorkloadConfig:
    n_sessions: int = 16
    seed: int = 0
    intent_mix: Optional[Dict[str, float]] = None   # default: uniform
    profile: str = "uniform"
    inter_arrival: float = 1.0   # mean ticks between session arrivals
    burst_size: int = 4          # arrivals per burst ("bursty" profile)
    max_turns: int = 1           # session length drawn from 1..max_turns
    turn_gap: int = 1            # ticks between turn finish and next turn
    max_new_tokens: int = 4
    temperature: float = 0.0
    sla_ticks: int = 64
    use_prefix: bool = True      # tag requests with the intent prefix key
    # long-prompt tail (the stall-free-scheduling bench's bursty mixed
    # workload): each session is long with probability long_frac, and a
    # long session pads every turn's prompt with ~long_words extra
    # words (~1 token each). 0.0 keeps the rng stream — and therefore
    # every existing workload — bit-identical.
    long_frac: float = 0.0
    long_words: int = 128


def _arrival_schedule(cfg: WorkloadConfig, rng: np.random.Generator,
                      n: int) -> List[int]:
    ia = max(cfg.inter_arrival, 1e-6)
    if cfg.profile == "uniform":
        return [int(i * ia) for i in range(n)]
    if cfg.profile == "poisson":
        gaps = rng.exponential(ia, size=n)
        return [int(t) for t in np.cumsum(gaps) - gaps[0]]
    if cfg.profile == "bursty":
        return [int((i // cfg.burst_size) * ia * cfg.burst_size)
                for i in range(n)]
    raise ValueError(f"unknown profile {cfg.profile!r}; "
                     f"choose from {PROFILES}")


def make_workload(cfg: WorkloadConfig) -> List[WorkloadRequest]:
    """Generate the full request list, sorted by (arrival, index) for
    turn-0 requests with follow-up turns interleaved after their
    session's opener. Deterministic: same config => identical list."""
    mix = cfg.intent_mix or uniform_mix()
    intents = sorted(mix)
    probs = np.asarray([mix[i] for i in intents], dtype=np.float64)
    probs = probs / probs.sum()
    rng = np.random.default_rng(cfg.seed)

    arrivals = _arrival_schedule(cfg, rng, cfg.n_sessions)
    out: List[WorkloadRequest] = []
    for sid in range(cfg.n_sessions):
        intent = intents[int(rng.choice(len(intents), p=probs))]
        n_turns = (1 if cfg.max_turns <= 1
                   else 1 + int(rng.integers(0, cfg.max_turns)))
        place = _PLACES[int(rng.integers(0, len(_PLACES)))]
        # draw the long flag ONLY when the tail is enabled: long_frac=0
        # consumes no rng, so pre-existing workloads stay bit-identical
        long = (cfg.long_frac > 0.0
                and float(rng.random()) < cfg.long_frac)
        prefix = intent_prefix(intent)
        for turn in range(n_turns):
            idx = len(out)
            query = _QUERY_TEMPLATES[intent].format(place=place)
            if long:
                # ~1 token per short word; fixed filler keeps prompt
                # lengths per-(intent, long) constant
                query += " context " + " ".join(
                    ["item"] * max(cfg.long_words - 1, 0))
            prompt = (f"{prefix} Session {sid:03d} turn {turn} "
                      f"request {idx:04d}: {query}")
            out.append(WorkloadRequest(
                index=idx, session_id=sid, turn=turn, n_turns=n_turns,
                arrival_tick=(arrivals[sid] if turn == 0
                              else cfg.turn_gap),
                intent=intent,
                prefix_key=(prefix_key_for(intent) if cfg.use_prefix
                            else None),
                prompt=prompt,
                max_new_tokens=cfg.max_new_tokens,
                sla_ticks=cfg.sla_ticks + int(rng.integers(
                    0, max(cfg.sla_ticks // 4, 1))),
                sampler_seed=int(rng.integers(0, 2**31 - 1)),
                temperature=cfg.temperature))
    return out


def workload_intents(requests: List[WorkloadRequest]) -> Dict[str, int]:
    """Per-SESSION intent counts (turns of one session share an intent)."""
    seen: Dict[int, str] = {}
    for w in requests:
        seen.setdefault(w.session_id, w.intent)
    counts: Dict[str, int] = {}
    for intent in seen.values():
        counts[intent] = counts.get(intent, 0) + 1
    return counts


def register_workload_prefixes(target, requests: List[WorkloadRequest]
                               ) -> Dict[str, int]:
    """Register every intent prefix appearing in the workload on
    ``target`` (an ``InferenceEngine`` or ``EngineCluster``); returns
    {prefix_key: prefix_len}."""
    done: Dict[str, int] = {}
    for w in requests:
        if w.prefix_key and w.prefix_key not in done:
            done[w.prefix_key] = target.register_prefix(
                w.prefix_key, intent_prefix(w.intent))
    return done
