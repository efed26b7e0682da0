"""Token & request accounting — the paper's cost metric.

Every LLM interaction (the gate call and each planner step) is recorded
with REAL token counts from the serialized prompt/completion text
(serving.tokenizer), not estimates.

With the tool-graph compiler (DESIGN.md §Tool-graph compiler) one
"plan" entry is one planner ROUND-TRIP that may fuse several virtual
linear steps; entries carry ``tool_calls``/``virtual_steps`` so the
round-trip and token deltas the compiler buys are first-class metrics
(surfaced in benchmarks/table2.py and benchmarks/steps_tools.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.serving.tokenizer import count_tokens


@dataclass
class LedgerEntry:
    kind: str              # "gate" | "plan" | "widen"
    prompt_tokens: int
    completion_tokens: int
    tool_calls: int = 0    # tool calls emitted in this round-trip
    virtual_steps: int = 0  # linear planner steps fused into it (1 when
    #                         the linear planner emitted it directly)


@dataclass
class TokenLedger:
    entries: List[LedgerEntry] = field(default_factory=list)

    def record(self, kind: str, prompt_text: str, completion_text: str,
               tool_calls: int = 0, virtual_steps: int = 0):
        self.entries.append(LedgerEntry(
            kind, count_tokens(prompt_text), count_tokens(completion_text),
            tool_calls=tool_calls, virtual_steps=virtual_steps))

    @property
    def prompt_tokens(self) -> int:
        return sum(e.prompt_tokens for e in self.entries)

    @property
    def completion_tokens(self) -> int:
        return sum(e.completion_tokens for e in self.entries)

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens

    @property
    def n_requests(self) -> int:
        return len(self.entries)

    @property
    def n_plan_steps(self) -> int:
        """Planner LLM requests (round-trips). Pre-compiler this equals
        virtual steps; with compile_plans it is what fusion shrinks."""
        return sum(1 for e in self.entries if e.kind == "plan")

    # round-trip accounting (tool-graph compiler) ------------------------
    n_round_trips = n_plan_steps

    @property
    def n_virtual_steps(self) -> int:
        """Linear planner steps the round-trips cover: invariant under
        compilation (the behaviour model is shared), so the compiler's
        win is exactly ``n_virtual_steps / n_round_trips``."""
        return sum(e.virtual_steps for e in self.entries
                   if e.kind == "plan")

    @property
    def n_tool_calls(self) -> int:
        return sum(e.tool_calls for e in self.entries if e.kind == "plan")

    @property
    def plan_prompt_tokens(self) -> int:
        """Prompt tokens across plan round-trips only — the serialized
        catalog+history re-sends that fusing round-trips eliminates."""
        return sum(e.prompt_tokens for e in self.entries
                   if e.kind == "plan")

    # toolset-retrieval miss-and-widen accounting ------------------------
    @property
    def n_widens(self) -> int:
        """Miss-and-widen re-issues: a "widen" entry is one k-escalation
        re-serialization after the planner emitted a call outside the
        retrieved toolset (TOOL_NOT_RETRIEVED). Widen entries carry
        tokens (total_tokens includes them) but zero virtual steps, so
        they never move round-trip or step metrics."""
        return sum(1 for e in self.entries if e.kind == "widen")

    def summary(self) -> Dict[str, float]:
        return {"total_tokens": self.total_tokens,
                "prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "requests": self.n_requests,
                "plan_steps": self.n_plan_steps,
                "round_trips": self.n_round_trips,
                "virtual_steps": self.n_virtual_steps,
                "tool_calls": self.n_tool_calls,
                "plan_prompt_tokens": self.plan_prompt_tokens,
                "widens": self.n_widens}
