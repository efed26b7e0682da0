"""Neural GeckOpt components served by the port's model.

Port of the JAX package's ``serving/neural_planner.py``.
``NeuralIntentClassifier`` replaces the scripted gate classifier with a
real model: the planner-proxy LM scores each intent label as a
continuation of the gate prompt (constrained decoding over the 8-way
intent grammar — no free-form generation can escape the taxonomy).

``BatchedNeuralIntentClassifier`` makes the same decisions but scores
every (query, intent) pair of a pipeline admission wave in ONE
``(Q*8, L)`` forward instead of Q*8 sequential B=1 calls — the gate hot
path of serving/pipeline.py. On the card that forward is a planner-width
prefill with no cache: ``flash_prefill`` at a batch of Q*8 rows.

Both run the model's forward-only train mode (``model.forward_hidden``),
whose products and norms run in fixed-size row calls, and score the head
in fixed-size calls of ``HEAD_ROWS`` rows (the fp32 logits, their
logsumexp and the picked label), so a row's loss has the same bits at
every batch size and the two classifiers decide alike exactly. The
per-position sums run on the host in a fixed order.

``make_intent_dataset`` builds (query -> intent) LM training pairs from
the task generator, the JAX package's draws as numpy batches;
``launch/train_planner.py`` trains the gate on them and plugs the result
into the Table-2 harness.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.core.intents import INTENTS
from repro_torch.models.model import Model, _logits, forward_hidden
from repro_torch.serving.tokenizer import TOKENIZER

#: rows of each fixed-size call of the head, its logsumexp and the pick
HEAD_ROWS = 128


def encode_pair(query: str, intent: str, seq_len: int) -> Tuple[np.ndarray,
                                                                np.ndarray]:
    """LM pair: loss only on the intent suffix."""
    q = TOKENIZER.encode(f"classify intent: {query} => ")
    a = TOKENIZER.encode(intent)
    toks = (q + a)[:seq_len]
    labels = ([-1] * len(q) + list(a))[:seq_len]
    pad = seq_len - len(toks)
    tokens = np.array(toks + [0] * pad, np.int32)
    labs = np.array([-1] + labels[1:] + [-1] * pad, np.int32)
    # labels are next-token: shift left by one
    labs = np.concatenate([labs[1:], [-1]]).astype(np.int32)
    return tokens, labs


def make_intent_dataset(tasks, seq_len: int = 64, batch: int = 16):
    """An endless iterator of {"tokens", "labels"} (batch, seq_len) int32
    numpy batches of ``encode_pair`` rows, drawn by ``default_rng(0)``
    as the JAX package draws them."""
    pairs = [encode_pair(t.query, t.intent, seq_len) for t in tasks]
    rng = np.random.default_rng(0)

    def batches():
        while True:
            idx = rng.integers(0, len(pairs), batch)
            yield {"tokens": np.stack([pairs[i][0] for i in idx]),
                   "labels": np.stack([pairs[i][1] for i in idx])}
    return batches()


def _label_nll(model: Model, x2, labels):
    """Masked next-token NLL (M,) fp32 of (M, d) hidden rows against (M,)
    labels (-1 = no label): the fp32 head, logsumexp minus the picked
    label, in calls of exactly HEAD_ROWS rows (the last zero-padded)."""
    M = x2.shape[0]
    n = -(-M // HEAD_ROWS)
    x2 = F.pad(x2, (0, 0, 0, n * HEAD_ROWS - M))
    labels = F.pad(labels, (0, n * HEAD_ROWS - M), value=-1)
    out = []
    for i in range(n):
        rows = slice(i * HEAD_ROWS, (i + 1) * HEAD_ROWS)
        logits = _logits(model, x2[rows])                    # (R, V) fp32
        lc = labels[rows]
        picked = torch.gather(logits, 1, lc.clamp(min=0)[:, None])[:, 0]
        out.append((torch.logsumexp(logits, dim=-1) - picked)
                   * (lc >= 0).float())
    return torch.cat(out)[:M]


@torch.no_grad()
def per_example_loss(model: Model, batch, chunk: int = 16) -> torch.Tensor:
    """Per-row masked LM loss (B,) fp32 on the host — ``train_loss``
    without the cross-example mean: the sum of each row's label losses
    over chunks of ``chunk`` positions, over the count of its labels
    (at least 1), as the JAX package's ``per_example_loss`` computes it.
    MoE aux loss is omitted there too (the intent argmin only compares
    label-token losses)."""
    x = forward_hidden(model, batch)
    B, S, d = x.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    labels = torch.as_tensor(np.asarray(batch["labels"]), dtype=torch.long)
    nll = _label_nll(model, x.reshape(B * S, d),
                     labels.reshape(B * S).to(x.device)).reshape(B, S).cpu()
    mask = (labels >= 0).float()
    tot = torch.zeros(B)
    cnt = torch.zeros(B)
    for c in range(S // chunk):
        loss = torch.zeros(B)
        n = torch.zeros(B)
        for j in range(c * chunk, (c + 1) * chunk):
            loss = loss + nll[:, j]
            n = n + mask[:, j]
        tot = tot + loss
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


class NeuralIntentClassifier:
    """Scores each intent by LM loss of its label continuation, one B=1
    forward per (query, intent).

    Scoring uses ``per_example_loss`` (pure label-token likelihood) so
    the batched classifier's single-pass decisions match this one."""

    def __init__(self, cfg: ModelConfig, model: Model, seq_len: int = 64):
        self.cfg = cfg
        self.model = model
        self.seq_len = seq_len

    def classify(self, query: str) -> Tuple[str, str]:
        losses = []
        for intent in INTENTS:
            toks, labs = encode_pair(query, intent, self.seq_len)
            batch = {"tokens": toks[None], "labels": labs[None]}
            losses.append(float(per_example_loss(self.model, batch)[0]))
        best = INTENTS[int(np.argmin(losses))]
        return best, best

    def classify_batch(self, queries: Sequence[str]
                       ) -> List[Tuple[str, str]]:
        return [self.classify(q) for q in queries]

    def accuracy(self, tasks) -> float:
        hits = sum(self.classify(t.query)[0] == t.intent for t in tasks)
        return hits / max(len(tasks), 1)


class BatchedNeuralIntentClassifier:
    """Same decisions as ``NeuralIntentClassifier``, one forward pass.

    All Q queries × 8 intents are encoded into a single ``(Q*8, L)``
    batch and scored by one ``per_example_loss`` call; the intent with
    the minimum label-suffix loss wins per query. Row counts are padded
    to a power of two (by repeating the last row), as in the JAX package,
    so a pipeline's waves run O(log Q) distinct batch shapes.
    """

    def __init__(self, cfg: ModelConfig, model: Model, seq_len: int = 64):
        self.cfg = cfg
        self.model = model
        self.seq_len = seq_len

    def _encode_rows(self, queries: Sequence[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [encode_pair(q, intent, self.seq_len)
                 for q in queries for intent in INTENTS]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def losses(self, queries: Sequence[str]) -> np.ndarray:
        """(Q, 8) label-suffix loss matrix for all queries/intents."""
        toks, labs = self._encode_rows(queries)
        rows = toks.shape[0]
        padded = max(8, 1 << (rows - 1).bit_length())
        if padded > rows:
            reps = padded - rows
            toks = np.concatenate([toks, np.repeat(toks[-1:], reps, 0)])
            labs = np.concatenate([labs, np.repeat(labs[-1:], reps, 0)])
        out = per_example_loss(self.model, {"tokens": toks, "labels": labs})
        return out.numpy()[:rows].reshape(len(queries), len(INTENTS))

    def classify_batch(self, queries: Sequence[str]
                       ) -> List[Tuple[str, str]]:
        if not queries:
            return []
        best = np.argmin(self.losses(queries), axis=1)
        return [(INTENTS[int(i)],) * 2 for i in best]

    def classify(self, query: str) -> Tuple[str, str]:
        return self.classify_batch([query])[0]

    def accuracy(self, tasks) -> float:
        decisions = self.classify_batch([t.query for t in tasks])
        hits = sum(d[0] == t.intent for d, t in zip(decisions, tasks))
        return hits / max(len(tasks), 1)
