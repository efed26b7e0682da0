"""Synthetic LM data pipeline with document packing.

Documents are drawn from a deterministic seeded "corpus" generator (the
planner examples feed real serialized agent transcripts through the same
packing path). Packing concatenates documents with an EOS separator and
emits fixed-length (tokens, labels) windows; labels are shifted tokens with
-100-style masking (-1 here) across document boundaries optionally kept.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

EOS = 1
PAD = 0


class PackedLMDataset:
    """Streams packed (tokens, labels) batches from a token-id document
    iterator."""

    def __init__(self, docs: Iterator[Sequence[int]], batch: int,
                 seq_len: int, vocab_size: int, mask_boundaries: bool = False):
        self.docs = iter(docs)
        self.batch = batch
        self.seq_len = seq_len
        self.vocab = vocab_size
        self.mask_boundaries = mask_boundaries
        self._buf: List[int] = []

    def _fill(self, n: int):
        while len(self._buf) < n:
            try:
                doc = next(self.docs)
            except StopIteration:
                # loop the corpus
                self._buf.extend([EOS] * (n - len(self._buf)))
                return
            self._buf.extend(list(doc))
            self._buf.append(EOS)

    def __iter__(self):
        return self

    def __next__(self):
        need = self.batch * (self.seq_len + 1)
        self._fill(need)
        chunk = np.array(self._buf[:need], np.int32)
        self._buf = self._buf[need:]
        chunk = chunk.reshape(self.batch, self.seq_len + 1)
        tokens = chunk[:, :-1]
        labels = chunk[:, 1:].copy()
        if self.mask_boundaries:
            labels[tokens == EOS] = -1
        return {"tokens": tokens, "labels": labels}


def synthetic_docs(vocab_size: int, seed: int = 0,
                   mean_len: int = 256) -> Iterator[List[int]]:
    """Infinite stream of synthetic documents with Zipf-ish unigrams and a
    local bigram structure (so a small LM has something learnable)."""
    rng = np.random.default_rng(seed)
    # Fixed random bigram transition "grammar" over a small state space.
    n_states = 64
    trans = rng.integers(2, vocab_size, size=(n_states, 8))
    while True:
        length = max(8, int(rng.exponential(mean_len)))
        state = int(rng.integers(0, n_states))
        doc = []
        for _ in range(length):
            tok = int(trans[state, int(rng.integers(0, 8))])
            doc.append(tok)
            state = tok % n_states
        yield doc
