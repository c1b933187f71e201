"""Training-pair mining from the index: the data side of fine-tuning.

A copy of `lattice_tpu/models/data.py`. A bi-encoder adapts to a private
codebase by contrastive training on (natural language, code) pairs mined
from what the indexer already extracted, with no labeling:

- (docstring + signature, entity code) for every documented entity
- (extractive/LLM summary, chunk content) from the summaries collection

Pairs tokenize through the same `CodeTokenizer` the embedder uses and batch
into the int32 numpy arrays `models/train.ContrastiveTrainer` consumes.
The length buckets (32 ... 512) compiled once per shape on the TPU; nothing
compiles per shape on the card, but they are kept so that the pairs and
pads of each batch are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.text.tokenizer import CodeTokenizer

LENGTH_BUCKETS = (32, 64, 128, 256, 512)


@dataclass(slots=True)
class TrainingPair:
    anchor: str      # natural-language side
    positive: str    # code side
    source: str      # docstring | summary


def mine_pairs(code_store: ChunkStore,
               summary_store: ChunkStore | None = None,
               min_anchor_chars: int = 12,
               min_code_chars: int = 40,
               max_pairs: int = 50000) -> list[TrainingPair]:
    """Extract (NL, code) pairs from indexed payloads."""
    pairs: list[TrainingPair] = []
    for _row, payload in code_store.scroll({}, limit=max_pairs * 2):
        doc = payload.get("docstring")
        content = payload.get("content", "")
        if doc and len(doc) >= min_anchor_chars and \
                len(content) >= min_code_chars:
            anchor = doc
            if payload.get("signature"):
                anchor = f"{payload['signature']}\n{doc}"
            pairs.append(TrainingPair(anchor=anchor, positive=content,
                                      source="docstring"))
            if len(pairs) >= max_pairs:
                return pairs
    if summary_store is not None:
        by_node = {}
        for _row, payload in code_store.scroll({}, limit=max_pairs * 2):
            node = payload.get("graph_node_id")
            if node and node not in by_node:
                by_node[node] = payload.get("content", "")
        for _row, payload in summary_store.scroll({}, limit=max_pairs):
            node = payload.get("graph_node_id") or payload.get("name")
            code = by_node.get(node)
            summary = payload.get("content", "")
            if code and len(summary) >= min_anchor_chars and \
                    len(code) >= min_code_chars:
                pairs.append(TrainingPair(anchor=summary, positive=code,
                                          source="summary"))
                if len(pairs) >= max_pairs:
                    break
    return pairs


class PairBatcher:
    """Shuffled epochs of tokenized (anchor, positive) batches."""

    def __init__(self, pairs: list[TrainingPair], tokenizer: CodeTokenizer,
                 batch_size: int = 32, max_length: int = 256, seed: int = 0):
        self.pairs = pairs
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.pairs) // self.batch_size

    def batches(self):
        order = self._rng.permutation(len(self.pairs))
        for start in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
            chunk = [self.pairs[i] for i in order[start:start + self.batch_size]]
            a_ids, a_mask = self.tokenizer.encode_batch(
                [p.anchor for p in chunk], self.max_length)
            p_ids, p_mask = self.tokenizer.encode_batch(
                [p.positive for p in chunk], self.max_length)
            # both sides padded to the longer of the two, rounded up to a
            # bucket, as the reference pads them
            la, lp = len(a_ids[0]), len(p_ids[0])
            length = max(la, lp)
            for bucket in LENGTH_BUCKETS:
                if length <= bucket:
                    length = bucket
                    break
            else:
                length = self.max_length

            def pad(ids, mask, cur):
                if cur == length:
                    return ids, mask
                extra = length - cur
                return ([row + [self.tokenizer.PAD] * extra for row in ids],
                        [row + [0] * extra for row in mask])

            a_ids, a_mask = pad(a_ids, a_mask, la)
            p_ids, p_mask = pad(p_ids, p_mask, lp)
            yield {
                "anchor_ids": np.asarray(a_ids, dtype=np.int32),
                "anchor_mask": np.asarray(a_mask, dtype=np.int32),
                "positive_ids": np.asarray(p_ids, dtype=np.int32),
                "positive_mask": np.asarray(p_mask, dtype=np.int32),
            }
