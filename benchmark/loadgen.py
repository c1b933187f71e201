"""The one generator of traffic: it reads a mix's parameters from
`traffic/<name>.json` and makes the cell's inputs from `--seed`.

A driver takes the kind of input its entry point wants:
- `query_pool`: `pool_batches` batches of `batch` raw query vectors drawn
  around the corpus's centres at `query_spread`, as query embeddings land
  near the code they ask about (made on the card);
- `chunk_pool`: `pool_batches` batches of `batch` token-id chunks framed
  as the UniXcoder tokenizer frames them ([CLS, mode, SEP, body..., SEP],
  padded to the batch's longest with the pad id), as host arrays. Their
  lengths follow the mix's `lengths.histogram`, measured chunk lengths
  (`chunk_lengths.py`): the pool takes the histogram's quantiles, so
  every run does the same work; `--seed` deals the lengths into batches
  in another order and draws the ids.

A closed loop of one caller takes the pool's batches in order, round and
round, for the whole window."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import cluster_rows, derive_seed, generator


def query_pool(traffic: dict, centers: torch.Tensor, seed: int
               ) -> list[torch.Tensor]:
    gen = generator(seed, "queries", centers.device)
    return [cluster_rows(centers, traffic["batch"], gen,
                         traffic["query_spread"])
            for _ in range(traffic["pool_batches"])]


def chunk_lengths(traffic: dict) -> np.ndarray:
    """Every chunk's length in tokens, framing included: the quantiles of
    the mix's histogram [[tokens, chunks], ...] at the pool's
    `batch * pool_batches` evenly spaced points. The same for every
    seed."""
    table = np.asarray(traffic["lengths"]["histogram"], dtype=np.int64)
    measured = np.repeat(table[:, 0], table[:, 1])
    n = traffic["batch"] * traffic["pool_batches"]
    at = ((np.arange(n) + 0.5) * len(measured) / n).astype(np.int64)
    return np.sort(measured)[at]


def chunk_pool(traffic: dict, seed: int
               ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(input ids, attention mask) int64 host arrays per batch, each padded
    to its longest chunk."""
    rng = np.random.default_rng(derive_seed(seed, "chunks"))
    lengths = rng.permutation(chunk_lengths(traffic))
    frame, ids_spec, b = traffic["frame"], traffic["ids"], traffic["batch"]
    pool = []
    for start in range(0, len(lengths), b):
        ln = lengths[start:start + b]
        cols = np.arange(int(ln.max()))[None, :]
        ids = rng.integers(ids_spec["low"], ids_spec["high"],
                           size=(len(ln), cols.shape[1]), dtype=np.int64)
        ids[:, 0], ids[:, 1], ids[:, 2] = (frame["cls"], frame["mode"],
                                           frame["sep"])
        ids[np.arange(len(ln)), ln - 1] = frame["sep"]
        live = cols < ln[:, None]
        ids[~live] = frame["pad"]
        pool.append((ids, live.astype(np.int64)))
    return pool


def sample_calls(n_calls: int, count: int, seed: int,
                 must: tuple[int, ...] = ()) -> list[int]:
    """Indices of the window's calls whose answers are checked: `count`
    drawn from the seed, plus `must`, in order."""
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    picked = set(int(j) for j in must if 0 <= j < n_calls)
    if n_calls:
        picked |= set(rng.choice(n_calls, size=min(count, n_calls),
                                 replace=False).tolist())
    return sorted(picked)
