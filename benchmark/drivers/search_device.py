"""Driver of `ChunkStore.search_device`: the bulk vector search of a code
index, as an agent or a service calls `/v1/search_vector_batch`.

Set-up builds the configuration's corpus on the device from the seed,
through `VectorIndexer(..., dtype, device)` and `ChunkStore.add` with the
payloads the indexer writes, makes the traffic's query pool, and warms the
plan with `warm_calls` calls of the window's own shape (the first
small-batch auto call builds the IVF partition and, on this corpus,
refuses it; the int8 shadow is built too). A call is one
`search_device(queries, k, method)`; the answer counts once its scores and
ids are on the host, copied with `.cpu()` as `BatchingFrontend` copies
them.

The check runs after the window, with the store freed: the rows are made
again from the seed and the reference (`reference/exact_search.py`) judges
the answers of `check_calls` calls drawn from the seed, the window's last
call among them."""

from __future__ import annotations

import gc
import time

import torch

from benchmark import inputs, loadgen
from benchmark.reference import exact_search as ref

# what calibrate.py and the tests can break underneath the timed path
FAULTS = ("control", "stale", "half_batch", "half_rows", "altered",
          "rescore_dropped")


class State:
    SPAN = "bench.search_device"     # the profiler's name for one call

    def __init__(self, cell):
        from lattice_tpu_torch.embeddings.embedder import Embedder
        from lattice_tpu_torch.embeddings.indexer import VectorIndexer
        from lattice_tpu_torch.providers.hash_provider import HashEmbedder

        self.cell = cell
        cfg, traffic, dev = cell.config, cell.traffic, cell.device
        self.k, self.method = traffic["k"], traffic["method"]
        self.centers = inputs.corpus_centers(cfg, cell.seed, dev)
        indexer = VectorIndexer(Embedder(HashEmbedder(dimensions=cfg["dim"])),
                                dtype=cfg["dtype"],
                                initial_capacity=cfg["rows"], device=dev)
        self.store = indexer.code
        for lo, hi, rows in inputs.corpus_blocks(cfg, cell.seed, self.centers):
            self.store.add(rows, inputs.payloads(lo, hi, cfg["rows_per_file"]))
        self.pool = loadgen.query_pool(traffic, self.centers, cell.seed)
        self.search = self.store.search_device
        for i in range(traffic["warm_calls"]):
            self.call(i)

    def call(self, i: int):
        """(host seconds until `search_device` returned, answers, (scores,
        ids) on the host)."""
        q = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        scores, ids = self.search(q, self.k, method=self.method)
        issued = time.perf_counter() - t0
        out = (scores.cpu(), ids.cpu())
        return issued, int(out[1].shape[0]), out

    def inputs_of(self, i: int) -> torch.Tensor:
        return self.pool[i % len(self.pool)]

    def free(self) -> None:
        self.store = self.search = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_rows(self) -> torch.Tensor:
        """The rows the store should hold, worked out again from the seed."""
        cfg = self.cell.config
        dtype = getattr(torch, cfg["dtype"])
        return torch.cat([ref.stored_rows(rows, dtype) for _, _, rows in
                          inputs.corpus_blocks(cfg, self.cell.seed,
                                               self.centers)])

    def check(self, latest: list, free: bool = True) -> dict[str, float]:
        """The reference's numbers over `check_calls` of the window's
        newest answers to each pooled batch, [(call, (scores, ids))] in
        call order, drawn from the seed, the window's last call among
        them."""
        picks = loadgen.sample_calls(len(latest),
                                     self.cell.traffic["check_calls"],
                                     self.cell.seed, must=(len(latest) - 1,))
        answers = [latest[j][1] for j in picks]
        queries = [self.inputs_of(latest[j][0]) for j in picks]
        if free:
            self.free()
        return ref.judge(queries, [(s.numpy(), i.numpy()) for s, i in answers],
                         self.reference_rows(), self.k)

    def plant(self, fault: str) -> None:
        """Break the timed path underneath: `control` puts the reference's
        lower-precision scan in the program's place; the others break the
        program's answers."""
        search = self.search = self.store.search_device   # one fault at a time
        n = self.cell.config["rows"]
        if fault == "control":
            rows = self.reference_rows()
            self.search = lambda q, k, method: ref.lower_precision_search(
                q, rows, k)
        elif fault == "stale":          # answers of the call before
            last = [search(self.pool[-1], self.k, method=self.method)]

            def stale(q, k, method):
                out, last[0] = last[0], search(q, k, method=method)
                return out
            self.search = stale
        elif fault == "half_batch":     # half of the queries never answered
            self.search = lambda q, k, method: search(q[:q.shape[0] // 2], k,
                                                      method=method)
        elif fault == "half_rows":      # half of the rows never scanned
            self.store._valid[n // 2:] = False
        elif fault == "altered":        # one id altered where it is made
            def altered(q, k, method):
                s, i = search(q, k, method=method)
                i = i.clone()
                i[0, 0] = (i[0, 0] + 1) % n
                return s, i
            self.search = altered
        elif fault == "rescore_dropped":  # the int8 first stage alone
            store = self.store
            self.search = lambda q, k, method: store._quant_view(
            ).search_device(q, store._valid, k)
        else:
            raise ValueError(f"unknown fault {fault!r}")


def setup(cell) -> State:
    return State(cell)
