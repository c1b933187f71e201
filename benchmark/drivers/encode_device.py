"""Driver of `UniXcoderModel.encode_device`: the encoder's indexing
forward, as `lattice index` embeds a repository's chunks.

Set-up makes the model at the configuration's sizes and serving options
(f32 parameters, the compute dtype, paired attention and flash as
stated, and pinned by the configuration's `env` against the port's
levers), loads the benchmark's own weights, made on the device from the
seed, under the port's names, makes the traffic's chunk pool, and warms
each length bucket that the pool's batches fall in. On the card, where
the configuration states paired attention, it stops unless the warm-up
launched the `paired_attention` kernel. A call hands one
batch's token ids and mask to `encode_device` as host arrays, as the
provider hands them after tokenizing; its chunks count once the pooled
rows are complete, read back with `.cpu()`.

The check runs after the window, with the model freed: the weights are
made again from the seed and the reference (`reference/roberta.py`)
judges the pooled rows of `check_batches` calls drawn from the seed, one
holding the pool's longest chunk among them."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import inputs, loadgen
from benchmark.reference import roberta as ref

FAULTS = ("control", "stale", "half_batch", "altered")


def _attention_launches() -> int:
    from lattice_tpu_torch.ops import _build
    return _build.launch_counts().get("paired_attention", 0)


class State:
    SPAN = "bench.encode_device"     # the profiler's name for one call

    def __init__(self, cell):
        from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                                        UniXcoderModel)

        self.cell = cell
        cfg = cell.config
        ucfg = UniXcoderConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg["max_position_embeddings"],
            type_vocab_size=cfg["type_vocab_size"],
            layer_norm_eps=cfg["layer_norm_eps"],
            pad_token_id=cfg["pad_token_id"], dtype=cfg["compute_dtype"],
            paired_attention=cfg["paired_attention"],
            fused_attention=cfg["fused_attention"])
        self.model = UniXcoderModel(ucfg, device=cell.device)
        weights = inputs.roberta_weights(cfg, cell.seed, cell.device)
        with torch.no_grad():
            self.model.encoder.load_state_dict(inputs.port_state(weights, cfg))
        del weights
        self.pool = loadgen.chunk_pool(cell.traffic, cell.seed)
        self.encode = self.model.encode_device
        buckets = {}
        for j, (ids, _) in enumerate(self.pool):
            buckets.setdefault(self.model.bucket_length(ids.shape[1]), j)
        launched = _attention_launches()
        for j in buckets.values():
            for _ in range(cell.traffic["warm_calls"]):
                self.call(j)
        if (cfg["paired_attention"] and cell.device.startswith("cuda")
                and _attention_launches() == launched):
            raise RuntimeError("the configuration states paired attention, "
                               "and the warm-up launched no paired_attention")

    def call(self, i: int):
        """(host seconds until `encode_device` returned, chunks, pooled
        rows on the host)."""
        ids, mask = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        rows = self.encode(ids, mask)
        issued = time.perf_counter() - t0
        out = rows.cpu()
        return issued, int(out.shape[0]), out

    def inputs_of(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return self.pool[i % len(self.pool)]

    def free(self) -> None:
        self.model = self.encode = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, latest: list, free: bool = True) -> dict[str, float]:
        """The reference's numbers over `check_batches` of the window's
        newest answers to each pooled batch, [(call, pooled rows)] in call
        order, drawn from the seed, the batch with the pool's longest chunk
        among them."""
        longest = max(range(len(self.pool)),
                      key=lambda j: int(self.pool[j][1].sum(1).max()))
        holds = next((j for j, (i, _) in enumerate(latest)
                      if i % len(self.pool) == longest), -1)
        picks = loadgen.sample_calls(len(latest),
                                     self.cell.traffic["check_batches"],
                                     self.cell.seed, must=(holds,))
        if free:
            self.free()
        w = inputs.roberta_weights(self.cell.config, self.cell.seed,
                                   self.cell.device)
        expected = [ref.pooled(w, self.cell.config,
                               *self.inputs_of(latest[j][0]))
                    for j in picks]
        return ref.judge(expected, [latest[j][1].numpy() for j in picks])

    def plant(self, fault: str) -> None:
        """Break the timed path underneath: `control` puts the reference in
        fp8 in the program's place; the others break the program's rows."""
        encode = self.encode = self.model.encode_device   # one fault at a time
        if fault == "control":
            w = inputs.roberta_weights(self.cell.config, self.cell.seed,
                                       self.cell.device)
            self.encode = lambda ids, mask: ref.pooled(
                w, self.cell.config, ids, mask, precision="fp8")
        elif fault == "stale":          # the rows of the batch before
            last = [encode(*self.pool[-1])]

            def stale(ids, mask):
                out, last[0] = last[0], encode(ids, mask)
                return out
            self.encode = stale
        elif fault == "half_batch":     # half of the chunks never embedded
            self.encode = lambda ids, mask: encode(ids[:len(ids) // 2],
                                                   mask[:len(mask) // 2])
        elif fault == "altered":        # one row altered where it is made
            def altered(ids, mask):
                rows = encode(ids, mask).clone()
                rows[0] = rows[1]
                return rows
            self.encode = altered
        else:
            raise ValueError(f"unknown fault {fault!r}")


def setup(cell) -> State:
    return State(cell)
