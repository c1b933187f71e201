"""Fine-tuning entry: mine pairs -> contrastive steps -> save params.

Port of `lattice_tpu/models/finetune.py`, the CLI's `lattice train`: mines
(NL, code) pairs from a loaded index (`models/data.py`), runs
`ContrastiveTrainer` steps on one device or over `mesh` (a `parallel/`
mesh: data and tensor parallelism, the global in-batch loss), and writes
the parameters and the report under the index's data dir. The report has
the reference's keys and statuses ("skipped" when fewer pairs than a
batch are mined).

`finetuned_params.npz` holds the reference's names and shapes
(`unixcoder.params_to_jax`: flax's slash-joined tree paths, Dense kernels
[in, out], f32), so either package's `UniXcoderModel(finetune_dir=...)`
loads it. It is written with `np.savez`, uncompressed, where the reference
uses `np.savez_compressed`: zlib runs at a few MB/s on random f32 values,
minutes for the ~500 MB of the full-width encoder (`PERF.md`, cell J).
`np.load` reads both.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from lattice_tpu_torch.models.data import PairBatcher, mine_pairs
from lattice_tpu_torch.models.train import ContrastiveTrainer
from lattice_tpu_torch.models.unixcoder import UniXcoderConfig, params_to_jax
from lattice_tpu_torch.text.tokenizer import CodeTokenizer


def finetune_from_index(
    code_store, summary_store=None, *,
    data_dir: str | Path,
    config: UniXcoderConfig | None = None,
    mesh=None,
    steps: int = 100,
    batch_size: int = 16,
    max_length: int = 256,
    learning_rate: float = 2e-5,
    seed: int = 0,
    progress=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Returns a report dict; saves params + report under data_dir."""
    data_dir = Path(data_dir)
    config = config or UniXcoderConfig()
    pairs = mine_pairs(code_store, summary_store)
    if len(pairs) < batch_size:
        return {"status": "skipped",
                "reason": f"only {len(pairs)} pairs mined "
                          f"(need >= {batch_size})"}
    tokenizer = CodeTokenizer(vocab_size=config.vocab_size)
    batcher = PairBatcher(pairs, tokenizer, batch_size=batch_size,
                          max_length=max_length, seed=seed)
    trainer = ContrastiveTrainer(config, mesh=mesh,
                                 learning_rate=learning_rate, seed=seed,
                                 device=device)
    losses: list[float] = []
    t0 = time.time()
    step = 0
    while step < steps:
        for batch in batcher.batches():
            loss = trainer.train_step(batch)
            losses.append(loss)
            step += 1
            if progress is not None:
                progress(step, steps, loss)
            if step >= steps:
                break
    elapsed = time.time() - t0
    ckpt_path = data_dir / "finetuned_params.npz"
    data_dir.mkdir(parents=True, exist_ok=True)
    np.savez(ckpt_path, **params_to_jax(trainer.state_dict()))
    report = {
        "status": "completed",
        "pairs_mined": len(pairs),
        "steps": step,
        "batch_size": batch_size,
        "first_loss": round(float(losses[0]), 4),
        "last_loss": round(float(losses[-1]), 4),
        "elapsed_s": round(elapsed, 1),
        "checkpoint": str(ckpt_path),
    }
    (data_dir / "finetune_report.json").write_text(json.dumps(report, indent=1))
    return report
