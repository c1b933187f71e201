"""The port's pair mining, batching and fine-tune entry against JAX's.

The sample project is indexed by both packages' `PipelineOrchestrator`
(hash embedder, metadata off); `mine_pairs` and `PairBatcher` must give
equal pairs in order and equal batches, array for array, epoch after
epoch. `finetune_from_index` runs in both at `tests/test_finetune.py`'s
`TINY` config (f32): the reports have the same keys and statuses, the
skip is the same dict, and each package loads the other's
`finetuned_params.npz` and embeds as the other does within the encoder
tests' f32 bar (2e-4).
"""

import asyncio

import numpy as np
import pytest

from lattice_tpu.config.settings import Settings as JaxSettings
from lattice_tpu.embeddings.embedder import Embedder as JaxEmbedder
from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.models.data import PairBatcher as JaxBatcher
from lattice_tpu.models.data import mine_pairs as jax_mine
from lattice_tpu.models.finetune import finetune_from_index as jax_finetune
from lattice_tpu.models.unixcoder import UniXcoderConfig as JaxConfig
from lattice_tpu.models.unixcoder import UniXcoderModel as JaxModel
from lattice_tpu.pipeline.orchestrator import (
    PipelineOrchestrator as JaxOrchestrator)
from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
from lattice_tpu.text.tokenizer import CodeTokenizer as JaxTokenizer
from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.models import unixcoder as um
from lattice_tpu_torch.models.data import PairBatcher, mine_pairs
from lattice_tpu_torch.models.finetune import finetune_from_index
from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
from lattice_tpu_torch.providers.hash_provider import HashEmbedder
from lattice_tpu_torch.text.tokenizer import CodeTokenizer

TINY = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=600,
            dtype="float32")
RUN = dict(steps=3, batch_size=4, max_length=64, learning_rate=1e-3)


@pytest.fixture(scope="module")
def indexed(sample_project_path):
    """(JAX run, port run) over one sample project."""
    js = JaxSettings()
    js.metadata.enabled = False
    jrun = asyncio.run(JaxOrchestrator(
        sample_project_path, JaxEmbedder(JaxHash(dimensions=64)),
        project_name="ft", settings=js).run())
    ps = Settings()
    ps.metadata.enabled = False
    prun = asyncio.run(PipelineOrchestrator(
        sample_project_path, Embedder(HashEmbedder(dimensions=64)),
        project_name="ft", settings=ps, device="cpu").run())
    return jrun, prun


@pytest.fixture(scope="module")
def runs(indexed, tmp_path_factory):
    """Each package's fine-tune over its own index, into its own dir."""
    jrun, prun = indexed
    jdir = tmp_path_factory.mktemp("jax_ft")
    pdir = tmp_path_factory.mktemp("port_ft")
    jrep = jax_finetune(jrun.indexer.code, jrun.indexer.summaries,
                        data_dir=jdir, config=JaxConfig(**TINY), **RUN)
    prep = finetune_from_index(prun.indexer.code, prun.indexer.summaries,
                               data_dir=pdir, config=um.UniXcoderConfig(**TINY),
                               device="cpu", **RUN)
    return (jrep, jdir), (prep, pdir)


def test_pairs_equal(indexed):
    jrun, prun = indexed
    want = jax_mine(jrun.indexer.code, jrun.indexer.summaries)
    got = mine_pairs(prun.indexer.code, prun.indexer.summaries)
    assert len(want) >= 5 and {p.source for p in want} >= {"docstring"}
    assert [(p.anchor, p.positive, p.source) for p in got] == \
        [(p.anchor, p.positive, p.source) for p in want]
    assert mine_pairs(prun.indexer.code) == \
        [p for p in got if p.source == "docstring"]


@pytest.mark.parametrize("batch_size,max_length,seed", [
    (4, 128, 0), (4, 64, 3), (8, 256, 1), (3, 24, 2)])
def test_batches_equal(indexed, batch_size, max_length, seed):
    """Two shuffled epochs: the same pairs in each batch, the same bucketed
    length and pads, int32 arrays equal."""
    jrun, prun = indexed
    jb = JaxBatcher(jax_mine(jrun.indexer.code, jrun.indexer.summaries),
                    JaxTokenizer(vocab_size=512), batch_size=batch_size,
                    max_length=max_length, seed=seed)
    pb = PairBatcher(mine_pairs(prun.indexer.code, prun.indexer.summaries),
                     CodeTokenizer(vocab_size=512), batch_size=batch_size,
                     max_length=max_length, seed=seed)
    assert len(pb) == len(jb) > 0
    for _epoch in range(2):
        want, got = list(jb.batches()), list(pb.batches())
        assert len(got) == len(want) == len(jb)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])


def test_reports_match(runs):
    (jrep, jdir), (prep, pdir) = runs
    assert prep.keys() == jrep.keys()
    assert prep["status"] == jrep["status"] == "completed"
    for key in ("pairs_mined", "steps", "batch_size"):
        assert prep[key] == jrep[key], key
    assert np.isfinite(prep["last_loss"])
    assert prep["checkpoint"] == str(pdir / "finetuned_params.npz")
    assert (pdir / "finetune_report.json").is_file()
    with np.load(jdir / "finetuned_params.npz") as j, \
            np.load(pdir / "finetuned_params.npz") as p:
        assert sorted(p.files) == sorted(j.files)
        for name in j.files:
            assert p[name].shape == j[name].shape, name
            assert p[name].dtype == np.float32, name


def test_too_few_pairs_skips(tmp_path):
    want = jax_finetune(JaxStore(dim=8), data_dir=tmp_path / "j",
                        config=JaxConfig(**TINY), steps=2, batch_size=4)
    got = finetune_from_index(ChunkStore(8, device="cpu"),
                              data_dir=tmp_path / "p",
                              config=um.UniXcoderConfig(**TINY), steps=2,
                              batch_size=4, device="cpu")
    assert got == want and got["status"] == "skipped"
    assert not (tmp_path / "p").exists()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_across(runs, writer):
    """Each package's checkpoint, loaded through `finetune_dir` by both
    packages' `UniXcoderModel`, embeds the same."""
    (_, jdir), (_, pdir) = runs
    where = pdir if writer == "port" else jdir
    jm = JaxModel(JaxConfig(**TINY), seed=3, finetune_dir=where)
    pm = um.UniXcoderModel(um.UniXcoderConfig(**TINY), seed=3,
                           finetune_dir=where, device="cpu")
    assert jm.loaded_finetuned and pm.loaded_finetuned
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 512, (3, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 17:] = 0
    ids[1, 17:] = 1
    np.testing.assert_allclose(pm.encode(ids, mask), jm.encode(ids, mask),
                               atol=2e-4)
    with np.load(where / "finetuned_params.npz") as flat:
        np.testing.assert_array_equal(
            pm.encoder.word_embeddings.weight.detach().numpy(),
            flat["word_embeddings/embedding"])
