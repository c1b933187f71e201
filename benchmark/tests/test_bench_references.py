"""Both references against the port's CPU paths at small sizes, and the
controls: the reference in the next lower precision reads worse."""

import numpy as np
import pytest
import torch

from benchmark import inputs, loadgen
from benchmark.reference import exact_search, roberta


def _store(rows, device="cpu"):
    from lattice_tpu_torch.index.chunk_store import ChunkStore
    store = ChunkStore(rows.shape[1], dtype="bfloat16",
                       initial_capacity=rows.shape[0], device=device)
    store.add(rows, inputs.payloads(0, rows.shape[0], 50))
    return store


@pytest.fixture(scope="module")
def corpus():
    cfg = {"centers": 8, "dim": 64, "rows": 3000, "add_batch": 1000,
           "spread": 0.35}
    centers = inputs.corpus_centers(cfg, 11, "cpu")
    rows = torch.cat([r for _, _, r in inputs.corpus_blocks(cfg, 11,
                                                            centers)])
    queries = loadgen.query_pool({"batch": 24, "pool_batches": 2,
                                  "query_spread": 0.35}, centers, 11)
    return rows, queries


def test_exact_topk_is_a_full_sort(corpus):
    rows, queries = corpus
    q = exact_search.normalize(queries[0])
    stored = exact_search.stored_rows(rows, torch.bfloat16)
    s, i = exact_search.exact_topk(q, stored, 10)
    full = q @ stored.float().T
    want_s, want_i = torch.sort(full, dim=1, descending=True, stable=True)
    assert torch.equal(i, want_i[:, :10])
    assert torch.equal(s, want_s[:, :10])


# the plans that rescore in f32 ("flat" scores a bf16-rounded query)
@pytest.mark.parametrize("method", ["quantized", "refined"])
def test_the_ports_answers_pass_the_search_judge(corpus, method):
    rows, queries = corpus
    store = _store(rows)
    answers = [tuple(t.numpy() for t in store.search_device(q, 10,
                                                            method=method))
               for q in queries]
    got = exact_search.judge(queries, answers,
                             exact_search.stored_rows(rows, torch.bfloat16),
                             10)
    assert got["bad_slots"] == 0
    assert got["score_err"] < 1e-6
    assert got["miss_share"] <= 0.02


def test_the_search_control_reads_worse(corpus):
    rows, queries = corpus
    stored = exact_search.stored_rows(rows, torch.bfloat16)
    answers = [tuple(t.numpy() for t in
                     exact_search.lower_precision_search(q, stored, 10))
               for q in queries]
    got = exact_search.judge(queries, answers, stored, 10)
    assert got["bad_slots"] == 0 and got["score_err"] > 1e-4


def test_the_search_judge_counts_missing_and_wrong_slots(corpus):
    rows, queries = corpus
    stored = exact_search.stored_rows(rows, torch.bfloat16)
    s, i = exact_search.exact_topk(exact_search.normalize(queries[0]),
                                   stored, 10)
    s, i = s.numpy(), i.numpy()
    assert exact_search.judge(queries[:1], [(s, i)], stored, 10) == {
        "bad_slots": 0, "score_err": pytest.approx(0, abs=1e-6),
        "miss_share": 0}
    half = exact_search.judge(queries[:1], [(s[:12], i[:12])], stored, 10)
    assert half["bad_slots"] == 12 * 10
    dup = i.copy()
    dup[0, 1] = dup[0, 0]
    assert exact_search.judge(queries[:1], [(s, dup)], stored, 10)[
        "bad_slots"] == 1


TINY_ENC = {"vocab_size": 300, "hidden_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 256,
            "max_position_embeddings": 80, "type_vocab_size": 10,
            "layer_norm_eps": 1e-5, "pad_token_id": 1,
            "init": {"bias_std": 0.02}}
TRAFFIC = {"batch": 6, "pool_batches": 1, "ids": {"low": 3, "high": 300},
           "frame": {"cls": 0, "mode": 6, "sep": 2, "pad": 1},
           "lengths": {"histogram": [[16, 2], [30, 3], [64, 1]]}}


def _port_model(dtype, paired):
    from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                                    UniXcoderModel)
    c = TINY_ENC
    model = UniXcoderModel(UniXcoderConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        dtype=dtype, paired_attention=paired), device="cpu")
    weights = inputs.roberta_weights(c, 5, "cpu")
    model.encoder.load_state_dict(inputs.port_state(weights, c))
    return model, weights


@pytest.mark.parametrize("paired", [True, False])
def test_roberta_matches_the_ports_f32_encoder(paired):
    model, weights = _port_model("float32", paired)
    (ids, mask), = loadgen.chunk_pool(TRAFFIC, 5)
    ref = roberta.pooled(weights, TINY_ENC, ids, mask)
    got = model.encode_device(ids, mask).numpy()
    assert roberta.judge([ref], [got]) == {
        "bad_rows": 0, "row_err": pytest.approx(0, abs=2e-5)}


def test_the_encoder_control_reads_worse_than_bf16():
    model, weights = _port_model("bfloat16", True)
    (ids, mask), = loadgen.chunk_pool(TRAFFIC, 5)
    ref = roberta.pooled(weights, TINY_ENC, ids, mask)
    bf16 = roberta.judge([ref], [model.encode_device(ids, mask).numpy()])
    fp8 = roberta.judge([ref], [roberta.pooled(weights, TINY_ENC, ids, mask,
                                               precision="fp8").numpy()])
    assert 0 < bf16["row_err"] < 0.02
    assert fp8["row_err"] > 3 * bf16["row_err"]


def test_the_encoder_judge_counts_missing_rows():
    ref = torch.ones(4, 8)
    got = np.ones((3, 8))
    got[1, 2] = np.nan
    assert roberta.judge([ref], [got]) == {"bad_rows": 2, "row_err": 0.0}
