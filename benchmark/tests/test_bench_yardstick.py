"""The operations and bytes behind every share, against counts by hand."""

import numpy as np
import pytest

from benchmark import yardstick


def test_bound_takes_the_larger_side():
    assert yardstick.bound_s(3.35e12, 0, "int8") == pytest.approx(1.0)
    assert yardstick.bound_s(0, 989e12, "bf16") == pytest.approx(1.0)
    assert yardstick.bound_s(3.35e12, 2 * 1979e12, "int8") == pytest.approx(2.0)


def test_scan_int8_work():
    # 8 rows of 16 bytes + a 4-byte scale + a validity byte; 2 int8 queries
    # with scales; [2, 4] scores and ids written
    assert yardstick.scan_int8_work(8, 16, 2, 4) == (
        8 * 21 + 2 * 20 + 2 * 4 * 8, 2 * 2 * 8 * 16)


def test_search_call_work():
    # k=10: 16 candidates a query rescored from 2-byte rows
    n_bytes, ops = yardstick.search_call_work(100, 16, 2, 10)
    assert n_bytes == 100 * 21 + 2 * 16 * 4 + 2 * 16 * 16 * 2 + 2 * 10 * 8
    assert ops == 2 * 2 * 100 * 16
    assert yardstick.int8_first_stage_width(10, 100) == 16
    assert yardstick.int8_first_stage_width(2, 100) == 8
    assert yardstick.int8_first_stage_width(50, 30) == 30


def test_search_call_bound_at_the_cells_shape():
    # 1M x 768 int8 rows dominate: ~0.242 ms
    bound = yardstick.bound_s(*yardstick.search_call_work(1 << 20, 768, 256,
                                                          10), "int8")
    assert 0.2420e-3 < bound < 0.2460e-3


def test_attention_work_counts_the_tiles_the_mask_needs():
    mask = np.zeros((2, 128), dtype=np.int64)
    mask[0, :70] = 1      # both key tiles hold a live key
    mask[1, :10] = 1      # only the first
    keys = 128 + 64
    w = 2 * 64
    n_bytes, ops = yardstick.attention_work(mask, heads=2)
    assert n_bytes == 2 * 2 * 128 * w + 4 * keys * w + 4 * 2 * 128 \
        + 4 * 2 * 128 * w
    assert ops == 4 * w * 128 * keys


def test_attention_work_row_without_a_live_key_runs_every_tile():
    mask = np.zeros((1, 100), dtype=np.int64)
    _, ops = yardstick.attention_work(mask, heads=2)
    assert ops == 4 * 128 * 100 * (64 + 36)


def test_encoder_params_match_the_ports_module():
    from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                                    UniXcoderEncoder)
    cfg = {"hidden_size": 128, "intermediate_size": 256,
           "num_hidden_layers": 2}
    enc = UniXcoderEncoder(UniXcoderConfig(
        vocab_size=50, hidden_size=128, num_layers=2, num_heads=2,
        intermediate_size=256, max_position_embeddings=20))
    tables = sum(p.numel() for n, p in enc.named_parameters()
                 if n.endswith("embeddings.weight"))
    total = sum(p.numel() for p in enc.parameters())
    assert yardstick.encoder_nonembedding_params(cfg) == total - tables


def test_encoder_flops_by_hand():
    cfg = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 1}
    params = 4 * (16 + 4) + (32 + 8) + (32 + 4) + 2 * 2 * 4 + 2 * 4
    assert yardstick.encoder_nonembedding_params(cfg) == params
    assert yardstick.encoder_flops(cfg, np.array([3, 5])) == (
        2 * params * 8 + 1 * 4 * 4 * (9 + 25))
