"""The port's contrastive trainer against the JAX package's.

`TINY` is `tests/test_finetune.py`'s config (hidden 32, four heads of 8,
two layers, f32), so both packages take the einsum attention path, the one
where the reference has a gradient. JAX's initial parameters are carried
into the port (`params_from_jax`); the batches are `make_dummy_batch`'s,
with ragged masks.

Tolerances:
- the loss: relative 1e-5 (f32 sums in another order);
- the gradients: rtol 1e-4, and atol 1e-4 of the largest gradient element.
  The attention's key bias has a gradient of exactly zero (a softmax does
  not move under a shift of its row), so both packages give it rounding
  noise of ~1e-8 there, which no relative bound holds;
- three AdamW steps at lr 1e-3: every loss within 1e-4 relative; every
  parameter within 2e-5, except where the first gradient is that noise
  (|g| < 1e-6): Adam moves such an element by about lr a step whatever the
  noise's size, and the two packages' noise points either way, so those
  are bounded by 2 * steps * lr. The same bars hold the flash trainer
  (`fused_attention=True`, SDPA) to the einsum trainer at L = 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.models.train import ContrastiveTrainer as JaxTrainer
from lattice_tpu.models.train import contrastive_loss as jax_loss
from lattice_tpu.models.train import make_dummy_batch as jax_dummy
from lattice_tpu.models.unixcoder import UniXcoderConfig as JaxConfig
from lattice_tpu_torch.core.errors import ConfigurationError, EmbeddingError
from lattice_tpu_torch.models import train as pt
from lattice_tpu_torch.models import unixcoder as um

TINY = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=600,
            dtype="float32")
LR = 1e-3
STEPS = 3
NOISE = 1e-6


def flat_params(params) -> dict:
    """The JAX param tree as `models/finetune.py:66-70` flattens it."""
    flat = {}
    for path, value in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat[key] = np.asarray(value)
    return flat


def ragged_batch(seed=1):
    batch = pt.make_dummy_batch(4, 32, TINY["vocab_size"], seed=seed)
    batch["anchor_mask"][1, 20:] = 0
    batch["positive_mask"][2, 10:] = 0
    batch["positive_mask"][3, 1:] = 0
    return batch


def port_trainer(jax_params, remat=True) -> pt.ContrastiveTrainer:
    trainer = pt.ContrastiveTrainer(um.UniXcoderConfig(**TINY), remat=remat,
                                    learning_rate=LR, device="cpu")
    trainer.load_state_dict(um.params_from_jax(flat_params(jax_params)))
    return trainer


@pytest.fixture(scope="module")
def start():
    """JAX's initial parameters, its loss and gradient on one batch."""
    jt = JaxTrainer(JaxConfig(**TINY), remat=False, learning_rate=LR)
    batch = ragged_batch()
    loss, grads = jax.value_and_grad(jax_loss)(
        jt.state.params, jt.module, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return jt.state.params, float(loss), flat_params(grads)


@pytest.mark.parametrize("args", [(8, 32, 1000, 0), (3, 17, 51416, 5)])
def test_dummy_batch_equals_jax(args):
    got, want = pt.make_dummy_batch(*args), jax_dummy(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_loss_and_gradients_match_jax(start):
    params, want_loss, want_grads = start
    trainer = port_trainer(params)
    loss = trainer.loss(trainer.shard_batch(ragged_batch()))
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    loss.backward()
    grads = um.params_to_jax(trainer.grads())
    assert grads.keys() == want_grads.keys()
    top = max(np.abs(g).max() for g in want_grads.values())
    for name, want in want_grads.items():
        np.testing.assert_allclose(grads[name], want, rtol=1e-4,
                                   atol=1e-4 * top, err_msg=name)
    noise = {n for n, g in want_grads.items() if np.abs(g).max() < NOISE}
    assert noise == {"layer_0/attention/key/bias",
                     "layer_1/attention/key/bias"}


@pytest.mark.parametrize("remat", [True, False])
def test_three_steps_match_jax(start, remat):
    params, _, first_grads = start
    jt = JaxTrainer(JaxConfig(**TINY), remat=remat, learning_rate=LR)
    jt.state = dataclasses.replace(jt.state, params=params,
                                   opt_state=jt.optimizer.init(params))
    trainer = port_trainer(params, remat=remat)
    assert trainer.config.remat is remat
    batch = ragged_batch()
    for _ in range(STEPS):
        want, got = jt.train_step(batch), trainer.train_step(batch)
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    assert trainer.state.step == STEPS
    got = um.params_to_jax(trainer.state_dict())
    for name, want in flat_params(jt.state.params).items():
        diff = np.abs(got[name] - want)
        noise = np.abs(first_grads[name]) < NOISE
        assert diff[~noise].max(initial=0.0) <= 2e-5, name
        assert diff[noise].max(initial=0.0) <= 2 * STEPS * LR, name


def test_remat_is_bit_equal(start):
    """Rematerialization recomputes the same layers: on the CPU three
    steps with and without it give the same bits."""
    params = start[0]
    a, b = port_trainer(params, remat=True), port_trainer(params, remat=False)
    batch = ragged_batch(seed=4)
    for _ in range(STEPS):
        assert a.train_step(batch) == b.train_step(batch)
    for (name, x), y in zip(a.state_dict().items(),
                            b.state_dict().values()):
        assert torch.equal(x, y), name


def test_optimizer_is_optax_adamw():
    opt = pt.make_optimizer([torch.zeros(2, requires_grad=True)])
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (2e-5, (0.9, 0.999), 1e-8, 0.01)


def test_trainer_takes_the_einsum_path(monkeypatch):
    """At heads of 64, where serving takes `paired_attention`, the trainer
    runs the einsum path and never reaches the kernel's wrapper."""
    def refuse(*args):
        raise AssertionError("the trainer reached paired_attention")

    calls = []

    def einsum(*args, _real=um._einsum_attention):
        calls.append(1)
        return _real(*args)

    monkeypatch.setattr(um, "paired_attention", refuse)
    monkeypatch.setattr(um, "_einsum_attention", einsum)
    cfg = um.UniXcoderConfig(vocab_size=512, hidden_size=128, num_layers=1,
                             num_heads=2, intermediate_size=256,
                             max_position_embeddings=66, dtype="float32")
    trainer = pt.ContrastiveTrainer(cfg, device="cpu")
    assert trainer.config.paired_attention is False and trainer.config.remat
    loss = trainer.train_step(pt.make_dummy_batch(2, 16, 512))
    assert np.isfinite(loss) and len(calls) >= 2


def test_trainer_refusals(monkeypatch):
    """What the trainer still refuses: CUDA without CUDA, a model axis that
    does not split the heads, and LATTICE_PAIRED_ATTN=1 where it would
    send a step through `paired_attention` (heads of 64 that pair up),
    which has no backward: raised when the trainer is made. At TINY's
    heads of 8 the paired path never applies, and with LATTICE_FLASH_ATTN=1
    flash wins over it, so both train. A mesh and `fused_attention=True`
    are accepted."""
    heads64 = um.UniXcoderConfig(vocab_size=512, hidden_size=128,
                                 num_layers=1, num_heads=2,
                                 intermediate_size=256,
                                 max_position_embeddings=66, dtype="float32")
    monkeypatch.setenv("LATTICE_PAIRED_ATTN", "1")
    with pytest.raises(ConfigurationError, match="no backward"):
        pt.ContrastiveTrainer(heads64, device="cpu")
    pt.ContrastiveTrainer(um.UniXcoderConfig(**TINY), device="cpu")
    monkeypatch.setenv("LATTICE_FLASH_ATTN", "1")
    pt.ContrastiveTrainer(heads64, device="cpu")
    monkeypatch.delenv("LATTICE_PAIRED_ATTN")
    monkeypatch.delenv("LATTICE_FLASH_ATTN")
    from lattice_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ConfigurationError, match="does not split"):
        pt.ContrastiveTrainer(heads64, mesh=make_mesh(
            4, model_parallel=4, device="cpu"))
    trainer = pt.ContrastiveTrainer(
        um.UniXcoderConfig(**TINY, fused_attention=True),
        mesh=make_mesh(4, model_parallel=2, device="cpu"))
    assert trainer.config.fused_attention and trainer.mp == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EmbeddingError):
        pt.ContrastiveTrainer(um.UniXcoderConfig(**TINY))


@pytest.mark.parametrize("opt_in", ["config", "env"])
def test_flash_trainer_steps_match_einsum(start, monkeypatch, opt_in):
    """`fused_attention=True` (or LATTICE_FLASH_ATTN=1) trains through
    `scaled_dot_product_attention` at L >= 128: three steps from JAX's
    parameters equal the einsum trainer's at this file's bars (the live
    tokens' attention is the same function; a pad token's context, which
    the pool drops, differs)."""
    params, _, _ = start
    calls = []
    real = um._flash_attention

    def spy(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(um, "_flash_attention", spy)
    einsum = port_trainer(params)
    batch = pt.make_dummy_batch(4, 128, TINY["vocab_size"], seed=2)
    batch["anchor_mask"][1, 70:] = 0
    batch["positive_mask"][3, 5:] = 0
    want = [einsum.train_step(batch) for _ in range(STEPS)]
    assert calls == []
    if opt_in == "env":
        monkeypatch.setenv("LATTICE_FLASH_ATTN", "1")
        flash = port_trainer(params)
    else:
        flash = pt.ContrastiveTrainer(
            um.UniXcoderConfig(**TINY, fused_attention=True), remat=True,
            learning_rate=LR, device="cpu")
        flash.load_state_dict(um.params_from_jax(flat_params(params)))
    got = [flash.train_step(batch) for _ in range(STEPS)]
    # 2 layers, anchors and positives, each step; remat recomputes each
    assert len(calls) == STEPS * 2 * 2 * 2 and set(calls) == {128}
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w), (g, w)
    a, b = flash.state_dict(), einsum.state_dict()
    for name in a:
        assert (a[name] - b[name]).abs().max().item() <= 2 * STEPS * LR
    moved = max((a[n] - b[n]).abs().max().item() for n in a
                if "key.bias" not in n)
    assert moved <= 2e-5, moved
