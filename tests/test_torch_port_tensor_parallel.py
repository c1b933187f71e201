"""The port's trainer mesh, tensor-parallel encoder and dry run against the
JAX package's, on a CPU mesh of logical shards.

The JAX objects run on `make_mesh(8, model_parallel=2)` over the 8 virtual
CPU devices of `tests/conftest.py`; the port's on `make_mesh(8,
model_parallel=2, device="cpu")`, eight logical shards on the CPU (four
data rows of two model positions). Parameters are carried from JAX into
the port (`params_from_jax`), as `tests/test_torch_port_train.py` does.

Tolerances, those of `tests/test_torch_port_train.py` for training:
- losses within 1e-4 relative over 3 AdamW steps at lr 1e-3; every
  parameter within 2e-5, except where the first gradient is rounding noise
  (|g| < 1e-6, the attention's key bias): there Adam moves an element by
  about lr a step whatever the noise's sign, so 2 * steps * lr;
- the dp-only and dp x tp steps against the port's single-device step: the
  same bars (the split only reorders f32 sums);
- the first gradient of the dp-only and dp x tp trainers against the
  single-device one: within 1e-5 of its norm, while the gradient of a
  loss that drops one data row's gradient, or of per-shard losses, is
  more than 1e-2 of it away;
- the dp x tp forward (`UniXcoderModel.use_mesh`): f32 within 2e-5 of the
  unsharded forward and 2e-4 of JAX's sharded one; bf16 within 2e-2 of
  JAX's with every row's cosine >= 0.999.

Every bias and LayerNorm parameter is drawn at random (`random_vectors`)
before a comparison: the init makes them 0 and 1 in both packages, and a
forward on those could not see a bias added once a partial or sliced from
the wrong columns.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.models.train import ContrastiveTrainer as JaxTrainer
from lattice_tpu.models.train import contrastive_loss as jax_loss
from lattice_tpu.models.unixcoder import UniXcoderConfig as JaxConfig
from lattice_tpu.models.unixcoder import UniXcoderModel as JaxModel
from lattice_tpu.parallel import mesh as jax_mesh
from lattice_tpu_torch import graft_entry
from lattice_tpu_torch.core.errors import ConfigurationError
from lattice_tpu_torch.models import train as pt
from lattice_tpu_torch.models import unixcoder as um
from lattice_tpu_torch.models.data import TrainingPair
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.parallel.mesh import make_mesh, shard_params

# tests/test_models_parallel.py's TINY
TINY = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64, dtype="float32")
LR = 1e-3
STEPS = 3
NOISE = 1e-6


def flat_params(params) -> dict:
    """The JAX param tree as `models/finetune.py` flattens it."""
    flat = {}
    for path, value in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat[key] = np.asarray(value)
    return flat


def random_vectors(params, seed=11):
    """The JAX parameters (a tree, or flat as `flat_params` gives them)
    with every bias and LayerNorm scale drawn from one numpy generator:
    biases normal(0, 0.1), scales 1 + normal(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        # a tree's last key, or a flat name's last part
        leaf = str(getattr(path[-1], "key", path[-1])).rsplit("/", 1)[-1]
        if leaf not in ("bias", "scale"):
            return x
        value = rng.normal(0.0, 0.1, x.shape) + (leaf == "scale")
        return jnp.asarray(value, x.dtype)
    return jax.tree_util.tree_map_with_path(draw, params)


def port_mesh(model_parallel=2, n=8):
    return make_mesh(n, model_parallel=model_parallel, device="cpu")


def sharded_batch(kind: str) -> dict:
    """`test_sharded_step_matches_shape`'s batch (8 x 12, vocab 256); the
    ragged kind masks tails of some rows."""
    batch = pt.make_dummy_batch(batch_size=8, length=12, vocab_size=256)
    if kind == "ragged":
        batch["anchor_mask"][1, 7:] = 0
        batch["positive_mask"][4, 3:] = 0
        batch["positive_mask"][6, 1:] = 0
    return batch


@pytest.fixture(scope="module")
def jax_start():
    """The JAX mesh trainer's initial parameters (`random_vectors`) and the
    first gradient of the ragged batch (unsharded)."""
    jt = JaxTrainer(JaxConfig(**TINY), mesh=jax_mesh.make_mesh(
        8, model_parallel=2), learning_rate=LR)
    params = random_vectors(jax.device_get(jt.state.params))
    batch = {k: jnp.asarray(v) for k, v in sharded_batch("ragged").items()}
    _, grads = jax.jit(jax.value_and_grad(jax_loss), static_argnums=1)(
        params, jt.module, batch)
    return params, flat_params(grads)


def port_trainer(params, mesh=None, **kw) -> pt.ContrastiveTrainer:
    trainer = pt.ContrastiveTrainer(um.UniXcoderConfig(**TINY), mesh=mesh,
                                    learning_rate=LR, device="cpu", **kw)
    trainer.load_state_dict(um.params_from_jax(flat_params(params)))
    return trainer


def same_params(got: dict, want: dict, first_grads: dict) -> None:
    got = um.params_to_jax(got)
    assert got.keys() == want.keys()
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        noise = np.abs(first_grads[name]) < NOISE
        assert diff[~noise].max(initial=0.0) <= 2e-5, name
        assert diff[noise].max(initial=0.0) <= 2 * STEPS * LR, name


@pytest.mark.parametrize("kind", ["dummy", "ragged"])
def test_sharded_steps_match_jax(jax_start, kind):
    """`TestContrastiveTrainer.test_sharded_step_matches_shape`'s mesh and
    batch: three steps of both packages' dp x tp trainers from the same
    parameters."""
    params, first_grads = jax_start
    jmesh = jax_mesh.make_mesh(8, model_parallel=2)
    jt = JaxTrainer(JaxConfig(**TINY), mesh=jmesh, learning_rate=LR)
    placed = jax_mesh.shard_params(params, jmesh)
    jt.state = dataclasses.replace(jt.state, params=placed,
                                   opt_state=jt.optimizer.init(placed))
    trainer = port_trainer(params, mesh=port_mesh())
    assert trainer.mp == 2 and len(trainer.mesh.model_rows) == 4
    batch = sharded_batch(kind)
    for _ in range(STEPS):
        want, got = jt.train_step(batch), trainer.train_step(batch)
        assert np.isfinite(got)
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    assert trainer.state.step == STEPS
    same_params(trainer.state_dict(), flat_params(jt.state.params),
                first_grads)


@pytest.mark.parametrize("model_parallel", [1, 2])
@pytest.mark.parametrize("remat", [True, False])
def test_mesh_steps_match_single_device(jax_start, model_parallel, remat):
    """The dp-only (8 x 1) and dp x tp (4 x 2) trainers against the port's
    single-device trainer on the same batch."""
    params, first_grads = jax_start
    one = port_trainer(params, remat=remat)
    mesh = port_trainer(params, mesh=port_mesh(model_parallel), remat=remat)
    batch = sharded_batch("ragged")
    for _ in range(STEPS):
        want, got = one.train_step(batch), mesh.train_step(batch)
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    same_params(mesh.state_dict(), um.params_to_jax(one.state_dict()),
                first_grads)


def test_mesh_loss_is_the_global_in_batch_loss(jax_start):
    """The mesh trainer's loss is InfoNCE over the whole batch (every row's
    negatives are the batch's), not the mean of per-shard losses, which on
    this batch is far smaller: each shard of 2 rows has 1 negative."""
    params, _ = jax_start
    one = port_trainer(params)
    mesh = port_trainer(params, mesh=port_mesh())
    batch = mesh.shard_batch(sharded_batch("ragged"))
    with torch.no_grad():
        got = mesh.loss(batch).item()
        whole = one.loss(batch).item()
        per_shard = np.mean([
            one.loss({k: v[r:r + 2] for k, v in batch.items()}).item()
            for r in range(0, 8, 2)])
    assert abs(got - whole) <= 1e-5 * abs(whole)
    assert abs(got - per_shard) > 0.5, (got, per_shard)


def relative(got: dict, want: dict) -> float:
    """|got - want| / |want| over every weight's gradient at once."""
    num = sum(float((got[k] - want[k]).square().sum()) for k in want)
    return (num / sum(float(w.square().sum()) for w in want.values())) ** 0.5


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_mesh_gradient_matches_and_planted_faults_show(jax_start,
                                                        model_parallel):
    """The mesh trainer's first gradient is the single-device trainer's
    within 1e-5 of its norm; the gradient of a loss that drops one data
    row's gradient (its pooled rows detached), or of the mean of per-row
    losses, is more than 1e-2 of it away, so the bar tells both faults
    from the sound step."""
    params, _ = jax_start
    one = port_trainer(params)
    mesh = port_trainer(params, mesh=port_mesh(model_parallel))
    batch = one.shard_batch(sharded_batch("ragged"))
    one.loss(batch).backward()
    mesh.loss(batch).backward()
    want = one.grads()
    assert relative(mesh.grads(), want) <= 1e-5
    names = list(one.state.params)
    leaves = [one.state.params[n][0] for n in names]
    per = 8 // len(mesh.rows)
    anchor, positive = one.encode_pairs(batch)
    dropped = torch.cat([anchor[:per].detach(), anchor[per:]])
    shards = range(0, 8, per)
    faults = {
        "row dropped": pt.info_nce(dropped, torch.cat(
            [positive[:per].detach(), positive[per:]])),
        "per-row loss": sum(pt.info_nce(anchor[r:r + per],
                                        positive[r:r + per])
                            for r in shards) / len(shards)}
    for fault, loss in faults.items():
        grads = torch.autograd.grad(loss, leaves, retain_graph=True,
                                    allow_unused=True)
        got = {n: torch.zeros_like(want[n]) if g is None else g
               for n, g in zip(names, grads)}
        assert relative(got, want) > 1e-2, fault


def test_split_weights_live_as_slices(jax_start):
    """A weight the rules split lives as one slice a model position and
    nowhere whole, a replicated one once on the lead; the trainer keeps no
    module beside them, the optimizer holds every leaf once, and
    `state_dict` puts the whole weights back together."""
    params, _ = jax_start
    trainer = port_trainer(params, mesh=port_mesh())
    split = "layers.0.intermediate.weight"
    parts = trainer.state.params[split]
    assert [tuple(p.shape) for p in parts] == [(32, 32)] * 2
    assert all(p.is_leaf and p.requires_grad for p in parts)
    assert not hasattr(trainer, "module")
    assert [tuple(p.shape) for p in trainer.state.params[
        "layers.0.attention.query.bias"]] == [(32,)]
    assert [tuple(p.shape) for p in trainer.state.params[
        "layers.1.output.weight"]] == [(32, 32)] * 2
    leaves = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    assert len(leaves) == len({id(p) for p in leaves}) == sum(
        len(v) for v in trainer.state.params.values())
    state = trainer.state_dict()
    want = um.params_from_jax(flat_params(params))
    assert state.keys() == want.keys()
    for name in want:
        assert torch.equal(state[name], want[name]), name


def test_mesh_trainer_refuses_an_uneven_model_axis():
    with pytest.raises(ConfigurationError, match="does not split"):
        pt.ContrastiveTrainer(um.UniXcoderConfig(**{**TINY, "num_heads": 2}),
                              mesh=make_mesh(8, model_parallel=4,
                                             device="cpu"))


def test_finetune_from_index_passes_the_mesh(monkeypatch, tmp_path):
    """`finetune_from_index(mesh=...)` trains over the mesh and saves the
    whole weights."""
    from lattice_tpu_torch.models import finetune
    seen = []
    real = finetune.ContrastiveTrainer

    def spy(*args, **kw):
        seen.append(kw.get("mesh"))
        return real(*args, **kw)

    monkeypatch.setattr(finetune, "ContrastiveTrainer", spy)
    pairs = [TrainingPair(anchor=f"return the value {i}",
                          positive=f"def f{i}():\n    return {i}\n",
                          source="docstring")
             for i in range(8)]
    monkeypatch.setattr(finetune, "mine_pairs", lambda *a: pairs)
    mesh = port_mesh()
    report = finetune.finetune_from_index(
        None, data_dir=tmp_path, config=um.UniXcoderConfig(**TINY),
        mesh=mesh, steps=2, batch_size=8, max_length=16, device="cpu")
    assert report["status"] == "completed" and report["steps"] == 2
    assert seen == [mesh]
    with np.load(tmp_path / "finetuned_params.npz") as flat:
        assert flat["layer_0/intermediate/kernel"].shape == (32, 64)
        assert flat["layer_1/output/kernel"].shape == (64, 32)


# ---- the dp x tp forward ----------------------------------------------------

# heads of 64 (two a position at mp 2: the paired path) and of 16 (einsum)
ENCODERS = {"heads64": dict(vocab_size=512, hidden_size=256, num_layers=2,
                            num_heads=4, intermediate_size=256,
                            max_position_embeddings=66),
            "heads16": dict(vocab_size=512, hidden_size=64, num_layers=2,
                            num_heads=4, intermediate_size=128,
                            max_position_embeddings=66)}


def encoder_batch(seed=3, b=5, ln=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 500, (b, ln)).astype(np.int32)
    mask = np.ones_like(ids)
    for r, n in enumerate(rng.integers(1, ln + 1, b)):
        ids[r, n:] = 1
        mask[r, n:] = 0
    mask[0] = 1
    return ids, mask


def cosine(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(
        b, axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ENCODERS))
def test_tensor_parallel_encoder_matches_jax(monkeypatch, arch, dtype):
    cfg = ENCODERS[arch]
    jm = JaxModel(JaxConfig(**cfg, dtype=dtype), seed=7)
    jm.params = random_vectors(jm.params)
    port = um.UniXcoderModel(um.UniXcoderConfig(**cfg, dtype=dtype),
                             device="cpu")
    port.encoder.load_state_dict(um.params_from_jax(flat_params(jm.params)))
    ids, mask = encoder_batch()
    whole = port.encode(ids, mask)
    widths = []
    real = um.paired_attention

    def counted(q, k, v, m, scale):
        widths.append(q.shape[-1])
        return real(q, k, v, m, scale)

    monkeypatch.setattr(um, "paired_attention", counted)
    port.use_mesh(port_mesh())
    assert port.data_shards == 4
    got = port.encode(ids, mask)
    before = _build.launch_counts()["paired_attention"]
    jm.use_mesh(jax_mesh.make_mesh(8, model_parallel=2))
    want = jm.encode(ids, mask)
    assert _build.launch_counts()["paired_attention"] == before
    # four data rows x two positions x two layers; 2 heads of 64 a position
    assert widths == ([128] * 16 if arch == "heads64" else [])
    assert got.shape == (5, cfg["hidden_size"])
    if dtype == "float32":
        np.testing.assert_allclose(got, whole, atol=2e-5)
        np.testing.assert_allclose(got, want, atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2)
        assert cosine(got, want).min() >= 0.999
        assert cosine(got, whole).min() >= 0.999


def test_tensor_parallel_placement_and_fused_qkv():
    """Each data row's weights are `shard_params`' placement (rows on the
    same devices share one), and a fused-QKV weight stays whole: its
    product is sliced per position, with the same embeddings. The biases
    and LayerNorms are JAX's `random_vectors`, carried across."""
    cfg = um.UniXcoderConfig(**ENCODERS["heads64"], dtype="float32")
    port = um.UniXcoderModel(cfg, seed=2, device="cpu")
    port.encoder.load_state_dict(um.params_from_jax(flat_params(
        random_vectors(um.params_to_jax(port.encoder.state_dict())))))
    ids, mask = encoder_batch(seed=5)
    whole = port.encode(ids, mask)
    port.use_mesh(port_mesh())
    got = port.encode(ids, mask)
    placed = [v for k, v in port._row_weights.items() if isinstance(k, tuple)]
    assert len(placed) == 1
    assert [tuple(p.shape) for p in placed[0]["layers.0.output.weight"]] \
        == [(256, 128)] * 2
    port.enable_fused_qkv()
    fused = port.encode(ids, mask)
    qkv = [v for k, v in port._row_weights.items() if isinstance(k, tuple)][0]
    assert [tuple(p.shape) for p in qkv["layers.0.attention.qkv.weight"]] \
        == [(768, 256)] * 2
    np.testing.assert_allclose(got, whole, atol=2e-5)
    np.testing.assert_allclose(fused, whole, atol=2e-5)
    with pytest.raises(ConfigurationError):
        port.use_mesh(make_mesh(8, model_parallel=8, device="cpu"))


def test_shard_params_takes_a_row_of_devices():
    state = um.UniXcoderModel(um.UniXcoderConfig(**ENCODERS["heads16"]),
                              device="cpu").encoder.state_dict()
    devices = (torch.device("cpu"),) * 2
    a = shard_params(state, devices)
    b = shard_params(state, port_mesh())
    for name in state:
        assert len(a[name]) == 2
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y), name


# ---- the dry run ----------------------------------------------------------

DRY = um.UniXcoderConfig(vocab_size=512, hidden_size=256, num_layers=2,
                         num_heads=4, intermediate_size=256,
                         max_position_embeddings=130)


def test_dryrun_multichip():
    """`TestGraftEntry.test_dryrun_multichip`'s counterpart: every step of
    the dry run over 8 logical CPU shards, the dp x tp forward at a small
    config (the full-width one runs on the card)."""
    graft_entry.dryrun_multichip(8, device="cpu", config=DRY)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_on_fewer_shards(n):
    graft_entry.dryrun_multichip(n, device="cpu", config=DRY)


def test_entry_compiles():
    """`TestGraftEntry.test_entry_compiles`'s counterpart: `entry()` gives
    a callable and its arguments, a batch of 8 pooled rows (a small config
    here; `entry()`'s default is full width)."""
    fn, args = graft_entry.entry(device="cpu", config=DRY)
    out = fn(*args)
    assert out.shape == (8, DRY.hidden_size)
    assert bool(torch.isfinite(out).all())
