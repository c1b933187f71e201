"""A one-process device mesh and its placement helpers (torch port).

Port of `lattice_tpu/parallel/mesh.py`. The JAX package is single-
controller: one process runs `shard_map` over every device of its mesh.
So is the port: a mesh is one process's grid of `torch.device`s, never a
`torch.distributed` group, and a collective is a copy to the lead device
plus a local op (`parallel/sharded_index.merge_topk_axis`,
`sharded_graph`'s frontier sum).

A mesh position is a logical shard. Shard i lives on `pool[i % len(pool)]`,
the pool being every visible CUDA device (or the one device named), so
`make_mesh(4)` on one card lays four shards on `cuda:0` and
`make_mesh(4, device="cpu")` four on the CPU: the port's counterpart of
XLA's `--xla_force_host_platform_device_count`. With as many cards as
shards, each shard has a card of its own. Multi-host is out of scope.

The stores' sharded plans and views (`ChunkStore`, `GraphStore`, the
engine's sharded deep branch) span every visible device of their kind, as
the JAX package's span `jax.devices()`. `default_mesh(mesh)` replaces that
process-wide within its block, so that one setting gives every store the
same mesh, such as four logical shards on one card.

Axes, as in the JAX package:
- `data` shards the corpus rows (the index, the rank columns), the edge
  lists and the encoder's batch;
- `model` is the Megatron tensor-parallel axis of the encoder. Its rules
  (`param_sharding_rules`, `shard_params`) are here; the forward over it
  is `models/unixcoder.tensor_parallel_forward`, run by
  `UniXcoderModel.use_mesh` and `ContrastiveTrainer(mesh=...)` for each
  data row (`model_rows`);
- `dcn` (`make_multislice_mesh`) groups the shards into slices whose
  results merge within a slice first, then across slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Sequence

import torch

from lattice_tpu_torch.core.errors import ConfigurationError

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A grid of devices, one per logical shard, row-major over `axes`."""

    axes: tuple[tuple[str, int], ...]
    devices: tuple[torch.device, ...]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multislice(self) -> bool:
        return DCN_AXIS in self.axis_names

    @property
    def row_devices(self) -> tuple[torch.device, ...]:
        """The device of each row shard, in row order: every position of a
        (dcn, data) mesh, the model index 0 of a (data, model) one."""
        if self.multislice:
            return self.devices
        mp = self.shape.get(MODEL_AXIS, 1)
        return self.devices[::mp]

    @property
    def model_rows(self) -> tuple[tuple[torch.device, ...], ...]:
        """The devices of each data row's model positions, in row order
        (one position a row without a model axis)."""
        if self.multislice:
            return tuple((d,) for d in self.devices)
        mp = self.shape.get(MODEL_AXIS, 1)
        return tuple(self.devices[i:i + mp]
                     for i in range(0, len(self.devices), mp))

    @property
    def slices(self) -> list[range]:
        """The row shards of each slice (one slice without a dcn axis)."""
        n = len(self.row_devices)
        per = self.shape[DATA_AXIS] if self.multislice else n
        return [range(lo, lo + per) for lo in range(0, n, per)]

    @property
    def lead(self) -> torch.device:
        """Where merged results land."""
        return self.devices[0]

    def __str__(self) -> str:
        axes = " x ".join(f"{name} {n}" for name, n in self.axes)
        used = sorted({str(d) for d in self.devices})
        return f"mesh ({axes}) on {', '.join(used)}"


def _pool(device: str | torch.device | Sequence[torch.device]
          ) -> list[torch.device]:
    """The devices the shards are dealt over: every visible CUDA device for
    "cuda", else the one device named (or the list given)."""
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigurationError(
                f"a mesh on {dev} requested but CUDA is not available")
        if dev.index is None:
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    return [dev]


def _deal(n: int, device) -> tuple[torch.device, ...]:
    pool = _pool(device)
    n = n or len(pool)
    return tuple(pool[i % len(pool)] for i in range(n))


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device: str | torch.device | Sequence[torch.device] = "cuda"
              ) -> DeviceMesh:
    """(data, model) mesh of `n_devices` shards (default: one per device of
    the pool), dealt over the pool in order."""
    devices = _deal(n_devices or 0, device)
    n = len(devices)
    if n % model_parallel != 0:
        model_parallel = 1
    return DeviceMesh(((DATA_AXIS, n // model_parallel),
                       (MODEL_AXIS, model_parallel)), devices)


def make_multislice_mesh(n_slices: int, n_devices: int | None = None,
                         device: str | torch.device
                         | Sequence[torch.device] = "cuda") -> DeviceMesh:
    """(dcn, data) mesh: slices outermost, the shards of a slice inner."""
    devices = _deal(n_devices or 0, device)
    n = len(devices)
    if n % n_slices:
        raise ValueError(f"{n} devices do not factor into {n_slices} slices")
    return DeviceMesh(((DCN_AXIS, n_slices), (DATA_AXIS, n // n_slices)),
                      devices)


_DEFAULT_MESH: DeviceMesh | None = None   # set within `default_mesh`


@contextlib.contextmanager
def default_mesh(mesh: DeviceMesh | None):
    """Within the block, `mesh` is the mesh of every store's sharded plan,
    views and walk in this process (`visible_mesh`); None restores every
    visible device. The previous setting comes back on exit."""
    global _DEFAULT_MESH
    prev, _DEFAULT_MESH = _DEFAULT_MESH, mesh
    try:
        yield mesh
    finally:
        _DEFAULT_MESH = prev


def visible_mesh(device: str | torch.device) -> DeviceMesh:
    """The stores' mesh for a device of this kind: the one `default_mesh`
    set, else one shard per visible device (one shard on the CPU)."""
    if _DEFAULT_MESH is not None:
        return _DEFAULT_MESH
    return make_mesh(device=torch.device(device).type)


def visible_shards(device: str | torch.device) -> int:
    """Row shards of `visible_mesh(device)`, counted without building it."""
    if _DEFAULT_MESH is not None:
        return len(_DEFAULT_MESH.row_devices)
    return (torch.cuda.device_count()
            if torch.device(device).type == "cuda" else 1)


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> list[torch.Tensor]:
    """`x` on the device of every row shard; shards that share a device
    share one copy."""
    on: dict[torch.device, torch.Tensor] = {}
    return [on.setdefault(d, x.to(d, non_blocking=True))
            for d in mesh.row_devices]


def rows_per_shard(mesh: DeviceMesh, n: int) -> int:
    """Rows each shard holds of `n`, padded up to a multiple of the row
    shards."""
    return -(-n // len(mesh.row_devices))


def row_sharded(mesh: DeviceMesh, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """Axis 0 of `x` padded with zeros to a multiple of the row shards and
    split over them: a fresh contiguous block (of `dtype`, default x's) on
    each shard's device, never a view of `x`."""
    per = rows_per_shard(mesh, x.shape[0])
    out = []
    for i, dev in enumerate(mesh.row_devices):
        block = torch.zeros((per,) + tuple(x.shape[1:]),
                            dtype=dtype or x.dtype, device=dev)
        part = x[i * per:(i + 1) * per]
        block[:part.shape[0]] = part.to(dev)
        out.append(block)
    return out


def device_memory_bytes(device: torch.device) -> int:
    """The memory of one device: a card's `total_memory`, the host's
    physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


# ---- tensor parallelism: the rules, for the encoder's model axis -----------


def param_sharding_rules(name: str, value: torch.Tensor
                         ) -> tuple[str | None, ...]:
    """Megatron partition of one encoder parameter (a torch state-dict
    name; weights are [out, in]): the query, key, value and intermediate
    weights column-parallel (their output features over `model`), the
    attention-output and FFN-output weights row-parallel (their input
    features), the intermediate bias with its columns, everything else
    replicated (an empty spec)."""
    if value.dim() == 2 and name.endswith("weight"):
        if any(k in name for k in ("query", "key", "value", "intermediate")):
            return (MODEL_AXIS, None)
        if "output" in name:
            return (None, MODEL_AXIS)
    if value.dim() == 1 and "intermediate" in name and name.endswith("bias"):
        return (MODEL_AXIS,)
    return ()


def shard_params(params: dict[str, torch.Tensor],
                 where: DeviceMesh | Sequence[torch.device]
                 ) -> dict[str, list[torch.Tensor]]:
    """Place a state dict under the tensor-parallel rules: for each name,
    one tensor per position of the model axis, on that position's device
    (a mesh's first data row, or the devices given), split along the
    dimension its spec names, else whole."""
    devices = (where.model_rows[0] if isinstance(where, DeviceMesh)
               else tuple(where))
    mp = len(devices)
    out = {}
    for name, value in params.items():
        spec = param_sharding_rules(name, value)
        if MODEL_AXIS in spec:
            dim = spec.index(MODEL_AXIS)
            if value.shape[dim] % mp:
                raise ValueError(f"{name}: {tuple(value.shape)} does not "
                                 f"split {mp} ways on dim {dim}")
            parts = value.chunk(mp, dim)
        else:
            parts = (value,) * mp
        out[name] = [p.to(d).contiguous() for p, d in zip(parts, devices)]
    return out


def shards_per_device(mesh: DeviceMesh) -> dict[torch.device, int]:
    """How many row shards each device holds."""
    count: dict[torch.device, int] = {}
    for d in mesh.row_devices:
        count[d] = count.get(d, 0) + 1
    return count
