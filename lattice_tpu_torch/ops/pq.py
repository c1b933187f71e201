"""Product quantization: the 8x-compression capacity tier (torch port).

Port of `lattice_tpu/ops/pq.py`, which holds no Pallas kernel: its XLA
code becomes torch ops here, and its `lax.top_k` becomes kernel B
(`scan_topk.merge_positions` / `merge_candidates`, plain versions on the
CPU).

Each row is m uint8 codes, one per dsub-dim subvector, each against its
own ksub-entry codebook: 768 dims at the default dsub=4 cost 192 B/row,
8x under bf16. Scoring is asymmetric (ADC):

    score(q, n) = sum_j <q_j, cb[j, code[n, j]]>

which is the dot product of q with the reconstructed row. `pq_topk`
reconstructs a block of rows at a time by a gather of the bf16 codebooks
(the same bf16 codewords the JAX version's one-hot einsum gives), scores
the block against the whole query batch with f32 products of the
bf16-rounded operands (`full_f32`: TF32 never enters), and keeps a running
top-k: kernel B's positional entry selects each block's top k, its
candidate entry merges that into the running list, by (score desc, row id
asc) as `lax.top_k` orders the reference's running merge. Padding is -1 /
-inf. No [B, N] score matrix exists at any time.

`train_pq` runs the reference's per-subspace L2 Lloyd iterations,
blockwise so the [m, block, ksub] score slab stays bounded; empty
clusters keep their centroid. `PQIndex.build` draws its training sample
and seeds with the numpy `rng` the reference draws them with, so both
packages train from the same rows. `PQIndex.from_numpy` carries a JAX
index's arrays across.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from lattice_tpu_torch.core.errors import VectorStoreError
from lattice_tpu_torch.ops import scan_topk as scan_ops
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.ops.topk import NEG_INF, full_f32

# rows per decode-and-score step: bounds the [block, d] decoded rows and
# the [B, block] score slab
DEFAULT_BLOCK = 4096
# training sample cap: Lloyd cost is iters * Ns * ksub * d MACs; 64K rows
# bound the build to seconds while leaving >=256 points per centroid.
DEFAULT_TRAIN_ROWS = 65_536
# rows per Lloyd step: the [m, block, ksub] f32 score slab (~400 MB at
# block=2048, m=192)
TRAIN_BLOCK = 2048


def choose_m(d: int, target_dsub: int = 4) -> int:
    """Largest m with d % m == 0 and d/m >= target_dsub. dsub=4 is the
    8x-vs-bf16 tier; dsub=2 (4x) is dominated by the int4 view."""
    for dsub in range(target_dsub, d + 1):
        if d % dsub == 0:
            return d // dsub
    return 1


def _device(device: str | torch.device) -> torch.device:
    """The device exactly as asked: "cuda" without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise VectorStoreError(f"device {dev} requested but CUDA is not "
                               "available")
    return dev


def _host_bool(valid: np.ndarray | torch.Tensor) -> np.ndarray:
    """A validity mask on any device as a host bool array."""
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    return np.asarray(valid, dtype=bool)


def _offsets(m: int, ksub: int, device: torch.device) -> torch.Tensor:
    """Row offset of each subspace's codebook in the flat [m * ksub, dsub]
    table."""
    return torch.arange(m, dtype=torch.int64, device=device) * ksub


# ---- codebook training ---------------------------------------------------


def train_pq(sample: torch.Tensor, init_idx: torch.Tensor, m: int,
             ksub: int = 256, iters: int = 8, block: int = TRAIN_BLOCK
             ) -> torch.Tensor:
    """Per-subspace L2 Lloyd iterations over all m subspaces at once.

    `sample` [Ns, m * dsub] f32, `init_idx` [ksub] rows seeding every
    subspace. Assignment is argmin ||x - c||^2 = argmin (||c||^2 - 2 x.c),
    first index on ties; the update is the mean of the assigned points.
    Empty clusters keep their previous centroid. Returns codebooks
    [m, ksub, dsub] f32."""
    x = sample.to(torch.float32)
    ns, d = x.shape
    dsub = d // m
    block = max(1, min(block, ns))
    device = x.device
    cb = x[init_idx.to(device=device, dtype=torch.int64)].reshape(
        ksub, m, dsub).transpose(0, 1).contiguous()
    offs = _offsets(m, ksub, device)[:, None]
    for _ in range(iters):
        c2 = (cb * cb).sum(-1)                                # [m, ksub]
        sums = torch.zeros((m * ksub, dsub), dtype=torch.float32,
                           device=device)
        counts = torch.zeros((m * ksub,), dtype=torch.float32, device=device)
        for lo in range(0, ns, block):
            xs = x[lo:lo + block].reshape(-1, m, dsub).transpose(0, 1)
            with full_f32():
                xc = torch.bmm(xs, cb.transpose(1, 2))        # [m, bn, ksub]
            a = torch.argmin(c2[:, None, :] - 2.0 * xc, dim=-1)
            flat = (a + offs).reshape(-1)
            sums.index_add_(0, flat, xs.reshape(-1, dsub))
            counts.index_add_(0, flat, torch.ones(flat.shape[0],
                                                  dtype=torch.float32,
                                                  device=device))
        sums = sums.view(m, ksub, dsub)
        counts = counts.view(m, ksub, 1)
        cb = torch.where(counts > 0, sums / counts.clamp(min=1.0), cb)
    return cb


def pq_encode_block(block: torch.Tensor, codebooks: torch.Tensor
                    ) -> torch.Tensor:
    """Nearest-codeword assignment per subspace of [bn, d] rows. Returns
    [bn, m] uint8."""
    m, ksub, dsub = codebooks.shape
    x = block.to(torch.float32).reshape(-1, m, dsub).transpose(0, 1)
    cb = codebooks.to(torch.float32)
    with full_f32():
        xc = torch.bmm(x, cb.transpose(1, 2))                 # [m, bn, ksub]
    c2 = (cb * cb).sum(-1)
    assign = torch.argmin(c2[:, None, :] - 2.0 * xc, dim=-1)  # [m, bn]
    return assign.transpose(0, 1).to(torch.uint8).contiguous()


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstruct rows (f32) by a gather of the codebooks."""
    n, m = codes.shape
    _, ksub, dsub = codebooks.shape
    table = codebooks.to(torch.float32).reshape(m * ksub, dsub)
    idx = codes.to(torch.int64) + _offsets(m, ksub, codes.device)
    return table[idx].reshape(n, m * dsub)


# ---- search ---------------------------------------------------------------


def pq_topk(queries: torch.Tensor, codes: torch.Tensor,
            codebooks: torch.Tensor, valid: torch.Tensor, k: int,
            block: int = DEFAULT_BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k by blockwise decode-then-score with a running merge.

    Reads only the uint8 codes of the corpus. Returns (scores [B, k] f32,
    ids [B, k] i32; -1 / NEG_INF for padding), sorted by (score desc, row
    id asc). On a CUDA device the selection runs kernel B, which keeps
    lists of at most `scan_topk.MAX_K1_LONG`; a longer k raises there."""
    b = queries.shape[0]
    n, m = codes.shape
    _, ksub, dsub = codebooks.shape
    device = codes.device
    block = min(block, max(n, 1))
    k_eff = min(k, block)
    table = codebooks.to(torch.bfloat16).reshape(m * ksub, dsub)
    offs = _offsets(m, ksub, device)
    q = queries.to(device=device, dtype=torch.bfloat16).to(torch.float32)
    keep = valid.to(device=device, dtype=torch.bool)
    best_s = torch.full((b, k_eff), NEG_INF, dtype=torch.float32,
                        device=device)
    best_i = torch.full((b, k_eff), -1, dtype=torch.int32, device=device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        xhat = table[codes[lo:hi].to(torch.int64) + offs].reshape(
            hi - lo, m * dsub).to(torch.float32)
        with full_f32():
            s = q @ xhat.T                                    # [B, hi-lo]
        s = torch.where(keep[None, lo:hi], s, neg).contiguous()
        bs, bi = scan_ops.merge_positions(s, min(k_eff, hi - lo))
        best_s, best_i = scan_ops.merge_candidates(
            torch.cat([best_s, bs], dim=1).contiguous(),
            torch.cat([best_i, bi + lo], dim=1).contiguous(), k_eff)
    if k_eff < k:
        pad = k - k_eff
        best_s = torch.nn.functional.pad(best_s, (0, pad), value=NEG_INF)
        best_i = torch.nn.functional.pad(best_i, (0, pad), value=-1)
    return best_s, best_i


# ---- NumPy oracle ----------------------------------------------------------


def pq_decode_oracle(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes)
    cb = np.asarray(codebooks, np.float64)
    m = codes.shape[1]
    parts = [cb[j][codes[:, j].astype(np.int64)] for j in range(m)]
    return np.concatenate(parts, axis=1)


def pq_topk_oracle(queries, codes, codebooks, valid, k,
                   filter_mask=None) -> tuple[np.ndarray, np.ndarray]:
    """Exact ADC ranking (float64 decode)."""
    xhat = pq_decode_oracle(codes, codebooks)
    return topk_ops.topk_oracle(queries, xhat, valid, k, filter_mask)


# ---- index -----------------------------------------------------------------


class PQIndex:
    """Device-resident PQ view: uint8 codes, f32 codebooks and validity on
    one device. Row ids are the owning store's row ids; `insert` and
    `remove` keep it up to date O(delta) with frozen codebooks."""

    def __init__(self, codebooks: torch.Tensor, codes: torch.Tensor,
                 valid: torch.Tensor, n_rows: int):
        self.codebooks = codebooks
        self.codes = codes
        self.valid = valid
        self.n_rows = n_rows
        self.measured_recall: float | None = None

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def ksub(self) -> int:
        return int(self.codebooks.shape[1])

    @property
    def dim(self) -> int:
        return int(self.codebooks.shape[0] * self.codebooks.shape[2])

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def memory_bytes(self) -> int:
        return (self.codes.numel() + self.codebooks.numel() * 4
                + self.valid.numel())

    @classmethod
    def from_numpy(cls, codebooks: np.ndarray, codes: np.ndarray,
                   valid: np.ndarray, n_rows: int, *,
                   device: str | torch.device) -> "PQIndex":
        """An index from a JAX index's arrays taken as numpy
        (`np.asarray(idx.codebooks)`, `.codes`, `.valid`, `idx.n_rows`)."""
        dev = _device(device)

        def put(a, dtype):
            return torch.from_numpy(np.array(a, dtype)).to(dev)
        return cls(codebooks=put(codebooks, np.float32),
                   codes=put(codes, np.uint8), valid=put(valid, bool),
                   n_rows=int(n_rows))

    @classmethod
    def build(cls, embeddings: np.ndarray | torch.Tensor,
              valid: np.ndarray | torch.Tensor,
              m: int | None = None, ksub: int = 256,
              train_rows: int = DEFAULT_TRAIN_ROWS, iters: int = 8,
              seed: int = 0, encode_block: int = 4096,
              device: str | torch.device | None = None) -> "PQIndex":
        """Train codebooks on a live-row sample, then encode blockwise.

        A tensor `embeddings` builds on its own device; host rows go to
        `device` (by default "cuda") one block at a time, so the
        full-precision matrix need not fit there."""
        n, d = embeddings.shape
        if m is None:
            m = choose_m(d)
        if d % m:
            raise ValueError(f"dim {d} not divisible by m={m}")
        if ksub > 256:
            raise ValueError("ksub > 256 does not fit uint8 codes")
        on_device = isinstance(embeddings, torch.Tensor)
        dev = (embeddings.device if on_device and device is None
               else _device(device if device is not None else "cuda"))
        valid_np = _host_bool(valid)
        live = np.flatnonzero(valid_np)
        rng = np.random.default_rng(seed)
        n_train = min(train_rows, len(live)) or 1
        rows = (rng.choice(live, size=n_train, replace=False)
                if len(live) else np.zeros(1, np.int64))
        if on_device:
            sample = embeddings[torch.from_numpy(rows.astype(np.int64)).to(
                embeddings.device)].to(device=dev, dtype=torch.float32)
        else:
            sample = torch.from_numpy(np.asarray(
                np.asarray(embeddings)[rows], dtype=np.float32)).to(dev)
        ksub_eff = min(ksub, n_train)
        init = rng.permutation(n_train)[:ksub_eff].astype(np.int64)
        if ksub_eff < ksub:  # tiny corpora: repeat seeds, Lloyd separates
            init = np.resize(init, ksub)
        codebooks = train_pq(sample, torch.from_numpy(init).to(dev), m, ksub,
                             iters)
        parts = []
        for start in range(0, n, encode_block):
            blk = embeddings[start:start + encode_block]
            blk = (blk.to(device=dev, dtype=torch.float32) if on_device
                   else torch.from_numpy(np.asarray(blk, np.float32)).to(dev))
            parts.append(pq_encode_block(blk, codebooks))
        codes = (torch.cat(parts) if parts
                 else torch.zeros((0, m), dtype=torch.uint8, device=dev))
        return cls(codebooks=codebooks, codes=codes,
                   valid=torch.from_numpy(valid_np.copy()).to(dev), n_rows=n)

    # ---- O(delta) mutation (codebooks are frozen; ChunkStore tracks
    # churn and rebuilds past its drift threshold, as with IVF) ----------

    def insert(self, emb_rows: torch.Tensor, row_ids: Sequence[int]) -> None:
        max_row = max(row_ids)
        if max_row >= self.codes.shape[0]:
            pad = max_row + 1 - self.codes.shape[0]
            self.codes = torch.cat([self.codes, torch.zeros(
                (pad, self.m), dtype=self.codes.dtype, device=self.device)])
            self.valid = torch.cat([self.valid, torch.zeros(
                (pad,), dtype=torch.bool, device=self.device)])
            self.n_rows = max_row + 1
        new_codes = pq_encode_block(emb_rows.to(self.device), self.codebooks)
        idx = torch.as_tensor(list(row_ids), dtype=torch.int64,
                              device=self.device)
        self.codes[idx] = new_codes
        self.valid[idx] = True

    def remove(self, row_ids: Sequence[int]) -> None:
        keep = [r for r in row_ids if r < self.codes.shape[0]]
        if not keep:
            return
        self.valid[torch.as_tensor(keep, dtype=torch.int64,
                                   device=self.device)] = False

    # ---- search ---------------------------------------------------------

    def search_device(self, queries: torch.Tensor, k: int,
                      mask: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """ADC search on the index's device (tensors in and out). `mask`
        (a store's filter mask, possibly longer than the codes after the
        store grew) ANDs into the validity."""
        valid = self.valid
        if mask is not None:
            valid = valid & mask.to(self.device)[:valid.shape[0]]
        return pq_topk(queries.to(self.device, torch.float32), self.codes,
                       self.codebooks, valid, k)

    def search(self, queries: np.ndarray, k: int,
               mask: np.ndarray | torch.Tensor | None = None,
               rescore_rows: np.ndarray | None = None,
               widen: int = 4) -> tuple[np.ndarray, np.ndarray]:
        """Host entry; optional exact rescore against host-resident rows:
        the ADC scan's top max(widen * k, 32) candidates re-rank exactly on
        the host."""
        q = topk_ops.l2_normalize(np.atleast_2d(queries))
        mask_dev = (None if mask is None
                    else torch.as_tensor(mask, dtype=torch.bool))
        qt = torch.from_numpy(q)
        if rescore_rows is None:
            s, i = self.search_device(qt, k, mask_dev)
            return s.cpu().numpy(), i.cpu().numpy()
        k1 = min(max(widen * k, 32), self.codes.shape[0])
        s1, c1 = self.search_device(qt, k1, mask_dev)
        s1, c1 = s1.cpu().numpy(), c1.cpu().numpy()
        safe = np.maximum(c1, 0)
        rows = np.asarray(rescore_rows)[safe].astype(np.float32)
        scores = np.einsum("bd,bkd->bk", q, rows)
        scores = np.where(s1 > NEG_INF / 2, scores, NEG_INF)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        top_s = np.take_along_axis(scores, order, axis=1)
        top_i = np.take_along_axis(c1, order, axis=1)
        top_i = np.where(top_s > NEG_INF / 2, top_i, -1)
        return top_s, top_i

    def measure_recall(self, emb_ref: torch.Tensor | np.ndarray,
                       valid: torch.Tensor | np.ndarray,
                       n_sample: int = 128, k: int = 10,
                       seed: int = 0, rescore: bool = False) -> float:
        """Self-sample recall@k against the exact scan over `emb_ref`.

        With device rows and `rescore`, the widened ADC candidates rescore
        on the device (`scan_topk._exact_rescore`, the store's serving
        path), gathering only the [B, k1, d] candidates; the exact side is
        the blocked flat scan."""
        valid_np = _host_bool(valid)
        live = np.flatnonzero(valid_np)
        if len(live) == 0:
            self.measured_recall = 0.0
            return 0.0
        rng = np.random.default_rng(seed)
        rows = rng.choice(live, size=min(n_sample, len(live)),
                          replace=False)
        k_eff = min(k, len(live))
        if isinstance(emb_ref, torch.Tensor):
            dev = emb_ref.device
            q = emb_ref[torch.from_numpy(rows.astype(np.int64)).to(dev)].to(
                torch.float32)
            _, exact_i = topk_ops.flat_topk_blocked(
                q, emb_ref, torch.from_numpy(valid_np).to(dev), k_eff)
            exact_np = exact_i.cpu().numpy()
            q_np = q.cpu().numpy()
        else:
            q_np = np.asarray(emb_ref)[rows].astype(np.float32)
            _, exact_np = topk_ops.topk_oracle(
                q_np, emb_ref, valid_np, k_eff)
        if rescore and isinstance(emb_ref, torch.Tensor):
            qn = torch.from_numpy(topk_ops.l2_normalize(q_np)).to(dev)
            k1 = min(max(4 * k_eff, 32), self.codes.shape[0])
            s1, c1 = self.search_device(qn, k1)
            _, got_dev = scan_ops._exact_rescore(qn, emb_ref.to(dev), s1, c1,
                                                 k_eff)
            got = got_dev.cpu().numpy()
        else:
            rr = np.asarray(emb_ref, np.float32) if rescore else None
            _, got = self.search(q_np, k_eff, rescore_rows=rr)
        hits = sum(
            len(set(got[i].tolist()) & set(exact_np[i].tolist()))
            for i in range(len(rows)))
        self.measured_recall = hits / (len(rows) * k_eff)
        return self.measured_recall
