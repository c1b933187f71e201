"""Paired self-attention for head_dim-64 encoders (UniXcoder serving).

Port of `lattice_tpu/ops/attention.py`. `paired_attention` is masked
full-row softmax self-attention over q/k/v [B, L, H*64] in the layout the
Q/K/V projections produce (head h in columns [64h, 64h + 64)), so no
transpose feeds it; out is the f32 context in the same layout. It is the
hand-written CUDA kernel `csrc/paired_attention.cu`, which replaces
`_paired_attn_kernel` via `paired_attention` (attention.py:42, :71).

What bounds the bf16 kernel on the H100 at the encoder's shape (B=128,
L=512, H=12, every key live): bytes 0.1503 ms (q/k/v and the mask read
once, the f32 context written once, at 3.35 TB/s), operations 0.1042 ms
(103 GFLOP at 989 TFLOP/s), and B*H*L^2 = 402.7 M exps, ~0.11 ms at the
special-function units' 16 a clock per SM. What the design does (details
at the head of the CUDA source): a block of 128 queries streams K/V tiles
of 64 keys through a TMA-fed ring, so K/V cross L2 L/128 times and the
scores never leave registers; both products run on `wgmma`; each score
costs one FFMA and one `ex2` (scale and bias folded in log2 units), and a
tile's softmax runs while the tensor cores do the previous tile's PV.

Key tiles whose 64 keys are all masked are skipped when the batch row has
a live key. That is exact: the row max is then at least the live key's
score, a masked score sits ~1e9 below it, so its exp is 0 in f32 and the
tile adds zeros and leaves the max as it is. A row with no live key runs
every tile: its answer is the mean of V over all keys.

`paired_attention_plain` is the same function in torch, with the kernel's
rounding points: f32 scores, `s * sm_scale + neg` with neg 0 / -1e9 from
`mask > 0`, a full-row max and exp, p rounded to the input dtype before
the PV product, and the context divided by the f32 sum of p. The kernel's
online softmax differs from it only in rounding. The wrapper takes it only
for tensors on the CPU; a CUDA tensor launches the kernel or raises
`KernelError`.
"""

from __future__ import annotations

import torch

from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops.scan_topk import _aligned, _on_cpu, _stream
from lattice_tpu_torch.ops.topk import full_f32

HEAD_DIM = 64          # must match csrc/paired_attention.cu
PAIR = 2 * HEAD_DIM    # the reference packs head pairs: H must be even
MAX_LEN = 512          # longest L the kernel takes
MASKED = -1e9          # additive bias of a masked key (not -inf)

PAIRED_ATTENTION = _build.Kernel(
    "paired_attention", "lattice_tpu_torch/csrc/paired_attention.cu",
    "lattice_tpu/ops/attention.py:42")

_ENTRIES = {torch.bfloat16: "lt_paired_attention_bf16",
            torch.float32: "lt_paired_attention_f32"}


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H*64] -> [B, H, L, 64] as f32."""
    b, ln, w = x.shape
    return x.reshape(b, ln, w // HEAD_DIM, HEAD_DIM).transpose(1, 2).float()


def paired_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """The kernel's function in torch (`attention_oracle` with the kernel's
    rounding of p to the input dtype); [B, L, H*64] f32."""
    bsz, ln, width = q.shape
    neg = torch.where(mask > 0, 0.0, MASKED).to(torch.float32)[:, None, None, :]
    with full_f32():
        s = _heads(q) @ _heads(k).transpose(-1, -2)
    s = s * sm_scale + neg
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    with full_f32():
        c = p.to(v.dtype).float() @ _heads(v)
    return (c / denom).transpose(1, 2).reshape(bsz, ln, width)


def paired_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Self-attention over head-contiguous projections.

    q/k/v: [B, L, H*64] of one dtype, bf16 or f32, H even, 1 <= L <= 512;
    mask: [B, L] (> 0 = real token). Returns [B, L, H*64] f32 context in
    the same layout."""
    if _on_cpu(q, k, v, mask):
        return paired_attention_plain(q, k, v, mask, sm_scale)
    entry = _ENTRIES.get(q.dtype)
    if entry is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise KernelError(f"paired_attention: no kernel for q/k/v of "
                          f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise KernelError(f"paired_attention: q/k/v shapes {tuple(q.shape)} "
                          f"{tuple(k.shape)} {tuple(v.shape)}")
    bsz, ln, width = q.shape
    if width % PAIR or not 1 <= ln <= MAX_LEN or mask.shape != (bsz, ln):
        raise KernelError(f"paired_attention: [B, L, W] = {tuple(q.shape)} "
                          f"with mask {tuple(mask.shape)}: need W a multiple "
                          f"of {PAIR} (head pairs of {HEAD_DIM}), 1 <= L <= "
                          f"{MAX_LEN}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and _aligned(q, k, v)):
        raise KernelError("paired_attention: q/k/v must be contiguous and "
                          "16-byte aligned")
    out = torch.empty((bsz, ln, width), dtype=torch.float32, device=q.device)
    if bsz == 0:
        return out
    mask_i = mask.to(torch.int32).contiguous()
    with torch.cuda.device(q.device):
        PAIRED_ATTENTION.launch(
            entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
            bsz, ln, width // HEAD_DIM, float(sm_scale), out.data_ptr(),
            _stream(q.device))
    return out
