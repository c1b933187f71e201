"""Paired self-attention for head_dim-64 encoders (UniXcoder serving).

Port of `lattice_tpu/ops/attention.py`. `paired_attention` is masked
full-row softmax self-attention over q/k/v [B, L, H*64] in the layout the
Q/K/V projections produce (head h in columns [64h, 64h + 64)), so no
transpose feeds it; out is the f32 context in the same layout. It is the
hand-written CUDA kernel `csrc/paired_attention.cu`, which replaces
`_paired_attn_kernel` (attention.py:42). The kernel's design and what
bounds it on the H100 are written at the head of the CUDA source: both
products on tensor cores (bf16) and the [L, L] scores never in device
memory.

`paired_attention_plain` is the same function in torch, with the kernel's
rounding points: f32 scores, `s * sm_scale + neg` with neg 0 / -1e9 from
`mask > 0`, a full-row max and exp, p rounded to the input dtype before
the PV product, and the context divided by the f32 sum of p. The wrapper
takes it only for tensors on the CPU; a CUDA tensor launches the kernel or
raises `KernelError`.
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
