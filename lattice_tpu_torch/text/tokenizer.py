"""Tokenization: token counting for chunk budgets + input ids for UniXcoder.

A copy of `lattice_tpu/text/tokenizer.py` (pure Python, stdlib `re`,
`json` and `hashlib`), so both packages give a text the same ids:
- `ApproxTokenCounter`, the deterministic stand-in for tiktoken's
  `cl100k_base` count that the chunker budgets with.
- `CodeTokenizer`, the input ids of the UniXcoder encoder: true byte-level
  BPE from a `vocab.json`/`merges.txt` pair when given one, else word
  pieces hashed into a fixed vocab range, with the reference's framing
  `[CLS, <encoder-only>, SEP, tokens..., SEP]` truncated to `max_length`.

`NativeBPECounter` and `get_token_counter` are not here yet: they load the
C++ counter of `native/` through the JAX package's `utils/native.py`,
which comes over with the host stack.
"""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

_WORD_RE = re.compile(
    r"[A-Za-z]+|[0-9]{1,3}|\s+|[^\sA-Za-z0-9]+"
)
_CAMEL_RE = re.compile(
    r"[A-Z]+(?![a-z])|[A-Z][a-z]+|[a-z]+|[0-9]{1,3}|[^\sA-Za-z0-9_]|_+"
)

# GPT-2 pre-tokenizer, stdlib-re approximation: `[^\W\d_]` stands in for
# \p{L}, `\d` for \p{N}, `(?:[^\s\w]|_)` for \p{P}∪\p{S} (underscore is
# punctuation to GPT-2 since \w includes it but \p{L}/\p{N} do not). A
# leading single space folds INTO the following word — that is the Ġ-word
# convention RoBERTa ids depend on (ADVICE r1: the old path emitted the
# space as its own token and looked up bare words, silently diverging from
# RobertaTokenizer when real weights are mounted).
_GPT2_PRE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"
    r"|\s+(?!\S)|\s+"
)


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte→printable-codepoint table (order-preserving, invertible)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_MAP = _bytes_to_unicode()


class ApproxTokenCounter:
    """Deterministic approximation of a BPE token count for code.

    Splits on a GPT-style pre-tokenization boundary set, then charges long
    alphabetic runs one token per ~4 chars (BPE merges rarely exceed that on
    identifiers) and punctuation runs one token per 2 chars.
    """

    name = "approx"

    def count(self, text: str) -> int:
        if not text:
            return 0
        total = 0
        for m in _WORD_RE.finditer(text):
            tok = m.group()
            if tok.isspace():
                # runs of whitespace compress well; newlines roughly 1 each
                total += tok.count("\n") or (1 if len(tok) > 1 else 0)
            elif tok[0].isalpha():
                total += max(1, (len(tok) + 3) // 4)
            elif tok[0].isdigit():
                total += 1
            else:
                total += max(1, (len(tok) + 1) // 2)
        return total


class CodeTokenizer:
    """Deterministic tokenizer producing input ids for the UniXcoder encoder.

    Mirrors the framing of the reference tokenizer use
    (`unixcoder_provider.py:87-135`): `<s> <encoder-only> </s> tokens... </s>`
    with CLS/SEP framing and max_length truncation. When pointed at a real
    HF vocab (`vocab.json` + `merges.txt`) it performs true byte-level BPE;
    offline it hashes word pieces into [n_special, vocab_size).
    """

    PAD, CLS, SEP, UNK, MASK = 0, 1, 2, 3, 4
    MODE_ENCODER = 5   # <encoder-only>
    MODE_DECODER = 6   # <decoder-only>
    N_SPECIAL = 16

    def __init__(self, vocab_size: int = 50265,
                 vocab_dir: str | Path | None = None):
        self.vocab_size = vocab_size
        self._vocab: dict[str, int] | None = None
        self._merges: dict[tuple[str, str], int] | None = None
        if vocab_dir is not None:
            self._load_hf_vocab(Path(vocab_dir))

    # ---- optional real-vocab path --------------------------------------

    def _load_hf_vocab(self, vocab_dir: Path) -> None:
        vocab_file = vocab_dir / "vocab.json"
        merges_file = vocab_dir / "merges.txt"
        if not (vocab_file.is_file() and merges_file.is_file()):
            return
        self._vocab = json.loads(vocab_file.read_text())
        merges: dict[tuple[str, str], int] = {}
        for i, line in enumerate(merges_file.read_text().splitlines()):
            if line.startswith("#") or not line.strip():
                continue
            a, _, b = line.partition(" ")
            merges[(a, b)] = i
        self._merges = merges
        self.vocab_size = max(self.vocab_size, max(self._vocab.values()) + 1)
        # Real RoBERTa special ids differ from the hashing defaults
        # (<s>=0, <pad>=1, </s>=2, <unk>=3); framing must use the vocab's
        # own ids or real-weight embeddings read the wrong rows.
        specials = {"<pad>": "PAD", "<s>": "CLS", "</s>": "SEP",
                    "<unk>": "UNK", "<mask>": "MASK",
                    "<encoder-only>": "MODE_ENCODER",
                    "<decoder-only>": "MODE_DECODER"}
        for token, attr in specials.items():
            if token in self._vocab:
                setattr(self, attr, self._vocab[token])

    def _bpe_word(self, word: str) -> list[str]:
        """Greedy lowest-rank merge loop (standard BPE)."""
        assert self._merges is not None
        pieces = list(word)
        while len(pieces) > 1:
            best, best_rank = None, None
            for i in range(len(pieces) - 1):
                rank = self._merges.get((pieces[i], pieces[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best, best_rank = i, rank
            if best is None:
                break
            pieces[best: best + 2] = [pieces[best] + pieces[best + 1]]
        return pieces

    # ---- hashing fallback ----------------------------------------------

    def _hash_id(self, piece: str) -> int:
        digest = hashlib.blake2b(piece.encode("utf-8"), digest_size=8).digest()
        span = self.vocab_size - self.N_SPECIAL
        return self.N_SPECIAL + int.from_bytes(digest, "little") % span

    def _pieces(self, text: str) -> list[str]:
        """camelCase/snake_case aware word-piece split (code-friendly)."""
        return [m.group() for m in _CAMEL_RE.finditer(text)]

    def tokenize_ids(self, text: str) -> list[int]:
        if self._vocab is not None and self._merges is not None:
            # byte-level BPE exactly as GPT-2/RoBERTa: pre-tokenize (leading
            # space folds into the word), utf-8 bytes through the
            # order-preserving byte map (0x20 -> 'Ġ'), then greedy merges
            ids: list[int] = []
            for m in _GPT2_PRE.finditer(text):
                mapped = "".join(_BYTE_MAP[b] for b in m.group().encode("utf-8"))
                for piece in self._bpe_word(mapped):
                    ids.append(self._vocab.get(piece, self.UNK))
            return ids
        return [self._hash_id(p) for p in self._pieces(text) if not p.isspace()]

    def encode(self, text: str, max_length: int = 512,
               mode: int | None = None) -> tuple[list[int], list[int]]:
        """(input_ids, attention_mask) with UniXcoder mode-token framing.

        Layout: [CLS, mode, SEP, tokens..., SEP], truncated to max_length
        (reference `unixcoder_provider.py:87-135`).
        """
        mode = self.MODE_ENCODER if mode is None else mode
        body = self.tokenize_ids(text)[: max_length - 4]
        ids = [self.CLS, mode, self.SEP] + body + [self.SEP]
        mask = [1] * len(ids)
        return ids, mask

    def encode_batch(self, texts: list[str], max_length: int = 512
                     ) -> tuple[list[list[int]], list[list[int]]]:
        """Pad a batch to the longest sequence (PAD id 0, mask 0)."""
        encoded = [self.encode(t, max_length) for t in texts]
        longest = max((len(ids) for ids, _ in encoded), default=0)
        ids_out, mask_out = [], []
        for ids, mask in encoded:
            pad = longest - len(ids)
            ids_out.append(ids + [self.PAD] * pad)
            mask_out.append(mask + [0] * pad)
        return ids_out, mask_out
