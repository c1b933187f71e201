"""The port's tokenizer against the JAX package's, file by file.

Every file of the golden fixture project goes through both
`CodeTokenizer`s: in hashing mode (no vocab, at the provider's vocab size
and at the default) and with a tiny byte-level `vocab.json`/`merges.txt`
pair written to a temporary directory (unknown pieces map to <unk>, so the
BPE path, the byte map and the special ids are all exercised). Ids and
masks must be equal, single and batched, at max_length 512 and 64.
"""

import json
from pathlib import Path

import pytest

from lattice_tpu.text.tokenizer import ApproxTokenCounter as JaxCounter
from lattice_tpu.text.tokenizer import CodeTokenizer as JaxTokenizer
from lattice_tpu.text.tokenizer import _BYTE_MAP
from lattice_tpu_torch.text.tokenizer import ApproxTokenCounter, CodeTokenizer

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "golden_project"
FILES = sorted(str(p.relative_to(FIXTURE)) for p in FIXTURE.rglob("*")
               if p.is_file())

MERGES = ["Ġ d", "Ġd e", "Ġde f", "s e", "se l", "sel f", "r e", "re t",
          "ret u", "retu r", "retur n", "Ġ retur", "i m", "im p", "Ġ =",
          "Ċ Ġ", "Ġ Ġ", "ĠĠ ĠĠ", "( s", "c l", "cl a", "cla s", "clas s"]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A tiny RoBERTa-style vocab: the specials at their real ids, the
    printable ASCII bytes and every merge product; anything else is
    <unk>."""
    d = tmp_path_factory.mktemp("vocab")
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4,
             "<encoder-only>": 5}
    for b in range(0x20, 0x7f):
        vocab.setdefault(_BYTE_MAP[b], len(vocab))
    vocab.setdefault(_BYTE_MAP[0x0a], len(vocab))
    for m in MERGES:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return d


def _text(name: str) -> str:
    return (FIXTURE / name).read_text(encoding="utf-8")


@pytest.mark.parametrize("vocab_size", [51416, 50265])
@pytest.mark.parametrize("name", FILES)
def test_hashing_ids_match(name, vocab_size):
    text = _text(name)
    ours = CodeTokenizer(vocab_size=vocab_size)
    ref = JaxTokenizer(vocab_size=vocab_size)
    assert ours.tokenize_ids(text) == ref.tokenize_ids(text)
    for max_length in (512, 64):
        ids, mask = ours.encode(text, max_length)
        assert (ids, mask) == ref.encode(text, max_length)
        assert len(ids) <= max_length and ids[:3] == [ours.CLS,
                                                      ours.MODE_ENCODER,
                                                      ours.SEP]
        assert ids[-1] == ours.SEP
    assert ApproxTokenCounter().count(text) == JaxCounter().count(text)


@pytest.mark.parametrize("name", FILES)
def test_bpe_ids_match(name, vocab_dir):
    text = _text(name)
    ours = CodeTokenizer(vocab_size=51416, vocab_dir=vocab_dir)
    ref = JaxTokenizer(vocab_size=51416, vocab_dir=vocab_dir)
    assert (ours.CLS, ours.SEP, ours.PAD, ours.UNK) == (0, 2, 1, 3)
    got = ours.tokenize_ids(text)
    assert got == ref.tokenize_ids(text)
    assert ours.encode(text, 512) == ref.encode(text, 512)


@pytest.mark.parametrize("use_vocab", [False, True])
def test_batches_match(use_vocab, vocab_dir):
    texts = [_text(n)[:2000] for n in FILES] + ["", "x"]
    vd = vocab_dir if use_vocab else None
    ours = CodeTokenizer(vocab_size=51416, vocab_dir=vd)
    ref = JaxTokenizer(vocab_size=51416, vocab_dir=vd)
    for max_length in (512, 128):
        ids, mask = ours.encode_batch(texts, max_length)
        assert (ids, mask) == ref.encode_batch(texts, max_length)
        assert len({len(r) for r in ids}) == 1
        if use_vocab:  # bytes outside the tiny vocab (tabs, utf-8) -> <unk>
            assert any(ours.UNK in r for r in ids)
        assert all(sum(m) == len(ours.encode(t, max_length)[0])
                   for t, m in zip(texts, mask))
