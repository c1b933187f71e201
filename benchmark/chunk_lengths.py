"""Measure the chunk lengths that `lattice index` hands the encoder, over a
code tree, for a traffic mix's `lengths.histogram`.

    python3 benchmark/chunk_lengths.py <tree> [--max-length 512]

It takes each chunk the way the port's indexing path makes it: the port's
`FileScanner` over the tree with its default settings, `CodeParser`,
`CodeChunker` at its default budget, and the UniXcoder provider's
`CodeTokenizer` at the encoder's vocabulary, framed and truncated to
`--max-length`. With no `vocab.json`/`merges.txt` the tokenizer hashes
word pieces, as the provider does without a checkpoint. It prints one
JSON object: the tree's counts of files and chunks and the histogram of
framed lengths, `[[tokens, chunks], ...]` in order of length.

It runs on the host, on no card, and only when a mix is measured: the
benchmark's runs read the committed histogram and never this program."""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path


def chunk_lengths(tree: Path, max_length: int, vocab_size: int
                  ) -> tuple[int, list[int]]:
    """(files chunked, the framed length of every chunk) over `tree`."""
    from lattice_tpu_torch.embeddings.chunker import CodeChunker
    from lattice_tpu_torch.parsing.parser import CodeParser
    from lattice_tpu_torch.parsing.scanner import FileScanner
    from lattice_tpu_torch.text.tokenizer import CodeTokenizer

    parser, chunker = CodeParser(), CodeChunker()
    tokenizer = CodeTokenizer(vocab_size=vocab_size)
    files, lengths = 0, []
    for info in FileScanner(tree).scan():
        if not parser.supports(info.language):
            continue
        chunks = chunker.chunk_file(parser.parse_file(info))
        files += bool(chunks)
        lengths += [len(tokenizer.encode(c.content, max_length)[0])
                    for c in chunks]
    return files, lengths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--max-length", type=int, default=512)
    ap.add_argument("--vocab-size", type=int, default=51416)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    files, lengths = chunk_lengths(args.tree, args.max_length,
                                   args.vocab_size)
    print(json.dumps({"files": files, "chunks": len(lengths),
                      "histogram": sorted(Counter(lengths).items())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
