"""Summarization prompt templates.

Parity target: reference `src/lattice/summarization/prompts.py:3-181` —
search-optimized prompts per entity kind emphasizing action verbs and
searchable keywords, with per-kind source-char caps (8000 file / 4000
function / 6000 class).
"""

from __future__ import annotations

MAX_FILE_CHARS = 8000
MAX_FUNCTION_CHARS = 4000
MAX_CLASS_CHARS = 6000

FILE_PROMPT = (
    "Summarize this source file for a code-search index. Write 2-4 dense "
    "sentences: what the file provides, the key classes/functions, and the "
    "concepts a developer would search for. Use concrete action verbs and "
    "domain keywords; no filler, no markdown.\n\n"
    "Path: {path}\nLanguage: {language}\n\n```\n{code}\n```"
)

FUNCTION_PROMPT = (
    "Summarize this {kind} for a code-search index in 1-2 sentences: what "
    "it does, its inputs/outputs, and notable side effects. Lead with an "
    "action verb; include searchable keywords; no filler.\n\n"
    "Qualified name: {qualified_name}\nSignature: {signature}\n\n"
    "```\n{code}\n```"
)

CLASS_PROMPT = (
    "Summarize this class for a code-search index in 2-3 sentences: its "
    "responsibility, key methods, and how it relates to its base classes. "
    "Use searchable keywords; no filler.\n\n"
    "Qualified name: {qualified_name}\nBases: {bases}\n\n```\n{code}\n```"
)


class SummaryPrompts:
    @staticmethod
    def for_file(path: str, language: str, code: str) -> str:
        return FILE_PROMPT.format(path=path, language=language,
                                  code=code[:MAX_FILE_CHARS])

    @staticmethod
    def for_function(qualified_name: str, signature: str, code: str,
                     kind: str = "function") -> str:
        return FUNCTION_PROMPT.format(
            kind=kind, qualified_name=qualified_name, signature=signature,
            code=code[:MAX_FUNCTION_CHARS])

    @staticmethod
    def for_class(qualified_name: str, bases: list[str], code: str) -> str:
        return CLASS_PROMPT.format(
            qualified_name=qualified_name,
            bases=", ".join(bases) or "none",
            code=code[:MAX_CLASS_CHARS])
