"""AI code summarization.

Parity target: reference `src/lattice/summarization/summarizer.py:85-273` —
strategy map per entity type, semaphore-bounded provider concurrency,
search-optimized summaries for files, classes, and functions. Degrades to a
deterministic extractive summary (docstring + signature digest) when no LLM
provider is configured, keeping the summaries collection populated offline.
"""

from __future__ import annotations

import asyncio
import logging

from lattice_tpu_torch.core.types import EntityType
from lattice_tpu_torch.parsing.models import CodeEntity, ParsedFile
from lattice_tpu_torch.summarization.prompts import SummaryPrompts

logger = logging.getLogger(__name__)


class CodeSummarizer:
    def __init__(self, llm_provider=None, max_concurrent: int = 5):
        self.llm = llm_provider
        self._semaphore = asyncio.Semaphore(max_concurrent)
        self.stats = {"files": 0, "entities": 0, "fallbacks": 0, "errors": 0}

    # ---- strategies (reference `summarizer.py:88-92`) -------------------

    async def summarize_file(self, parsed: ParsedFile) -> str:
        info = parsed.file_info
        try:
            code = info.path.read_text(encoding="utf-8", errors="replace")
        except OSError:
            code = ""
        prompt = SummaryPrompts.for_file(info.relative_path,
                                         info.language.value, code)
        summary = await self._complete(prompt)
        if summary is None:
            summary = self._extractive_file_summary(parsed)
        self.stats["files"] += 1
        return summary

    async def summarize_entity(self, entity: CodeEntity) -> str:
        if entity.entity_type == EntityType.CLASS:
            prompt = SummaryPrompts.for_class(
                entity.qualified_name, entity.base_classes, entity.code)
        else:
            prompt = SummaryPrompts.for_function(
                entity.qualified_name, entity.signature, entity.code,
                kind=entity.entity_type.value)
        summary = await self._complete(prompt)
        if summary is None:
            summary = self._extractive_entity_summary(entity)
        self.stats["entities"] += 1
        return summary

    async def _complete(self, prompt: str) -> str | None:
        if self.llm is None:
            return None
        async with self._semaphore:
            try:
                return (await self.llm.complete(
                    [{"role": "user", "content": prompt}])).strip()
            except Exception as exc:
                self.stats["errors"] += 1
                logger.warning("summarization LLM call failed: %s", exc)
                return None

    # ---- offline fallbacks ---------------------------------------------

    def _extractive_file_summary(self, parsed: ParsedFile) -> str:
        self.stats["fallbacks"] += 1
        info = parsed.file_info
        classes = [e.name for e in parsed.classes][:6]
        functions = [e.name for e in parsed.functions][:8]
        module_doc = None
        for entity in parsed.entities:
            if entity.docstring:
                module_doc = entity.docstring.splitlines()[0]
                break
        parts = [f"{info.relative_path} ({info.language.value})"]
        if classes:
            parts.append("classes: " + ", ".join(classes))
        if functions:
            parts.append("functions: " + ", ".join(functions))
        if module_doc:
            parts.append(module_doc)
        return ". ".join(parts)

    def _extractive_entity_summary(self, entity: CodeEntity) -> str:
        self.stats["fallbacks"] += 1
        parts = [f"{entity.entity_type.value} {entity.qualified_name}"]
        if entity.signature:
            parts.append(entity.signature)
        if entity.docstring:
            parts.append(entity.docstring.splitlines()[0])
        if entity.calls:
            parts.append("calls: " + ", ".join(entity.calls[:6]))
        return ". ".join(parts)
