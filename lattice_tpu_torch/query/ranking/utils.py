"""Result serialization helpers.

Parity target: reference `query/ranking/utils.py:6-30`
(`ranked_results_to_search_results`) — the dict shape the CLI search
table and MCP tools consume. Kept as one canonical function so every
surface serializes identically.
"""

from __future__ import annotations

from typing import Any

from lattice_tpu_torch.query.ranking.models import RankedResult


def ranked_results_to_search_results(
        results: list[RankedResult]) -> list[dict[str, Any]]:
    """Flatten ranked results into transport dicts (reference field
    layout: top-level identity/score columns + a `metadata` bag for the
    ranking provenance)."""
    return [
        {
            "source": (result.source.value
                       if hasattr(result.source, "value")
                       else str(result.source)),
            "score": round(result.score, 4),
            # the original --json shape's keys ride along with the
            # reference layout so existing consumers keep working
            "name": result.qualified_name or result.name,
            "type": result.entity_type,
            "file": result.file_path,
            "line": result.start_line,
            "file_path": result.file_path,
            "entity_type": result.entity_type,
            "entity_name": result.name,
            "qualified_name": result.qualified_name,
            "content": result.content,
            "start_line": result.start_line,
            "end_line": result.end_line,
            "graph_node_id": result.graph_node_id or result.qualified_name,
            "metadata": {
                "signal_scores": result.signal_scores,
                "relationship": result.relationship,
                "depth_from_query": result.depth,
            },
        }
        for result in results
    ]
