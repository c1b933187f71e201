"""Stage re-exports (parity with reference `pipeline/stages.py:1-4`)."""

from lattice_tpu_torch.core.types import PipelineStage
from lattice_tpu_torch.pipeline.progress import StageProgress

__all__ = ["PipelineStage", "StageProgress"]
