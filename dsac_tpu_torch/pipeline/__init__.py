"""Batched relocalisation (port of dsac_tpu/pipeline/forward.py, serve
path)."""

from dsac_tpu_torch.pipeline.forward import (
    FrameDraws, FrameResult, process_frame, process_frames_batched,
)
