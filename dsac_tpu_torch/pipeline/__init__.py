"""Batched relocalisation and its evaluation (port of
dsac_tpu/pipeline/forward.py and evaluate.py)."""

from dsac_tpu_torch.pipeline.evaluate import (FrameEval, evaluate_frame,
                                              summarize)
from dsac_tpu_torch.pipeline.forward import (
    FrameDraws, FrameResult, process_frame, process_frames_batched,
    verified_selection,
)
