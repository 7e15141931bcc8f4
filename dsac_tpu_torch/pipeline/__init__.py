"""Batched relocalisation, its evaluation and end-to-end training (port
of dsac_tpu/pipeline/forward.py, evaluate.py and train.py)."""

from dsac_tpu_torch.pipeline.evaluate import (FrameEval, evaluate_frame,
                                              summarize)
from dsac_tpu_torch.pipeline.forward import (
    FrameDraws, FrameResult, make_refiners, process_frame,
    process_frame_softam, process_frames_batched, verified_selection,
)
