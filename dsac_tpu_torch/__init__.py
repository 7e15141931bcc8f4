"""dsac_tpu_torch — the PyTorch/CUDA port of ``dsac_tpu``.

A second package beside the JAX reference.  Plain tensor code is PyTorch;
every Pallas kernel of the serve path is a CUDA kernel written for Hopper
(``csrc/*.cu``), built with ``nvcc`` into one shared library at first use
and bound with ``ctypes`` (``ops/_build.py``).  Each kernel wrapper keeps
its plain PyTorch version beside it: a CPU tensor goes there, a CUDA tensor
goes to the kernel.

The package imports neither JAX nor ``dsac_tpu``: what it needs of the
reference it keeps as its own copy.

Layer map (mirrors ``dsac_tpu``):

  config        Camera, PoseConfig, DataConfig, NetConfig, DSACConfig
  geometry/     pose math, P3P, Gauss-Newton refinement, pose errors
  ops/          sampling, scoring, selection, and the three CUDA kernels
  models/       DenseCoordNet (bf16 convolutions)
  data/         the default synthetic room, rendered on the device
  pipeline/     batched relocalisation (process_frames_batched)
  cli/          serve
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is chains of tiny f32 products whose error compounds into pose
# error: keep true f32 everywhere, like dsac_tpu/__init__.py:36 sets
# jax_default_matmul_precision="highest".  The CNN opts into bf16 itself.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> _torch.device:
    """The device an entry point runs on; raises rather than falling back.

    Entry points default to ``"cuda"``.  Without a card they raise unless
    the caller asked for the CPU explicitly.
    """
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev
