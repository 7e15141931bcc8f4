"""dsac_tpu_torch — the PyTorch/CUDA port of ``dsac_tpu``.

A second package beside the JAX reference.  Plain tensor code is PyTorch;
every Pallas kernel of the reference is a CUDA kernel written for Hopper
(``csrc/*.cu``), built with ``nvcc`` into one shared library at first use
and bound with ``ctypes`` (``ops/_build.py``).  Each kernel wrapper keeps
its plain PyTorch version beside it: a CPU tensor goes there, a CUDA tensor
goes to the kernel.

The package imports neither JAX nor ``dsac_tpu``: what it needs of the
reference it keeps as its own copy.

Layer map (mirrors ``dsac_tpu``):

  config        Camera, PoseConfig, DataConfig, NetConfig, DSACConfig
  flags         the reference's config files and short flags (-c, -fl,
                -rI, -rdraw, ...)
  geometry/     pose math and vec6, P3P (differentiable, with the
                reference's gradient cuts), Gauss-Newton refinement and
                the implicit step, pose errors
  ops/          sampling, scoring, selection, and the five CUDA kernels:
                P3P, soft-inlier score, diff-map, fused IRLS refine (with
                its init-pose backward, a torch.autograd.Function) and
                IRLS statistics
  models/       DenseCoordNet and ScoreNet (bf16 convolutions, f32
                master weights)
  data/         the synthetic room and its archetypes, rendered on the
                device, with the reference's frame sets; 7-Scenes-layout
                datasets and pose files
  pipeline/     batched DSAC and SoftAM forward passes and their refine
                modes (the hard-threshold one too), evaluation, end-to-end
                training
  utils/        npz weights (read and write), snapshots, training and
                evaluation logs, timing on the card, PNG decoding and
                prefetch (native library or the port's codec)
  cli/          serve, profile_serve, profile_kernels, test_ransac,
                test_ransac_softam, train_ransac, train_ransac_softam,
                export_synthetic, link_7scenes, and their frame sources
                and model selection (common)
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
