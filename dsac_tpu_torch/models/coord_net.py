"""Scene-coordinate regression CNNs (port of dsac_tpu/models/coord_net.py).

* :class:`DenseCoordNet`: the fully convolutional stride-8 regressor over
  the whole image, with the plain stem (arch ``dense``), the
  space-to-depth stem (``dense_s2d``) or the dilated context stack
  (``dense_ctx``);
* :class:`PatchCoordNet`: the paper's patch net (arch ``patch``), one
  coordinate per 42x42 patch, fed by :func:`extract_patches`.

Both run like the Flax reference: each layer casts its input and weights
to ``dtype`` (bf16) and adds the bias in ``dtype``; the last layer runs
in f32.  The
dense nets reproduce Flax's ``padding="SAME"`` exactly: a stride-2 3x3
conv on an even input pads (0, 1), not (1, 1), so padding is explicit
(``F.pad``) and the convolutions themselves pad nothing.  The patch net
pads as the reference spells it out: VALID on Conv_0 and Conv_9, (1, 1)
on the others, strided ones included.  The public layout is NHWC, as in
the reference.  The convolutions run on cuDNN and the patch net's dense
layers on cuBLAS: the reference has no Pallas kernel for either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

ARCHS = ("dense", "dense_s2d", "dense_ctx", "patch")
CONTEXT_DILATIONS = (2, 4, 8, 16)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA/Flax SAME padding (low, high) of one spatial axis for a kernel
    of effective size k (a dilated 3x3 of dilation d is 2d + 1)."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_flops(size_hw: tuple[int, int], spec, cin: int) -> int:
    """Multiply-adds x 2 of a stack of (cout, k, stride, pad, ...)
    convolutions on an input of size_hw; pad None is SAME."""
    flops, (h, w) = 0, size_hw
    for cout, k, s, p, *_ in spec:
        if p is None:
            h, w = -(-h // s), -(-w // s)
        else:
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        flops += 2 * h * w * k * k * cin * cout
        cin = cout
    return flops


class DenseCoordNet(nn.Module):
    """(B, H, W, 3) RGB in [0, 255] -> (B, H/8, W/8, 3) scene coordinates
    in metres.

    ``s2d`` folds the stem's full-resolution conv and its stride-2 conv
    into a 2x2 space-to-depth rearrangement, channels ordered (dy, dx, c)
    as the reference's reshape and transpose give them, and one conv of
    12 input channels at half resolution.  ``context`` adds, after the
    last 3x3 conv, four residual dilated 3x3 convs (dilations 2, 4, 8,
    16; ``x + relu(conv(x))`` in bf16).  ``convs`` holds the layers in
    Flax's creation order, so that ``convs.i`` is ``Conv_i``.
    """

    def __init__(self, width: int = 64, s2d: bool = False,
                 context: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = width
        self.s2d, self.context, self.dtype = s2d, context, dtype
        # (out channels, kernel, stride, dilation, residual) of Conv_0 ..
        stem = [(c, 3, 1, 1, False)] if s2d else [(c, 3, 1, 1, False),
                                                  (c, 3, 2, 1, False)]
        self.spec = stem + [
            (2 * c, 3, 1, 1, False), (2 * c, 3, 2, 1, False),
            (4 * c, 3, 1, 1, False), (4 * c, 3, 2, 1, False),
            (8 * c, 3, 1, 1, False)]
        if context:
            self.spec += [(8 * c, 3, 1, d, True) for d in CONTEXT_DILATIONS]
        self.spec += [(8 * c, 1, 1, 1, False), (8 * c, 1, 1, 1, False),
                      (3, 1, 1, 1, False)]
        cin = 12 if s2d else 3
        self.convs = nn.ModuleList()
        for cout, k, *_ in self.spec:
            self.convs.append(nn.Conv2d(cin, cout, k, padding=0))
            cin = cout

    @property
    def arch(self) -> str:
        return ("dense_s2d" if self.s2d else
                "dense_ctx" if self.context else "dense")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - 127.0) / 1.0
        if self.s2d:
            B, H, W, C = x.shape
            x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        last = len(self.convs) - 1
        for i, (conv, (_cout, k, s, d, residual)) in enumerate(
                zip(self.convs, self.spec)):
            dtype = torch.float32 if i == last else self.dtype
            ph = _same_pads(x.shape[2], (k - 1) * d + 1, s)
            pw = _same_pads(x.shape[3], (k - 1) * d + 1, s)
            x = x.to(dtype)
            y = F.pad(x, (pw[0], pw[1], ph[0], ph[1])) if any(ph + pw) else x
            y = F.conv2d(y, conv.weight.to(dtype), None, stride=s,
                         dilation=d)
            y = y + conv.bias.to(dtype)[:, None, None]
            if residual:
                x = x + torch.relu(y)
            elif i != last:
                x = torch.relu(y)
            else:
                x = y
        return x.permute(0, 2, 3, 1).float().contiguous()

    def flops_per_frame(self, height: int, width: int) -> int:
        """Multiply-adds x 2 of the convolutions on one (height, width)
        frame."""
        size = (height // 2, width // 2) if self.s2d else (height, width)
        return _conv_flops(size, [(o, k, s, None) for o, k, s, *_ in
                                  self.spec], 12 if self.s2d else 3)


class PatchCoordNet(nn.Module):
    """(M, 42, 42, 3) RGB patches in [0, 255] -> (M, 3) scene coordinates
    in metres (train_obj.lua:49-102): ten 3x3 convs (64 .. 512 channels
    x width_mult, stride 2 down to 2x2), then dense layers 2048 -> 4096 ->
    4096 -> 3 (x dense_mult) on the NHWC-flattened features."""

    arch = "patch"

    def __init__(self, width_mult: float = 1.0, dense_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.width_mult, self.dense_mult = width_mult, dense_mult
        self.dtype = dtype

        def w(f):
            return max(8, int(f * width_mult))

        # (out channels, kernel, stride, padding) of Conv_0 .. Conv_9
        self.spec = [(w(64), 3, 1, 0), (w(64), 3, 2, 1), (w(128), 3, 1, 1),
                     (w(128), 3, 2, 1), (w(256), 3, 1, 1),
                     (w(256), 3, 1, 1), (w(256), 3, 2, 1),
                     (w(512), 3, 1, 1), (w(512), 3, 1, 1),
                     (w(512), 3, 2, 0)]
        cin = 3
        self.convs = nn.ModuleList()
        for cout, k, _s, _p in self.spec:
            self.convs.append(nn.Conv2d(cin, cout, k))
            cin = cout
        fc = max(16, int(4096 * dense_mult))
        self.dense = nn.ModuleList([nn.Linear(2 * 2 * cin, fc),
                                    nn.Linear(fc, fc), nn.Linear(fc, 3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = ((x - 127.0) / 1.0).to(dt).permute(0, 3, 1, 2)
        for conv, (_cout, _k, s, p) in zip(self.convs, self.spec):
            x = F.conv2d(x, conv.weight.to(dt), None, stride=s, padding=p)
            x = torch.relu(x + conv.bias.to(dt)[:, None, None])
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax's NHWC flatten order
        for fc in self.dense[:2]:
            x = torch.relu(F.linear(x, fc.weight.to(dt)) + fc.bias.to(dt))
        last = self.dense[2]
        return F.linear(x.float(), last.weight.float(), last.bias.float())

    def flops_per_patch(self, patch_size: int = 42) -> int:
        """Multiply-adds x 2 of the convolutions and dense layers on one
        patch."""
        return _conv_flops((patch_size, patch_size), self.spec, 3) + sum(
            2 * fc.in_features * fc.out_features for fc in self.dense)


def make_coord_net(arch: str, width_mult: float = 1.0) -> nn.Module:
    """The coordinate net of ``arch`` at ``width_mult``, as the
    reference's build_models sizes it (dsac_tpu/cli/common.py:254-266)."""
    if arch == "patch":
        return PatchCoordNet(width_mult=width_mult, dense_mult=width_mult)
    if arch not in ARCHS:
        raise ValueError(f"unknown coordinate-net arch {arch!r}")
    return DenseCoordNet(width=max(8, int(64 * width_mult)),
                         s2d=arch == "dense_s2d",
                         context=arch == "dense_ctx")


def extract_patches(images: torch.Tensor, centers: torch.Tensor,
                    patch_size: int) -> torch.Tensor:
    """Square patches around integer pixel centres, batched.

    images: (B, H, W, C); centers: (B, N, 2) as (x, y).  Returns
    (B * N, P, P, C).  Each patch's corner is clipped into the image, as
    the reference's ``extract_patches`` does
    (dsac_tpu/models/coord_net.py:139-156).  The gather reads a strided
    window view of the images, so it copies only the patches."""
    B, H, W, C = images.shape
    half = patch_size // 2
    x0 = torch.clamp(centers[..., 0].long() - half, 0, W - patch_size)
    y0 = torch.clamp(centers[..., 1].long() - half, 0, H - patch_size)
    windows = images.unfold(1, patch_size, 1).unfold(2, patch_size, 1)
    b = torch.arange(B, device=images.device)[:, None]
    patches = windows[b, y0, x0]  # (B, N, C, P, P)
    return patches.permute(0, 1, 3, 4, 2).flatten(0, 1)


def gather_dense_coords(coord_map: torch.Tensor, pix: torch.Tensor,
                        stride: int = 8) -> torch.Tensor:
    """Bilinear lookup of stride-s coordinate maps at pixel locations.

    coord_map: (B, H/s, W/s, 3); pix: (B, N, 2) full-resolution (x, y).
    Returns (B, N, 3).
    """
    B, gh, gw, _ = coord_map.shape
    fx = torch.clamp(pix[..., 0].float() / stride - 0.5, 0, gw - 1)
    fy = torch.clamp(pix[..., 1].float() / stride - 0.5, 0, gh - 1)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    x1 = torch.clamp(x0 + 1, max=gw - 1)
    y1 = torch.clamp(y0 + 1, max=gh - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    b = torch.arange(B, device=coord_map.device)[:, None]
    c00 = coord_map[b, y0, x0]
    c01 = coord_map[b, y0, x1]
    c10 = coord_map[b, y1, x0]
    c11 = coord_map[b, y1, x1]
    return ((1 - wy) * ((1 - wx) * c00 + wx * c01)
            + wy * ((1 - wx) * c10 + wx * c11))


def coord_apply(net: nn.Module, images: torch.Tensor, pix: torch.Tensor,
                patch_size: int = 42) -> torch.Tensor:
    """A coordinate net read at pixels pix (B, N, 2) of images
    (B, H, W, 3): a dense net's stride-8 map gathered bilinearly, or the
    patch net on the patches centred there (dsac_tpu/cli/common.py:
    254-273).  Returns (B, N, 3) metres."""
    if isinstance(net, PatchCoordNet):
        B, N = pix.shape[:2]
        return net(extract_patches(images, pix, patch_size)).reshape(B, N, 3)
    return gather_dense_coords(net(images), pix, stride=8)
