"""MS-TCN (counterpart of ``pytorch_video_action_tpu/models/mstcn.py``,
reference ``networks.py:298-347``): stage 1 on the features, each later
stage on the softmax of the previous one times the frame mask; a stage is
a 1x1 conv, ``num_layers`` dilated residual layers (dilation 2^i) and a
1x1 conv, frame-masked.  The output is the element-wise max of the
stages' logits (``networks.py:317-319``), raw logits trained with
cross-entropy.

The train form runs each layer through ``DilatedResidualFn`` (the layer
kernel and its backward on the card), with the global dropout stream and
one seed a layer, stage-major: the JAX default path's stream, so the same
seeds give the JAX ``Trainer``'s masks.  With ``use_pallas`` (the train
CLI's ``--use_pallas``, as in JAX) it draws the per-video stream instead,
the JAX package's Pallas layer's (``ops/conv.py:366-375``): each layer's
seed is a sequence of one uint32 a video.  The eval form runs each stage's
layers in one ``fused_stage`` launch; with gradients enabled it takes the
per-layer path instead, whose backward is a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.conv import DilatedResidualFn, conv1x1, fused_stage, init_conv1d
from ..ops.masking import length_mask
from .common import dropout_on


@dataclass(frozen=True)
class MSTCNConfig:
    dim: int = 400
    num_stages: int = 4
    num_layers: int = 20
    num_f_maps: int = 64
    n_class: int = 48
    dropout_rate: float = 0.5
    use_pallas: bool = False  # the per-video dropout stream


class DilatedResidualLayer(nn.Module):
    def __init__(self, num_f_maps: int, generator=None):
        super().__init__()
        self.conv_dilated = init_conv1d(num_f_maps, num_f_maps, 3, generator)
        self.conv_1x1 = init_conv1d(num_f_maps, num_f_maps, 1, generator)


class Stage(nn.Module):
    def __init__(self, num_layers: int, num_f_maps: int, dim: int,
                 n_class: int, generator=None):
        super().__init__()
        self.conv_in = init_conv1d(dim, num_f_maps, 1, generator)
        self.layers = nn.ModuleList(
            DilatedResidualLayer(num_f_maps, generator)
            for _ in range(num_layers))
        self.conv_out = init_conv1d(num_f_maps, n_class, 1, generator)

    def forward(self, x, maskf, mask, keep: float, seeds, train: bool,
                per_video: bool):
        """``maskf`` f32 ``[B, T]`` for the layers, ``mask`` ``[B, T, 1]``
        in x's dtype; ``seeds`` one a layer when ``keep < 1``: a uint32
        (the global stream) or, with ``per_video``, one a video."""
        out = conv1x1(self.conv_in, x)
        if train or torch.is_grad_enabled():
            for i, layer in enumerate(self.layers):
                seed = None if seeds is None else seeds[i]
                out = DilatedResidualFn.apply(
                    layer.conv_dilated.w, layer.conv_dilated.b,
                    layer.conv_1x1.w, layer.conv_1x1.b, out, maskf, 2 ** i,
                    keep, None if per_video else seed,
                    seed if per_video else None)
        else:
            out = fused_stage(
                torch.stack([l.conv_dilated.w for l in self.layers]),
                torch.stack([l.conv_dilated.b for l in self.layers]),
                torch.stack([l.conv_1x1.w[0] for l in self.layers]),
                torch.stack([l.conv_1x1.b for l in self.layers]),
                out, maskf)
        return conv1x1(self.conv_out, out) * mask


class MSTCN(nn.Module):
    name = "ms_tcn"
    stateful = False

    def __init__(self, cfg: MSTCNConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.dim] + [cfg.n_class] * (cfg.num_stages - 1)
        self.stages = nn.ModuleList(
            Stage(cfg.num_layers, cfg.num_f_maps, d, cfg.n_class, generator)
            for d in dims)

    @property
    def n_dropout_sites(self) -> int:
        """Seeds a ``train=True`` forward takes: one a layer, stage-major
        (each a sequence of one a video with :attr:`per_video_dropout`)."""
        return self.cfg.num_stages * self.cfg.num_layers

    @property
    def per_video_dropout(self) -> bool:
        return self.cfg.use_pallas

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, dim]`` -> logits ``[B, T, n_class]`` (stage max).

        ``seeds`` (train only): layer i of stage s takes ``seeds[s *
        num_layers + i]``, ``B`` of them with ``use_pallas``."""
        drop = dropout_on(self, train, seeds)
        keep = 1.0 - self.cfg.dropout_rate if drop else 1.0
        maskf = length_mask(lengths, x.shape[1]).to(torch.float32)
        mask = maskf.to(x.dtype)[:, :, None]
        n = self.cfg.num_layers
        acc = out = None
        for s, stage in enumerate(self.stages):
            inp = x if s == 0 else torch.softmax(out, dim=-1) * mask
            out = stage(inp, maskf, mask, keep,
                        seeds[s * n:(s + 1) * n] if drop else None, train,
                        self.cfg.use_pallas)
            acc = out if acc is None else torch.maximum(acc, out)
        return acc
