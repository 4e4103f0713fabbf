"""LaMa inpainting (big-lama's FFCResNetGenerator).

The counterpart of the JAX package's `models/lama.py` (reference:
test/remove_foreground.py:11-42 inpaints the dilated foreground mask with
`saicinpainting`'s LamaInpainter):

* stem: ReflectionPad(3) + 7x7 FFC (ratio 0 -> 0) + BN + ReLU;
* 3 stride-2 reflect-padded downsampling FFCs (the last splits the
  channels 25/75 into local and global branches);
* 18 FFC residual blocks at ratio 0.75: local <-> global 3x3 cross convs
  plus a SpectralTransform global path (1x1 conv -> FourierUnit: rfft2,
  a 1x1 conv over the per-channel interleaved (re, im), irfft2 -> 1x1
  conv);
* 3 ConvTranspose(3, stride 2, pad 1, output_padding 1) + BN + ReLU;
* ReflectionPad(3) + 7x7 conv + sigmoid.

Module names are the release checkpoint's (`model.<i>.*` of the
generator), so its state dict loads strictly (models/weights_lama.py).
BatchNorm runs in eval mode (running statistics). fp32, NCHW; the FFTs are
`torch.fft.rfft2` / `irfft2` with norm="ortho".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from diffusionhandles_tpu_torch.utils.device import (deterministic_cudnn,
                                                     resolve_device)


@dataclasses.dataclass(frozen=True)
class LamaConfig:
    input_nc: int = 4           # rgb + mask
    output_nc: int = 3
    ngf: int = 64
    n_downsampling: int = 3
    n_blocks: int = 18          # big-lama; lama-fourier uses 9
    resnet_ratio: float = 0.75  # big-lama's global-branch share
    max_features: int = 1024


class FourierUnit(nn.Module):
    """rfft2 -> 1x1 conv + BN + ReLU over the interleaved (re, im)
    channels -> irfft2 (channels in == out)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(channels * 2, channels * 2, 1,
                                    bias=False)
        self.bn = nn.BatchNorm2d(channels * 2)

    def forward(self, x):
        b, c, h, w = x.shape
        ff = torch.fft.rfft2(x.float(), norm="ortho")        # [B, C, H, Wf]
        ff = torch.stack([ff.real, ff.imag], dim=2)          # [B, C, 2, H, Wf]
        ff = ff.reshape(b, 2 * c, h, -1)                     # c0 re, c0 im, ..
        ff = torch.relu(self.bn(self.conv_layer(ff)))
        ff = ff.reshape(b, c, 2, h, -1)
        return torch.fft.irfft2(torch.complex(ff[:, :, 0], ff[:, :, 1]),
                                s=(h, w), norm="ortho")


class SpectralTransform(nn.Module):
    """1x1 reduce -> FourierUnit -> 1x1 expand (enable_lfu=False, as
    big-lama)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        half = out_channels // 2
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_channels, half, 1, bias=False),
            nn.BatchNorm2d(half), nn.ReLU())
        self.fu = FourierUnit(half)
        self.conv2 = nn.Conv2d(half, out_channels, 1, bias=False)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(x + self.fu(x))


class FFC(nn.Module):
    """Fast Fourier convolution: local/global channel split with four
    cross paths (absent ones are None); spatial convs are bias-free with
    reflect padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, ratio_gin: float, ratio_gout: float,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        in_cg = int(in_channels * ratio_gin)
        in_cl = in_channels - in_cg
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg

        def conv(ic, oc):
            return nn.Conv2d(ic, oc, kernel_size, stride, padding,
                             bias=False, padding_mode="reflect")

        self.convl2l = conv(in_cl, out_cl) if in_cl and out_cl else None
        self.convl2g = conv(in_cl, out_cg) if in_cl and out_cg else None
        self.convg2l = conv(in_cg, out_cl) if in_cg and out_cl else None
        self.convg2g = (SpectralTransform(in_cg, out_cg)
                        if in_cg and out_cg else None)
        self.has_l, self.has_g = out_cl > 0, out_cg > 0

    @staticmethod
    def _sum(*terms):
        terms = [t for t in terms if t is not None]
        return terms[0] + terms[1] if len(terms) == 2 else terms[0]

    def forward(self, x_l, x_g):
        out_l = out_g = None
        if self.has_l:
            out_l = self._sum(
                self.convl2l(x_l) if self.convl2l is not None else None,
                self.convg2l(x_g) if self.convg2l is not None else None)
        if self.has_g:
            out_g = self._sum(
                self.convl2g(x_l) if self.convl2g is not None else None,
                self.convg2g(x_g) if self.convg2g is not None else None)
        return out_l, out_g


class FFCBnAct(nn.Module):
    """FFC, then BatchNorm + ReLU on each branch present (the release's
    FFC_BN_ACT)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, ratio_gin: float, ratio_gout: float,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.ffc = FFC(in_channels, out_channels, kernel_size, ratio_gin,
                       ratio_gout, stride, padding)
        out_cg = int(out_channels * ratio_gout)
        self.bn_l = (nn.BatchNorm2d(out_channels - out_cg)
                     if out_cg < out_channels else None)
        self.bn_g = nn.BatchNorm2d(out_cg) if out_cg else None

    def forward(self, x_l, x_g):
        y_l, y_g = self.ffc(x_l, x_g)
        if y_l is not None:
            y_l = torch.relu(self.bn_l(y_l))
        if y_g is not None:
            y_g = torch.relu(self.bn_g(y_g))
        return y_l, y_g


class FFCResnetBlock(nn.Module):
    def __init__(self, dim: int, ratio: float):
        super().__init__()
        self.conv1 = FFCBnAct(dim, dim, 3, ratio, ratio, padding=1)
        self.conv2 = FFCBnAct(dim, dim, 3, ratio, ratio, padding=1)

    def forward(self, x_l, x_g):
        h_l, h_g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + h_l, x_g + h_g


class LamaGenerator(nn.Module):
    """[B, input_nc, H, W] (masked rgb + mask) -> rgb [B, 3, H, W] in
    (0, 1). `model` is the release's Sequential; its parameter-free layers
    (pads, the concat, ReLUs, the sigmoid) are kept as Identity slots so
    that the indices match. cuDNN runs its deterministic algorithms here
    (the upsampling transposed convs), so an inpainting is the same bits
    each call."""

    def __init__(self, config: LamaConfig):
        super().__init__()
        self.config = cfg = config
        ngf, mf, nd = cfg.ngf, cfg.max_features, cfg.n_downsampling
        layers = [nn.Identity(),  # ReflectionPad2d(3)
                  FFCBnAct(cfg.input_nc, ngf, 7, 0.0, 0.0)]
        for i in range(nd):
            gout = cfg.resnet_ratio if i == nd - 1 else 0.0
            layers.append(FFCBnAct(min(mf, ngf * 2 ** i),
                                   min(mf, ngf * 2 ** (i + 1)), 3, 0.0, gout,
                                   stride=2, padding=1))
        dim = min(mf, ngf * 2 ** nd)
        layers += [FFCResnetBlock(dim, cfg.resnet_ratio)
                   for _ in range(cfg.n_blocks)]
        layers.append(nn.Identity())  # ConcatTupleLayer
        for i in range(nd):
            out = min(mf, ngf * 2 ** (nd - i - 1))
            layers += [nn.ConvTranspose2d(min(mf, ngf * 2 ** (nd - i)), out,
                                          3, stride=2, padding=1,
                                          output_padding=1),
                       nn.BatchNorm2d(out), nn.ReLU()]
        layers += [nn.Identity(),  # ReflectionPad2d(3)
                   nn.Conv2d(ngf, cfg.output_nc, 7), nn.Sigmoid()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        with deterministic_cudnn():
            return self._generate(x)

    def _generate(self, x):
        cfg = self.config
        m = self.model
        pad = lambda t: nn.functional.pad(t, (3, 3, 3, 3), mode="reflect")
        x_l, x_g = m[1](pad(x), None)
        for i in range(2, 2 + cfg.n_downsampling + cfg.n_blocks):
            x_l, x_g = m[i](x_l, x_g)
        h = torch.cat([t for t in (x_l, x_g) if t is not None], dim=1)
        up = 3 + cfg.n_downsampling + cfg.n_blocks
        for layer in m[up:up + 3 * cfg.n_downsampling]:
            h = layer(h)
        return m[-1](m[-2](pad(h)))


@torch.no_grad()
def seeded_init_lama_(model: nn.Module,
                      generator: torch.Generator) -> nn.Module:
    """Seeded random weights as flax initializes the JAX model: LeCun
    truncated-normal kernels, zero biases, unit BatchNorm scales (running
    mean 0 and variance 1, the BatchNorm defaults)."""
    from diffusionhandles_tpu_torch.diffuser import seeded_init_
    seeded_init_(model, generator)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model


class ForegroundRemover:
    """Service-level interface (the reference's
    webapp/webapps/foreground_remover_webapp.py)."""

    def remove_foreground(self, img: np.ndarray, fg_mask: np.ndarray,
                          dilation: int = 0) -> np.ndarray:
        """img [1, 3, H, W] in [0, 1], fg_mask [1, 1, H, W] -> bg image."""
        raise NotImplementedError


class LamaInpainter(ForegroundRemover):
    """`saicinpainting.LamaInpainter.inpaint` semantics on `device`
    (default: the GPU): the input is concat([img * (1 - mask), mask]) and
    the known pixels are kept. Weights from `params` (a generator state
    dict, `model.<i>.*`), else `checkpoint_path` (a released big-lama
    checkpoint), else seeded random."""

    def __init__(self, config: Optional[LamaConfig] = None, params=None,
                 seed: int = 0, checkpoint_path: Optional[str] = None,
                 device=None):
        self.config = config or LamaConfig()
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = LamaGenerator(self.config)
        if checkpoint_path is not None:
            from diffusionhandles_tpu_torch.models.weights_lama import \
                load_lama_checkpoint
            params = load_lama_checkpoint(checkpoint_path, self.config)
        if params is None:
            seeded_init_lama_(self.model, torch.Generator(
                device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    @torch.no_grad()
    def inpaint(self, image, mask) -> np.ndarray:
        """image [1, 3, H, W] in [0, 1], mask [1, 1, H, W] binary ->
        [1, 3, H, W]."""
        x = torch.as_tensor(np.ascontiguousarray(image, np.float32),
                            device=self.device)
        m = torch.as_tensor(np.ascontiguousarray(mask, np.float32),
                            device=self.device)
        out = self.model(torch.cat([x * (1.0 - m), m], dim=1))
        return (out * m + x * (1.0 - m)).cpu().numpy()

    def remove_foreground(self, img, fg_mask, dilation: int = 0):
        """img [1, 3, H, W] in [0, 1], fg_mask [1, 1, H, W] -> bg image,
        the mask dilated `dilation` times first (reference:
        test/remove_foreground.py:34-40)."""
        from diffusionhandles_tpu_torch.ops.morphology import \
            binary_dilation_iter
        img = np.asarray(img, np.float32)
        mask = np.asarray(fg_mask, np.float32).reshape(
            1, 1, img.shape[-2], img.shape[-1])
        if dilation > 0:
            mask = binary_dilation_iter(torch.from_numpy(mask[0, 0]) > 0.5,
                                        dilation).float().numpy()[None, None]
        return self.inpaint(img, mask)


def tiny_lama_config(**overrides) -> LamaConfig:
    base = dict(ngf=8, n_downsampling=2, n_blocks=2)
    base.update(overrides)
    return LamaConfig(**base)
