"""The decoder CNN of the neural model reparameterization
(`examples/neural_reparam_fwi_torch.py`): PyTorch counterpart of the flax
`Decoder` of `examples/neural_reparam_fwi.py`.

A fixed latent (width, ceil(nz/4), ceil(nx/4)) goes through two levels of
3x3 'SAME' convolution, GELU (flax's nn.gelu is the tanh approximation)
and x2 bilinear upsampling with half-pixel centres (jax.image.resize
'bilinear' when it grows), then a 3x3 convolution, GELU and a 3x3
convolution to one channel, scaled as scale * tanh: a velocity
perturbation in [-scale, scale] m/s on a grid of 4 multiples, which the
caller crops.  `convert.decoder_from_flax` carries a flax decoder's weights
and latent into it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

N_CONV = 4


class Decoder(nn.Module):
    """forward() -> (4 h, 4 w) perturbation of the latent buffer (width, h,
    w).  Built with skip_init, so it draws nothing from the global random
    state; `init_lecun_normal` gives flax's default initialisation from a
    generator."""

    def __init__(self, latent: torch.Tensor, scale: float = 300.0):
        super().__init__()
        width = latent.shape[0]
        self.register_buffer("latent", latent)
        self.scale = float(scale)
        self.convs = nn.ModuleList(
            nn.utils.skip_init(nn.Conv2d, width, 1 if i == N_CONV - 1
                               else width, 3, padding=1,
                               device=latent.device)
            for i in range(N_CONV))

    @torch.no_grad()
    def init_lecun_normal(self, generator: torch.Generator):
        """flax's Conv defaults: kernels from a normal truncated at two
        standard deviations, of variance 1 / fan_in (lecun_normal), biases
        zero."""
        for conv in self.convs:
            fan_in = conv.in_channels * 3 * 3
            # the truncated normal's std is 0.8796 of its scale
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            conv.bias.zero_()
        return self

    def forward(self):
        z = self.latent[None]
        for conv in self.convs[:2]:
            z = F.gelu(conv(z), approximate="tanh")
            z = F.interpolate(z, scale_factor=2, mode="bilinear",
                              align_corners=False)
        z = F.gelu(self.convs[2](z), approximate="tanh")
        return self.scale * torch.tanh(self.convs[3](z)[0, 0])
