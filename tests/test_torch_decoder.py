"""The decoder CNN of the neural model reparameterization against flax's,
on the CPU: convert.decoder_from_flax builds the port's Decoder
(sep2023_tpu_torch/decoder.py) from the weights and latent of the flax
decoder of examples/neural_reparam_fwi.py, and it computes what flax
computes, to 1e-5 in float32, at odd sizes (the crop of the 4-multiple
upsample).  The port's make_decoder draws from its own generators,
repeatably.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sep2023_tpu_torch import convert

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import neural_reparam_fwi as jnn  # noqa: E402
import neural_reparam_fwi_torch as tnn  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


@pytest.mark.parametrize("nz,nx,width", [(39, 53, 8), (21, 30, 4)])
def test_decoder_from_flax_matches_flax(nz, nx, width):
    params, apply = jnn.make_decoder(nz, nx, width=width)
    # the latent of jnn.make_decoder: PRNGKey(0), (ceil(nz/4), ceil(nx/4),
    # width), float32
    latent = jax.random.normal(jax.random.PRNGKey(0),
                               (-(-nz // 4), -(-nx // 4), width),
                               jnp.float32)
    ref = np.asarray(apply(params))
    dec = convert.decoder_from_flax(params, latent, device="cpu")
    with torch.no_grad():
        out = dec()[:nz, :nx].numpy()
    assert out.shape == ref.shape == (nz, nx)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # the port's own decoder crops the same way and draws from generators
    tdec, tapply = tnn.make_decoder(nz, nx, width=width)
    assert tapply(tdec).shape == (nz, nx)
    again, _ = tnn.make_decoder(nz, nx, width=width)
    assert torch.equal(tapply(tdec), tapply(again))
