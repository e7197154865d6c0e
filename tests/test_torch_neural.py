"""The neural model reparameterization of the port against the JAX
package's, on the CPU.

examples/neural_reparam_fwi_torch.invert_nn on tests/test_neural_reparam
.py's problem, with the JAX decoder's weights carried over by
convert.decoder_from_flax (held to flax in tests/test_torch_decoder.py):
its first 3 losses equal the JAX invert_nn's (optax Adam, the plain XLA
loss) to 1e-4 on the same observed data, and the loss falls below 0.7 of
its first value in 12 steps, as in the JAX test.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sep2023_tpu as st
from sep2023_tpu import models as jmodels
from sep2023_tpu_torch import convert, parallel
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.medium import pad_model_np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import neural_reparam_fwi as jnn  # noqa: E402
import neural_reparam_fwi_torch as tnn  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


def _problem():
    """tests/test_neural_reparam.py's problem, in both packages."""
    nz, nx, npml = 40, 56, 8
    kw = dict(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0, nt=140,
              dt=0.002, f0=10.0, npml=npml)
    vp_t = np.full((nz, nx), 3000.0)
    vp_t[18:26, 20:36] += 250.0
    vp_bg = jmodels.smooth(vp_t, 8.0)
    survey = dict(src_z=np.full(3, 2), src_x=np.array([10, 28, 46]),
                  rec_z=np.full(20, 24), rec_x=np.arange(12, 32))
    stf = np.broadcast_to(np.asarray(st.ricker(10.0, 140, 0.002),
                                     np.float32), (3, 140))
    return kw, vp_t, vp_bg, survey, stf


def test_invert_nn_matches_jax():
    kw, vp_t, vp_bg, sv, stf = _problem()
    rho = 2500.0
    cfg, survey = SimConfig(**kw), Survey(**sv)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    # one set of observed data for both packages: the port's plain forward
    vp_pad = t(pad_model_np(vp_t, 8))
    vs_pad = vp_pad / np.sqrt(3.0)
    rr = torch.full_like(vp_pad, rho)
    obs = parallel.make_forward(cfg, survey, use_kernels=False,
                                device="cpu")(
        (vp_pad ** 2 - 2 * vs_pad ** 2) * rr, vs_pad ** 2 * rr, rr, t(stf))
    assert float(obs.abs().max()) > 1e-3  # receivers in wave reach
    _, jlosses = jnn.invert_nn(st.SimConfig(**kw), st.Survey(**sv), vp_bg,
                               rho, jnp.asarray(stf), jnp.asarray(obs.numpy()),
                               n_steps=3, lr=4e-3, width=8)

    params, _ = jnn.make_decoder(*vp_bg.shape, width=8)
    latent = jax.random.normal(jax.random.PRNGKey(0),
                               (-(-vp_bg.shape[0] // 4),
                                -(-vp_bg.shape[1] // 4), 8), jnp.float32)
    dec = convert.decoder_from_flax(params, latent, device="cpu")
    _, losses = tnn.invert_nn(cfg, survey, vp_bg, rho, t(stf), obs,
                              n_steps=12, lr=4e-3, width=8, device="cpu",
                              decoder=dec)
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[:3], jlosses[:3], rtol=1e-4)
    assert losses[-1] < 0.7 * losses[0], losses
