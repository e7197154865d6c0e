"""sep2023_tpu_torch — the PyTorch/CUDA port of sep2023_tpu: elastic wave
modeling for DAS full-waveform inversion on an NVIDIA GPU.

It imports torch and never jax or sep2023_tpu.  Numpy-only modules of the
JAX package (config, cpml, models, survey_tools) are copied here; the rest
is PyTorch, and every Pallas kernel on the ported path is a hand-written
CUDA kernel (csrc/, built with nvcc at first use).

Layers (bottom-up):
  ops.fd / ops.signal                stencils, taper window
  cpml, medium                       absorbing boundaries, material fields
  propagator, acoustic               plain PyTorch elastic and acoustic engines
  ops.cuda_engine, ops.cuda_acoustic the CUDA kernels, their plain versions
  parallel, convert, io              geometry, JAX-array conversion, Shot files
  imaging                            chain rules, RTM images, illumination
  api, cli                           ElasticPropagator; forward, invert, rtm
"""

from sep2023_tpu_torch.acoustic import AcGeom, propagate_acoustic
from sep2023_tpu_torch.config import (C1, C2, Grid, SimConfig, Survey,
                                      klauder, ricker, ricker_integrated)
from sep2023_tpu_torch.medium import (MatFields, Medium, material_fields,
                                      pad_model)
from sep2023_tpu_torch.propagator import (CHANNELS, ShotGeom, propagate,
                                          propagate_shots)

__version__ = "0.1.0"
