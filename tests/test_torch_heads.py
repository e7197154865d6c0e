"""The heads' resident fields (`heads.Head`), on the CPU.

Each of the seven heads of `HEADS`, applied twice to float32 parameters and
once to float64 ones, gives bit for bit the blend computed directly from
the float64 fields it was built from, cast to the parameters' dtype
(`mask * resize_and_pad(p) + (1 - mask) * ref`, then the head's map), and
so do the gradients of a scalar of its output.  On `meta` tensors, which
stand for a device, the first apply copies the mask and each reference
field once and a second apply copies nothing.

    python -m pytest tests/test_torch_heads.py -q
"""
import numpy as np
import pytest
import torch

from sep2023_tpu_torch import heads, models, spans
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.medium import resize_and_pad

NZ, NX, NPML = 20, 30, 6


def _setup(name):
    grid = SimConfig(nz=NZ + 2 * NPML, nx=NX + 2 * NPML, dz=20.0, dx=20.0,
                     nt=10, dt=0.002, f0=10.0, npml=NPML).grid
    true, init, bounds, names = models.twin_experiment_setup(name, NZ, NX)
    mask = heads.default_mask(grid, 4)
    head = heads.HEADS[name](grid, init, mask=mask, bounds=bounds)
    return grid, true, init, mask, head, names


def _direct(grid, init, mask, head, params):
    """The blend and the map from the float64 fields, in params' dtype."""
    f64 = torch.float64
    m = torch.as_tensor(mask, dtype=f64)
    out = []
    for n in head.param_names:
        p = params[n]
        ref = resize_and_pad(torch.as_tensor(init[n], dtype=f64),
                             grid.nz_phys, grid.nx_phys, grid.npml)
        mp, rp = m.to(p.device, p.dtype), ref.to(p.device, p.dtype)
        pad = resize_and_pad(p, grid.nz_phys, grid.nx_phys, grid.npml)
        out.append(mp * pad + (1 - mp) * rp)
    return head.to_lame(*out)


def _value_and_grads(fn, params, names, cts):
    ps = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    outs = fn(ps)
    scalar = sum((o * c).sum() for o, c in zip(outs, cts))
    grads = torch.autograd.grad(scalar, [ps[k] for k in names])
    return [o.detach() for o in outs], grads


def _same(a, b, what):
    assert a.dtype == b.dtype, what
    assert torch.equal(a, b), (what, float((a - b).abs().max()))


@pytest.mark.parametrize("name", sorted(heads.HEADS))
def test_resident_fields_give_the_blend_bit_for_bit(name):
    grid, true, init, mask, head, names = _setup(name)
    rng = np.random.default_rng(22)
    direct = lambda ps: _direct(grid, init, mask, head, ps)
    # float32 twice (a fill, then a hit), then float64, then float32 again
    for dtype in (torch.float32, torch.float32, torch.float64,
                  torch.float32):
        params = {k: torch.as_tensor(np.asarray(v)).to(dtype)
                  for k, v in true.items()}
        cts = [torch.as_tensor(rng.standard_normal(grid.shape)).to(dtype)
               for _ in range(3)]
        got, g_got = _value_and_grads(head.apply, params, names, cts)
        want, g_want = _value_and_grads(direct, params, names, cts)
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{name} {dtype} output {i}")
        for k, a, b in zip(names, g_got, g_want):
            _same(a, b, f"{name} {dtype} gradient {k}")
    # a float64 CPU run blends with the fields themselves
    mask64, refs64 = head._fields(torch.device("cpu"), torch.float64)
    assert mask64 is head.mask
    assert all(refs64[k] is head.refs[k] for k in names)
    assert not mask64.requires_grad


def test_fields_are_copied_once_per_device_and_dtype():
    """meta stands for a device: the copies are counted there."""
    _, true, _, _, head, names = _setup("vp_vs_rho")
    params = {k: torch.empty(np.shape(v), device="meta")
              for k, v in true.items()}
    counts = []
    for _ in range(2):
        with spans.span("test.apply") as outer:
            out = head.apply(params)
        (applied,) = [s for s in list(spans.RECORDS)[-2:]
                      if s.name == "heads.apply" and s.parent == outer.id]
        counts.append((applied.h2d, applied.h2d_bytes))
    assert all(t.device.type == "meta" for t in out)
    plane = 4 * head.grid.shape[0] * head.grid.shape[1]
    assert counts == [(1 + len(names), (1 + len(names)) * plane), (0, 0)]
    # another dtype is another key
    with spans.span("heads.test") as s:
        head.blend({k: v.double() for k, v in params.items()})
    assert (s.h2d, s.h2d_bytes) == (1 + len(names),
                                    2 * (1 + len(names)) * plane)
