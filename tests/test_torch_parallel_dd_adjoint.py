"""The shot x domain loss's boundary-saving adjoint (`parallel._DDPropagate`)
against the whole grid's (`propagator._Propagate`), on the CPU in float64.

* The blocks' strip cells are the grid's strip cells, each once (the
  whole grid's flat layout holds the four corners twice); the blocked
  forward with strip saving gives the whole grid's data and final fields
  bit for bit, and the blocked reconstruction back to t=0 equals
  `propagator.reconstruct` bit for bit, on 1 x 2 and 1 x 3 meshes; on the
  30-column grid the block edges cut both side strips.
* What the loss saves for its backward is each block's strips and final
  fields beside the model and the wavelets: the bytes of the backward
  nodes' saved tensors are those of the local loss's, which saves the
  whole grid's strips and final fields, less the strip corners it holds
  twice and plus a model copy a row; the gradients are the local
  loss's.
"""
import numpy as np
import pytest
import torch
from torch_threads import two_threads  # noqa: F401  (autouse)

from sep2023_tpu_torch import parallel, propagator
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import pad_model_np

NPML = 8


def _problem(nz, nx, nt=50, S=2):
    """A random medium on an nz x nx grid (padded), S shots at its two
    ends and a receiver row across it, float64."""
    cfg = SimConfig(nz=nz, nx=nx, dz=20.0, dx=20.0, nt=nt, dt=0.002,
                    f0=10.0, npml=NPML)
    pz, px = nz - 2 * NPML, nx - 2 * NPML
    survey = Survey(src_z=np.full(S, 2),
                    src_x=np.linspace(3, px - 4, S).astype(int),
                    rec_z=np.full(px - 4, pz - 4), rec_x=np.arange(2, px - 2))
    rng = np.random.default_rng(15)
    vp = 3000.0 + 200.0 * rng.random((pz, px))
    rho = 2500.0 + 100.0 * rng.random((pz, px))
    t = lambda a: torch.tensor(pad_model_np(a, NPML))
    lam, mu = t(rho * vp ** 2 / 3.0), t(rho * vp ** 2 / 3.0)
    stf = torch.tensor(np.broadcast_to(ricker(cfg.f0, nt, cfg.dt),
                                       (S, nt)).copy())
    geoms = parallel.survey_to_geoms(survey, NPML, device="cpu",
                                     dtype=torch.float64)
    return cfg, survey, (lam, mu, t(rho), stf), geoms


def _stitch(blocks_fields):
    """The whole grid's 5 fields from each block's owned columns."""
    return [torch.cat([f[k] for f in blocks_fields], dim=-1)
            for k in range(propagator.N_FIELDS)]


@pytest.mark.parametrize("nx,n_x", [(52, 2), (52, 3), (30, 3)],
                         ids=["1x2", "1x3", "1x3 cutting both side strips"])
def test_blocked_reconstruction_is_bitwise(nx, n_x):
    cfg, _, (lam, mu, rho, stf), geoms = _problem(44, nx)
    data, final, strips = propagator._forward(cfg, lam, mu, rho, stf, geoms,
                                              save_bnd=True)
    f0 = propagator.reconstruct(cfg, lam, mu, rho, stf, geoms, final, strips)
    blocks = parallel._dd_blocks(cfg, [torch.device("cpu")] * n_x, lam, mu,
                                 rho, geoms)
    # each block's strip cells as (z, x) of the grid: together the grid's
    # strip cells, each once
    cells = []
    for b in blocks:
        w = b.x1 - b.x0 + 2 * parallel.HALO
        z, x = divmod(b.strip_cells.numpy(), w)
        assert ((x >= parallel.HALO) & (x < w - parallel.HALO)).all()
        cells += zip(z.tolist(), (x - parallel.HALO + b.x0).tolist())
    L, z0, z1, xl, xr = propagator._strip_bounds(cfg)
    grid = np.zeros((cfg.nz, cfg.nx), bool)
    for r in (z0, z1):
        grid[r:r + L] = True
    for c in (xl, xr):
        grid[:, c:c + L] = True
    assert sorted(cells) == sorted(zip(*(a.tolist() for a in
                                         np.nonzero(grid))))
    cut = [c for c in (xl, xr) if any(c < b.x0 < c + L for b in blocks)]
    assert len(cut) == (2 if nx == 30 else 0)
    assert len(cells) == propagator.strip_len(cfg) - 4 * L * L
    d_dd, final_dd, strips_dd = parallel._dd_forward(cfg, blocks, stf,
                                                     save_strips=True)
    assert torch.equal(d_dd, data)
    assert all(torch.equal(a, b) for a, b in zip(_stitch(final_dd), final))
    assert [s.shape for s in strips_dd] == [
        (2, cfg.nt - 1, 5, len(b.strip_cells)) for b in blocks]
    rec = parallel._dd_reconstruct(cfg, blocks, stf, final_dd, strips_dd)
    own = [[a[..., parallel.HALO:-parallel.HALO] for a in f] for f in rec]
    assert float(max(a.abs().max() for a in f0)) > 0
    for a, b in zip(_stitch(own), f0):
        assert torch.equal(a, b)


def _saved_nodes(out, name):
    """The nodes of out's graph whose class is `name`."""
    seen, todo, found = set(), [out.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == name:
            found.append(node)
        todo.extend(n for n, _ in node.next_functions)
    return found


def _saved_bytes(nodes):
    return sum(t.numel() * t.element_size() for n in nodes
               for t in n.saved_tensors)


def test_dd_saves_strips_and_final_fields():
    """One loss evaluation on a 2 x 2 mesh: its two _DDPropagate nodes save
    the bytes of the model, the rows' wavelets, the strips (S, nt-1, 5,
    the grid's strip cells) and the final fields (5, S, nz, nx): the bytes
    the local loss's _Propagate node saves for the same shots, whose flat
    strips (strip_len) hold the 4 L x L corner cells twice, and a second
    copy of the model, one a row; the gradients are the local loss's."""
    cfg, survey, (lam, mu, rho, stf), geoms = _problem(44, 52, S=4)
    obs = parallel.make_forward(cfg, survey, use_kernels=False, device="cpu",
                                dtype=torch.float64)(lam * 1.02, mu, rho, stf)
    w = torch.ones(4, dtype=torch.float64)
    params = [a.clone().requires_grad_() for a in (lam, mu, rho, stf)]
    dd = parallel.make_dd_misfit(cfg, parallel.mesh_2d(
        2, 2, devices=["cpu"] * 4))(*params, geoms, obs, w)
    local = parallel.make_local_misfit(cfg)(*params, geoms, obs, w)
    nodes = _saved_nodes(dd, "_DDPropagateBackward")
    assert len(nodes) == 2
    S, nz, nx, nt = 4, cfg.nz, cfg.nx, cfg.nt
    L = cfg.n_bnd_layers
    corners = S * (nt - 1) * 5 * 4 * L * L
    strips = S * (nt - 1) * 5 * propagator.strip_len(cfg) - corners
    model = 2 * 3 * nz * nx + S * nt   # a copy of the model a row
    want = 8 * (strips + 5 * S * nz * nx + model)
    assert _saved_bytes(nodes) == want
    assert _saved_bytes(_saved_nodes(local, "_PropagateBackward")) == \
        want - 8 * 3 * nz * nx + 8 * corners
    g = torch.autograd.grad(dd, params)
    g_lo = torch.autograd.grad(local, params)
    for a, b in zip(g, g_lo):
        assert float((a - b).abs().max()) <= 1e-8 * float(b.abs().max())
