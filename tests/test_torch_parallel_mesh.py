"""The port's sharded paths against the JAX package's, on the CPU: check 2
of `__graft_entry__.py::dryrun_multichip` (the CLI's loss builder with a
mesh and per-trace conditioning), the kernels' sharded loss on a ragged
survey that the mesh pads, `make_forward(mesh=)` and the 4 x 2 shot x
domain mesh (check 4), on tests/test_torch_parallel_sharded.py's problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel_sharded import (_close, _jax_vg, _port, _port_vg,
                                         _survey, problem)  # noqa: F401
from torch_threads import two_threads  # noqa: F401  (autouse)

import sep2023_tpu as st
from sep2023_tpu import cli as jcli
from sep2023_tpu import parallel as jpar
from sep2023_tpu.config import Survey as JSurvey
from sep2023_tpu.ops import misfit as jmf
from sep2023_tpu_torch import cli, parallel, propagator
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.medium import MatFields, material_fields
from sep2023_tpu_torch.propagator import ShotGeom

CPU8 = ("cpu",) * 8


def test_cli_builder_sharded_per_trace(problem):
    """Check 2: cli.build_stage_loss with a mesh and per-trace windows and
    weights (the loss `invert --n-devices` takes on the CPU) against the
    JAX CLI's builder over a 4-device mesh."""
    cfg, arrays, survey = problem
    model, geoms, obs, w = _port(arrays, survey, cfg)
    rng = np.random.default_rng(5)
    ws = rng.uniform(0, 10, (8, 12))
    we = rng.uniform(40, cfg.nt - 1, (8, 12))
    tw = rng.uniform(0.5, 2.0, (8, 12))
    aux = tuple(torch.tensor(a) for a in (ws, we, tw))
    loss = cli.build_stage_loss(cfg, survey, geoms, use_kernels=False,
                                mesh=parallel.shot_mesh(4, device="cpu"),
                                shot_chunk=0, channels=("ett",),
                                per_trace=True)
    v, g = _port_vg(loss, model, (obs, w, *aux))

    jcfg = st.SimConfig(nz=44, nx=52, dz=20.0, dx=20.0, nt=60, dt=0.002,
                        f0=10.0, npml=8)
    jsurvey = JSurvey(**_survey())
    jgeoms = jpar.survey_to_geoms(jsurvey, 8, dtype=jnp.float64)
    jloss = jcli.build_stage_loss(jcfg, jsurvey, jgeoms, use_pallas=False,
                                  mesh=jpar.shot_mesh(4), shot_chunk=0,
                                  channels=("ett",), per_trace=True)
    lam, mu, rho, stf, jobs, jw = (jnp.asarray(a) for a in arrays)
    v_j, g_j = _jax_vg(jloss, (lam, mu, rho, stf, jobs, jw,
                               *(jnp.asarray(a) for a in (ws, we, tw))))
    _close(v, g, v_j, g_j, 1e-10, 1e-8)


def test_cuda_sharded_misfit_ragged_padded():
    """A ragged survey (tests/test_ragged.py's, 3 shots here) over 2
    shards, padded to 4: make_cuda_sharded_misfit with per-trace aux on CPU
    tensors against the unsharded make_cuda_misfit on the 3 real shots and
    the JAX package's sharded Pallas loss (interpret mode) on the same
    padded shots: each shard must fire its own shots' sources and pick its
    own spreads out of the union."""
    npml = 10
    cfg = SimConfig(nz=60, nx=76, dz=20.0, dx=20.0, nt=100, dt=0.002,
                    f0=10.0, npml=npml)
    jcfg = st.SimConfig(nz=60, nx=76, dz=20.0, dx=20.0, nt=100, dt=0.002,
                        f0=10.0, npml=npml)
    kw = dict(src_z=np.array([2, 2, 2]), src_x=np.array([14, 40, 28]),
              rec_z=np.array([[30] * 12 + [30] * 4, [32] * 16, [31] * 16]),
              rec_x=np.array([list(range(14, 26)) + [25] * 4,
                              list(range(18, 34)), list(range(20, 36))]),
              rec_live=np.array([[1.0] * 12 + [0.0] * 4, [1.0] * 16,
                                 [1.0] * 16]))
    survey, jsurvey = Survey(**kw), JSurvey(**kw)
    vp = np.full((60, 76), 3000.0)
    vp[26:32, 30:44] += 220.0
    rho = np.full_like(vp, 2500.0)
    mu = rho * vp ** 2 / 3.0
    lam, mu, rho = (a.astype(np.float32) for a in
                    (rho * vp ** 2 - 2.0 * mu, mu, rho))
    stf = np.broadcast_to(st.ricker(cfg.f0, cfg.nt, cfg.dt),
                          (3, cfg.nt)).astype(np.float32)
    t = lambda a: torch.tensor(np.asarray(a)).float()
    fwd = parallel.make_forward(cfg, survey, use_kernels=True, device="cpu")
    obs = fwd(t(lam * 1.02), t(mu), t(rho), t(stf))
    tw = survey.live_trace_weights()
    aux = (np.zeros(tw.shape), np.full(tw.shape, cfg.nt - 1.0), tw)
    fn = parallel.mf.make_preprocessed_l2(channels=("ett",), dt=cfg.dt,
                                          per_trace=True)
    w = torch.ones(3)
    v_lo, g_lo = _port_vg(parallel.make_cuda_misfit(cfg, survey, misfit_fn=fn),
                          (lam, mu, rho, stf),
                          (obs, w, *(t(a) for a in aux)))

    mesh = parallel.shot_mesh(2, device="cpu")
    geoms = parallel.survey_to_geoms(survey, npml, device="cpu")
    stf_p, _, obs_p, w_p, aux_p = parallel.pad_shots(
        t(stf), geoms, obs, w, 2, tuple(t(a) for a in aux))
    loss = parallel.make_cuda_sharded_misfit(
        cfg, parallel.pad_survey(survey, 2), mesh, misfit_fn=fn,
        n_trace_aux=3)
    p = [t(a).requires_grad_() for a in (lam, mu, rho, stf)]
    v = loss(*p[:3], parallel._pad_rows(p[3], 1), obs_p, w_p, *aux_p)
    g = [a.numpy() for a in torch.autograd.grad(v, p)]
    _close(float(v.detach()), g, v_lo, g_lo, 1e-6, 2e-5)

    jfn = jmf.make_preprocessed_l2(channels=("ett",), dt=cfg.dt,
                                   per_trace=True)
    jloss = jpar.make_pallas_sharded_misfit(
        jcfg, jpar.pad_survey(jsurvey, 2), jpar.shot_mesh(2), misfit_fn=jfn,
        n_trace_aux=3)
    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)
    jv = float(jax.jit(jloss)(f32(lam), f32(mu), f32(rho),
                              f32(stf_p.numpy()), f32(obs_p.numpy()),
                              f32(w_p.numpy()),
                              *(f32(a.numpy()) for a in aux_p)))
    assert float(v.detach()) == pytest.approx(jv, rel=1e-5)


@pytest.mark.parametrize("use_kernels,dtype", [
    (False, torch.float64), (True, torch.float32)],
    ids=["plain propagator", "kernels' plain versions"])
def test_make_forward_mesh_matches_unsharded(problem, use_kernels, dtype):
    """make_forward(mesh=) over 3 shards, the 8 shots padded to 9, equals
    the unsharded forward (the shots are independent: bit for bit), with
    shot chunks inside the shards too."""
    cfg, arrays, survey = problem
    if use_kernels:
        survey = Survey(**_survey(rec_x=np.arange(8, 20)))
    (lam, mu, rho, stf), *_ = _port(arrays, survey, cfg, dtype)
    one = parallel.make_forward(cfg, survey, use_kernels=use_kernels,
                                device="cpu", dtype=dtype)(lam, mu, rho, stf)
    for chunk in (0, 2):
        out = parallel.make_forward(
            cfg, survey, use_kernels=use_kernels, shot_chunk=chunk,
            mesh=parallel.shot_mesh(3, device="cpu"), device="cpu",
            dtype=dtype)(lam, mu, rho, stf)
        assert out.shape == one.shape == (8, 4, survey.n_rec, cfg.nt)
        assert float((out - one).abs().max()) <= 1e-12 * float(
            one.abs().max())


def _autograd_oracle(cfg):
    """The local loss differentiated by plain autograd through every
    `propagator.elastic_step`, the material fields' gradients kept inside
    the interior: the exact gradient of the discrete forward."""
    def loss(lam, mu, rho, stf, geoms, obs, weights):
        mz, mx = propagator._interior_mask(cfg, device=lam.device,
                                           dtype=lam.dtype)
        mat = MatFields(*(torch.where((mz * mx) > 0, m, m.detach())
                          for m in material_fields(lam, mu, rho)))
        cp, mask_f = propagator._consts(cfg, device=lam.device,
                                        dtype=lam.dtype)
        state = propagator.zero_state((stf.shape[0], cfg.nz, cfg.nx),
                                      device=lam.device, dtype=lam.dtype)
        recs = [torch.zeros((stf.shape[0], 4, geoms.rec_z.shape[1]),
                            dtype=lam.dtype)]
        for it in range(cfg.nt - 1):
            state, r = propagator.elastic_step(state, mat, stf[:, it], geoms,
                                               cp, mask_f, cfg)
            recs.append(r)
        syn = torch.stack(recs, dim=-1)
        return (weights * parallel.default_shot_misfit(("ett",))(obs, syn)
                ).sum()

    return loss


def test_dd_misfit_matches_jax_and_local(problem):
    """The 4 x 2 shot x domain mesh (dry run check 4, tests/test_parallel.py
    ::test_dd_2d_mesh_matches_local): make_dd_misfit's hand-written halo
    exchange and its boundary-saving adjoint on the blocks against the
    local loss and the JAX package's GSPMD one, on 4 shots: the loss and
    the gradients of lam, mu, rho and stf on the whole grid.  Against plain
    autograd through the unsplit steps (the exact gradient of the discrete
    forward) lam, mu and stf agree on the whole grid, and rho's departs in
    the 2 cells next to the interior's edge exactly as the local loss's
    does (by 0.9426 of its max on this problem): a property of the
    boundary-saving adjoint, which both losses share."""
    cfg, arrays, survey = problem
    (lam, mu, rho, stf), geoms, obs, w = _port(arrays, survey, cfg)
    sl = lambda a: a[:4]
    model = (lam.numpy(), mu.numpy(), rho.numpy(), sl(stf).numpy())
    rest = (ShotGeom(*(sl(g) for g in geoms[:5])), sl(obs), sl(w))
    mesh = parallel.mesh_2d(4, 2, devices=CPU8)
    assert [len(r) for r in mesh] == [2] * 4
    v, g = _port_vg(parallel.make_dd_misfit(cfg, mesh), model, rest)
    v_lo, g_lo = _port_vg(parallel.make_local_misfit(cfg), model, rest)
    _close(v, g, v_lo, g_lo, 1e-10, 1e-8)

    v_ex, g_ex = _port_vg(_autograd_oracle(cfg), model, rest)
    no_rho = lambda g: [g[0], g[1], g[3]]
    _close(v, no_rho(g), v_ex, no_rho(g_ex), 1e-10, 1e-8)
    scale = np.abs(g_ex[2]).max()
    assert np.abs((g[2] - g_ex[2]) - (g_lo[2] - g_ex[2])).max() <= \
        1e-8 * scale
    ring = np.abs(g[2] - g_ex[2]).max() / scale
    assert ring == pytest.approx(0.9426, rel=1e-3)

    jcfg = st.SimConfig(nz=44, nx=52, dz=20.0, dx=20.0, nt=60, dt=0.002,
                        f0=10.0, npml=8)
    jgeoms = jax.tree.map(sl, jpar.survey_to_geoms(
        JSurvey(**_survey()), 8, dtype=jnp.float64))
    j = [jnp.asarray(a) for a in arrays]
    v_j, g_j = _jax_vg(jpar.make_dd_misfit(jcfg, jpar.mesh_2d(4, 2)),
                       (*j[:3], sl(j[3]), jgeoms, sl(j[4]), sl(j[5])))
    _close(v, g, v_j, g_j, 1e-10, 1e-8)
