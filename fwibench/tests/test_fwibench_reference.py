"""The plain reference agrees with the port's plain path at a tiny size:
the observed data, the loss and the head's gradients of an evaluation as
`optimize.ScipyObjective` makes it, and the start model."""
import numpy as np
import pytest
import torch

from fwibench import inputs
from fwibench.harness import drive, judge
from fwibench.reference import twin
from fwibench.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["main001", "main004"])
def test_reference_matches_port(name):
    from sep2023_tpu_torch import cli, optimize, parallel

    cj = tiny.config(name)
    dev = torch.device("cpu")
    traffic = tiny.wk.load("traffic", "invert")
    fields, noise = inputs.draw(cj, 5, dev)
    p = drive.build(cj, traffic, fields, dev)
    fwd = parallel.make_forward(p.cfg, p.survey, use_kernels=True,
                                device=dev)
    obs = inputs.add_noise(fwd(*p.true_lame, p.stf), noise.clone(), cj)
    loss = cli.build_stage_loss(p.cfg, p.survey, p.geoms, use_kernels=True,
                                shot_chunk=0, channels=["ett"])
    w = torch.ones(p.survey.n_shots)

    def param_loss(params, stf, obs_):
        return loss(*p.head.apply({**p.init_t, **params}), stf, obs_, w)

    obj = optimize.ScipyObjective(param_loss, p.start, bounds=p.bounds,
                                  aux=(p.stf, obs), device="cpu")
    x = obj.x0 * (1 + 0.01 * np.sin(np.arange(obj.x0.size)))
    f, g = obj._evaluate(x)

    tw = twin.Twin(cj, judge.config_module(name), dev, torch.float32)
    tw.set_fields(fields)
    assert np.array_equal(tw.x0(), obj.x0)
    obs_ref = tw.observed(noise)
    assert judge.rel_gap(obs, obs_ref) < 1e-5
    f_ref, g_ref = tw.value_and_grad(x, obs_ref)
    assert abs(f - f_ref) / f_ref < 1e-5
    assert judge.grad_gap(g, g_ref, 3) < 1e-5
    assert f > 0 and np.abs(g).max() > 0


def test_perturbation_and_noise_from_the_seed():
    cj = tiny.config("main001")
    a, na = inputs.draw(cj, 2 ** 31 + 3, "cpu")
    b, nb = inputs.draw(cj, 2 ** 31 + 3, "cpu")
    c, _ = inputs.draw(cj, 2 ** 31 + 4, "cpu")
    assert np.array_equal(a, b) and torch.equal(na, nb)
    assert not np.array_equal(a, c)
    assert a.shape == (3, cj["nz"], cj["nx"])
    assert np.allclose(np.abs(a).max(axis=(1, 2)), 1.0)
