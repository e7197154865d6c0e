"""The correctness check fails what it has to: runs of each cell on the
CPU with the timed path broken underneath, and the control (the plain
reference in bfloat16 in the port's place), judged against the cell's
committed limits.  The faults a one-chip cell can have: a step that
returns its state unchanged, half of the shots left out and the rest's
mean taken for them, an answer altered where it is produced.  (No cell
exchanges anything between chips.)"""
import pytest
import torch

from fwibench.control import control_numbers
from fwibench.harness import judge
from fwibench.tests import tiny

CELLS = [w["name"] for w in tiny.BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def unchanged_step(mp):
    """Every forward step returns the state it was given: the wavefield
    stays at its zero start (the source is never injected)."""
    from sep2023_tpu_torch.ops import cuda_engine
    forward = cuda_engine.forward_cuda_plan

    def unchanged(plan, lam, mu, rho, stf, *a, **kw):
        return forward(plan, lam, mu, rho, torch.zeros_like(stf), *a, **kw)

    mp.setattr(cuda_engine, "forward_cuda_plan", unchanged)


def half_the_shots(mp):
    from sep2023_tpu_torch import parallel
    misfit, forward = parallel.make_cuda_misfit, parallel.make_forward

    def make_misfit(*a, **kw):
        loss = misfit(*a, **kw)

        def half(lam, mu, rho, stf, obs, w, *aux):
            h = max(1, stf.shape[0] // 2)
            return loss(lam, mu, rho, stf[:h], obs[:h], w[:h]) * (
                stf.shape[0] / h)
        return half

    def make_forward(*a, **kw):
        fwd = forward(*a, **kw)

        def half(lam, mu, rho, stf):
            h = max(1, stf.shape[0] // 2)
            d = fwd(lam, mu, rho, stf[:h])
            rest = d.mean(0, keepdim=True).expand(stf.shape[0] - h,
                                                  *d.shape[1:])
            return torch.cat([d, rest])
        return half

    mp.setattr(parallel, "make_cuda_misfit", make_misfit)
    mp.setattr(parallel, "make_forward", make_forward)


def altered_answer(mp):
    from sep2023_tpu_torch.ops import cuda_engine
    backward, forward = cuda_engine.backward_cuda_plan, \
        cuda_engine.forward_cuda_plan

    def halve_peak(t, row0=0):
        """t with its largest value from row row0 down halved."""
        t = t.clone()
        part = t[..., row0:, :]
        i = int(part.abs().argmax())
        part.reshape(-1)[i] *= 0.5
        t[..., row0:, :] = part
        return t

    def altered_backward(plan, *a, **kw):
        d_lam, *rest = backward(plan, *a, **kw)
        # below the rows the inversion freezes, where the head passes it on
        return (halve_peak(d_lam, plan.cfg.npml + 4), *rest)

    def altered_forward(*a, save_strips=False, **kw):
        out = forward(*a, save_strips=save_strips, **kw)
        if save_strips:
            return out
        return halve_peak(out)

    mp.setattr(cuda_engine, "backward_cuda_plan", altered_backward)
    mp.setattr(cuda_engine, "forward_cuda_plan", altered_forward)


FAULTS = {"unchanged_step": unchanged_step, "half_the_shots": half_the_shots,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_run_incorrect(cell, fault, monkeypatch):
    if fault == "altered_answer" and cell.endswith("invert"):
        # the forward of the twin data stays whole: the gradient is altered
        from sep2023_tpu_torch.ops import cuda_engine
        forward = cuda_engine.forward_cuda_plan
        FAULTS[fault](monkeypatch)
        monkeypatch.setattr(cuda_engine, "forward_cuda_plan", forward)
    else:
        FAULTS[fault](monkeypatch)
    res = tiny.run(cell, seconds=0.5)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    w = next(x for x in tiny.BENCH["workloads"] if x["name"] == cell)
    cj = tiny.config(w["config"])
    kind = tiny.wk.load("traffic", w["traffic"])["kind"]
    lim = judge.limits(cell)
    for seed in (3, 4, 5):
        nums = control_numbers(cj, kind, seed, "cpu", torch.bfloat16)
        ok, _ = judge.verdict(nums, lim)
        assert not ok, nums
