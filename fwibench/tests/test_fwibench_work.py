"""The yardstick's arithmetic on hand-worked shapes: GCell counts,
operations and bytes of each kind of work, roofline and whole-step
shares."""
import pytest

from fwibench.harness import work as wk
from fwibench.harness.trace import short

MAIN001 = wk.load("configs", "main001")
MAIN004 = wk.load("configs", "main004")


def test_cells():
    # 165 x 265 padded, 1500 steps, 19 shots
    assert wk.cells(MAIN001, 19) == 165 * 265 * 1500 * 19 == 1246162500
    # 265 x 385 padded, 4000 steps, 31 shots
    assert wk.cells(MAIN004, 31) == 265 * 385 * 4000 * 31 == 12651100000


def test_forward_ops_and_bytes():
    ops, n_bytes = wk.ops_bytes("forward", MAIN001, 19)
    assert ops == 102 * 1246162500
    assert n_bytes == 4 * (3 * 43725 + 19 * 1501 + 4 * 19 * 181 * 1501)
    # bound by operations: 1.897 ms, as the port's kernel table has it
    assert wk.bound_s("forward", MAIN001, 19) == pytest.approx(
        102 * 1246162500 / 67e12)
    assert round(wk.bound_s("forward", MAIN001, 19) * 1e3, 3) == 1.897


def test_strips_and_adjoint():
    strip_len = 2 * 5 * (165 + 265)
    assert wk.dims(MAIN001, 19)["strip_len"] == strip_len == 4300
    _, fb = wk.ops_bytes("forward_strips", MAIN001, 19)
    _, f0 = wk.ops_bytes("forward", MAIN001, 19)
    assert fb - f0 == 4 * (5 * 19 * 1500 * strip_len + 5 * 19 * 43725)
    ops, _ = wk.ops_bytes("adjoint", MAIN001, 19)
    assert ops == 215 * 1246162500
    assert round(wk.bound_s("adjoint", MAIN001, 19) * 1e3, 3) == 3.999


def test_shot_sum_bound_by_bytes():
    ops, n_bytes = wk.ops_bytes("shot_sum", MAIN001, 19)
    assert ops == 5 * 43725 * 19
    assert n_bytes == 4 * (5 * 19 * 43725 + 5 * 43725)
    assert n_bytes / wk.PEAK_BYTES > ops / wk.PEAK_FP32


def test_roofline_and_mfu():
    traffic = wk.load("traffic", "invert")
    work = wk.units_work(traffic, [19], 4)
    assert [k for k, _, _ in work] == ["forward_strips", "adjoint",
                                       "shot_sum"]
    # 4 evaluations, the adjoint kernel at 100 ms each: 4 x 3.999 / 400
    pct = wk.roofline_pct("bwd_step_kernel", work, MAIN001,
                          {"bwd_step_kernel": 0.4})
    assert pct == pytest.approx(100 * 4 * 215 * 1246162500 / 67e12 / 0.4)
    assert wk.roofline_pct("bwd_step_kernel", work, MAIN001, {}) is None
    assert wk.roofline_pct("fwd_step_kernel",
                           wk.units_work(wk.load("traffic", "forward"),
                                         [19], 1), MAIN001,
                           {"fwd_step_kernel": 0.0}) is None
    ops = 4 * (317 * 1246162500 + 5 * 43725 * 19)
    assert wk.mfu_pct(work, MAIN001, 2.0) == pytest.approx(
        100 * ops / 2.0 / 67e12)


def test_expressions_refuse_other_syntax():
    with pytest.raises(ValueError):
        wk.evaluate("__import__('os')", {})
    with pytest.raises(ValueError):
        wk.evaluate("nz ** 2", {"nz": 3})
    assert wk.evaluate("2*(nz+1)//3", {"nz": 4}) == 3


def test_short_names():
    assert short("void (anonymous namespace)::bwd_step_kernel<true>"
                 "(float const*)") == "bwd_step_kernel"
    assert short("void at::native::vectorized_elementwise_kernel<4, "
                 "at::native::FillFunctor<float> >(int)") == \
        "vectorized_elementwise_kernel"
    assert short("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
