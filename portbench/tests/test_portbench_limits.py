"""The rule that turns calibration readings into the check's limits."""
import pytest

from portbench import check


def _rows(kind, *numbers):
    return [{"kind": kind, "numbers": n} for n in numbers]


def test_limit_lies_between_the_readings_nearer_the_upper():
    rows = _rows("program", {"loss_gap": 1e-3, "grad_gap": 2e-4},
                 {"loss_gap": 2e-3, "grad_gap": 1e-4})
    rows += _rows("control", {"loss_gap": 5.4e-2, "grad_gap": 3e-4})
    rows += _rows("half_batch", {"loss_gap": 0.5, "grad_gap": 0.4})
    got = check.limits_from(rows)
    # loss: control 27x the lower bounds it; grad: the control (1.5x)
    # does not, the fault (2,000x) does
    assert got["loss_gap"] == pytest.approx(
        (2e-3) ** (1 / 3) * (5.4e-2) ** (2 / 3), rel=0.05)
    assert got["grad_gap"] == pytest.approx(
        (2e-4) ** (1 / 3) * 0.4 ** (2 / 3), rel=0.05)
    assert 2e-3 < got["loss_gap"] < 5.4e-2


def test_a_number_without_an_upper_reading_is_not_compared():
    rows = _rows("program", {"loss_gap": 1e-3, "change_gap": 0.4})
    rows += _rows("control", {"loss_gap": 2e-3, "change_gap": 0.5})
    rows += _rows("no_mix", {"loss_gap": 5e-3, "change_gap": 0.9})
    got = check.limits_from(rows)
    assert "loss_gap" not in got and "change_gap" not in got


def test_a_state_left_unchanged_bounds_the_change_and_exact_stays_exact():
    rows = _rows("program", {"change_gap": 1e-2, "dormant_moved": 0})
    got = check.limits_from(rows)
    assert 1e-2 < got["change_gap"] < 1.0
    assert got["dormant_moved"] == 0
    ok, table = check.decide({"change_gap": 0.5, "dormant_moved": 0,
                              "loss_gap": 9.0}, got)
    assert not ok and set(table) == {"change_gap", "dormant_moved"}
    assert check.decide({"loss_gap": 1.0}, {})[0] is False
