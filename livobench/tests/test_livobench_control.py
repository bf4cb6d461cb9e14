"""The control: the nearest precision below the configuration's in the
program's place. For the float64 cell that is the program's own float32
path, run and checked the same way, which its start number
(`lio_start_pos_gap_m`) finds out; the TF32 reference in the program's
place is read beside it. The check has to find the control out; the sound
program has to pass. At the small size of the CPU tests, against the
cell's own limits."""

from livobench import check, control
from livobench.tests import small


def test_the_control_fails_and_the_reference_passes():
    c = small.cell(small.ROOM_LIO)
    assert c.precision == "float64"
    got = control.readings(c, 3000000019, 8.0, "cpu", overrides=small.SMALL[c.workload["config"]],
                           traffic=small.small_traffic(c))
    assert check.judge(got["sound"], c.limits)[0], got["sound"]
    assert not check.judge(got["control"], c.limits)[0], got["control"]
    assert not check.judge(got["tf32"], c.limits)[0], got["tf32"]
