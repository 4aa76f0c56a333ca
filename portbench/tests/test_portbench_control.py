"""The control, the reference computed in fp8 and put in the program's
place, comes out not correct against each cell's limits; so does each
fault that the cell can have, planted in the reference put in the
program's place: half of the batch left out (training), an answer altered
where it is produced (served answers: each scene answered with the one
before). The faults at the tests' tiny sizes on the CPU; the control at
the cells' own sizes on the card, as ``readings.py --control`` reads it."""

import pytest
import torch

from portbench.core import common
from portbench.readings import reference_readings
from portbench.tests.tiny import TINY

FAULTS = [("config2-train", "half_batch"), ("config4-train", "half_batch"),
          ("config4-online", "stale_answer"), ("config2-eval", "stale_answer")]


def readings(workload, what, device, overrides, seed=246813579135):
    bench = common.load_bench()
    wl, conf, traffic = common.cell(bench, workload)
    numbers = reference_readings(conf, traffic, seed, device, (what,), overrides=overrides)[what]
    lims = {k: v for k, v in common.limits(workload).items() if k in numbers}
    return numbers, lims


@pytest.mark.parametrize("workload,what", FAULTS)
def test_a_planted_fault_fails_the_limits(workload, what):
    conf = common.cell(common.load_bench(), workload)[1]
    numbers, lims = readings(workload, what, torch.device("cpu"), TINY[conf["name"]])
    assert not common.judge(numbers, lims), numbers


@pytest.mark.card
@pytest.mark.parametrize("workload", ["config2-train", "config4-train", "config4-online",
                                      "config2-eval"])
def test_the_control_fails_the_limits_at_the_cells_size(workload, cuda_device):
    numbers, lims = readings(workload, "control", cuda_device, None)
    assert not common.judge(numbers, lims), numbers
