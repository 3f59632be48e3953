"""On the card: the cells at a size a test run holds, the program through
its kernels and the control (its own float32 path where float64 is
stated), which has to come out as not correct.  The full-size readings
come from ``python3 -m portbench.control``.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

import pytest
import torch

from portbench.tests.tiny import rehearse

WALK = {"m": 256, "data": {"kind": "random_walk", "length": 1 << 16}}
SIZES = {
    "showcase-f64.selfjoin": {"config": WALK, "traffic": {"check": {"share": 1.0, "rows": 2048}}},
    "showcase-f64.append": {"config": WALK, "traffic": {}},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_program_is_correct_and_its_float32_control_is_not(card, workload):
    ov = SIZES[workload]
    sound = rehearse(workload, seed=2**31 + 11, seconds=2.0, overrides=ov, device=card)
    assert sound["correct"] is True, sound["checks"]
    low = dict(ov, config=dict(ov["config"], dtype="float32"))
    control = rehearse(workload, seed=2**31 + 11, seconds=2.0, overrides=low, device=card)
    assert control["correct"] is False, control["checks"]
    assert control["checks"]["dist_err"]["value"] > 100 * sound["checks"]["dist_err"]["value"]
