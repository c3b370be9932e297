"""``cosine_schedule`` of the port against the reference's, within 1e-7:
warm-up, the warm-up's end, the cosine's end and past it, for an int
step (a float lr) and a tensor step (a tensor lr), and as the ``lr`` of
the port's AdamW."""
import pytest
import torch

from repro.optim import cosine_schedule as jcosine
from repro_torch.optim import adamw, cosine_schedule

PEAK, WARMUP, TOTAL = 3e-4, 10, 100
STEPS = [0, WARMUP - 1, WARMUP, TOTAL, 2 * TOTAL]


@pytest.mark.parametrize("step", STEPS)
def test_cosine_schedule_matches_reference(step):
    want = float(jcosine(PEAK, WARMUP, TOTAL)(step))
    lr = cosine_schedule(PEAK, WARMUP, TOTAL)
    got = lr(step)
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-7
    t = lr(torch.tensor(step))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert abs(float(t) - want) <= 1e-7


def test_cosine_schedule_drives_adamw():
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert lr(0) == 0.0 and lr(10) == pytest.approx(1.0)
    assert lr(100) == pytest.approx(0.1, abs=1e-6) and lr(55) < lr(20)
    opt = adamw(lr, weight_decay=0.0)
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    _, state, info = opt.update({"w": torch.ones(3)}, state, params)
    assert info["lr"] == lr(1)
