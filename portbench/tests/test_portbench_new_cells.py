"""The nemotron prefill cell rehearsed on the CPU at the program's test
size, and its counts at the published sizes."""
import pytest
import torch

from portbench import bench, counts_hybrid_moe, harness

SMALL = {
    "nemotron-3-nano-30b-a3b.prefill": dict(batch=2, prompt_len=24,
                                            prompt_pool=4,
                                            checked_requests=3),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rehearse(workload, seconds=0.2, **kw):
    b = harness.benchmark()
    ctx = bench.make_context(workload, 2**31 + 77, seconds, False,
                             torch.device("cpu"), bench=b, reduced=True,
                             traffic_changes=SMALL[workload], **kw)
    return bench.execute(ctx, b)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_each_new_loop_rehearses_on_the_cpu(workload):
    outcome, checks, metrics = rehearse(workload)
    b = harness.benchmark()
    assert set(metrics) == {m["name"] for m in
                            harness.metrics_of("end_to_end", workload, b)}
    assert all(v["value"] > 0 for v in metrics.values())
    assert harness.checks_ok(checks), checks
    assert outcome.attempted > 0 and outcome.failed == 0


def test_nemotron_prefill_counts():
    """The published sizes' prefill of 4 x 4096: 98.5 TFLOP, the routed
    products 45.1 of them, 62.8 GB of weights read."""
    cfg = harness.config("nemotron-3-nano-30b-a3b")
    w = counts_hybrid_moe.prefill(cfg, 4, 4096)
    assert round(w["prefill"]["flops"] / 1e12, 1) == 98.5
    assert round(w["expert_mm"]["flops"] / 1e12, 1) == 45.1
    assert 62e9 < w["prefill"]["bytes"] < 64e9
    per = counts_hybrid_moe.layer_macs(cfg)
    assert per["E"] == 2688 * 128 + 6 * 2 * 2688 * 1856 + 2 * 2688 * 3712
