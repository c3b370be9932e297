"""The benchmark's counts against hand counts, and against
``FlopCounterMode`` over the frozen reference at a small size."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, harness
from portbench.reference import model as ref


def _cfg(name):
    return harness.config(name)


def _small(name, **changes):
    from repro_torch.configs import get_config
    cfg = dataclasses.asdict(get_config(name).reduced())
    cfg.update(changes)
    return cfg


@pytest.mark.parametrize("seq,window", [(1, 0), (7, 0), (64, 0), (64, 16),
                                        (64, 64), (64, 100), (2048, 1024)])
def test_attention_pairs_count_the_visible_band(seq, window):
    q = torch.arange(seq)[:, None]
    k = torch.arange(seq)[None, :]
    visible = k <= q
    if window > 0:
        visible &= k > q - window
    assert counts.attention_pairs(seq, window) == int(visible.sum())
    assert sum(counts.keys_visible(p, window) for p in range(seq)) \
        == int(visible.sum())


def test_parameter_counts_by_hand():
    ff = _cfg("fedforecast-100m")
    n = sum(int(torch.tensor(s).prod()) for s in
            ref.tree_paths(ref.param_shapes(ff)).values())
    assert n == 116_411_136                  # T of the packed buffer
    assert counts.weight_bytes(ff, 0, nbytes=1) == n
    hy = _cfg("hymba-1.5b")
    shapes = ref.tree_paths(ref.param_shapes(hy))
    per_layer = sum(int(torch.tensor(s[1:]).prod())
                    for p, s in shapes.items()
                    if p.startswith("stack/") and len(s) == 3
                    and p.rsplit("/", 1)[-1] != "conv_w")
    assert per_layer == counts.layer_matmul_params(hy)
    # a prefill of 8 tokens reads 8 rows of the untied embedding table and
    # the output matrix's real vocabulary columns
    every = sum(int(torch.tensor(s).prod()) for s in shapes.values())
    assert counts.weight_bytes(hy, 8, nbytes=1) == \
        every - (ref.padded_vocab(hy) - 8) * hy["d_model"] \
        - (ref.padded_vocab(hy) - hy["vocab"]) * hy["d_model"]


def test_k1_k6_k7_by_hand():
    assert counts.k1(3, 1000) == {"flops": 6000, "bytes": 16012,
                                  "precision": "f32"}
    hy = _cfg("hymba-1.5b")
    k6 = counts.k6(hy, 4, 2048, 1024)
    pairs = 1024 * 1025 // 2 + 1024 * 1024
    assert k6["flops"] == 4 * 64 * 25 * 4 * pairs
    assert k6["bytes"] == 4 * 2048 * 64 * (50 + 10) * 2
    k7 = counts.k7(hy, 4, 2048)
    assert k7["flops"] == 5 * 64 * 16 * 50 * 4 * 2048
    assert k7["bytes"] == (4 * 2048 * 50 * 64 * 6 + 4 * 2048 * 50 * 4 + 200
                           + 2 * 4 * 2048 * 16 * 2 + 4 * 50 * 64 * 16 * 4)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_dense_forward_and_step_match_the_flop_counter():
    cfg = _small("fedforecast-100m")
    B, S = 2, 32
    params = ref.make_params(cfg, 1, "cpu")
    tokens = torch.randint(0, cfg["vocab"], (B, S))
    H, Dh, L = cfg["n_heads"], ref.head_dim(cfg), cfg["n_layers"]
    # the reference scores every pair, the count only the visible ones
    extra = 4 * Dh * H * B * (S * S - counts.attention_pairs(S, 0)) * L
    fwd = counts.forward_flops(cfg, B, S, S)
    got = _counted(lambda: ref.logits_at(cfg, params, tokens,
                                         list(range(S))))
    assert got == fwd["total"] + extra
    step = counts.train_step(cfg, B, S)["flops"]
    leaves = {p: v.requires_grad_(True) for p, v in ref.leaf_paths(params)}

    def train():
        ref.loss(cfg, params, tokens).backward()
    extra_step = 3 * extra + 3 * 2 * B * cfg["d_model"] * (
        ref.padded_vocab(cfg) - cfg["vocab"]) * (S - 1)
    assert _counted(train) == step + extra_step
    assert leaves


def test_hybrid_projections_match_the_flop_counter():
    cfg = _small("hymba-1.5b")
    x = torch.randn(2, 16, cfg["d_model"])
    p = ref._layer(ref.make_params(cfg, 2, "cpu"), 0)
    mm_flops = _counted(lambda: (ref.mlp(p["mlp"], x, torch.matmul),
                                 torch.matmul(x, p["ssm"]["in_proj"]),
                                 torch.matmul(x[..., :cfg["d_model"]]
                                              .repeat(1, 1, 2),
                                              p["ssm"]["out_proj"])))
    d = cfg["d_model"]
    attn_proj = d * (cfg["n_heads"] + 2 * cfg["n_kv_heads"]) \
        * ref.head_dim(cfg) + cfg["n_heads"] * ref.head_dim(cfg) * d
    assert mm_flops + 2 * 32 * attn_proj == \
        2 * 32 * counts.layer_matmul_params(cfg)


def test_served_cells_are_bound_as_predicted():
    """At the cells' sizes: the prefill is compute-bound, the decode step
    bytes-bound on the weights and the cache."""
    hy = _cfg("hymba-1.5b")
    pre = counts.prefill(hy, 4, 1920)
    assert pre["flops"] / 989e12 > 10 * pre["bytes"] / 3.35e12
    dec = counts.decode_steps(hy, 4, 2048, 256)
    assert dec["bytes"] / 3.35e12 > 10 * dec["flops"] / 989e12
    assert 3.0e9 < dec["bytes"] < 3.6e9
