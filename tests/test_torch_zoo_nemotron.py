"""nemotron-3-nano-30b-a3b at a small size against the benchmark's plain
reference (``portbench/reference/nemotron_h.py``): the published layer
pattern of Mamba2 (8 heads in 4 B/C groups), MoE (8 experts, top 2, a
shared expert, dropless) and attention layers at d_model 64, on seeded
weights. Prefill logits and prefill-then-decode through the cache against
the reference's full forward; the dropless MoE against every expert
computed densely; the sigmoid router's pick with and without its score
bias; the MoE layer's spans and counters; grouped K7's plain path against
the sequential scan; hymba-1.5b's served bits unchanged at one group."""
import dataclasses
import hashlib

import pytest
import torch

from portbench.reference import nemotron_h as ref
from repro_torch.configs import get_config
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod

SEED = 20260918


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    c = get_config("nemotron-3-nano-30b-a3b")
    return dataclasses.replace(
        c, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
        vocab=300, dtype="float32", ssm_heads=8, ssm_groups=4,
        ssm=SSMConfig(d_state=8, d_head=8, expand=2, d_conv=4, chunk=16),
        moe=dataclasses.replace(c.moe, num_experts=8, top_k=2, d_expert=32,
                                d_shared=48))


def setup(seed=SEED):
    cfg = small_cfg()
    d = dataclasses.asdict(cfg)
    params = ref.make_params(d, seed, "cpu")
    model = build_model(cfg, impl="kernel", device="cpu")
    assert ref.tree_paths(model.abstract_params()) == ref.tree_paths(params)
    return cfg, d, model, params


def tokens(cfg, B, S, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=g)


def close(got, want, tol=2e-4):
    err = (got - want).abs().max() / want.abs().max()
    assert err < tol, float(err)


def test_prefill_logits_match_the_reference():
    cfg, d, model, params = setup()
    tok = tokens(cfg, 2, 40)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok}, 40)
        want = ref.logits_from_params(d, params, tok, [39])
    assert logits.shape == (2, 1, cfg.vocab)
    close(logits, want)
    assert set(cache) == {"mamba", "attention"}
    assert cache["mamba"]["state"].shape == (23, 2, 8, 8, 8)
    assert cache["attention"]["k"].shape == (6, 2, 40, 2, 16)
    fresh = model.init_cache(2, 40)
    assert {k: {n: t.shape for n, t in v.items()} for k, v in fresh.items()} \
        == {k: {n: t.shape for n, t in v.items()} for k, v in cache.items()}


def test_prefill_then_decode_matches_the_full_forward():
    cfg, d, model, params = setup()
    tok = tokens(cfg, 2, 29)
    S0, steps = 24, 5
    got = []
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok[:, :S0]},
                                      S0 + steps)
        got.append(logits)
        for i in range(steps - 1):
            logits, cache = model.decode_step(
                params, cache, tok[:, S0 + i:S0 + i + 1],
                torch.full((2, 1), S0 + i))
            got.append(logits)
        want = ref.logits_from_params(d, params, tok[:, :S0 + steps - 1],
                                      list(range(S0 - 1, S0 + steps - 1)))
    close(torch.cat(got, 1), want)


def test_seeded_draws_are_layerwise_and_rounded():
    """The program's tree in bf16 holds the reference's float32 draws
    rounded, each layer drawn by itself."""
    cfg, d, _, _ = setup()
    bf = ref.make_params(d, 7, "cpu", dtype=torch.bfloat16)
    for name, j in ((n, j) for n, j in ref.slots(d) if j in (0, 2)):
        layer = ref.layer_params(d, 7, name, j, "cpu")
        for k, w in layer.items():
            assert torch.equal(bf["stack"][name][k][j], w.to(torch.bfloat16))
    assert not torch.equal(ref.layer_params(d, 7, "moe", 0, "cpu")["w_up"],
                           ref.layer_params(d, 7, "moe", 1, "cpu")["w_up"])


def _dense_moe(p, cfg, x):
    """Every expert on every token, weighted by the router's pick (0 for
    the others), plus the shared expert."""
    m = cfg.moe
    t = x.reshape(-1, x.shape[-1])
    w, idx = moe_mod._router_sigmoid(p, m, t)
    gate = torch.zeros(t.shape[0], m.num_experts).scatter(1, idx, w)

    def mlp(up, down):
        return torch.relu(t @ up).square() @ down
    out = 0
    for e in range(m.num_experts):
        out = out + gate[:, e:e + 1] * mlp(p["w_up"][e], p["w_down"][e])
    out = out + mlp(p["shared_up"], p["shared_down"])
    return out.reshape(x.shape)


@pytest.mark.parametrize("score_bias", [True, False])
def test_dropless_moe_is_every_expert_computed(score_bias):
    """Nemotron's MoE, with and without the router's score bias."""
    cfg = small_cfg()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, score_bias=score_bias))
    model = build_model(cfg, device="cpu")
    p = model.init(model.generator(5))["stack"]["moe"]
    p = {k: v[1] for k, v in p.items()}
    assert ("router_bias" in p) == score_bias
    if score_bias:
        p["router_bias"] = torch.randn(cfg.moe.num_experts) * 0.05
    x = torch.randn(3, 17, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    stats = {}
    y, aux = moe_mod.moe_apply(p, cfg, x, stats=stats)
    close(y, _dense_moe(p, cfg, x), 1e-5)
    assert float(aux) == 0.0
    _, idx = moe_mod._router_sigmoid(p, cfg.moe, x.reshape(-1, 64))
    assert int(stats["rows_max"]) == int(torch.bincount(
        idx.reshape(-1), minlength=cfg.moe.num_experts).max())


def _refused(cfg):
    with pytest.raises(ValueError, match="dropless"):
        moe_mod.moe_apply({}, cfg, torch.zeros(1, 2, cfg.d_model))
    with pytest.raises(ValueError, match="dropless"):
        moe_mod.moe_init(torch.Generator(), cfg)


def test_capacity_dispatch_takes_only_the_reference_moe():
    cfg = small_cfg()
    _refused(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=False)))


def test_dropless_dispatch_takes_only_nemotron_moe():
    """The dropless dispatch refuses the reference's softmax router and
    SwiGLU experts."""
    cfg = small_cfg()
    _refused(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="softmax", activation="swiglu")))


def test_sigmoid_router_picks_by_bias_and_weighs_by_score():
    m = small_cfg().moe
    D, E = 4, m.num_experts
    p = {"router": torch.zeros(D, E)}
    p["router"][0] = torch.linspace(-1.0, 1.0, E)     # expert 7 scores most
    x = torch.zeros(1, D)
    x[0, 0] = 1.0
    w, idx = moe_mod._router_sigmoid(p, m, x)
    assert idx.tolist() == [[7, 6]]
    s = torch.sigmoid(torch.linspace(-1.0, 1.0, E))
    close(w, (s[[7, 6]] / s[[7, 6]].sum() * m.routed_scale)[None], 1e-6)
    # a bias lifts experts 0 and 1 into the pick; their weights stay the
    # normalised scores, the bias not added
    p["router_bias"] = torch.zeros(E)
    p["router_bias"][[0, 1]] = 1.0
    w, idx = moe_mod._router_sigmoid(p, m, x)
    assert idx.tolist() == [[1, 0]]
    close(w, (s[[1, 0]] / s[[1, 0]].sum() * m.routed_scale)[None], 1e-6)
    # equal scores tie to the lower expert
    p = {"router": torch.zeros(D, E)}
    _, idx = moe_mod._router_sigmoid(p, m, x)
    assert idx.tolist() == [[0, 1]]


def test_moe_spans_and_counters():
    """A served MoE layer opens ``serve.moe`` (its layer and rows), counts
    its rows always and, while recording, its busiest expert's rows,
    resolved at ``snapshot()``; the stack is not trained."""
    from repro_torch.core.telemetry import Telemetry, scope
    cfg, _, model, params = setup()
    tok = tokens(cfg, 2, 24)
    tel = Telemetry(enabled=True)
    with scope(tel), torch.no_grad():
        model.prefill(params, {"tokens": tok}, 24)
    moe = [s for s in tel.spans() if s.name == "serve.moe"]
    layers = [i for i, k in enumerate(cfg.layer_pattern) if k == "E"]
    assert [s.attrs["layer"] for s in moe] == layers
    assert all(s.attrs["rows"] == 2 * 24 * 2 for s in moe)
    snap = tel.metrics.snapshot()
    assert snap["serve.moe_rows"] == {f"layer={i}": 96 for i in layers}
    busiest = snap["serve.moe_rows_max"]
    assert set(busiest) == {f"layer={i}" for i in layers}
    assert all(96 // 8 <= v <= 48 for v in busiest.values())
    with pytest.raises(ValueError, match="not trained"):
        model.loss_fn(params, {"tokens": tok})


@pytest.mark.parametrize("form", ["ssd_chunked", "ssd_three_pass"])
def test_grouped_scan_plain_path_matches_the_recurrence(form):
    """B and C in 4 groups of 2 heads each: the chunked forms against the
    sequential recurrence with each head's group's B and C."""
    g = torch.Generator().manual_seed(11)
    b, S, H, P, G, N = 2, 45, 8, 4, 4, 6
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.2
    A = -torch.rand(H, generator=g) - 0.5
    B = torch.randn(b, S, G, N, generator=g)
    C = torch.randn(b, S, G, N, generator=g)
    y, h = getattr(sref, form)(x, dt, A, B, C, chunk=16)
    heads = torch.arange(H) // (H // G)
    for hh in range(H):
        wy, wh = sref.ssd_ref(x[:, :, hh:hh + 1], dt[:, :, hh:hh + 1],
                              A[hh:hh + 1], B[:, :, heads[hh]],
                              C[:, :, heads[hh]])
        close(y[:, :, hh:hh + 1], wy, 1e-4)
        close(h[:, hh:hh + 1], wh, 1e-4)


# sha256 of hymba-1.5b's reduced prefill (logits and cache) and two decode
# steps at seed 0, one CPU thread, float32: the bits before B/C groups
# and the mixed stack came in
HYMBA_BITS = ("35526d33ebefeba84fa8a881debdb1c1"
              "cb966be0a67c45c15bc5d5ef8a74bf00")


def hymba_bits() -> str:
    cfg = get_config("hymba-1.5b").reduced()
    model = build_model(cfg, impl="kernel", device="cpu")
    params = model.cast(model.init(model.generator(0)))
    tok = tokens(cfg, 2, 24, seed=4)
    h = hashlib.sha256()
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok}, 40)
        outs = [logits] + [cache["ssm"]["state"], cache["ssm"]["conv"],
                           cache["attn"]["k"]]
        n0 = cfg.n_meta_tokens + 24
        for i in range(2):
            logits, cache = model.decode_step(params, cache, tok[:, i:i + 1],
                                              torch.full((2, 1), n0 + i))
            outs += [logits, cache["ssm"]["state"]]
    for t in outs:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_hymba_bits_unchanged_at_one_group():
    assert get_config("hymba-1.5b").n_ssm_groups == 1
    assert hymba_bits() == HYMBA_BITS
