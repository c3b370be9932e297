"""Frontend and encoder-decoder zoo twins against the JAX package, reduced
configs: internvl2-2b (the vision stub: projected patches lead the
stream) and seamless-m4t-large-v2 (biases, a non-causal encoder over
projected frames, cross-attention, a bos decoded at position 0); the
serve loop's enc-dec positions; and ``repro_torch.launch.serve`` on the
CPU for one architecture of each family. Tolerances: ``torch_zoo_twins``
(1e-4 for logits and caches)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models.layers import rms_norm
from torch_zoo_twins import (one_torch_thread,  # noqa: F401 (autouse)
                             TOL, check_adamw_step, check_decode_step,
                             check_loss_and_grads, check_prefill)

ARCHS = ["internvl2-2b", "seamless-m4t-large-v2"]
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches(arch):
    check_adamw_step(arch)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches(arch, impl):
    check_prefill(arch, impl)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches(arch, impl):
    check_decode_step(arch, impl)


def _teacher_forced(model, params, batch, dec_tokens):
    """Last-position logits of the decoder run over ``dec_tokens`` at
    positions 0 .. n-1, teacher-forced, on the encoded frames."""
    cfg = model.cfg
    enc_out = model._encode(params, batch["frames"])
    B, n = dec_tokens.shape
    hidden = encdec.decoder_apply(
        cfg, params["dec_stack"], model._embed_tokens(params, dec_tokens),
        torch.arange(n, dtype=torch.int32).expand(B, n), enc_out,
        torch.ones(enc_out.shape[:2], dtype=torch.bool))
    hidden = rms_norm(hidden[:, -1:], params["final_norm"], cfg.norm_eps)
    return model._logits(params, hidden)


def test_encdec_serve_decodes_after_the_bos():
    """The serve loop decodes an enc-dec's stream at 1 + i after the bos
    at 0: its last step's logits equal a teacher-forced decoder pass over
    [bos, t0, t1, t2]. The reference's loop decodes at S + i, after a gap
    of S - 1 positions; that disagrees with the teacher-forced pass."""
    model, params, batch = serve.setup("seamless-m4t-large-v2", batch=2,
                                       prompt_len=12, seed=3, device="cpu")
    with torch.no_grad():
        res = serve.generate(model, params, batch, 4)
        out = res["tokens"]
        bos = torch.zeros((2, 1), dtype=torch.int64)
        forced = _teacher_forced(model, params, batch,
                                 torch.cat([bos, out[:, :3]], 1))
        np.testing.assert_allclose(res["last_logits"].numpy(),
                                   forced.numpy(), atol=TOL, rtol=TOL)
        # the reference's positions: t0 at S, t1 at S + 1, t2 at S + 2
        _, cache = model.prefill(params, batch, model.cache_len_for(16))
        for i in range(3):
            pos = torch.full((2, 1), 12 + i, dtype=torch.int32)
            gap, cache = model.decode_step(params, cache, out[:, i:i + 1],
                                           pos)
    assert float((gap - forced).abs().max()) > 10 * TOL


FAMILIES = ["gemma3-4b", "olmoe-1b-7b", "minicpm3-4b", "mamba2-780m",
            "internvl2-2b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_on_cpu(arch, capsys):
    """``--impl kernel`` (K6/K7's plain versions here) gives the ``xla``
    path's logits."""
    args = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--gen", "3"]
    res = serve.main(args)
    printed = capsys.readouterr().out
    assert f"arch={arch} impl=kernel device=cpu" in printed
    assert "prefill:" in printed and "sample continuation:" in printed
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["last_logits"]).all()
    xla = serve.main(args + ["--impl", "xla"])
    np.testing.assert_allclose(xla["last_logits"].numpy(),
                               res["last_logits"].numpy(), atol=TOL,
                               rtol=TOL)


def test_serve_module_runs_an_encdec_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "seamless-m4t-large-v2", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "2"], env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "frames=16" in res.stdout and "decode:" in res.stdout
