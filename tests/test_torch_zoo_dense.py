"""Dense zoo twins: the local/global windows and softcaps of gemma2-9b,
gemma3-4b's qk-norm at head dim 256 (reduced: 64), command-r-plus-104b's
qk-norm, and GQA and MLP biases (fedforecast-100m with ``use_bias``), each
on its reduced config against the JAX package (``torch_zoo_twins``
states the tolerances). Also K6's plain version at head dim 256 against
the reference's ``attention_ref``: the Pallas K6 does not run here, and
on the card ``chip_smoke.py`` holds the CUDA kernel against this plain
version."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_ref as jattention
from repro_torch.kernels.flash_attention import ops as fops
from torch_zoo_twins import (one_torch_thread,  # noqa: F401 (autouse)
                             check_adamw_step, check_decode_consistency,
                             check_decode_step, check_loss_and_grads,
                             check_prefill)

CASES = [("gemma2-9b", ()), ("gemma3-4b", ()),
         ("command-r-plus-104b", ()),
         ("fedforecast-100m", (("use_bias", True),))]
IDS = ["gemma2-9b", "gemma3-4b", "command-r-plus-104b", "biased-dense"]


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_loss_and_grads_match(arch, changes):
    check_loss_and_grads(arch, changes)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_adamw_step_matches(arch, changes):
    check_adamw_step(arch, changes)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_prefill_matches(arch, changes, impl):
    check_prefill(arch, impl, changes)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_decode_step_matches(arch, changes, impl):
    check_decode_step(arch, impl, changes)


@pytest.mark.parametrize("arch", ["fedforecast-100m", "gemma2-9b"])
def test_decode_consistency_twin(arch):
    check_decode_consistency(arch)


# B, S, H, Hkv, causal, window, softcap: gemma2's softcap and window,
# gemma3's window, non-causal, a ragged S
K6_CASES = [(2, 96, 4, 2, True, 0, 0.0), (1, 80, 4, 2, True, 32, 50.0),
            (1, 64, 2, 1, False, 0, 0.0), (2, 45, 4, 4, True, 16, 0.0)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", K6_CASES)
def test_flash_plain_head_dim_256_matches_attention_ref(case, dtype, tol):
    B, S, H, Hkv, causal, window, cap = case
    rng = np.random.default_rng(sum(case[:4]))
    q, k, v = (rng.normal(size=(B, S, h, 256)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    tdt = getattr(torch, dtype)
    got = fops.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, logit_softcap=cap, scale=256 ** -0.5)
    want = jattention(*(jnp.asarray(a, dtype).transpose(0, 2, 1, 3)
                        for a in (q, k, v)), scale=256 ** -0.5,
                      causal=causal, window=window, softcap=cap)
    assert got.shape == (B, S, H, 256) and got.dtype == tdt
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32))
        .transpose(0, 2, 1, 3), atol=tol, rtol=tol)
