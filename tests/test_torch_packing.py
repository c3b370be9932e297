"""Packed plane and model digest of the PyTorch port against the JAX
package: bitwise, on the reference's own params converted through numpy
(``fedforecast-100m.reduced()``, T = 1,443,072)."""
import numpy as np
import pytest
import torch

import jax

from repro.checkpoint import pytree_digest as jdigest
from repro.configs import get_config
from repro.core.packing import pack_many as jpack_many
from repro.core.packing import pack_pytree as jpack
from repro.models import build_model as jbuild
from repro_torch.checkpoint import pytree_digest as tdigest
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.packing import (PackedLayout, pack_many, pack_pytree,
                                      unpack_pytree)
from repro_torch.models import build_model as tbuild


@pytest.fixture(scope="module")
def params():
    model = jbuild(get_config("fedforecast-100m").reduced())
    jp = model.init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_pack_bitwise_equal(params):
    jp, tp = params
    jbuf, jlayout = jpack(jp)
    tbuf, tlayout = pack_pytree(tp)
    assert tbuf.dtype == torch.float32 and tbuf.shape == (1_443_072,)
    np.testing.assert_array_equal(np.asarray(jbuf).view(np.uint32),
                                  tbuf.numpy().view(np.uint32))
    assert tlayout.to_dict() == jlayout.to_dict()


def test_unpack_round_trips(params):
    _, tp = params
    buf, layout = pack_pytree(tp)
    back = unpack_pytree(buf, layout)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(params_to_numpy(back))):
        np.testing.assert_array_equal(a, b)
    # the leaves are fresh tensors, not views into the buffer
    buf.zero_()
    assert float(back["embed"].abs().sum()) > 0
    with pytest.raises(ValueError):
        unpack_pytree(buf[:-1], layout)


def test_pack_many_matches(params):
    jp, tp = params
    twice = {k: v for k, v in tp.items()}
    jm, _ = jpack_many([jp, jp])
    tm, layout = pack_many([tp, twice])
    assert isinstance(layout, PackedLayout)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def test_digest_equal(params):
    jp, tp = params
    assert tdigest(tp) == jdigest(jp)
    cfg = get_config("fedforecast-100m")      # bf16 compute dtype
    jcast = jbuild(cfg).cast(jp)
    tcast = tbuild(cfg, device="cpu").cast(tp)
    assert tcast["embed"].dtype == torch.bfloat16
    assert tdigest(tcast) == jdigest(jcast)
    tp2 = {**tp, "final_norm": tp["final_norm"] + 1.0}
    assert tdigest(tp2) != jdigest(jp)
