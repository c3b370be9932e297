"""The port's ``remat`` (``Model(cfg, remat=True)``, the default) against
``remat=False`` and against the JAX package's ``Model(cfg, remat=True)``.

The reference checkpoints (``jax.checkpoint``) each layer body of its
scans, each chunk of the CE and each q chunk of the plain attention; the
port checkpoints the same four places with ``torch.utils.checkpoint``
while autograd records. On reduced configs, at 2 x 1024 tokens (two q
chunks of 512 a layer, two CE chunks):

* loss and every gradient at ``remat=True`` bitwise equal to
  ``remat=False`` (dense, MoE, hybrid SSM with meta tokens, enc-dec);
* the loss within the twin tolerance (1e-5) of the reference's
  ``loss_fn`` on the same weights and batch;
* a spy on ``torch.utils.checkpoint.checkpoint`` sees, in the forward,
  one call a layer body (encoder and decoder layers for the enc-dec), one
  a CE chunk and one a q chunk of every full-sequence attention; at
  ``remat=False`` the same but the layer bodies; none without grad
  (prefill);
* the dry run's live-bytes peak of a train step is lower at
  ``remat=True``.
"""
import collections
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import InputShape
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.models import build_model as tbuild
from torch_zoo_twins import (LOSS_TOL, cfgs, np_batch, one_torch_thread,  # noqa: F401
                             perturb_zeros)

ARCHS = ["fedforecast-100m", "olmoe-1b-7b", "hymba-1.5b",
         "seamless-m4t-large-v2"]
S = 1024                      # two q chunks, two CE chunks
SEED = 3


def _batch(cfg):
    return np_batch(cfg, S, SEED, n_frames=S)


def _port_params(arch):
    jcfg, tcfg = cfgs(arch)
    jp = perturb_zeros(jbuild(jcfg).init(jax.random.PRNGKey(SEED)), SEED)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _loss_and_grads(model, params, batch):
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss, _ = model.loss_fn(tree.unflatten(treedef, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_and_the_reference_loss(arch):
    jcfg, tcfg, jp, params = _port_params(arch)
    batch = _batch(tcfg)
    got = {r: _loss_and_grads(tbuild(tcfg, remat=r, device="cpu"), params,
                              batch) for r in (True, False)}
    (l1, g1), (l0, g0) = got[True], got[False]
    assert torch.equal(l1, l0)
    assert len(g1) == len(g0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)
    jloss, _ = jax.jit(jbuild(jcfg, remat=True).loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(l1) - float(jloss)) <= LOSS_TOL


def _spy(monkeypatch):
    """Counts checkpoint calls by the function that asked for them."""
    seen = collections.Counter()
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kwargs):
        seen[sys._getframe(2).f_code.co_name] += 1
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    return seen


def _sites(cfg):
    """The reference's checkpoints of one forward at S tokens: its layer
    bodies, its CE chunks and its attention's q chunks."""
    chunks = S // 512
    if cfg.is_encoder_decoder:
        # encoder self-attention, decoder self- and cross-attention
        return {"encoder_apply": cfg.n_encoder_layers,
                "decoder_apply": cfg.n_layers,
                "chunked_softmax_xent": chunks,
                "attend_masked": chunks * (cfg.n_encoder_layers
                                           + 2 * cfg.n_layers)}
    stream = S + cfg.n_meta_tokens
    q_chunks = stream // 512 if stream % 512 == 0 else 0
    sites = {"stack_apply": cfg.n_layers,
             "chunked_softmax_xent": -(-stream // 512)}
    if q_chunks:
        sites["attend_masked"] = q_chunks * cfg.n_layers
    return sites


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_spy_sees_the_reference_sites(arch, monkeypatch):
    _, tcfg, _, params = _port_params(arch)
    batch = _batch(tcfg)
    seen = _spy(monkeypatch)
    leaves, treedef = tree.flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    tbuild(tcfg, remat=True, device="cpu").loss_fn(
        tree.unflatten(treedef, leaves), batch)
    assert dict(seen) == _sites(tcfg)
    seen.clear()
    tbuild(tcfg, remat=False, device="cpu").loss_fn(
        tree.unflatten(treedef, leaves), batch)
    layers = ("stack_apply", "encoder_apply", "decoder_apply")
    assert dict(seen) == {k: n for k, n in _sites(tcfg).items()
                          if k not in layers}
    seen.clear()
    with torch.no_grad():
        tbuild(tcfg, remat=True, device="cpu").loss_fn(params, batch)
    assert not seen


@pytest.mark.parametrize("arch", ["fedforecast-100m", "olmoe-1b-7b"])
def test_remat_lowers_the_train_step_peak(arch):
    cfg = tget(arch).reduced()
    shape = InputShape("train", S, 4, "train")
    peak = {}
    for remat in (True, False):
        _, fn, args = dryrun.build_dryrun(cfg, shape, remat=remat)
        peak[remat] = dryrun.count(fn, args)["temp_bytes"]
    assert 0 < peak[True] < peak[False]
