"""The port's optimizer side of a train step (`train_step.make_update_fn`:
global-norm clipping, AdamW or Adafactor, optax `MultiSteps` gradient
accumulation) against the JAX package's `make_optimizer`, on the CPU.

A small module holds the parameter kinds whose layouts differ between
flax and the port: a conv kernel with both channel counts >= 128 (optax
factors its (I, O) dimensions; the port's (O, I, kh, kw) tensor would not
factor on its last two), a conv kernel too small to factor, a linear
weight (transposed against flax), a bias and a norm scale (1-D: a full
second moment).  The same random gradients, drawn in the flax layout, go
to optax on the flax tree and to the port on the module, for 6 optimizer
updates (6 k calls under accumulation k), with a warmup-cosine learning
rate, so the schedule's index matters:

  * every parameter after every call within 1e-5 relative of optax's
    (f32 elementwise work and a few reductions), and bit-unchanged on the
    calls where `MultiSteps` emits no update;
  * the reported grad norm is the call's own gradient's (before
    clipping, before accumulation), as JAX's metric;
  * Adafactor's factored statistics (v_row, v_col, v) equal optax's
    `FactoredState` in the flax layout to 1e-5 relative;
  * Adafactor's foreach update split into chunks of 300 elements (the
    conv and linear kernels each alone) matches optax as well.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tests.torch_port_helpers import assert_rel_close
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.train import train_step as jstep
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.convert import (
    flax_from_module, flax_permutations, state_dict_from_flax,
)
from unirenderer_tpu_torch.train import adafactor
from unirenderer_tpu_torch.train.adafactor import factored_dims
from unirenderer_tpu_torch.train.train_step import (
    TrainState, make_optimizer, make_update_fn,
)

REL = 1e-5
UPDATES = 6

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Tree(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(128, 256, 3)       # flax (3, 3, 128, 256)
        self.square = nn.Conv2d(128, 128, 1)     # ties: (1, 1, 128, 128)
        self.small = nn.Conv2d(8, 16, 3)         # (3, 3, 8, 16): unfactored
        self.dense = nn.Linear(160, 192)         # flax (160, 192)
        self.norm = nn.GroupNorm(4, 16)          # scale, bias: 1-D


def configs(optimizer, k, max_norm):
    over = dict(optimizer=optimizer, gradient_accumulation_steps=k,
                learning_rate=1e-2, lr_schedule="cosine", lr_warmup_steps=2,
                lr_decay_steps=8, max_grad_norm=max_norm)
    jc, tc = jcfg.tiny(), tcfg.tiny()
    return (dataclasses.replace(jc, train=dataclasses.replace(jc.train,
                                                              **over)),
            dataclasses.replace(tc, train=dataclasses.replace(tc.train,
                                                              **over)))


def test_factored_dims_follow_the_flax_shape():
    perms = flax_permutations(Tree())
    shapes = {n: tuple(p.shape) for n, p in Tree().named_parameters()}
    flax = {n: tuple(s[i] for i in perms[n]) if perms[n] else s
            for n, s in shapes.items()}
    assert flax["conv.weight"] == (3, 3, 128, 256)
    assert factored_dims(flax["conv.weight"]) == (2, 3)
    assert factored_dims(shapes["conv.weight"][-2:]) is None   # torch's
    assert factored_dims(flax["small.weight"]) is None
    assert factored_dims(flax["dense.weight"]) == (0, 1)
    assert factored_dims(flax["conv.bias"]) is None


@pytest.mark.parametrize("optimizer,k,max_norm,chunk", [
    ("adafactor", 1, 1.0, None), ("adafactor", 1, 0.0, None),
    ("adamw", 2, 1.0, None), ("adamw", 3, 1e4, None),
    ("adafactor", 2, 1.0, None), ("adafactor", 3, 1.0, None),
    ("adafactor", 1, 1.0, 300)])
def test_updates_match_optax(monkeypatch, optimizer, k, max_norm, chunk):
    """`chunk`: Adafactor's foreach chunk size in elements (300: several
    chunks a group, and parameters larger than a chunk alone)."""
    if chunk is not None:
        monkeypatch.setattr(adafactor, "CHUNK_ELEMENTS", chunk)
    jc, tc = configs(optimizer, k, max_norm)
    torch.manual_seed(0)
    tree = Tree()
    with torch.no_grad():
        for p in tree.parameters():
            p.normal_(0.0, 0.5)
    jparams = {key: jnp.asarray(v) for key, v in
               flax_from_module(tree).items()}
    opt = jstep.make_optimizer(jc)
    jstate = opt.init(jparams)
    opt_update = jax.jit(opt.update)
    params = dict(tree.named_parameters())
    state = TrainState(params, make_optimizer(tc, params,
                                              flax_permutations(tree)))
    update = make_update_fn(tc)
    rng = np.random.default_rng(7)
    before = flax_from_module(tree)
    for call in range(UPDATES * k):
        g = {key: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
             for key, v in before.items()}
        upd, jstate = opt_update({key: jnp.asarray(v) for key, v in
                                  g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = state_dict_from_flax(g)
        norm = update(state, [tg[n].clone() for n in params])
        want_norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                for v in g.values()))
        assert_rel_close(norm, want_norm, REL, f"norm @ {call}")
        got = flax_from_module(tree)
        emitted = (call + 1) % k == 0
        for key, w in jparams.items():
            assert_rel_close(got[key], np.asarray(w), REL, f"{key} @ {call}")
            if not emitted:
                np.testing.assert_array_equal(got[key], before[key],
                                              err_msg=f"{key} @ {call}")
        before = got
    assert state.step == UPDATES * k and state.updates == UPDATES
    assert state.mini_step == 0 and state.acc is None
    if optimizer == "adafactor" and k == 1:
        check_factored_state(tree, state, jstate)


def check_factored_state(tree, state, jstate):
    """The port's per-parameter v_row / v_col / v against optax's."""
    fs = next(s for s in jax_leaves(jstate) if hasattr(s, "v_row"))
    names = {id(p): n for n, p in tree.named_parameters()}
    flat = flax_from_module(tree)
    keys = {}              # torch name -> flax key, in flax_from_module order
    for (n, _), key in zip(tree.named_parameters(), flat):
        keys[n] = key
    for p, st in state.optimizer.state.items():
        key = keys[names[id(p)]]
        if "v" in st:
            assert_rel_close(st["v"], np.asarray(fs.v[key]), REL, key)
            assert np.asarray(fs.v_row[key]).shape == (1,)
        else:
            for part in ("v_row", "v_col"):
                want = np.asarray(getattr(fs, part)[key])
                assert tuple(st[part].shape) == want.shape, (key, part)
                assert_rel_close(st[part], want, REL, f"{key} {part}")


def jax_leaves(state):
    """The optax states nested in a chain's state."""
    out = [state]
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        for s in state:
            out += jax_leaves(s)
    elif hasattr(state, "_fields"):
        for s in state:
            if isinstance(s, tuple):
                out += jax_leaves(s)
    return out
