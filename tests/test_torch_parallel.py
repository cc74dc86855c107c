"""The port's DP, FSDP and Megatron TP (`parallel/mesh.py`) on
torch.distributed, held on the CPU:

  * the sharding plans against the JAX package's on the tiny dual
    stream's shape tree (meshes of 2 and 2 x 2 over the conftest's virtual
    CPU devices): the same tensors sharded, on the same dimension once
    mapped to torch's layout;
  * on 2 gloo ranks (one spawn, tests/torch_parallel_worker.py): the DP,
    FSDP, TP (1 x 2) and TP+FSDP (2 x 1) train steps, forward and inverse
    branch, against the port's single-process step on the same global
    batch (itself held to JAX in tests/test_torch_train_step.py): loss
    and every updated parameter within 1e-5 in f32, as the JAX
    tests/test_parallel_train.py holds its sharded steps, and the
    gradient norm and every gradient within 1e-5 relative; the DP and
    TP forward requests of `shard_pipeline` within 2e-4; a scene-bank
    Trainer step; an FSDP checkpoint saved at world 2 and resumed at world
    1, bit-equal;
  * on 4 ranks (a second spawn, beside the first): one 2 x 2 TP+FSDP
    step per branch;
  * Adafactor over sharded masters: `train/adafactor.Adafactor` on each
    rank's pieces (2 and 4 ranks) against `optax.adafactor` on the full
    tensors, 3 steps, within 1e-5 relative (kernels cut on either
    factored dimension, convs whose pieces would factor otherwise, a full
    `v`, a vector, TP's 2-block GEGLU `proj`, a replicated tensor; the
    clip active; the default chunks and chunks of 2^14 elements); the
    FSDP, TP and TP+FSDP steps (and the 2 x 2 one) with Adafactor, 2 steps
    a branch, and FSDP + Adafactor under gradient accumulation (k = 2),
    against the single-process Adafactor step under the same 1e-5; an
    FSDP Adafactor checkpoint saved at world 2 and resumed at
    world 1 bit-equal, and one saved by one process resumed by 2 FSDP
    ranks to the same next step within 1e-5.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_worker as W
from torch_port_helpers import assert_rel_close, flax_shapes, use_one_thread

use_one_thread()

from unirenderer_tpu.core import config as jcfg  # noqa: E402
from unirenderer_tpu.models.dual_stream import DualStreamModel as JaxDual  # noqa: E402,E501
from unirenderer_tpu.parallel import mesh as jmesh  # noqa: E402
from unirenderer_tpu_torch.core import config as tcfg  # noqa: E402
from unirenderer_tpu_torch.core.convert import flax_permutations  # noqa: E402,E501
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel  # noqa: E402,E501
from unirenderer_tpu_torch.parallel import mesh as pm  # noqa: E402

ATOL = 1e-5
GRAD_REL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both world layouts' ranks at once, one spawn each (one torch thread
    a rank), the single-process references computed here meanwhile ->
    {world: (directory, each rank's results)}, the references."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        runs = {}
        for world in W.STEP_CASES:
            out = str(tmp_path_factory.mktemp(f"ranks{world}"))
            runs[world] = out, mp.start_processes(
                W.run, args=(world, _free_port(), out), nprocs=world,
                join=False, start_method="spawn")
        single = W.single_process_cases()
        for _, ctx in runs.values():
            while not ctx.join():
                pass
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    return {world: (out, [torch.load(os.path.join(out, f"rank{r}.pt"),
                                     weights_only=False)
                          for r in range(world)])
            for world, (out, _) in runs.items()}, single


@pytest.fixture(scope="module")
def ranks2(spawned):
    return spawned[0][2]


@pytest.fixture(scope="module")
def ranks4(spawned):
    return spawned[0][4]


@pytest.fixture(scope="module")
def single(spawned):
    return spawned[1]


# ---------------------------------------------------------------------------
# Sharding plans against JAX
# ---------------------------------------------------------------------------

def _port_name(path) -> str:
    keys = [p.key for p in path if hasattr(p, "key")]
    if keys and keys[0] == "params":
        keys = keys[1:]
    leaf = keys[-1]
    if leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    return ".".join(keys[:-1] + [leaf])


def _jax_plan(shardings, perms):
    """{port name: (axis, torch dim) or None} of a JAX sharding tree."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        name = _port_name(path)
        place = None
        for i, axis in enumerate(s.spec):
            if axis is not None:
                perm = perms[name]
                place = (axis, i if perm is None else perm[i])
        out[name] = place
    return out


@pytest.fixture(scope="module")
def plan_trees():
    cfg = jcfg.tiny()
    u, s = cfg.unet, cfg.unet.sample_size
    shapes = flax_shapes(
        JaxDual(u, jnp.float32), jnp.zeros((1, s, s, 4)),
        jnp.zeros((1, s, s, u.attr_channels)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.text.max_length, u.cross_attention_dim)))
    with torch.device("meta"):
        dual = DualStreamModel(tcfg.tiny().unet)
    return shapes, dual, flax_permutations(dual)


@pytest.mark.parametrize("which", ["fsdp", "tp", "tp_fsdp"])
def test_sharding_plan_matches_jax(which, plan_trees, eight_devices,
                                   monkeypatch):
    shapes, dual, perms = plan_trees
    min_size = W.FSDP_MIN_SIZE
    monkeypatch.setattr(pm, "FSDP_MIN_SIZE", min_size)
    if which == "fsdp":
        want = _jax_plan(jmesh.fsdp_param_sharding(
            shapes, jmesh.make_mesh(2), min_size=min_size), perms)
        got = pm.fsdp_plan(dual, 2)
    else:
        fsdp = which == "tp_fsdp"
        want = _jax_plan(jmesh.tp_param_sharding(
            shapes, jmesh.make_mesh_2d(2, 2),
            data_axis="data" if fsdp else None, fsdp_min_size=min_size),
            perms)
        got = pm.tp_param_sharding(dual, 2, 2 if fsdp else None)
    assert got == want
    axes = {p[0] for p in got.values() if p is not None}
    assert axes == ({"data"} if which == "fsdp" else
                    {"model", "data"} if which == "tp_fsdp" else {"model"})


def test_fsdp_dim_sizes_plan_flagship_widths():
    """At flagship width the default 2^18 threshold shards the big
    kernels and keeps norms and biases replicated."""
    with torch.device("meta"):
        dual = DualStreamModel(tcfg.flagship().unet)
    plan = pm.fsdp_param_sharding(dual, 8)
    params = dict(dual.named_parameters())
    sharded = [n for n, d in plan.items() if d is not None]
    assert sharded and all(params[n].numel() >= 2 ** 18 for n in sharded)
    assert all(plan[n] is None for n in params if n.endswith(".bias"))


def test_split_and_join_blocks_roundtrip():
    full = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(16, 3)
    pieces = [pm.split_blocks(full, 0, 2, 2, r) for r in range(2)]
    # GEGLU: rank 0 holds rows 0-3 of the hidden half and 8-11 of the gate
    assert torch.equal(pieces[0][:, 0], torch.tensor(
        [0., 3, 6, 9, 24, 27, 30, 33]))
    assert torch.equal(pm.join_blocks(pieces, 0, 2), full)
    cols = [pm.split_blocks(full.T, 1, 1, 4, r) for r in range(4)]
    assert torch.equal(pm.join_blocks(cols, 1, 1), full.T)


def test_host_local_batch_slice_single_process():
    assert pm.host_local_batch_slice(4) == slice(0, 4)
    assert pm.initialize_distributed() is False


# ---------------------------------------------------------------------------
# 2 and 4 gloo ranks against the single-process step
# ---------------------------------------------------------------------------

def _check_step(got, want, what):
    """Loss, the updated masters (the config's learning rate, as the JAX
    tests take it) within 1e-5; the gradient norm and every gradient the
    optimizer was handed within 1e-5 relative (of the norm; of the
    largest gradient element)."""
    loss, gnorm, params, grads = got[:4]
    loss_w, gnorm_w, params_w, grads_w = want[:4]
    _check_grads(loss, gnorm, grads, loss_w, gnorm_w, grads_w, what)
    assert params.keys() == params_w.keys() == grads.keys()
    _check_params(params, params_w, what)


def _check_params(params, params_w, what):
    for k in params_w:
        err = np.abs(params[k] - params_w[k]).max()
        assert err <= ATOL, (what, k, err)


def _check_grads(loss, gnorm, grads, loss_w, gnorm_w, grads_w, what):
    assert abs(loss - loss_w) <= ATOL, (what, loss, loss_w)
    assert abs(gnorm - gnorm_w) <= 1e-5 * gnorm_w, (what, gnorm, gnorm_w)
    assert grads.keys() == grads_w.keys()
    scale = max(np.abs(g).max() for g in grads_w.values())
    for k in grads_w:
        err = np.abs(grads[k] - grads_w[k]).max()
        assert err <= GRAD_REL * scale, (what, k, err / scale)


@pytest.mark.parametrize("branch", W.BRANCHES)
@pytest.mark.parametrize("kind", W.STEP_CASES[2])
def test_two_rank_step_matches_single_process(kind, branch, ranks2, single):
    _, results = ranks2
    for r, res in enumerate(results):
        _check_step(res[(kind, branch)], single[("single", branch)],
                    (kind, branch, r))
        # TP wraps the linears over a model axis of 2 ("tp": 1 x 2) and
        # applies nothing over one of 1 ("tp_fsdp": 2 x 1)
        assert (res[(kind, branch)][4] > 0) == (kind == "tp"), kind


@pytest.mark.parametrize("branch", W.BRANCHES)
def test_four_rank_tp_fsdp_step_matches_single_process(branch, ranks4,
                                                       single):
    _, results = ranks4
    for r, res in enumerate(results):
        _check_step(res[("tp_fsdp_2x2", branch)],
                    single[("single", branch)], ("2x2", branch, r))


def test_two_rank_bank_step_matches_single_process(ranks2, single):
    """A DP scene-bank Trainer step (the bank whole on both ranks, the
    drawn scenes split) against one process's over the same 4 scenes."""
    _, results = ranks2
    loss_w, gnorm_w = single["bank"]
    for res in results:
        loss, gnorm = res["bank"]
        assert abs(loss - loss_w) <= ATOL, (loss, loss_w)
        assert abs(gnorm - gnorm_w) <= 1e-5 * gnorm_w, (gnorm, gnorm_w)


def test_two_rank_fsdp_trainer_on_local_rows_matches_single_process(
        ranks2, single):
    """Two FSDP Trainer steps, each rank given only its rows of the global
    batch, against one process's Trainer over the whole batches."""
    _, results = ranks2
    want = single["trainer"]
    for res in results:
        got = res["checkpoint"][3]
        assert np.allclose(got, want, rtol=0, atol=ATOL), (got, want)


@pytest.mark.parametrize("mesh_kind", ["dp", "tp"])
def test_sharded_serving_matches_single_process(mesh_kind, ranks2, single):
    _, results = ranks2
    want = single[("serve", "single")]
    assert np.abs(want).max() > 0.05
    for res in results:
        got = res[("serve", mesh_kind)]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_fsdp_checkpoint_resumes_bit_equal_at_world_one(ranks2):
    """Saved by 2 FSDP ranks (full tensors gathered), resumed by one
    process: every master, optimizer tensor, counter and the generator's
    state bit-equal to what the ranks held."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.train.trainer import Trainer
    out, results = ranks2
    params, st, sharded, _ = results[0]["checkpoint"]
    assert sharded > 10                 # FSDP split the big tensors
    p1 = results[1]["checkpoint"][0]
    for k in params:                    # both ranks gathered the same
        assert np.array_equal(params[k], p1[k]), k
    tr = Trainer(config.tiny(), os.path.join(out, "ckpt"), device="cpu")
    assert tr.maybe_resume() == 2
    got = {k: v.detach().numpy() for k, v in tr.state.params.items()}
    assert got.keys() == params.keys()
    for k in params:
        assert np.array_equal(got[k], params[k]), k
    mine = tr.resume_state()
    for key in ("step", "updates", "mini_step"):
        assert mine[key] == st[key]
    assert torch.equal(mine["generator"], st["generator"])
    want_opt, got_opt = st["optimizer"]["state"], mine["optimizer"]["state"]
    assert want_opt.keys() == got_opt.keys()
    for i in want_opt:
        for k, v in want_opt[i].items():
            assert torch.equal(got_opt[i][k], v), (i, k)


def _check_resumed_state(mine, st):
    """A resumed Trainer's full state (`resume_state`) against the state
    the ranks saved: counters, the generator, every optimizer entry
    bit-equal."""
    for key in ("step", "updates", "mini_step"):
        assert mine[key] == st[key]
    assert torch.equal(mine["generator"], st["generator"])
    want_opt, got_opt = st["optimizer"]["state"], mine["optimizer"]["state"]
    assert want_opt.keys() == got_opt.keys()
    for i in want_opt:
        assert want_opt[i].keys() == got_opt[i].keys(), i
        for k, v in want_opt[i].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got_opt[i][k], v), (i, k)
            else:
                assert got_opt[i][k] == v, (i, k)


# ---------------------------------------------------------------------------
# Adafactor over sharded masters
# ---------------------------------------------------------------------------

def _optax_adafactor(clip):
    """optax.adafactor over the full tensors of W.OPT_TENSORS (flax
    layout) -> ({name: parameter after W.OPT_STEPS updates, torch
    layout}, the FactoredState)."""
    full, grads = W.optimizer_case_tensors()
    perms = {n: t[1] for n, t in W.OPT_TENSORS.items()}

    def flax(n, v):
        return jnp.asarray(v if perms[n] is None else v.transpose(perms[n]))

    params = {n: flax(n, v) for n, v in full.items()}
    opt = optax.adafactor(W.OPT_LR, clipping_threshold=clip,
                          weight_decay_rate=W.OPT_WD)
    state = opt.init(params)
    update = jax.jit(opt.update)
    for g in grads:
        upd, state = update({n: flax(n, v) for n, v in g.items()}, state,
                            params)
        params = optax.apply_updates(params, upd)
    out = {n: np.asarray(v if perms[n] is None
                         else v.transpose(np.argsort(perms[n])))
           for n, v in params.items()}
    factored = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, "v_row")) if hasattr(s, "v_row"))
    return out, factored


@pytest.fixture(scope="module")
def optax_adafactor():
    """optax's result and statistics, and its parameters without the
    clip."""
    return _optax_adafactor(W.OPT_CLIP) + (_optax_adafactor(None)[0],)


@pytest.mark.parametrize("chunk", W.OPT_CHUNKS)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_adafactor_matches_optax(world, chunk, spawned,
                                         optax_adafactor):
    """Each rank's pieces after 3 updates, gathered, and the statistics
    (v_row / v_col whole on the rank, v gathered) against optax on the
    full tensors; the clip is active (optax without it ends elsewhere)."""
    want, fs, unclipped = optax_adafactor
    for r, res in enumerate(spawned[0][world][1]):
        got = res[("optimizer", chunk)]
        assert got.keys() == want.keys()
        for n in want:
            params, stats = got[n]
            assert_rel_close(params, want[n], 1e-5, (world, chunk, r, n))
            if "v" in stats:
                assert np.asarray(fs.v_row[n]).shape == (1,), n
                assert_rel_close(stats["v"], np.asarray(fs.v[n]), 1e-5, n)
            else:
                for part in ("v_row", "v_col"):
                    assert_rel_close(stats[part],
                                     np.asarray(getattr(fs, part)[n]), 1e-5,
                                     (world, chunk, r, n, part))
    assert max(np.abs(unclipped[n] - want[n]).max() for n in want) > 1e-3


def _replay_adafactor(history):
    """One process's Adafactor (`make_optimizer`, no split) from tiny()'s
    initial masters, fed the full gradients a run's optimizer was handed,
    update by update -> the masters after them."""
    from unirenderer_tpu_torch.train.train_step import (
        make_lr_schedule, make_optimizer,
    )
    cfg, dual, _, _ = W.tiny_models()
    cfg = W.with_optimizer(cfg, "adafactor")
    params = dict(dual.named_parameters())
    opt = make_optimizer(cfg, params, flax_permutations(dual))
    lr = make_lr_schedule(cfg)
    updates = [grads for _, _, grads in history if grads is not None]
    with torch.no_grad():
        for i, grads in enumerate(updates):
            for n, p in params.items():
                p.grad = torch.from_numpy(grads[n])
            for group in opt.param_groups:
                group["lr"] = lr(i)
            opt.step()
    return {n: p.detach().numpy() for n, p in params.items()}


def _check_adafactor_steps(got, want, what):
    """Each step's loss, gradient norm and gradients against the
    single-process Adafactor step's (ATOL, GRAD_REL), and the masters
    against one process's Adafactor fed the ranks' own gradients (ATOL).
    At tiny() widths nothing factors (every dimension is under 128), so a
    first update is lr x RMS(p) x sign(g) elementwise: a gradient element
    within float noise of zero takes either sign, and the masters are
    held to the optimizer's output for the gradients the ranks computed,
    not to another process's."""
    assert len(got[5]) == len(want[5])
    for i, ((loss, gnorm, grads), (loss_w, gnorm_w, grads_w)) in enumerate(
            zip(got[5], want[5])):
        assert (grads is None) == (grads_w is None), (what, i)
        if grads is None:          # accumulated, no update
            assert abs(loss - loss_w) <= ATOL, (what, i, loss, loss_w)
            assert abs(gnorm - gnorm_w) <= 1e-5 * gnorm_w, (what, i)
        else:
            _check_grads(loss, gnorm, grads, loss_w, gnorm_w, grads_w,
                         what + (f"step {i + 1}",))
    params_w = _replay_adafactor(got[5])
    assert got[2].keys() == params_w.keys()
    _check_params(got[2], params_w, what)


@pytest.mark.parametrize("branch", W.BRANCHES)
@pytest.mark.parametrize("kind", W.ADAFACTOR_CASES[2])
def test_two_rank_adafactor_step_matches_single_process(kind, branch, ranks2,
                                                        single):
    """2 Adafactor steps over sharded masters against one process's."""
    _, results = ranks2
    for r, res in enumerate(results):
        _check_adafactor_steps(res[(kind, branch, "adafactor")],
                               single[("single", branch, "adafactor")],
                               (kind, branch, "adafactor", r))


@pytest.mark.parametrize("branch", W.BRANCHES)
def test_four_rank_tp_fsdp_adafactor_step_matches_single_process(
        branch, ranks4, single):
    _, results = ranks4
    for r, res in enumerate(results):
        _check_adafactor_steps(res[("tp_fsdp_2x2", branch, "adafactor")],
                               single[("single", branch, "adafactor")],
                               ("2x2", branch, "adafactor", r))


def test_two_rank_fsdp_adafactor_accumulation_matches_single_process(
        ranks2, single):
    """FSDP + Adafactor under MultiSteps (k = 2): the first call only
    accumulates, the second updates from the mean of both gradients."""
    _, results = ranks2
    want = single["accumulation"]
    assert [g is None for _, _, g in want[5]] == [True, False]
    for r, res in enumerate(results):
        _check_adafactor_steps(res["accumulation"], want,
                               ("accumulation", r))


def test_two_rank_fsdp_adafactor_trainer_matches_single_process(ranks2,
                                                                single):
    """Two FSDP Adafactor Trainer steps on each rank's rows against one
    process's: the second loss follows the first update."""
    _, results = ranks2
    want = single["trainer_adafactor"]
    for res in results:
        got = res["checkpoint_adafactor"][3]
        assert np.allclose(got, want, rtol=0, atol=ATOL), (got, want)


def test_fsdp_adafactor_checkpoint_resumes_bit_equal_at_world_one(ranks2):
    """An FSDP Adafactor state saved by 2 ranks, resumed by one process:
    masters, v, v_row, v_col, steps, counters and the generator
    bit-equal to what the ranks held."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.train.trainer import Trainer
    out, results = ranks2
    params, st, sharded, _ = results[0]["checkpoint_adafactor"]
    assert sharded > 10
    kinds = {k for s in st["optimizer"]["state"].values() for k in s}
    assert kinds == {"step", "v", "v_row", "v_col"}
    tr = Trainer(W.with_optimizer(config.tiny(), "adafactor"),
                 os.path.join(out, "ckpt_adafactor"), device="cpu")
    assert tr.maybe_resume() == 2
    got = {k: v.detach().numpy() for k, v in tr.state.params.items()}
    assert got.keys() == params.keys()
    for k in params:
        assert np.array_equal(got[k], params[k]), k
    _check_resumed_state(tr.resume_state(), st)


def test_world_one_adafactor_checkpoint_resumes_at_world_two(ranks2):
    """Saved by one process after 2 Adafactor steps, resumed by 2 FSDP
    ranks: their third step equals the one process's within 1e-5."""
    _, results = ranks2
    for res in results:
        loss_w, params_w = res["world_one"]
        loss, params = res["resumed"]
        assert abs(loss - loss_w) <= ATOL, (loss, loss_w)
        for k in params_w:
            err = np.abs(params[k] - params_w[k]).max()
            assert err <= ATOL, (k, err)
