"""The port's BSDF, image loss and evaluation modules against the JAX
package, on the CPU, in float32 unless stated:

  * every BSDF function (`lambert`, `frostbite_diffuse`, `fresnel_schlick`,
    `ndf_ggx`, `lambda_ggx`, `masking_smith_ggx_correlated`,
    `pbr_specular`) in f32, and `pbr_bsdf` with both diffuse lobes in f64
    (`jax.enable_x64`; in f32 each side sits ~1.5e-5 * max from the f64
    value at the GGX peak, both held within 1e-4 of it): values within
    1e-5 * max|jax|, and the gradients of a weighted sum of each output
    against `jax.grad` within 1e-5 * max|jax grad| (on inputs away from
    the clamps' kinks); the numpy oracles of tests/test_ops.py;
  * `image_loss` for every loss x tonemap, value and gradient, 1e-5;
  * `mse`, `SegMetric`, `DepthMetric`, `frechet_distance` and `fid` (over
    a fixed random projection as the feature function) against JAX's
    numpy, 1e-12 relative (the same float64 arithmetic);
  * LPIPS and the InceptionV3 trunk against the flax modules, the flax
    parameters carried across by `state_dict_from_flax`: within 1e-4
    relative, small inputs, the flax modules applied eagerly (no jit);
    the 299^2 resize of `make_feature_fn` against `jax.image.resize`
    (f64, 1e-5);
  * the torchvision-layout loaders: random state_dicts in torchvision's
    and the lpips package's key layouts load into the port directly and
    give the same distances / features as the JAX module after
    `lpips_params_from_torch` / `load_torch_inception` (whose Mixed_7a
    names differ from torchvision's: mapped for it here).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_rel_close, flax_shapes
from unirenderer_tpu.eval import inception as jinc
from unirenderer_tpu.eval import lpips as jlp
from unirenderer_tpu.eval import metrics as jmet
from unirenderer_tpu.ops import bsdf as jb
from unirenderer_tpu.ops import image_loss as jil
from unirenderer_tpu_torch.eval import inception as tinc
from unirenderer_tpu_torch.eval import lpips as tlp
from unirenderer_tpu_torch.eval import metrics as tmet
from unirenderer_tpu_torch.ops import bsdf as tb
from unirenderer_tpu_torch.ops import image_loss as til

REL = 1e-5
NET_REL = 1e-4

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _nrm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed, n=64):
    """Unit vectors in the upper hemisphere around +z (front-facing
    light and view), colours and roughness in [0.1, 0.9]."""
    rng = np.random.default_rng(seed)

    def hemi():
        v = rng.standard_normal((n, 3))
        v[:, 2] = np.abs(v[:, 2]) + 0.5
        return _nrm(v).astype(np.float32)

    nrm = _nrm(np.array([0, 0, 1.0]) + 0.2 * rng.standard_normal((n, 3)))
    return dict(nrm=nrm.astype(np.float32), wi=hemi(), wo=hemi(),
                col=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                a=rng.uniform(0.1, 0.9, (n, 1)).astype(np.float32),
                c=rng.uniform(0.05, 0.95, (n, 1)).astype(np.float32),
                c2=rng.uniform(0.05, 0.95, (n, 1)).astype(np.float32))


CASES = {
    "lambert": (("nrm", "wi"), lambda m, d: m.lambert(d["nrm"], d["wi"])),
    "frostbite_diffuse": (("nrm", "wi", "wo", "a"),
                          lambda m, d: m.frostbite_diffuse(
                              d["nrm"], d["wi"], d["wo"], d["a"])),
    "fresnel_schlick": (("col", "a", "c"),
                        lambda m, d: m.fresnel_schlick(d["col"], d["a"],
                                                       d["c"])),
    "ndf_ggx": (("a", "c"), lambda m, d: m.ndf_ggx(d["a"], d["c"])),
    "lambda_ggx": (("a", "c"), lambda m, d: m.lambda_ggx(d["a"], d["c"])),
    "masking_smith_ggx_correlated": (
        ("a", "c", "c2"), lambda m, d: m.masking_smith_ggx_correlated(
            d["a"], d["c"], d["c2"])),
    "pbr_specular": (("col", "nrm", "wo", "wi", "a"),
                     lambda m, d: m.pbr_specular(d["col"], d["nrm"],
                                                 d["wo"], d["wi"], d["a"])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bsdf_function_and_gradient_match_jax(name):
    args, fn = CASES[name]
    d = _inputs(1)
    weights = np.random.default_rng(2).standard_normal(
        np.shape(fn(jb, {k: jnp.asarray(v) for k, v in d.items()})))
    want = np.asarray(fn(jb, {k: jnp.asarray(v) for k, v in d.items()}))
    tin = {k: torch.from_numpy(v).requires_grad_(k in args)
           for k, v in d.items()}
    got = fn(tb, tin)
    assert_rel_close(got, want, REL, name)
    (got * torch.from_numpy(weights).float()).sum().backward()

    def loss(*xs):
        dd = dict(d)
        dd.update({k: x for k, x in zip(args, xs)})
        return jnp.sum(fn(jb, dd) * weights)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(d[k]) for k in args])
    for k, g in zip(args, grads):
        assert_rel_close(tin[k].grad, np.asarray(g), REL, f"{name} d/d{k}")


@pytest.mark.parametrize("diffuse", ["lambert", "frostbite"])
def test_pbr_bsdf_and_gradient_match_jax(diffuse):
    rng = np.random.default_rng(3)
    shape = (2, 6, 7)
    d = dict(kd=rng.uniform(0, 1, shape + (3,)),
             arm=rng.uniform(0.1, 1, shape + (3,)),
             pos=rng.standard_normal(shape + (3,)) * 0.3,
             nrm=_nrm(np.array([0, 0, 1.0])
                      + 0.3 * rng.standard_normal(shape + (3,))),
             view=rng.standard_normal((2, 1, 1, 3)) + [0, 0, 5.0],
             light=rng.standard_normal((2, 1, 1, 3)) + [1, 0, 4.0])
    names = tuple(d)

    def jfn(*xs):
        return jb.pbr_bsdf(*xs, diffuse_bsdf=diffuse)
    # float64 on both sides: at roughness 0.1 the GGX peak puts each f32
    # evaluation ~1.5e-5 * max away from the f64 value, so f32 against f32
    # would measure that rounding, not the formulas
    with jax.enable_x64(True):
        want = np.asarray(jfn(*[jnp.asarray(d[k]) for k in names]))
        w = rng.standard_normal(want.shape)
        grads = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * w),
                         argnums=tuple(range(len(names))))(
            *[jnp.asarray(d[k]) for k in names])
    assert want.dtype == np.float64
    tin = [torch.from_numpy(d[k]).requires_grad_() for k in names]
    got = tb.pbr_bsdf(*tin, diffuse_bsdf=diffuse)
    assert_rel_close(got, want, REL, f"pbr_bsdf {diffuse}")
    (got * torch.from_numpy(w)).sum().backward()
    for k, t, g in zip(names, tin, grads):
        assert_rel_close(t.grad, np.asarray(g), REL, f"d pbr_bsdf / d{k}")
    # and in f32, both within 1e-4 * max of the f64 value
    got32 = tb.pbr_bsdf(*[torch.from_numpy(d[k].astype(np.float32))
                          for k in names], diffuse_bsdf=diffuse)
    want32 = jfn(*[jnp.asarray(d[k], jnp.float32) for k in names])
    assert_rel_close(got32, want, 1e-4, "f32 port")
    assert_rel_close(want32, want, 1e-4, "f32 jax")


def test_bsdf_oracles():
    """tests/test_ops.py's numpy oracles on the port: Lambert, Schlick,
    the GGX normalisation and no specular below the surface."""
    rng = np.random.default_rng(4)
    n = _nrm(rng.standard_normal((64, 3))).astype(np.float32)
    wi = _nrm(rng.standard_normal((64, 3))).astype(np.float32)
    np.testing.assert_allclose(
        tb.lambert(torch.from_numpy(n), torch.from_numpy(wi)).numpy(),
        np.clip((n * wi).sum(-1, keepdims=True), 0, None) / math.pi,
        rtol=1e-5, atol=1e-6)
    theta = (np.arange(512) + 0.5) * (math.pi / 2 / 512)
    dval = tb.ndf_ggx(0.3 ** 2, torch.from_numpy(
        np.cos(theta, dtype=np.float32)[:, None])).numpy()[:, 0]
    integral = float(np.sum(dval * np.cos(theta) * np.sin(theta))
                     * (math.pi / 2 / 512) * 2 * math.pi)
    assert abs(integral - 1.0) < 0.02
    wo = _nrm(np.abs(rng.standard_normal((8, 3)))).astype(np.float32)
    below = wo.copy()
    below[:, 2] = -np.abs(below[:, 2])
    out = tb.pbr_specular(torch.full((8, 3), 0.5),
                          torch.tensor([[0, 0, 1.0]]).expand(8, 3),
                          torch.from_numpy(wo), torch.from_numpy(below),
                          torch.full((8, 1), 0.2))
    assert (out == 0).all()


@pytest.mark.parametrize("tonemap", ["none", "log_srgb"])
@pytest.mark.parametrize("loss", ["l1", "mse", "smape", "relmse"])
def test_image_loss_matches_jax(loss, tonemap):
    rng = np.random.default_rng(5)
    img = np.exp(rng.standard_normal((2, 8, 9, 3))).astype(np.float32)
    ref = np.exp(rng.standard_normal((2, 8, 9, 3))).astype(np.float32)
    want = jil.image_loss(jnp.asarray(img), jnp.asarray(ref), loss, tonemap)
    t = torch.from_numpy(img).requires_grad_()
    got = til.image_loss(t, torch.from_numpy(ref), loss, tonemap)
    assert_rel_close(got, np.asarray(want), REL, f"{loss} {tonemap}")
    got.backward()
    g = jax.grad(lambda x: jil.image_loss(x, jnp.asarray(ref), loss,
                                          tonemap))(jnp.asarray(img))
    assert_rel_close(t.grad, np.asarray(g), REL, f"d {loss} {tonemap}")
    with pytest.raises(ValueError):
        til.image_loss(t, t, "huber", tonemap)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    a, b = rng.uniform(0, 1, (2, 3, 8, 8, 3))
    assert tmet.mse(a, b) == jmet.mse(a, b)
    ts, js = tmet.SegMetric(4), jmet.SegMetric(4)
    for _ in range(3):
        pred = rng.integers(0, 4, (16, 16))
        label = rng.integers(-1, 5, (16, 16))
        ts.update(pred, label)
        js.update(pred, label)
    np.testing.assert_array_equal(ts.confusion, js.confusion)
    for m in ("pixel_accuracy", "miou", "fw_iou"):
        assert getattr(ts, m)() == getattr(js, m)(), m
    td, jd = tmet.DepthMetric(), jmet.DepthMetric()
    for _ in range(2):
        gt = rng.uniform(0, 2, (12, 12))
        pred = gt * rng.uniform(0.7, 1.4, gt.shape)
        mask = rng.uniform(size=gt.shape) > 0.3
        td.update(pred, gt, mask)
        jd.update(pred, gt, mask)
    td.update(np.ones(4), np.zeros(4))              # nothing valid
    jd.update(np.ones(4), np.zeros(4))
    assert td.summary() == jd.summary()


def test_frechet_and_fid_match_jax():
    rng = np.random.default_rng(7)
    f1, f2 = rng.standard_normal((2, 40, 12))
    f2 = f2 @ rng.standard_normal((12, 12)) * 0.5 + 0.3
    stats = [f.mean(0) for f in (f1, f2)], [np.cov(f, rowvar=False)
                                           for f in (f1, f2)]
    args = (stats[0][0], stats[1][0], stats[0][1], stats[1][1])
    got, want = tmet.frechet_distance(*args), jmet.frechet_distance(*args)
    assert abs(got - want) <= 1e-12 * abs(want) and want > 0
    proj = rng.standard_normal((4 * 4 * 3, 16)).astype(np.float32)

    def feature_fn(images):
        return np.asarray(images, np.float32).reshape(len(images), -1) @ proj
    ia, ib = rng.uniform(0, 1, (2, 20, 4, 4, 3)).astype(np.float32)
    got, want = tmet.fid(ia, ib, feature_fn), jmet.fid(ia, ib, feature_fn)
    assert abs(got - want) <= 1e-12 * abs(want) and want > 0
    assert abs(tmet.fid(ia, ia, feature_fn)) < 1e-6


# ---------------------------------------------------------------------------
# LPIPS and InceptionV3 against the flax modules
# ---------------------------------------------------------------------------

def _random_flax(shapes, seed, scale_names=("lin",)):
    """Seeded values for a flax shape tree: kernels N(0, 2 / fan_in),
    biases N(0, 0.1^2), BatchNorm var in [0.5, 1.5), mean / beta
    N(0, 0.1^2), gamma 1 + N(0, 0.1^2), linear heads U(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return z * np.float32(np.sqrt(2.0 / np.prod(leaf.shape[:-1])))
        if name == "bn_var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "bn_gamma":
            return 1 + 0.1 * z
        if name.startswith(scale_names):
            return rng.uniform(0, 1, leaf.shape).astype(np.float32)
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_lpips_matches_flax_and_loads_torch_layouts():
    jm = jlp.LPIPS()
    z = jnp.zeros((1, 32, 32, 3))
    params = _random_flax(flax_shapes(jm, z, z), 8)
    rng = np.random.default_rng(9)
    a, b = rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(a), jnp.asarray(b)))
    tm = tlp.LPIPS().eval()
    tm.load_state_dict(tlp.state_dict_from_flax(params))
    fn, _ = tlp.make_lpips_fn(tm)
    assert_rel_close(fn(a, b), want, NET_REL, "LPIPS")
    np.testing.assert_allclose(fn(a, a), 0.0, atol=1e-6)

    # torchvision / lpips-package layouts, loaded as they come
    chans = [c for blk in tlp.VGG_BLOCKS for c in blk]
    feats, cin = {}, 3
    for ti, co in zip(tlp.VGG_CONV_INDICES, chans):
        feats[f"{ti}.weight"] = torch.from_numpy(rng.standard_normal(
            (co, cin, 3, 3)).astype(np.float32) * np.sqrt(2.0 / (9 * cin)))
        feats[f"{ti}.bias"] = torch.from_numpy(
            rng.standard_normal(co).astype(np.float32) * 0.1)
        cin = co
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(blk[-1] for blk in tlp.VGG_BLOCKS)}
    tm2 = tlp.LPIPS().eval()
    tm2.load_torch_weights(feats, lins)
    jparams = jlp.lpips_params_from_torch(
        {k: v.numpy() for k, v in feats.items()},
        {k: v.numpy() for k, v in lins.items()})
    want2 = np.asarray(jm.apply(jparams, jnp.asarray(a), jnp.asarray(b)))
    assert_rel_close(tlp.make_lpips_fn(tm2)[0](a, b), want2, NET_REL,
                     "LPIPS from torch layouts")


def test_inception_matches_flax_and_loads_torchvision_layout():
    jm = jinc.InceptionV3Features()
    params = _random_flax(flax_shapes(jm, jnp.zeros((1, 75, 75, 3))), 10)
    x = np.random.default_rng(11).uniform(0, 1, (2, 75, 75, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tinc.InceptionV3Features().eval()
    sd = tinc.state_dict_from_flax(params)
    tinc.load_torch_inception(tm, sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2048)
    assert_rel_close(got, want, NET_REL, "InceptionV3 pool3")

    # a torchvision-layout state_dict (with the aux head and fc, and
    # num_batches_tracked) loads directly; JAX's `load_torch_inception`
    # looks Mixed_7a's 7x7 branch up as `branch7x7_*` where torchvision
    # names it `branch7x7x3_*`, so its copy is renamed for it
    rng = np.random.default_rng(12)
    tv = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32) * (0.05 if v.dim() == 4 else 0.1)) for k, v in sd.items()}
    for k in tv:
        if k.endswith("running_var"):
            tv[k] = tv[k].abs() + 0.5
    full = dict(tv, **{"fc.weight": torch.zeros(1000, 2048),
                       "AuxLogits.fc.bias": torch.zeros(1000)})
    full.update({k.replace("running_var", "num_batches_tracked"):
                 torch.tensor(0) for k in tv if k.endswith("running_var")})
    tm2 = tinc.InceptionV3Features().eval()
    tinc.load_torch_inception(tm2, full)
    jax_sd = {k.replace("Mixed_7a.branch7x7x3_", "Mixed_7a.branch7x7_"):
              v.numpy() for k, v in tv.items()}
    ported = jinc.load_torch_inception(params, jax_sd)
    with torch.no_grad():
        got2 = tm2(torch.from_numpy(x))
    assert_rel_close(got2, np.asarray(jm.apply(ported, jnp.asarray(x))),
                     NET_REL, "InceptionV3 from a torchvision state_dict")
    with pytest.raises(KeyError):
        tinc.load_torch_inception(tm2, {k: v for k, v in tv.items()
                                        if "Mixed_7a" not in k})


def test_fid_resize_matches_jax_image_resize():
    """`make_feature_fn`'s resize to 299^2 against `jax.image.resize`
    bilinear, up and down (the triangle filter widened when shrinking)."""
    rng = np.random.default_rng(13)
    for hw in ((32, 40), (320, 310)):
        x = rng.uniform(0, 1, (1,) + hw + (3,))
        with jax.enable_x64(True):       # f64: the filters, not rounding
            want = np.asarray(jax.image.resize(
                jnp.asarray(x), (1, 299, 299, 3), "bilinear"))
        got = tinc.fid_resize(torch.from_numpy(x))
        assert_rel_close(got, want, REL, f"resize from {hw}")
    feats = tinc.make_feature_fn(tinc.random_inception(device="cpu"),
                                 device="cpu", batch=2)(
        x[:, :80, :80].astype(np.float32))
    assert feats.shape == (1, 2048) and np.isfinite(feats).all()
