"""The port's ResNet and ResNet-FPN vision towers against the JAX package's,
on the CPU: `ResNetBackbone` (resnet18/34/50/101 at 32 px, eval and train
mode with the updated BatchNorm statistics, `stride_in_1x1` on and off,
gradients), `convert_torchvision_resnet`, `roi_align` (ramps, random
boxes, bf16 maps, gradients), JAX's `nearest` resize at sizes that are not
twice the next level, `FPNVisionTower` in both modes (pooled p6 and the
regional top-K with its box head; exact `top_k` ties), the pooled tower's
dispatch and widths, and `convert_detectron2_fpn` / `load_detectron2_state_dict`
(`.pkl` and `.pth`) on a synthetic detectron2-layout state dict. Weights
move from Flax by `tree_to_state_dict`; f32 unless stated; every
comparison states its tolerance."""

import copy
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models import convert as jconvert
from multimodal_sequencing_tpu.models import fpn as jfpn
from multimodal_sequencing_tpu.models import resnet as jresnet
from multimodal_sequencing_tpu_torch.models import convert as tconvert
from multimodal_sequencing_tpu_torch.models import fpn as tfpn
from multimodal_sequencing_tpu_torch.models import resnet as tresnet
from multimodal_sequencing_tpu_torch.models.convert import tree_to_state_dict

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jit(method, **static):
    return jax.jit(functools.partial(method, **static))


def _images(b, size, seed=0):
    """(B, H, W, 3) f32 NHWC images and their NCHW torch view."""
    x = np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def _pair(jmod, tmod, x, **kw):
    """Init `jmod` on `x`, load its variables into `tmod`; the variables."""
    variables = _np(_jit(jmod.init, **kw)(jax.random.PRNGKey(3),
                                          jnp.asarray(x)))
    tmod.load_state_dict(tree_to_state_dict(variables["params"],
                                            variables.get("batch_stats")))
    return variables


def _close(got, want, rel, err=""):
    want = np.asarray(want)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=10 * rel,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=err)


def _f64(module):
    """A copy of `module` that computes in f64 throughout."""
    module = copy.deepcopy(module).double()
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return module


def _as_f32_as_jax(got, want, ref64, err="", jax_bound=1e-3):
    """Train-mode BatchNorms normalize by few samples a channel, which
    magnifies f32 rounding through a deep tower past any fixed bound. So
    both f32 runs are held to an f64 run of the port on the same weights:
    JAX's f32 within `jax_bound` of the largest entry (it computes the
    port's function: 1e-3, 1e-2 through resnet101's 33 blocks), the port's
    f32 no farther than 4x JAX's own distance + 1e-6 of the largest."""
    want = np.asarray(want, np.float64)
    ref = ref64.detach().numpy()
    got = got.detach().double().numpy()
    scale = np.abs(ref).max()
    d_jax = np.abs(want - ref).max()
    d_port = np.abs(got - ref).max()
    assert got.shape == want.shape == ref.shape
    assert d_jax <= jax_bound * scale, (err, d_jax, scale)
    assert d_port <= 4 * d_jax + 1e-6 * scale, (err, d_port, d_jax)


def _stats_close(tmod, updated, ref64=None, jax_bound=1e-3):
    """The port's running statistics against JAX's updated batch_stats:
    within 1e-5 of each statistic's largest entry, or with `ref64` (the
    f64 run's module) as `_as_f32_as_jax` holds them."""
    want = tree_to_state_dict({}, _np(updated))
    got = tmod.state_dict()
    ref = None if ref64 is None else ref64.state_dict()
    for key, val in want.items():
        if ref is not None:
            _as_f32_as_jax(got[key], val.numpy(), ref[key], key, jax_bound)
            continue
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=0,
                                   atol=1e-5 * val.abs().max().item(),
                                   err_msg=key)


# ----- ResNet ---------------------------------------------------------------


@pytest.mark.parametrize("name,stride_in_1x1,train", [
    ("resnet18", False, False), ("resnet18", False, True),
    ("resnet34", False, True), ("resnet50", False, False),
    ("resnet50", False, True), ("resnet50", True, True),
    ("resnet101", False, False), ("resnet101", True, True)])
def test_resnet_matches_jax(name, stride_in_1x1, train):
    # pooled features at 32 px (c5 is 1 x 1) in eval mode, within 1e-5 of
    # the largest entry (f32 sums in another order); in train mode at
    # 64 px (c5 2 x 2: the last BatchNorms see 16 values a channel, where
    # 4 at 32 px put even JAX's f32 2 % from the f64 function), with every
    # BatchNorm's updated running averages, against an f64 run
    # (`_as_f32_as_jax`)
    x, xt = _images(4, 64 if train else 32, seed=1)
    jm = jresnet.ResNetBackbone(name, stride_in_1x1=stride_in_1x1)
    tm = tresnet.ResNetBackbone(name, stride_in_1x1=stride_in_1x1)
    variables = _pair(jm, tm, x)
    if not train:
        with torch.no_grad():
            got = tm(xt)
        _close(got, _jit(jm.apply)(variables, jnp.asarray(x)), 1e-5)
        assert got.shape[-1] == tresnet.resnet_feature_dim(name)
        return
    want, upd = _jit(jm.apply, deterministic=False,
                     mutable=["batch_stats"])(variables, jnp.asarray(x))
    t64 = _f64(tm)
    with torch.no_grad():
        got = tm(xt, deterministic=False)
        ref = t64(xt.double(), deterministic=False)
    bound = 1e-2 if name == "resnet101" else 1e-3
    _as_f32_as_jax(got, want, ref, jax_bound=bound)
    _stats_close(tm, upd["batch_stats"], t64, bound)


def test_resnet_stages_and_gradients_match_jax():
    # resnet50's c2..c5 stages (NCHW against NHWC), and every parameter's
    # gradient of a train-mode loss at 64 px, relative to the global
    # gradient norm
    x, xt = _images(4, 64, seed=2)
    jm, tm = jresnet.ResNetBackbone("resnet50"), tresnet.ResNetBackbone(
        "resnet50")
    variables = _pair(jm, tm, x)
    stages = _jit(jm.apply, return_stages=True)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(xt, return_stages=True)
    for key in ("c2", "c3", "c4", "c5"):
        _close(got[key].permute(0, 2, 3, 1), stages[key], 1e-5, key)

    def loss(params):
        out, _ = jm.apply({**variables, "params": params}, jnp.asarray(x),
                          deterministic=False, mutable=["batch_stats"])
        return (jnp.sin(out) * out).sum()

    # the gradients through resnet18 (through resnet50's 16 train-mode
    # blocks JAX's own f32 gradients land 3 % of the norm from the f64)
    jm, tm = jresnet.ResNetBackbone("resnet18"), tresnet.ResNetBackbone(
        "resnet18")
    variables = _pair(jm, tm, x)
    want = tree_to_state_dict(_np(jax.jit(jax.grad(loss))(
        variables["params"])))
    t64 = _f64(tm)
    for model, inp in ((tm, xt), (t64, xt.double())):
        out = model(inp, deterministic=False)
        (torch.sin(out) * out).sum().backward()
    grads, ref = dict(tm.named_parameters()), dict(t64.named_parameters())
    assert set(grads) == set(want)
    _grads_as_jax(grads, want, ref)


def _grads_as_jax(grads, want, ref):
    """Train-mode gradients against JAX's through an f64 run: each
    parameter's distance over the global gradient norm, JAX's f32 from the
    f64 within 1e-3, the port's f32 within 4x JAX's + 1e-6."""
    total = sum(float((w.double() ** 2).sum()) for w in want.values()) ** 0.5
    for key, w in want.items():
        r = ref[key].grad
        d_jax = (w.double() - r).norm().item() / total
        d_port = (grads[key].grad.double() - r).norm().item() / total
        assert d_jax <= 1e-3, (key, d_jax)
        assert d_port <= 4 * d_jax + 1e-6, (key, d_port, d_jax)


def test_convert_torchvision_resnet_matches_jax():
    # a torchvision-layout state dict (the JAX package's exporter of random
    # Flax weights, plus the fc and num_batches_tracked entries a real file
    # has) through both converters: the same tensors, the same features
    x, xt = _images(2, 32, seed=3)
    for name in ("resnet18", "resnet50"):
        jm = jresnet.ResNetBackbone(name)
        variables = _np(_jit(jm.init)(jax.random.PRNGKey(5), jnp.asarray(x)))
        sd = jresnet.export_torchvision_resnet(
            variables["params"], jax.tree.map(
                lambda v: v + 0.25, variables["batch_stats"]), name)
        sd["fc.weight"] = np.zeros((10, jresnet.resnet_feature_dim(name)),
                                   np.float32)
        sd["bn1.num_batches_tracked"] = np.asarray(7)
        torch_sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
        got = tresnet.convert_torchvision_resnet(torch_sd, name)
        p, s = jresnet.convert_torchvision_resnet(torch_sd, name)
        want = tree_to_state_dict(p, s)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        tm = tresnet.ResNetBackbone(name)
        tm.load_state_dict(got)
        with torch.no_grad():
            out = tm(xt)
        _close(out, _jit(jm.apply)({"params": p, "batch_stats": s},
                                   jnp.asarray(x)), 1e-5, name)


# ----- roi_align and the FPN's resize -----------------------------------------


def test_roi_align_ramp_is_exact():
    # bilinear interpolation of a linear map reproduces it at the sample
    # points (inside the map): against the closed form and JAX
    h, w = 12, 16
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ramp = np.stack([2.0 * yy + 0.5 * xx, -xx + 3.0], -1).astype(np.float32)
    boxes = np.asarray([[[0.25, 0.2, 0.75, 0.7], [0.1, 0.3, 0.6, 0.9]]],
                       np.float32)
    s = 5
    got = tfpn.roi_align(torch.from_numpy(ramp)[None], torch.from_numpy(boxes),
                         s)[0]
    want = jax.vmap(lambda b: jfpn.roi_align(jnp.asarray(ramp), b, s))(
        jnp.asarray(boxes))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for k, (y0, x0, y1, x1) in enumerate(boxes[0]):
        ys = (y0 + (np.arange(s) + 0.5) / s * (y1 - y0)) * h - 0.5
        xs = (x0 + (np.arange(s) + 0.5) / s * (x1 - x0)) * w - 0.5
        exact = 2.0 * ys[:, None] + 0.5 * xs[None, :]
        np.testing.assert_allclose(got[k, :, :, 0].numpy(), exact, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_matches_jax(dtype):
    # random maps and boxes (edges clipped, a degenerate box), both
    # dtypes: the sample weights stay f32 and only the gathered values
    # carry the map's dtype, so the bf16 results agree to a bf16 ulp of
    # the largest value; f32 within 1e-6 of it; and the map's gradient
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    boxes = np.sort(rng.uniform(-0.1, 1.1, (2, 4, 2, 2)), axis=2).transpose(
        0, 1, 3, 2).reshape(2, 4, 4).astype(np.float32)
    boxes = boxes[..., [0, 2, 1, 3]]  # (y0, x0, y1, x1)
    boxes[1, 0] = [0.5, 0.5, 0.5, 0.5]
    boxes = np.clip(boxes, 0.0, 1.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.vmap(lambda f, b: jfpn.roi_align(f, b, 4))(
        jnp.asarray(feat, jdt), jnp.asarray(boxes))
    got = tfpn.roi_align(torch.from_numpy(feat).to(tdt),
                         torch.from_numpy(boxes), 4)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    if dtype == "float32":
        gj = jax.grad(lambda f: (jax.vmap(lambda a, b: jfpn.roi_align(
            a, b, 4))(f, jnp.asarray(boxes)) ** 2).sum())(jnp.asarray(feat))
        ft = torch.from_numpy(feat).requires_grad_()
        (tfpn.roi_align(ft, torch.from_numpy(boxes), 4) ** 2).sum().backward()
        np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gj),
                                   atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(2, 3), (3, 5), (5, 10), (7, 13),
                                        (10, 20), (1, 4), (13, 28)])
def test_nearest_resize_is_jax_nearest(n_in, n_out):
    # half-pixel centres, f32: the same source index for every output
    x = np.arange(n_in * n_in, dtype=np.float32).reshape(1, 1, n_in, n_in)
    want = jax.image.resize(jnp.asarray(x), (1, 1, n_out, n_out), "nearest")
    got = tfpn.resize_nearest(torch.from_numpy(x), (n_out, n_out))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----- the FPN tower ----------------------------------------------------------


def _towers(backbone="resnet18", **kw):
    kw.setdefault("fpn_channels", 16)
    return (jfpn.FPNVisionTower(backbone_name=backbone, **kw),
            tfpn.FPNVisionTower(backbone, **kw))


@pytest.mark.parametrize("size,pool,train", [(40, True, False),
                                             (64, True, True),
                                             (64, False, False),
                                             (32, True, False)])
def test_fpn_pooled_mode_matches_jax(size, pool, train):
    # the flattened (pooled) p6 at 40 px (levels 10/5/3/2: the top-down
    # resize is not a doubling), 64 px (p6 2 x 2: pooled to 1 x 1 or
    # flattened in (H, W, C) order) and 32 px (p6 1 x 1: no pool)
    x, xt = _images(2, size, seed=5)
    jm, tm = _towers(pool_full_img=pool)
    variables = _pair(jm, tm, x)
    assert tm(xt).shape[-1] == tfpn.full_img_feature_dim((size, size), pool,
                                                          16)
    if not train:
        with torch.no_grad():
            got = tm(xt)
        _close(got, _jit(jm.apply)(variables, jnp.asarray(x)), 1e-5)
        return
    want, upd = _jit(jm.apply, deterministic=False,
                     mutable=["batch_stats"])(variables, jnp.asarray(x))
    t64 = _f64(tm)
    with torch.no_grad():
        got = tm(xt, deterministic=False)
        ref = t64(xt.double(), deterministic=False)
    _as_f32_as_jax(got, want, ref)
    _stats_close(tm, upd["batch_stats"], t64)


@pytest.mark.parametrize("size,train", [(64, False), (40, True)])
def test_fpn_regional_mode_matches_jax(size, train):
    # K = 3 proposals: the full-image feature, the box head's regional
    # features, the top scores and their boxes (equal: the same scores to
    # f32 rounding pick the same cells), and the gradients of the box head
    # and the objectness convs
    x, xt = _images(2, size, seed=6)
    jm, tm = _towers(num_regional_features=3, feature_dim=24)
    variables = _pair(jm, tm, x)
    if train:
        want, upd = _jit(jm.apply, deterministic=False,
                         mutable=["batch_stats"])(variables, jnp.asarray(x))
        t64 = _f64(tm)
        with torch.no_grad():
            got = tm(xt, deterministic=False)
            ref = t64(xt.double(), deterministic=False)
        for g, w, r, name in zip(got, want, ref, ("full", "regional",
                                                  "scores", "boxes")):
            _as_f32_as_jax(g, w, r, name)
        _stats_close(tm, upd["batch_stats"], t64)
        return
    want = _jit(jm.apply)(variables, jnp.asarray(x))
    got = tm(xt)
    for g, w, name in zip(got, want, ("full", "regional", "scores")):
        _close(g, w, 1e-5, name)
    # the same cells: the boxes to an f32 ulp of 1 (XLA folds the constant
    # stride / size of the centres)
    np.testing.assert_allclose(got[3].detach().numpy(), np.asarray(want[3]),
                               rtol=0, atol=1.2e-7)

    def loss(params):
        full, reg, scores, _ = jm.apply({**variables, "params": params},
                                        jnp.asarray(x))
        return (reg ** 2).sum() + (scores ** 2).sum() + full.sum()

    want_g = tree_to_state_dict(_np(jax.jit(jax.grad(loss))(
        variables["params"])))
    full, reg, scores, _ = got
    ((reg ** 2).sum() + (scores ** 2).sum() + full.sum()).backward()
    total = sum(float((w.double() ** 2).sum())
                for w in want_g.values()) ** 0.5
    params = dict(tm.named_parameters())
    for key, w in want_g.items():
        err = (params[key].grad.double() - w.double()).norm().item() / total
        assert err <= 1e-5, (key, err)


def test_fpn_top_k_ties_take_the_lower_index():
    # a zero objectness head scores every cell 0: lax.top_k takes the
    # first K cells (p2's first row), so must the port
    x, xt = _images(1, 32, seed=7)
    jm, tm = _towers(num_regional_features=4, feature_dim=8)
    variables = _pair(jm, tm, x)
    params = jax.tree_util.tree_map(lambda v: v, variables["params"])
    params["obj_logit"] = jax.tree.map(np.zeros_like, params["obj_logit"])
    variables = {**variables, "params": params}
    with torch.no_grad():
        tm.obj_logit.weight.zero_()
        tm.obj_logit.bias.zero_()
        got = tm(xt)
    want = _jit(jm.apply)(variables, jnp.asarray(x))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # p2 of 32 px is 8 x 8 cells of stride 4: the first four of row 0,
    # squares of side 2 x 8 x 4 / 32 = 1 around their centres, clipped
    cx = (np.arange(4) + 0.5) * 4 / 32
    want_boxes = np.stack([np.zeros(4), np.zeros(4), np.full(4, 0.5625),
                           cx + 0.5], -1)
    np.testing.assert_allclose(got[3][0].numpy(), want_boxes, atol=1e-7)


def test_pooled_tower_dispatch_and_widths():
    # build_pooled_vision_tower picks the ResNet or the FPN tower (R-18 /
    # 34 / 50 / 101 by name) as JAX's does, and pooled_feature_dim is the
    # width JAX's tower returns
    for vm, size in (("resnet18", 32), ("resnet34", 32),
                     ("detectron2_COCO-Detection/faster_rcnn_R_50_FPN_3x",
                      64), ("detectron2_R_101_FPN", 32)):
        t = tfpn.build_pooled_vision_tower(vm, torch.float32)
        j = jfpn.build_pooled_vision_tower(vm, jnp.float32)
        if vm.startswith("detectron2"):
            assert isinstance(t, tfpn.FPNVisionTower)
            assert tfpn.backbone_from_name(vm) == jfpn.backbone_from_name(vm)
        else:
            assert isinstance(t, tresnet.ResNetBackbone)
        shape = jax.eval_shape(
            lambda x: j.init_with_output(jax.random.PRNGKey(0), x)[0],
            jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)).shape
        assert shape[-1] == tfpn.pooled_feature_dim(vm, (size, size)), vm


# ----- detectron2 weights -----------------------------------------------------


def _d2_state_dict(rng, backbone="resnet50", feature_dim=16, fpn=256,
                   roi=7):
    """Random weights in detectron2's ResNet-FPN key and shape layout
    (FrozenBN statistics, three RPN anchors, the box head's fc1 over a
    (C, s, s) flattening)."""
    block, layers, _ = jresnet._SPECS[backbone]
    bottleneck = block is jresnet.BottleneckBlock
    sd = {}

    def conv(name, cout, cin, k, bias=False):
        sd[f"{name}.weight"] = (rng.standard_normal((cout, cin, k, k))
                                * (2.0 / (cin * k * k)) ** 0.5
                                ).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = (0.05 * rng.standard_normal(cout)).astype(
                np.float32)

    def norm(name, c):
        sd[f"{name}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        sd[f"{name}.running_var"] = (1 + 0.1 * rng.random(c)).astype(
            np.float32)

    bu = "backbone.bottom_up"
    conv(f"{bu}.stem.conv1", 64, 3, 7)
    norm(f"{bu}.stem.conv1.norm", 64)
    cin, outs = 64, []
    for stage, blocks in enumerate(layers):
        width = 64 * 2 ** stage
        cout = width * (4 if bottleneck else 1)
        for b in range(blocks):
            p = f"{bu}.res{stage + 2}.{b}"
            src = cin if b == 0 else cout
            if bottleneck:
                shapes = ((width, src, 1), (width, width, 3),
                          (cout, width, 1))
            else:
                shapes = ((cout, src, 3), (cout, cout, 3))
            for c, (o, i, k) in enumerate(shapes, 1):
                conv(f"{p}.conv{c}", o, i, k)
                norm(f"{p}.conv{c}.norm", o)
            if b == 0 and (stage > 0 or cin != cout):
                conv(f"{p}.shortcut", cout, cin, 1)
                norm(f"{p}.shortcut.norm", cout)
        cin = cout
        outs.append(cout)
    for lvl, c in zip((2, 3, 4, 5), outs):
        conv(f"backbone.fpn_lateral{lvl}", fpn, c, 1, bias=True)
        conv(f"backbone.fpn_output{lvl}", fpn, fpn, 3, bias=True)
    conv("proposal_generator.rpn_head.conv", fpn, fpn, 3, bias=True)
    conv("proposal_generator.rpn_head.objectness_logits", 3, fpn, 1,
         bias=True)
    conv("proposal_generator.rpn_head.anchor_deltas", 12, fpn, 1, bias=True)
    sd["roi_heads.box_head.fc1.weight"] = (0.01 * rng.standard_normal(
        (feature_dim, fpn * roi * roi))).astype(np.float32)
    sd["roi_heads.box_head.fc1.bias"] = (0.01 * rng.standard_normal(
        feature_dim)).astype(np.float32)
    sd["roi_heads.box_head.fc2.weight"] = (0.1 * rng.standard_normal(
        (feature_dim, feature_dim))).astype(np.float32)
    sd["roi_heads.box_head.fc2.bias"] = (0.01 * rng.standard_normal(
        feature_dim)).astype(np.float32)
    sd["roi_heads.box_predictor.cls_score.weight"] = np.zeros(
        (81, feature_dim), np.float32)
    return sd


@pytest.fixture(scope="module")
def d2_sd():
    return _d2_state_dict(np.random.default_rng(0))


def test_convert_detectron2_fpn_matches_jax(d2_sd):
    # the converted entries equal JAX's converted tree moved by
    # tree_to_state_dict (fc1's columns in (s, s, C) order in both), and
    # the regional tower on them gives JAX's outputs
    got = tconvert.convert_detectron2_fpn(d2_sd, "resnet50")
    conv = jconvert.convert_detectron2_fpn(d2_sd, "resnet50")
    want = tree_to_state_dict(conv["params"], conv["batch_stats"])
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    x, xt = _images(2, 64, seed=8)
    jm = jfpn.FPNVisionTower(backbone_name="resnet50",
                             num_regional_features=3, feature_dim=16)
    tm = tfpn.FPNVisionTower("resnet50", num_regional_features=3,
                             feature_dim=16)
    assert not tm.load_state_dict(got, strict=False).unexpected_keys
    with torch.no_grad():
        out = tm(xt)
    ref = _jit(jm.apply)(conv, jnp.asarray(x))
    for g, w, name in zip(out, ref, ("full", "regional", "scores", "boxes")):
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("suffix", [".pkl", ".pth"])
def test_load_detectron2_state_dict_matches_jax(tmp_path, d2_sd, suffix):
    # a model-zoo pickle (numpy arrays under "model", with the zoo's other
    # keys) and a torch checkpoint of tensors: both loaders read the same
    # arrays
    path = str(tmp_path / f"model_final{suffix}")
    if suffix == ".pkl":
        with open(path, "wb") as f:
            pickle.dump({"model": d2_sd, "__author__": "synthetic",
                         "matching_heuristics": True}, f)
    else:  # a flat state dict, the layout both loaders take for .pth
        torch.save({k: torch.from_numpy(v) for k, v in d2_sd.items()}, path)
    got = tconvert.load_detectron2_state_dict(path)
    want = jconvert.load_detectron2_state_dict(path)
    assert set(got) == set(want) == set(d2_sd)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
