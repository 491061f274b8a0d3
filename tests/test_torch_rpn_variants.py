"""The RPN's configurations beyond the main path against the JAX package on
the CPU: the non-fixed NMS path (`foreground_resample_indices`, and
`RpnModel` with `rpn_fixed_num_proposal_nms` False in test and val mode),
a PointNet++ `RpnModel` in test, val and train mode and in bf16, PointCNN
with "ids" and "random" sampling and with sorted neighbourhoods, and a
PointNet++ pipeline config through the port's training, evaluation and
inference CLIs.

Flax variables are drawn from a seed and carried across by
`heterofusionrcnn_torch.convert`; both sides get the same numpy inputs. The
JAX PointCNN (and the KNN of its inverse-density sampling) takes the
direct-distance KNN (tests/test_torch_layers.py). The PointNet RPN's points
are the fixture frames' rounded to a grid of 1/4: every squared distance is
a multiple of 1/16 and exact in float32 on both sides, and each ball's
radius^2 lies halfway between two of them (the margin asserted), so both
ball queries find the same points (tests/test_torch_pointnet.py).

Tolerances: indices, masks, counts and keep lists exact; features, scores
and losses rtol / atol 1e-4, boxes 5e-4 absolute (tests/test_torch_models.py);
the PointNet RPN's gradients as the RCNN's (tests/test_torch_rcnn_training.py):
rtol 1e-3 plus 1e-4 of each tensor's largest element (at least 1e-5),
5e-3 of it in the image branch. In train mode the image branch's early
convs measured up to 5.9e-4 of their largest element apart, the PointNet's
tensors up to 5.3e-6. bf16 as tests/test_torch_bf16.py: 2^-6 |want| + 1%
of the tensor's scale.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.configs import config as jax_config
from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.models import rpn as j_rpn
from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn
from heterofusionrcnn_tpu.ops import grouping as j_grouping
from heterofusionrcnn_tpu.ops import sampling as j_sampling
from heterofusionrcnn_tpu.ops.pallas_knn import _knn_reference_jnp

from heterofusionrcnn_torch.configs import config as torch_config
from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import flax_to_state_dict, load_flax_variables
from heterofusionrcnn_torch.experiments import common, run_evaluation, run_inference, run_training
from heterofusionrcnn_torch.inference import CLUSTER_SIZES
from heterofusionrcnn_torch.models import rpn as t_rpn
from heterofusionrcnn_torch.models.extractors import pointcnn as t_pointcnn
from heterofusionrcnn_torch.ops import sampling as t_sampling
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.train_state import RPN_BATCH_KEYS

from tests.test_torch_layers import as_jax, direct_knn, random_variables
from tests.test_torch_run_inference import _fixture_copy
from tests.test_torch_training import _batches

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_SHARE = 1e-4        # of a tensor's largest gradient element
IMAGE_GRAD_SHARE = 5e-3  # the same in the image branch
GRID = 4  # the PointNet RPN's points lie on multiples of 1 / GRID


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_foreground_resample_indices():
    rng = np.random.default_rng(0)
    p, f = 257, 64
    scores = rng.random((6, p)).astype(np.float32)
    mask = np.zeros((6, p), bool)
    mask[0, rng.choice(p, 150, replace=False)] = True  # more points than npoint
    mask[1, rng.choice(p, 20, replace=False)] = True   # short: wrap-filled
    mask[2, 5] = True                                  # one point
    # row 3: all False
    mask[4, [3, 7, 11, 40]] = True                     # tied scores
    scores[4] = 0.5
    mask[5] = True                                     # every point, ties among them
    scores[5, ::3] = 0.25
    want = j_rpn.foreground_resample_indices(jnp.asarray(mask), jnp.asarray(scores), f)
    got = t_rpn.foreground_resample_indices(torch.from_numpy(mask), torch.from_numpy(scores), f)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert (got[3] == 0).all() and got[4, :8].tolist() == [3, 7, 11, 40, 3, 7, 11, 40]
    assert t_rpn.NUM_FG_POINT == j_rpn.NUM_FG_POINT == 2048


def _jax_rpn(cfg_key, mode, seed):
    """JAX RpnModel of one of `_configs()` in `mode` (stage-1 features
    saved), its inputs `_batch(cfg_key)` and variables drawn at `seed`."""
    jcfg, _ = _configs(cfg_key)
    model = j_rpn.RpnModel(config=jcfg.model_config, num_classes=3, cluster_sizes=CLUSTER_SIZES,
                           mode=mode, save_rpn_feature=True)
    args = [jnp.asarray(x) for x in _batch(cfg_key)]
    return model, args, _variables(cfg_key.replace("_bf16", ""), seed)


@functools.lru_cache(maxsize=None)
def _variables(cfg_key, seed):
    """The variables of a config family, drawn once: every mode and dtype
    of one config has the same float32 tree."""
    jcfg, _ = _configs(cfg_key)
    model = j_rpn.RpnModel(config=jcfg.model_config, num_classes=3, cluster_sizes=CLUSTER_SIZES,
                           mode="test", save_rpn_feature=True)
    args = [jnp.asarray(x) for x in _batch(cfg_key)]
    return random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), seed)


def _configs(key):
    """(JAX, port) pipeline configs: "nonfixed" is rpn_unittest with the
    non-fixed NMS path (its PointCNN cut to 3 XConv and 2 XDConv); "pointnet" rpn_unittest with a small PointNet++
    (a ball SA, an MSG SA, a ball SA; three FP levels), dropout 0 and path
    drop off; "pointnet_bf16" the same in bf16."""
    out = []
    for presets, lib in ((jax_presets, jax_config), (torch_presets, torch_config)):
        cfg = presets.rpn_unittest()
        mc = cfg.model_config
        if key == "nonfixed":
            mc.rpn_config.rpn_fixed_num_proposal_nms = False
            # rpn_unittest's widths at half its depth: 3 XConv, 2 XDConv.
            pc = mc.layers_config.pc_pointcnn
            pc.xconv_layers = pc.xconv_layers[:3]
            pc.xdconv_layers = [lib.XDConvParam(K=8, D=1, pts_layer_idx=2, qrs_layer_idx=1),
                                lib.XDConvParam(K=8, D=1, pts_layer_idx=1, qrs_layer_idx=0)]
        else:
            mc.layers_config.pc_extractor_type = "pointnet"
            mc.layers_config.pc_pointnet = lib.PointNetConfig(
                sa_modules=[
                    lib.SAModuleConfig(npoint=512, radius=_radius(63), nsample=16, mlp=[16, 32]),
                    lib.SAModuleConfig(npoint=128, use_msg=True, radii=[_radius(255), _radius(399)],
                                       nsamples=[8, 16], mlps=[[32], [32, 48]]),
                    lib.SAModuleConfig(npoint=32, radius=_radius(1023), nsample=16, mlp=[48, 64]),
                ],
                fp_modules=[lib.FPModuleConfig([48]), lib.FPModuleConfig([32]),
                            lib.FPModuleConfig([32, 32])],
                fc_layers=[lib.FCLayer(32, 0.0)],
            )
            for fc in mc.layers_config.rpn_fc_layers:
                fc.dropout_rate = 0.0
            mc.path_drop_probabilities = [1.0, 1.0]
            if key == "pointnet_bf16":
                mc.compute_dtype = "bfloat16"
        out.append(cfg)
    return out


def _radius(m: int) -> float:
    """A radius whose square lies halfway between the grid's squared
    distances m / GRID^2 and (m + 1) / GRID^2."""
    return float(np.sqrt((m + 0.5) / GRID ** 2))


@functools.lru_cache(maxsize=None)
def _batch(cfg_key):
    """A batch of 2 fixture frames (`RPN_BATCH_KEYS` but the GT boxes); for the PointNet RPN
    its points rounded to the grid, with every pair's margin to each radius^2
    asserted."""
    batch = dict(_batches()[0])
    if cfg_key == "pointnet_bf16":
        return _batch("pointnet")
    if cfg_key == "pointnet":
        pc = batch["point_cloud"].copy()
        pc[..., :3] = np.round(pc[..., :3] * GRID) / GRID
        batch["point_cloud"] = pc
        xyz = pc[..., :3].astype(np.float64)
        d = ((xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
        for m in (63, 255, 399, 1023):
            assert np.abs(d - _radius(m) ** 2).min() >= 1e-4
    # No GT boxes: the proposals' IoUs are not compared, so neither side
    # computes them (the JAX val graph compiles without them).
    return tuple(batch[k] for k in RPN_BATCH_KEYS[:5])


def _port_rpn(cfg_key, mode, v):
    _, tcfg = _configs(cfg_key)
    ours = t_rpn.RpnModel(tcfg.model_config, 3, CLUSTER_SIZES, mode=mode)
    return load_flax_variables(ours, v).train(mode == "train")


def _keeps_agree(got, want):
    """The port's NMS keeps against JAX's. The keeps may hold copies of one
    box: the non-fixed path's wrap-filled rows repeat boxes exactly, and so
    do points that share a grid position. Random weights decode some boxes
    of ~0 or negative size, whose IoU with anything (themselves too) is 0,
    so both sides keep such copies; and JAX's CPU NMS keeps some copies of a
    sane box as well (its IoU of two identical boxes can round below the
    threshold: its clipping drops a shared edge whose half-plane distance
    rounds below 0), where the port suppresses them. So the keeps are
    compared with every repeated box taken out: the same boxes in the same
    order, as far as the side that spent fewer slots on copies can be
    followed by the other before its slots ran out. Returns how many more
    copies JAX kept."""
    n = got["num_proposals_before_padding"]
    post = got["proposals"].shape[1]
    assert int(n.min()) > 0 and int(n.max()) <= post
    extra = 0
    for b in range(n.shape[0]):
        nb = int(n[b])
        scores = got["proposal_scores"][b, :nb]
        assert bool((scores[1:] <= scores[:-1]).all())  # score-sorted
        assert bool(got["proposal_valid"][b, :nb].all())
        assert not bool(got["proposal_valid"][b, nb:].any())
        nw = int(want["num_proposals_before_padding"][b])
        lists = []
        for boxes, sc, k in ((got["proposals"][b].detach().numpy(), scores.detach().numpy(), nb),
                             (np.asarray(want["proposals"][b]),
                              np.asarray(want["proposal_scores"][b]), nw)):
            first = np.sort(np.unique(boxes[:k], axis=0, return_index=True)[1])
            lists.append((boxes[first], sc[first]))
        (gb, gs), (wb, ws) = lists
        m = min(len(gb), len(wb))
        assert m > 0
        if nb < post and nw < post:
            assert len(gb) == len(wb)
        extra += (nw - len(wb)) - (nb - len(gb))
        np.testing.assert_allclose(gb[:m], wb[:m], rtol=0, atol=5e-4)
        np.testing.assert_allclose(gs[:m], ws[:m], **TOL)
    return extra


@pytest.mark.parametrize("mode", ["test", "val"])
def test_non_fixed_nms_path(monkeypatch, mode):
    """rpn_unittest with `rpn_fixed_num_proposal_nms` False: the resampled
    stage-1 rows, the NMS over every resampled point's box, the losses."""
    direct_knn(monkeypatch)
    model, args, v = _jax_rpn("nonfixed", mode, 21)
    jcfg = _configs("nonfixed")[0].model_config

    def f(v_, *a):
        out = model.apply(v_, *a, training=False)
        return out, (j_rpn.rpn_loss(out, jcfg) if mode == "val" else None)

    want, want_loss = jax.jit(f)(as_jax(v), *args)
    ours = _port_rpn("nonfixed", mode, v)
    with torch.no_grad():
        got = ours(*(torch.from_numpy(x) for x in _batch("nonfixed")))
    f = min(t_rpn.NUM_FG_POINT, args[0].shape[1])
    assert got["rpn_pts"].shape[1] == f and got["seg_logits"].shape[1] == args[0].shape[1]
    for key in ("seg_softmax", "seg_logits"):
        _close(got[key], want[key])
    # The resampled rows as sets: their order follows the foreground scores,
    # of which near-equal pairs (gaps of ~1e-7 among 2048) may swap between
    # two float32 runs.
    for b in range(got["rpn_pts"].shape[0]):
        orders = [np.lexsort(np.asarray(pts[b]).T[::-1])
                  for pts in (got["rpn_pts"].numpy(), want["rpn_pts"])]
        for key in ("rpn_pts", "rpn_intensity", "foreground_mask", "rpn_fts", "rpn_img_fts"):
            g, w = got[key][b].float().numpy()[orders[0]], np.asarray(want[key][b])[orders[1]]
            if key in ("rpn_fts", "rpn_img_fts"):
                np.testing.assert_allclose(g, w, err_msg=key, **TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=key)
    _keeps_agree(got, want)
    if mode == "val":
        want_losses, want_total = want_loss
        got_losses, got_total = t_rpn.rpn_loss(got, _configs("nonfixed")[1].model_config)
        _close(got_total, want_total)
        for key, val in want_losses.items():
            _close(got_losses[key], val)


@pytest.mark.parametrize("mode", ["test", "val", "train"])
def test_pointnet_rpn(mode):
    """A PointNet++ RPN: outputs and keeps (test, val), the loss (val,
    train), every parameter's gradient and the new BatchNorm statistics
    (train)."""
    model, args, v = _jax_rpn("pointnet", mode, 22)
    training = mode == "train"
    jcfg, tcfg = _configs("pointnet")

    def f(params):
        preds, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *args,
                                 training=training, mutable=["batch_stats"])
        total = j_rpn.rpn_loss(preds, jcfg.model_config)[1] if mode != "test" else 0.0
        return total, (preds, upd["batch_stats"])

    if mode != "train":
        (total, (want, _)) = jax.jit(f)(as_jax(v["params"]))
    else:
        (total, (want, stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            as_jax(v["params"]))
    ours = _port_rpn("pointnet", mode, v)
    assert hasattr(ours, "pc_pointnet") and not hasattr(ours, "pc_pointcnn")
    got = ours(*(torch.from_numpy(x) for x in _batch("pointnet")))
    np.testing.assert_array_equal(got["rpn_pts"].numpy(), np.asarray(want["rpn_pts"]))
    for key in ("seg_softmax", "rpn_fts", "rpn_img_fts"):
        _close(got[key], want[key])
    assert got["rpn_fts"].shape[-1] + got["rpn_img_fts"].shape[-1] == t_rpn.rpn_fts_channels(
        tcfg.model_config)
    if mode != "train":
        _keeps_agree(got, want)
    if mode == "test":
        return
    got_total = t_rpn.rpn_loss(got, tcfg.model_config)[1]
    _close(got_total, total)
    if mode == "val":
        return
    got_total.backward()
    want_grads = flax_to_state_dict(grads)
    assert sorted(n for n, _ in ours.named_parameters()) == sorted(want_grads)
    for name, p in ours.named_parameters():
        w = want_grads[name]
        share = IMAGE_GRAD_SHARE if name.startswith("img_vgg_pyr.") else GRAD_SHARE
        bound = 1e-3 * w.abs() + max(1e-5, share * float(w.abs().max()))
        assert bool(((p.grad - w).abs() <= bound).all()), (name, float((p.grad - w).abs().max()))
    if training:
        sd = ours.state_dict()
        for name, w in flax_to_state_dict({}, stats).items():
            np.testing.assert_allclose(sd[name].numpy(), w.numpy(), err_msg=name, **TOL)


def test_pointnet_rpn_bf16():
    """The PointNet++ RPN with compute_dtype "bfloat16": the PointNet runs
    float32 on both sides (the JAX `PointNet` has no dtype), the image
    branch and the heads in bf16."""
    model, args, v = _jax_rpn("pointnet_bf16", "test", 22)
    want = jax.jit(lambda v_, *a: model.apply(v_, *a, training=False))(as_jax(v), *args)
    ours = _port_rpn("pointnet_bf16", "test", v)
    with torch.no_grad():
        got = ours(*(torch.from_numpy(x) for x in _batch("pointnet_bf16")))
    assert got["rpn_fts"].dtype == torch.float32 and want["rpn_fts"].dtype == jnp.float32
    assert got["rpn_img_fts"].dtype == torch.bfloat16
    _close(got["rpn_fts"], want["rpn_fts"])
    for key in ("seg_softmax", "rpn_img_fts"):
        w = np.asarray(want[key], np.float32)
        g = got[key].float().numpy()
        assert (np.abs(g - w) <= 2.0 ** -6 * np.abs(w) + 0.01 * np.abs(w).max()).all(), key


def _pointcnn_configs(sampling, sorting):
    out = []
    for lib in (jax_config, torch_config):
        out.append(lib.PointCNNConfig(
            sampling=sampling, sorting_method=sorting, with_global=True,
            xconv_layers=[lib.XConvParam(K=8, D=1, P=-1, C=16),
                          lib.XConvParam(K=8, D=2, P=128, C=32),
                          lib.XConvParam(K=8, D=1, P=32, C=32)],
            xdconv_layers=[lib.XDConvParam(K=8, D=1, pts_layer_idx=2, qrs_layer_idx=0)],
            fc_layers=[],
        ))
    return out


@pytest.mark.parametrize("sampling,sorting", [("ids", ""), ("random", ""), ("fps", "cxyz"),
                                              ("fps", "l2")])
def test_pointcnn_sampling_and_sorting(monkeypatch, sampling, sorting):
    """PointCNN in eval mode (the port's fused XConv op, its plain version
    on the CPU) with "ids" sampling fed the uniforms of JAX's own "sampling"
    rng, with "random" sampling, and with sorted neighbourhoods."""
    monkeypatch.setattr(j_pointcnn, "knn_point", _knn_reference_jnp)
    monkeypatch.setattr(j_grouping, "knn_point", _knn_reference_jnp)
    uniforms = []

    def recording_ids(rng, points, k, n):
        uniforms.append(jax.random.uniform(rng, points.shape[:2]))
        return j_sampling.inverse_density_sampling(rng, points, k, n)

    monkeypatch.setattr(j_pointcnn, "inverse_density_sampling", recording_ids)
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((2, 512, 3)).astype(np.float32)
    fts = rng.standard_normal((2, 512, 1)).astype(np.float32)
    jcfg, tcfg = _pointcnn_configs(sampling, sorting)
    jmod = j_pointcnn.PointCNN(config=jcfg)
    args = (jnp.asarray(pts), jnp.asarray(fts))
    v = random_variables(lambda: jmod.init({"params": jax.random.PRNGKey(0),
                                            "sampling": jax.random.PRNGKey(1)}, *args, False), 6)

    def f(v_, *a):
        uniforms.clear()
        out = jmod.apply(v_, *a, False, rngs={"sampling": jax.random.PRNGKey(2)})
        return out, list(uniforms)

    (want_pts, want), drawn = jax.jit(f)(as_jax(v), *args)
    assert len(drawn) == (2 if sampling == "ids" else 0)
    drawn = [torch.from_numpy(np.asarray(u)) for u in drawn]
    real_ids = t_sampling.inverse_density_sampling
    monkeypatch.setattr(t_pointcnn, "inverse_density_sampling",
                        lambda p, k, n, gen: real_ids(p, k, n, uniforms=drawn.pop(0)))
    ours = load_flax_variables(t_pointcnn.PointCNN(tcfg, 1), v).eval()
    with torch.no_grad():
        got_pts, got = ours(torch.from_numpy(pts), torch.from_numpy(fts),
                            sampling=torch.Generator().manual_seed(0))
    assert not drawn
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    _close(got, want)
    if sampling == "ids":
        with pytest.raises(ValueError, match="sampling"):
            ours(torch.from_numpy(pts), torch.from_numpy(fts))


def test_inverse_density_sampling_and_prob_sample(monkeypatch):
    monkeypatch.setattr(j_grouping, "knn_point", _knn_reference_jnp)
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((2, 300, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = j_sampling.inverse_density_sampling(key, jnp.asarray(pts), 8, 100)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (2, 300))))
    got = t_sampling.inverse_density_sampling(torch.from_numpy(pts), 8, 100, uniforms=u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cdf = np.cumsum(rng.random((2, 50)), axis=1).astype(np.float32)
    cdf /= cdf[:, -1:]
    uni = rng.random((2, 40)).astype(np.float32)
    uni[0, :3] = cdf[0, [0, 10, 49]]  # exact hits go to the left
    want = j_sampling.prob_sample(jnp.asarray(cdf), jnp.asarray(uni))
    got = t_sampling.prob_sample(torch.from_numpy(cdf), torch.from_numpy(uni))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pointnet_pipeline_config_through_the_clis(tmp_path):
    """A saved PointNet++ pipeline config: 2 training steps, the RPN
    evaluator's handoff files (their feature width is `rpn_fts_channels`),
    and the two-stage inference CLI on them."""
    cfg = _configs("pointnet")[1]
    cfg.model_config.checkpoint_name = "rpn_pointnet_small"
    cfg.train_config.max_iterations = 2
    cfg.dataset_config.dataset_dir = str(_fixture_copy(tmp_path))  # split "two": 2 frames
    path = tmp_path / "rpn_pointnet_small.json"
    torch_config.save_config(cfg, str(path))
    root = str(tmp_path / "out")
    state = run_training.main(["--device", "cpu", "--pipeline_config", str(path),
                               "--output_root", root, "--data_split", "two"])
    assert state.step == 2 and hasattr(state.model, "pc_pointnet")
    metrics = [json.loads(line) for line in
               open(os.path.join(root, "rpn_pointnet_small", "logs", "metrics.jsonl"))]
    assert all(np.isfinite(m["total_loss"]) for m in metrics if "total_loss" in m)
    run_evaluation.main(["--device", "cpu", "--pipeline_config", str(path), "--output_root", root,
                         "--data_split", "two", "--save_rpn_feature"])
    feat_dir = os.path.join(root, "rpn_pointnet_small", "predictions", "rpn_feature", "two", "2")
    files = sorted(os.listdir(feat_dir))
    assert len(files) == 2
    width = t_rpn.rpn_fts_channels(cfg.model_config)
    assert width == 32 + cfg.model_config.layers_config.img_vgg_pyr.vgg_conv1[1]
    for name in files:
        assert np.load(os.path.join(feat_dir, name)).shape[1] == width + 5

    rcnn_cfg = torch_presets.rcnn_unittest()
    dataset = common.build_dataset(cfg, "test", "two")
    det = common.build_detector(cfg, rcnn_cfg, dataset)
    CheckpointManager(str(tmp_path / "rcnn_ckpt")).save(1, det.rcnn)
    res = run_inference.main(["--device", "cpu", "--rpn_config", str(path), "--rcnn_config",
                              "rcnn_unittest", "--rpn_checkpoint",
                              os.path.join(root, "rpn_pointnet_small", "checkpoints"),
                              "--rcnn_checkpoint", str(tmp_path / "rcnn_ckpt"),
                              "--data_split", "two", "--output_root", root])
    assert len(res["frames"]) == len(files)
