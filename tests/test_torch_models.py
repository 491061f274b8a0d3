"""The slice as a whole against the JAX package at `rpn_unittest` /
`rcnn_unittest` scale: RPN test mode, RCNN test mode, and the fused
two-stage inference (RPN -> RCNN on the shared stage-1 image map, as
`bench.py` builds it).

Flax variables are drawn at random from a seed (shapes from `jax.eval_shape`
of the flax `init`) and carried into the port by
`heterofusionrcnn_torch.convert`; both sides get the same numpy inputs.
The JAX PointCNN's KNN runs the TPU kernel's direct-distance semantics
(`_knn_reference_jnp`, see tests/test_torch_layers.py).

Tolerances: features and scores atol/rtol 1e-4, boxes 5e-4 absolute for
one stage and 1e-3 end to end (decoded coordinates of tens of metres);
masks, counts and keep lists exact. The seeds give score gaps well above that tolerance at
every top-k cut and NMS decision, so the selections agree exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.models.rcnn import RcnnModel as JaxRcnn
from heterofusionrcnn_tpu.models.rpn import RpnModel as JaxRpn

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.inference import CLUSTER_SIZES, TwoStageDetector, random_batch
from heterofusionrcnn_torch.models.extractors.layers import init_weights
from heterofusionrcnn_torch.models.rcnn import RcnnModel, rcnn_loss
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_loss

from tests.test_torch_layers import as_jax, direct_knn, random_variables

TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@functools.lru_cache(maxsize=1)
def _inputs(seed=3):
    """The bench's synthetic batch with the cloud shrunk 4x about the
    camera, so that 2048 points leave points inside the RoI crops."""
    batch = random_batch(torch_presets.rpn_unittest(), 2, seed=seed)
    batch["point_cloud"][..., :3] *= 0.25
    return batch


def _rpn_jax():
    """JAX RPN (test mode, stage-1 features saved), its variables and its
    outputs on `_inputs()`."""
    cfg = jax_presets.rpn_unittest().model_config
    model = JaxRpn(config=cfg, num_classes=3, cluster_sizes=CLUSTER_SIZES, mode="test",
                   save_rpn_feature=True)
    b = as_jax(_inputs())
    args = (b["point_cloud"], b["image_input"], b["stereo_calib_p2"])
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 7)
    out = jax.jit(lambda v_, *a: model.apply(v_, *a, training=False))(as_jax(v), *args)
    return v, jax.tree_util.tree_map(np.asarray, out)


def _rcnn_jax(rpn_out, shared_map):
    cfg = jax_presets.rcnn_unittest().model_config
    model = JaxRcnn(config=cfg, num_classes=3, cluster_sizes=CLUSTER_SIZES, mode="test")
    b = as_jax(_inputs())
    prop = jnp.asarray(rpn_out["proposals"])
    bsz, n = prop.shape[:2]
    args = (
        prop, jnp.zeros((bsz, n)), jnp.zeros((bsz, n, 8)),
        jnp.asarray(rpn_out["rpn_pts"]), jnp.asarray(rpn_out["rpn_intensity"][..., 0]),
        jnp.asarray(rpn_out["foreground_mask"].astype(np.float32)),
        jnp.concatenate([rpn_out["rpn_fts"], rpn_out["rpn_img_fts"]], -1),
        b["image_input"], b["stereo_calib_p2"],
    )
    v = random_variables(lambda: model.init(jax.random.PRNGKey(1), *args, training=False), 8)
    fmap = jnp.asarray(rpn_out["img_feature_map"]) if shared_map else None
    out = jax.jit(lambda v_, *a: model.apply(v_, *a, training=False, img_feature_map=fmap))(
        as_jax(v), *args)
    return v, jax.tree_util.tree_map(np.asarray, out)


@functools.lru_cache(maxsize=1)
def _rpn_pair():
    v, want = _rpn_jax()
    ours = RpnModel(torch_presets.rpn_unittest().model_config, 3, CLUSTER_SIZES)
    load_flax_variables(ours, v).eval()
    b = {k: torch.from_numpy(x) for k, x in _inputs().items()}
    with torch.no_grad():
        got = ours(b["point_cloud"], b["image_input"], b["stereo_calib_p2"])
    return got, want, v


def test_rpn_test_mode(monkeypatch):
    direct_knn(monkeypatch)
    got, want, _ = _rpn_pair()
    for key in ("seg_softmax", "rpn_fts", "rpn_img_fts", "img_feature_map"):
        _close(got[key], want[key], rtol=1e-4, atol=1e-3 if key == "img_feature_map" else 1e-4)
    np.testing.assert_array_equal(got["rpn_pts"].numpy(), want["rpn_pts"])
    np.testing.assert_array_equal(got["foreground_mask"].numpy(), want["foreground_mask"])
    np.testing.assert_array_equal(got["proposal_valid"].numpy(), want["proposal_valid"])
    np.testing.assert_array_equal(got["num_proposals_before_padding"].numpy(),
                                  want["num_proposals_before_padding"])
    _close(got["proposal_scores"], want["proposal_scores"])
    _close(got["proposals"], want["proposals"])
    assert int(got["num_proposals_before_padding"].min()) > 0


@pytest.mark.parametrize("shared_map", [False, True], ids=["own_vgg", "two_stage"])
def test_rcnn_and_two_stage(monkeypatch, shared_map):
    """own_vgg: the RCNN alone on the JAX RPN's outputs, with its own image
    extractor. two_stage: the fused detector end to end (RPN -> RCNN on
    the RPN's image map), the port's `TwoStageDetector`."""
    direct_knn(monkeypatch)
    _, rpn_want, rpn_v = _rpn_pair()
    rcnn_v, want = _rcnn_jax(rpn_want, shared_map)
    rpn_cfg = torch_presets.rpn_unittest()
    rcnn_cfg = torch_presets.rcnn_unittest()
    rcnn_cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map = shared_map
    b = {k: torch.from_numpy(x) for k, x in _inputs().items()}
    with torch.no_grad():
        if shared_map:
            det = TwoStageDetector(rpn_cfg, rcnn_cfg)
            load_flax_variables(det.rpn, rpn_v)
            load_flax_variables(det.rcnn, rcnn_v)
            got = det.eval()(b["point_cloud"], b["image_input"], b["stereo_calib_p2"])
            # The JAX fused function's dict (experiments/run_inference.py).
            assert set(got) == {"proposals", "proposal_scores", "final_boxes", "final_scores",
                                "final_classes", "final_valid", "num_final"}
            np.testing.assert_array_equal(got["final_classes"].numpy(), want["final_classes"])
            np.testing.assert_array_equal(got["final_valid"].numpy(), want["final_valid"])
            _close(got["proposals"], rpn_want["proposals"])
            _close(got["proposal_scores"], rpn_want["proposal_scores"])
            got["num_boxes_before_padding"] = got["num_final"]
        else:
            rcnn = RcnnModel(rcnn_cfg.model_config, 3, CLUSTER_SIZES, 64 + 8)
            load_flax_variables(rcnn, rcnn_v).eval()
            t = {k: torch.from_numpy(np.array(x)) for k, x in rpn_want.items()}
            got = rcnn(t["proposals"], t["rpn_pts"], t["rpn_intensity"][..., 0],
                       t["foreground_mask"].float(), torch.cat([t["rpn_fts"], t["rpn_img_fts"]], -1),
                       b["image_input"], b["stereo_calib_p2"])
            np.testing.assert_array_equal(got["non_empty_box_mask"].numpy(),
                                          want["non_empty_box_mask"])
            np.testing.assert_array_equal(got["nms_indices"].numpy(), want["nms_indices"])
            _close(got["cls_softmax"], want["cls_softmax"])
    np.testing.assert_array_equal(got["num_boxes_before_padding"].numpy(),
                                  want["num_boxes_before_padding"])
    _close(got["final_scores"], want["final_scores"])
    # End to end, the stage-1 features' f32 rounding differences (~1e-6)
    # pass through the whole stage-2 network before the box decode.
    box_tol = dict(rtol=1e-3, atol=1e-3) if shared_map else dict(rtol=1e-4, atol=5e-4)
    _close(got["final_boxes"], want["final_boxes"], **box_tol)
    assert int(got["num_boxes_before_padding"].min()) > 0


@pytest.mark.parametrize("stage", ["rpn", "rcnn"])
def test_bf16_train_mode_builds_and_runs(stage):
    """compute_dtype "bfloat16" trains (tests/test_torch_bf16_training.py):
    a bf16 model builds in train mode and runs a train-mode forward and
    backward, its heads float32 before the loss, every gradient float32
    and finite."""
    rng = np.random.default_rng(4)
    if stage == "rpn":
        cfg = torch_presets.rpn_unittest().model_config
        cfg.compute_dtype = "bfloat16"
        model = init_weights(RpnModel(cfg, 3, CLUSTER_SIZES, mode="train"), 0).train()
        b = {k: torch.from_numpy(x[:1]) for k, x in _inputs().items()}
        bsz, p = b["point_cloud"].shape[:2]
        segs = torch.from_numpy(rng.integers(-1, 4, (bsz, p)).astype(np.int32))
        regs = torch.from_numpy(rng.uniform(0.5, 3.0, (bsz, p, 7)).astype(np.float32))
        gens = {"dropout": torch.Generator().manual_seed(0),
                "path_drop": torch.Generator().manual_seed(1)}
        out = model(b["point_cloud"], b["image_input"], b["stereo_calib_p2"], segs, regs,
                    generators=gens)
        heads = [out["seg_softmax"], *out["cls_preds"], *out["reg_preds"]]
        _, total = rpn_loss(out, cfg)
    else:
        cfg = torch_presets.rcnn_unittest().model_config
        cfg.compute_dtype = "bfloat16"
        model = init_weights(RcnnModel(cfg, 3, CLUSTER_SIZES, 64 + 8, mode="train"), 0).train()
        n, pts = 4, torch.from_numpy(rng.uniform(-2, 2, (1, 64, 3)).astype(np.float32))
        props = torch.tensor([[[0.0, 0.0, 0.0, 3.9, 1.6, 1.5, 0.0]] * n])
        gt = torch.cat([props, torch.ones(1, n, 1)], -1)
        gens = {"dropout": torch.Generator().manual_seed(0),
                "path_drop": torch.Generator().manual_seed(1)}
        out = model(props, pts, torch.zeros(1, 64), torch.ones(1, 64),
                    torch.from_numpy(rng.standard_normal((1, 64, 72)).astype(np.float32)),
                    torch.from_numpy(rng.uniform(0, 255, (1, 16, 16, 3)).astype(np.float32)),
                    torch.eye(3, 4)[None], proposals_iou=torch.full((1, n), 0.9),
                    proposals_gt=gt, generators=gens)
        heads = [out["cls_logits"], *out["mb_cls_preds"], *out["mb_reg_preds"]]
        _, total = rcnn_loss(out, cfg)
    assert model.dtype == torch.bfloat16
    assert all(h.dtype == torch.float32 for h in heads)
    total.backward()
    assert total.dtype == torch.float32 and bool(torch.isfinite(total))
    for name, prm in model.named_parameters():
        assert prm.dtype == prm.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(prm.grad).all()), name
