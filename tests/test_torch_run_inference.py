"""The port's KITTI inference CLI (`heterofusionrcnn_torch.experiments.
run_inference`) end to end on the CPU, with both kernel switches on, against
the JAX package's fused function (`build_fused_inference`) fed the port
loader's batches with the same weights.

Two fixture frames through a split file of their own in a temporary copy of
the fixture tree, `rpn_unittest` / `rcnn_unittest` widths, random flax
variables carried into port checkpoints by `convert.py`. The RCNN runs its
own VGG pass (the CLI's default, `rcnn_use_rpn_img_feature_map` False). The
JAX PointCNN takes the direct-distance KNN (tests/test_torch_layers.py).

Tolerances as in tests/test_torch_models.py: boxes 1e-3 end to end, scores
1e-4, both plus the files' %.5f rounding; counts and classes exact.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.experiments import common as jax_common
from heterofusionrcnn_tpu.experiments.run_inference import build_fused_inference

from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.experiments import common, run_inference
from heterofusionrcnn_torch.models.extractors import layers as t_layers
from heterofusionrcnn_torch.ops import cropping
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager

from tests.test_torch_layers import as_jax, direct_knn, random_variables

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "kitti"
FRAMES = ("000001", "000004")
ROUND = 5e-6  # half a unit of %.5f


class _Count:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _fixture_copy(tmp_path: Path) -> Path:
    root = tmp_path / "kitti"
    root.mkdir()
    (root / "training").symlink_to(FIXTURE / "training")
    shutil.copy(FIXTURE / "train.txt", root / "train.txt")
    (root / "two.txt").write_text("\n".join(FRAMES) + "\n")
    return root


def _jax_fused(root: Path, batch):
    """The JAX fused function and random variables for both stages."""
    rpn_cfg = jax_common.resolve_config("rpn_unittest", str(root))
    rcnn_cfg = jax_common.resolve_config("rcnn_unittest", str(root))
    rpn_cfg.dataset_config.aug_list = []
    dataset = jax_common.build_dataset(rpn_cfg, "test", "two")
    fused, rpn_model, rcnn_model = build_fused_inference(rpn_cfg, rcnn_cfg, dataset)
    args = [jnp.asarray(batch[k]) for k in ("point_cloud", "image_input", "stereo_calib_p2")]
    rpn_v = random_variables(
        lambda: rpn_model.init(jax.random.PRNGKey(0), *args, training=False), 40)
    # The RCNN's init needs only the shapes of the RPN's outputs.
    out = jax.eval_shape(lambda v: rpn_model.apply(v, *args, training=False), rpn_v)
    zeros = {k: jnp.zeros(o.shape, jnp.float32) for k, o in out.items()}
    b, n = out["proposals"].shape[:2]
    rcnn_args = (zeros["proposals"], jnp.zeros((b, n)), jnp.zeros((b, n, 8)), zeros["rpn_pts"],
                 zeros["rpn_intensity"][..., 0], zeros["foreground_mask"],
                 jnp.concatenate([zeros["rpn_fts"], zeros["rpn_img_fts"]], -1), *args[1:])
    rcnn_v = random_variables(
        lambda: rcnn_model.init(jax.random.PRNGKey(1), *rcnn_args, training=False), 41)
    return fused, rpn_v, rcnn_v


def test_run_inference_cli_matches_jax(tmp_path, monkeypatch):
    direct_knn(monkeypatch)
    root = _fixture_copy(tmp_path)
    rpn_cfg = common.resolve_config("rpn_unittest", str(root))
    rcnn_cfg = common.resolve_config("rcnn_unittest", str(root))
    dataset = common.build_dataset(rpn_cfg, "test", "two")
    ic = rpn_cfg.model_config.input_config
    kw = dict(shuffle=False, model="rpn", pc_sample_pts=ic.pc_sample_pts,
              img_w=ic.img_dims_w, img_h=ic.img_dims_h)
    batches = [dataset.next_batch(1, **kw)[0] for _ in FRAMES]

    fused, rpn_v, rcnn_v = _jax_fused(root, batches[0])
    det = common.build_detector(rpn_cfg, rcnn_cfg, dataset)
    CheckpointManager(str(tmp_path / "rpn_ckpt")).save(3, load_flax_variables(det.rpn, rpn_v))
    CheckpointManager(str(tmp_path / "rcnn_ckpt")).save(7, load_flax_variables(det.rcnn, rcnn_v))

    counts = {}
    for mod, name in ((t_layers, "conv3x3_affine_relu"), (t_layers, "convtranspose3x3_affine_relu"),
                      (cropping, "crop_gather")):
        counts[name] = _Count(getattr(mod, name))
        monkeypatch.setattr(mod, name, counts[name])
    result = run_inference.main([
        "--rpn_config", "rpn_unittest", "--rcnn_config", "rcnn_unittest",
        "--rpn_checkpoint", str(tmp_path / "rpn_ckpt"),
        "--rcnn_checkpoint", str(tmp_path / "rcnn_ckpt"),
        "--dataset_dir", str(root), "--data_split", "two",
        "--output_root", str(tmp_path / "out"), "--device", "cpu",
        "--conv_kernels", "--crop_kernel",
    ])
    out_dir = Path(result["out_dir"])
    assert out_dir == (tmp_path / "out" / "rcnn_unittest" / "predictions"
                       / "final_predictions_and_scores" / "two" / "3_7_fused")
    assert result["frames"] == list(FRAMES)
    assert sorted(os.listdir(out_dir)) == [f"{f}.txt" for f in FRAMES]
    # The host ms a frame of each span, the root first.
    span_ms = result["span_ms"]
    assert list(span_ms)[:2] == ["two_stage", "rpn"]
    assert span_ms["two_stage"] >= span_ms["rpn"] + span_ms["rcnn"] > 0
    # Two VGG passes a frame (the RCNN's own): 7 convs and 3 transposed
    # convs each at unittest depth; one crop.
    assert {k: c.calls for k, c in counts.items()} == {
        "conv3x3_affine_relu": 14 * len(FRAMES), "convtranspose3x3_affine_relu": 6 * len(FRAMES),
        "crop_gather": len(FRAMES)}

    jit_vars = as_jax(rpn_v), as_jax(rcnn_v)
    for name, batch in zip(FRAMES, batches):
        want = jax.device_get(fused(*jit_vars, batch["point_cloud"], batch["image_input"],
                                    batch["stereo_calib_p2"]))
        rows = np.loadtxt(out_dir / f"{name}.txt").reshape(-1, 9)
        n = int(want["num_final"][0])
        assert n > 0 and rows.shape == (n, 9)
        np.testing.assert_allclose(rows[:, :7], want["final_boxes"][0][:n],
                                   rtol=1e-3, atol=1e-3 + ROUND)
        np.testing.assert_allclose(rows[:, 7], want["final_scores"][0][:n],
                                   rtol=1e-4, atol=1e-4 + ROUND)
        np.testing.assert_array_equal(rows[:, 8], want["final_classes"][0][:n])
