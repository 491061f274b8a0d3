"""The port's data-parallel training on the CPU: two ranks of a gloo group
against one process on the same global batch, and against the JAX
package's data-parallel step on a 2-device mesh.

Each rank is a process started by `spawn` running a function of
tests/torch_dp_worker.py (a module without jax), its rendezvous a file
store in the test's tmp_path (no port that two test workers could share);
every run of ranks is joined within DEADLINE_S and killed after it.

- BatchNorm in training (channels last and NCHW), the dropout draw, and
  the three losses' shares (foreground on both ranks, on one rank only, on
  neither) against `torch_dp_worker.layer_cases` in one process on the
  concatenated batch;
- two RPN train steps (`rpn_unittest`, the two fixture batches of
  tests/test_torch_training.py, dropout and path drop on) and two RCNN
  train steps (`rcnn_unittest` on a synthetic handoff, a positive RoI)
  against one process at the global batch of 2;
- two RPN train steps (dropout 0, path drop off) against the JAX package's
  step on `make_data_mesh(2)` with `shard_batch`;
- `run_training --device cpu --num_devices 2`: the iteration budget and the
  learning rate, rank 0's checkpoints and metrics, a resume.

Tolerances, from the arithmetic: the ranks sum the same terms as one
process in another order (two halves, then the all-reduce). Layer
outputs, running statistics, gradients and loss shares: rtol 1e-5 / atol
1e-6; dropout masks exactly. Each train step of the ranks starts from the
one-process state before it, so that a step's differences are its own:
its metrics rtol 1e-5 / atol 1e-6; its gradients (read from Adam's first
moment) rtol 1e-5 and an atol of 1e-4 x the tensor's largest |element|
(the batch sums of the BatchNorm backward cancel, so an element resolves
only to some 1e-5 of that largest one); every parameter, BatchNorm
statistic and EMA entry after it rtol 1e-5 and an atol of 1e-6 x the
tensor's largest |element| (at least 1e-8: statistics that are 0 in exact
arithmetic, such as the running mean of a normalised input, hold ~1e-11
of noise). Adam divides the gradient by its own scale, so a parameter's
update moves by about lr |dg| / sqrt(v_hat) for a gradient moved by dg:
each element is held within twice that more, which must stay below lr.
The biases that a training BatchNorm follows (18 tensors in the RPN, 13
in the RCNN, found as tests/test_torch_training.py finds them) have a
gradient of 0 in exact arithmetic, so rounding noise whose sign Adam
turns into an update of about lr: their gradients are held below 1e-5 on
both sides, their values within 2 x lr more. Against JAX,
tests/test_torch_training.py's `test_two_train_steps` tolerances.

bf16 (`compute_dtype` "bfloat16"): the BatchNorms' sums stay float32 and
are all-reduced in float32, so the running statistics and the weight and
bias gradients of a bf16 input hold the float32 tolerances, its bf16
output and input gradient one bf16 ulp (the input gradient 2^-7 of its
largest element more); dropout's bf16 mask and output exactly. Two bf16
train steps (the RPN and the RCNN, each step from the one-process state)
are held at bf16 resolution: a float32 sum of the other order rounds an
activation to the neighbouring bf16 value now and then, and the layers
carry it on. Metrics within 2^-7 relative; each step's gradient within
BF16_GRAD_SHARE of its largest |element| and BF16_GRAD_L2 in relative L2
norm (wider in the image branch); every parameter and EMA entry as in
float32 plus 2 x lr |dg| / sqrt(v_hat) at most 2 x lr, the elements at
that cap (gradients that bf16 does not resolve to a sign) counted and
bounded near the measured count; statistics within 1e-2 of their largest
|element| and 1e-6 absolute (a running mean that is 0 in exact
arithmetic holds ~1e-7 of noise).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.parallel.mesh import make_data_mesh
from heterofusionrcnn_tpu.parallel.mesh import replicate_state as j_replicate_state
from heterofusionrcnn_tpu.parallel.mesh import shard_batch as j_shard_batch
from heterofusionrcnn_tpu.runtime.optimizer import build_optimizer as j_build_optimizer
from heterofusionrcnn_tpu.runtime.optimizer import get_ema_params
from heterofusionrcnn_tpu.runtime.train_state import TrainState as JaxTrainState
from heterofusionrcnn_tpu.models import rpn as j_rpn
from heterofusionrcnn_tpu.runtime.train_state import make_rpn_train_step as j_make_step

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.configs.config import save_config
from heterofusionrcnn_torch.convert import flax_to_state_dict, load_flax_variables
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.experiments import common, run_training
from heterofusionrcnn_torch.models.extractors.layers import init_weights
from heterofusionrcnn_torch.parallel.distributed import spawn_ranks
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1, ADAM_B2, ADAM_EPS

from tests import torch_dp_worker as worker
from tests.rcnn_fixtures import write_handoff
from tests.test_torch_layers import as_jax, direct_knn, random_variables
from tests.test_torch_training import (
    BN_FOLLOWED_BIAS,
    FWD,
    GRAD,
    ZERO_GRAD,
    _batches,
    _configs,
    _jax_rpn,
)

WORLD = 2
DEADLINE_S = 180          # every run of ranks, joined within it
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-4)   # atol: x the tensor's largest |element|
ATOL_FLOOR = 1e-8
# bf16 (module docstring): one bf16 ulp of |x|, relative.
BF16_ULP = 2.0 ** -7
BF16_LAYER_ATOL_SHARE = 2.0 ** -7
BF16_LOSS_RTOL = 2.0 ** -7
# Per part (the image branch, everything else): measured 0.17 / 0.13 of the
# largest |element| and 0.11 / 0.088 in relative L2 (the RPN; the RCNN
# 0.14 / 0.059 and 0.085 / 0.050).
BF16_GRAD_SHARE = (0.35, 0.25)
BF16_GRAD_L2 = (0.2, 0.15)
BF16_STATS_SHARE = 1e-2
BF16_STATS_ATOL = 1e-6
# The elements a bf16 step leaves at the 2 x lr cap, per step (measured:
# the RPN 4,459 and 362 of 158,312, the RCNN 3,049 and 139 of 292,984).
BF16_WIDENED_MAX = {"rpn": (5_400, 450), "rcnn": (3_700, 170)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test (the ranks set their own): the tier-1 run
    has several workers a core set."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_ranks(fn, inputs, tmp_path):
    """`fn` of tests/torch_dp_worker.py on WORLD gloo ranks over `inputs`
    (saved for them); each rank's saved result."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    path, out, rdzv = tmp_path / "inputs.pt", tmp_path / "out", tmp_path / "rendezvous"
    out.mkdir()
    rdzv.mkdir()
    torch.save(inputs, path)
    spawn_ranks(fn, WORLD, args=(str(path), str(out)), timeout_s=DEADLINE_S,
                rendezvous_dir=str(rdzv))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rows(t, rank):
    b = t.shape[0] // WORLD
    return t[rank * b:(rank + 1) * b]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# Layers and losses

def _loss_predictions(rng, fg_ranks):
    """Random RPN predictions (4 frames x 32 points, 3 classes) and RCNN
    predictions (4 frames x 8 RoIs) whose foreground rows lie on the ranks
    `fg_ranks` only."""
    b, p, k, nbin = 4, 32, 3, 6

    def rows_on(shape):
        keep = np.zeros(shape[0], bool)
        for r in fg_ranks:
            keep[r * shape[0] // WORLD:(r + 1) * shape[0] // WORLD] = True
        return (rng.random(shape) < 0.4) & keep.reshape((-1,) + (1,) * (len(shape) - 1))

    def onehot(shape, n):
        return np.eye(n, dtype=np.float32)[rng.integers(0, n, shape)]

    def heads(shape):
        return dict(
            cls_preds=tuple(rng.standard_normal(shape + (nbin,)).astype(np.float32)
                            for _ in range(2)),
            cls_gts=(onehot(shape, nbin), onehot(shape, nbin)),
            reg_preds=(rng.standard_normal(shape).astype(np.float32),
                       rng.standard_normal(shape + (3,)).astype(np.float32)),
            reg_gts=(rng.standard_normal(shape).astype(np.float32),
                     rng.standard_normal(shape + (3,)).astype(np.float32)))

    logits = rng.standard_normal((b, p, k + 1))
    rpn = dict(heads((b, p)),
               seg_softmax=(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
               .astype(np.float32),
               seg_gt_one_hot=onehot((b, p), k + 1), foreground_mask=rows_on((b, p)))
    nb = b * 8
    rcnn = {"mb_" + key: val for key, val in heads((nb,)).items()}
    rcnn.update(cls_logits=rng.standard_normal((nb, k + 1)).astype(np.float32),
                cls_gt_one_hot=onehot((nb,), k + 1), pos_neg_cls_mask=rows_on((nb,)),
                pos_reg_mask=rows_on((nb,)))
    return dict(rpn=rpn, rcnn=rcnn)


LOSS_CASES = {"both": (0, 1), "one": (1,), "neither": ()}


def _layer_inputs():
    rng = np.random.default_rng(0)

    def bn_case(shape, c):
        return dict(x=(rng.standard_normal(shape) * 3 + 1).astype(np.float32),
                    cot=rng.standard_normal(shape).astype(np.float32),
                    weight=rng.uniform(0.5, 1.5, c).astype(np.float32),
                    bias=(rng.standard_normal(c) * 0.1).astype(np.float32))

    inputs = {"bn_last": bn_case((4, 16, 6), 6), "bn_nchw": bn_case((4, 5, 6, 7), 5),
              "dropout": dict(shape=(4, 8, 5), seed=7)}
    for case, fg_ranks in LOSS_CASES.items():
        inputs["loss_" + case] = _loss_predictions(rng, fg_ranks)
    return inputs


@pytest.fixture(scope="module")
def layer_results(tmp_path_factory):
    """(one process on the whole batch, [each rank's results])."""
    inputs = _layer_inputs()
    ranks = _run_ranks(worker.layers_rank, inputs, tmp_path_factory.mktemp("layers"))
    return worker.layer_cases(inputs, None), ranks


@pytest.mark.parametrize("name", ["bn_last", "bn_nchw"])
def test_batch_norm_over_the_global_batch(layer_results, name):
    """`BatchNorm` / `BatchNorm2d` in training at world 2 against world 1 on
    the concatenated batch: outputs and input gradients row for row, the
    running statistics on every rank, the weight and bias gradients summed
    over the ranks."""
    want, ranks = layer_results
    want = want[name]
    for r, got in enumerate(ranks):
        got = got[name]
        _close(got["y"], _rows(want["y"], r))
        _close(got["x_grad"], _rows(want["x_grad"], r))
        for key in ("running_mean", "running_var"):
            _close(got[key], want[key])
    for key in ("weight_grad", "bias_grad"):
        _close(sum(got[name][key] for got in ranks), want[key])


def test_dropout_draws_the_global_mask(layer_results):
    """Each rank's dropout mask is its rows of the one-process mask, and
    every rank's generator advances as the one-process generator does."""
    want, ranks = layer_results
    for r, got in enumerate(ranks):
        assert torch.equal(got["dropout"]["mask"], _rows(want["dropout"]["mask"], r))
        assert torch.equal(got["dropout"]["next"], want["dropout"]["next"])
    assert 0 < int(want["dropout"]["mask"].sum()) < want["dropout"]["mask"].numel()


@pytest.mark.parametrize("name", ["bn_last_bf16", "bn_nchw_bf16"])
def test_batch_norm_bf16_over_the_global_batch(layer_results, name):
    """The BatchNorms on a bf16 input at world 2 against world 1: the
    statistics' sums all-reduced in float32, so the running statistics and
    the weight and bias gradients (float32) as the float32 case's; the bf16
    output and input gradient within one bf16 ulp of |want| (a float32
    statistic in another summation order can round an element to the
    neighbouring bf16 value; BF16_LAYER_ATOL_SHARE of the largest element
    more for the input gradient, whose batch sums cancel)."""
    want, ranks = layer_results
    want = want[name]
    assert want["y"].dtype == want["x_grad"].dtype == torch.bfloat16
    for r, got in enumerate(ranks):
        got = got[name]
        assert got["y"].dtype == got["x_grad"].dtype == torch.bfloat16
        assert got["running_mean"].dtype == got["weight_grad"].dtype == torch.float32
        for key, share in (("y", 0.0), ("x_grad", BF16_LAYER_ATOL_SHARE)):
            g, w = got[key].float(), _rows(want[key], r).float()
            bound = BF16_ULP * w.abs() + share * float(w.abs().max())
            assert bool(((g - w).abs() <= bound).all()), (key, float((g - w).abs().max()))
        for key in ("running_mean", "running_var"):
            _close(got[key], want[key])
    for key in ("weight_grad", "bias_grad"):
        _close(sum(got[name][key] for got in ranks), want[key])


def test_dropout_bf16_draws_the_global_mask(layer_results):
    """A bf16 input's dropout at world 2: each rank's mask and bf16 output
    are its rows of the one-process ones, bit for bit."""
    want, ranks = layer_results
    want = want["dropout_bf16"]
    assert want["y"].dtype == torch.bfloat16
    for r, got in enumerate(ranks):
        got = got["dropout_bf16"]
        assert torch.equal(got["mask"], _rows(want["mask"], r))
        assert torch.equal(got["y"], _rows(want["y"], r))
        assert torch.equal(got["next"], want["next"])
    assert torch.equal(want["mask"], layer_results[0]["dropout"]["mask"])


@pytest.mark.parametrize("loss", ["bin", "rpn", "rcnn"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_shares_sum_to_the_global_loss(layer_results, case, loss):
    """`bin_losses`, `rpn_loss` and `rcnn_loss`: the ranks' shares add up
    to the one-process loss, whether the foreground lies on both ranks, on
    one rank only (the other's share of the foreground terms is 0, and the
    loss is not), or on neither (0)."""
    want, ranks = layer_results
    want = want["loss_" + case][loss]
    shares = [got["loss_" + case][loss] for got in ranks]
    _close(sum(shares), want)
    fg_terms = slice(None) if loss == "bin" else slice(1, None)  # the seg / cls loss aside
    if case == "one":
        assert torch.equal(shares[0][fg_terms], torch.zeros_like(shares[0][fg_terms]))
        assert bool((want[fg_terms] > 0).all())
    if case == "neither":
        assert torch.equal(want[fg_terms], torch.zeros_like(want[fg_terms]))


# ---------------------------------------------------------------------------
# Train steps against one process

def _steps_spec(kind, cfg, batches, seed):
    cfg.train_config.optimizer.use_moving_average = True
    cfg.train_config.optimizer.moving_average_decay = 0.9
    model, _ = worker.build(kind, cfg)
    init_weights(model, seed)
    return dict(kind=kind, cfg=cfg, state_dict=model.state_dict(), seed=seed, batches=batches)


def _step_grads(steps, i, name, mu_before):
    """Step i's (clipped) gradient of `name` from Adam's first moment."""
    return (steps[i]["optimizer"]["state"]["mu"][name] - ADAM_B1 * mu_before) / (1 - ADAM_B1)


def _check_steps(spec, run_ranks, n_bn_followed):
    """The steps at world 2 (`run_ranks(spec)`) against one process: each
    step of the ranks starts from the one-process state before it
    (`restarts`; the generators go on), and its metrics, gradients,
    parameters, statistics and EMA are held to the one-process step's
    (module docstring); the two ranks end bit-identical. Returns the
    one-process run."""
    want = worker.run_steps(spec, None, "cpu")
    spec = dict(spec, restarts=[None] + [{k: st[k] for k in ("state_dict", "optimizer")}
                                         for st in want["steps"][:-1]])
    ranks = run_ranks(spec)
    lr = float(spec["cfg"].train_config.optimizer.initial_learning_rate)
    names = list(want["steps"][0]["optimizer"]["state"]["mu"])
    assert sum(bool(BN_FOLLOWED_BIAS.search(n)) for n in names) == n_bn_followed
    for i, w in enumerate(want["steps"]):
        before = (want["steps"][i - 1]["optimizer"]["state"]["mu"] if i
                  else {n: 0.0 for n in names})
        v_hats = {n: nu / (1 - ADAM_B2 ** (i + 1))
                  for n, nu in w["optimizer"]["state"]["nu"].items()}
        for got in ranks:
            g = got["steps"][i]
            assert g["optimizer"]["count"] == w["optimizer"]["count"] == i + 1
            assert sorted(g["metrics"]) == sorted(w["metrics"])
            for key, val in w["metrics"].items():
                _close(g["metrics"][key], val)
            noise = {}
            for name in names:
                gw = _step_grads(want["steps"], i, name, before[name])
                gg = _step_grads(got["steps"], i, name, before[name])
                if BN_FOLLOWED_BIAS.search(name):  # 0 in exact arithmetic: noise on each side
                    assert max(float(gw.abs().max()), float(gg.abs().max())) < ZERO_GRAD, name
                    noise[name] = 2 * lr
                    continue
                err = (gg - gw).abs()
                assert bool((err <= GRAD_TOL["rtol"] * gw.abs()
                             + GRAD_TOL["atol"] * float(gw.abs().max())).all()), (
                    i, name, float(err.max() / gw.abs().max()))
                # Adam's update moves by about lr |dg| / sqrt(v_hat) for a
                # gradient moved by dg: twice that more (module docstring).
                noise[name] = 2 * lr * err / (torch.sqrt(v_hats[name]) + ADAM_EPS)
                assert float(noise[name].max()) < lr, (i, name)
            _held_alike(g["state_dict"], w["state_dict"], noise)
            _held_alike(g["optimizer"]["ema"], w["optimizer"]["ema"], noise)
    assert ranks[0]["step"] == want["step"] == len(spec["batches"])
    for name, t in ranks[0]["steps"][-1]["state_dict"].items():
        assert torch.equal(t, ranks[1]["steps"][-1]["state_dict"][name]), name
    return want


def _held_alike(got, want, noise):
    """Every tensor of `want` in `got` within rtol 1e-5 and 1e-6 x its
    largest |element| (module docstring), `noise` {name: atol} more."""
    for name, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[name], w), name
            continue
        atol = max(TOL["atol"] * float(w.abs().max()), ATOL_FLOOR)
        bound = TOL["rtol"] * w.abs() + atol + noise.get(name, 0.0)
        err = (got[name] - w).abs()
        assert bool((err <= bound).all()), (name, float(err.max()))


def test_rpn_train_steps_match_one_process(tmp_path):
    """Two RPN train steps with dropout and path drop on, at world 2 and in
    one process on the same global batches of 2."""
    cfg = torch_presets.rpn_unittest()
    lc = cfg.model_config.layers_config
    assert all(fc.dropout_rate > 0 for fc in lc.rpn_fc_layers + lc.pc_pointcnn.fc_layers)
    assert cfg.model_config.path_drop_probabilities == [0.9, 0.9]
    batches = [{k: b[k] for k in common.RPN_BATCH_KEYS} for b in _batches()]
    _check_steps(_steps_spec("rpn", cfg, batches, seed=5),
                 lambda spec: _run_ranks(worker.steps_rank, spec, tmp_path), 18)


def test_rcnn_train_steps_match_one_process(tmp_path):
    """Two RCNN train steps with dropout and path drop on, at world 2 and in
    one process, on a synthetic handoff with positive RoIs."""
    cfg = torch_presets.rcnn_unittest()
    ds = KittiDataset(cfg.dataset_config, "train")
    ds.seed(0)
    ds.proposal_dir, ds.proposal_iou_dir, ds.rpn_feature_dir = write_handoff(
        ds, str(tmp_path / "handoff"))
    next_batch = common.make_batch_fn(cfg, ds, "rcnn", 2)
    spec = _steps_spec("rcnn", cfg, [next_batch(), next_batch()], seed=6)
    want = _check_steps(
        spec, lambda spec: _run_ranks(worker.steps_rank, spec, tmp_path / "ranks"), 13)
    assert all(st["metrics"]["rcnn_reg_loss"] > 0 for st in want["steps"])


def _check_bf16_steps(spec, run_ranks, n_bn_followed):
    """`_check_steps` for a bf16 model: the ranks' bf16 activations round
    apart from one process's wherever a float32 sum in another order lands
    on the other side of a bf16 rounding, so each step is held at bf16
    resolution (module docstring): metrics within BF16_LOSS_RTOL, each
    step gradient (from Adam's first moment) within BF16_GRAD_SHARE of the
    tensor's largest |element| and BF16_GRAD_L2 in relative L2 norm, every
    parameter and EMA entry within TOL plus 2 x lr |dg| / sqrt(v_hat) (at
    most 2 x lr; the elements at that cap counted), every statistic within
    BF16_STATS_SHARE of its largest |element| and BF16_STATS_ATOL, and all
    of it float32. Returns the one-process run and the widened counts of
    each step on each rank."""
    want = worker.run_steps(spec, None, "cpu")
    spec = dict(spec, restarts=[None] + [{k: st[k] for k in ("state_dict", "optimizer")}
                                         for st in want["steps"][:-1]])
    ranks = run_ranks(spec)
    lr = float(spec["cfg"].train_config.optimizer.initial_learning_rate)
    names = list(want["steps"][0]["optimizer"]["state"]["mu"])
    assert sum(bool(BN_FOLLOWED_BIAS.search(n)) for n in names) == n_bn_followed
    widened = []
    for i, w in enumerate(want["steps"]):
        before = (want["steps"][i - 1]["optimizer"]["state"]["mu"] if i
                  else {n: 0.0 for n in names})
        for got in ranks:
            g = got["steps"][i]
            for key, val in w["metrics"].items():
                assert abs(g["metrics"][key] - val) <= BF16_LOSS_RTOL * abs(val), (i, key)
            noise, n_wide = {}, 0
            for name in names:
                gw = _step_grads(want["steps"], i, name, before[name])
                gg = _step_grads(got["steps"], i, name, before[name])
                assert gg.dtype == torch.float32
                if BN_FOLLOWED_BIAS.search(name):  # 0 in exact arithmetic: noise on each side
                    noise[name] = 2 * lr
                    continue
                err = (gg - gw).abs()
                scale = max(float(gw.abs().max()), 1e-30)
                part = 0 if name.startswith("img_vgg_pyr.") else 1
                assert float(err.max()) <= BF16_GRAD_SHARE[part] * scale, (
                    i, name, float(err.max()) / scale)
                assert float(err.norm()) <= BF16_GRAD_L2[part] * max(float(gw.norm()), 1e-30), (
                    i, name)
                v_hat = w["optimizer"]["state"]["nu"][name] / (1 - ADAM_B2 ** (i + 1))
                noise[name] = torch.clamp(2 * lr * err / (torch.sqrt(v_hat) + ADAM_EPS),
                                          max=2 * lr)
                n_wide += int((noise[name] >= 2 * lr).sum())
            widened.append(n_wide)
            for part in ("state_dict", "ema"):
                gs = g["state_dict"] if part == "state_dict" else g["optimizer"]["ema"]
                ws = w["state_dict"] if part == "state_dict" else w["optimizer"]["ema"]
                for name, wt in ws.items():
                    if not wt.is_floating_point():
                        assert torch.equal(gs[name], wt), name
                        continue
                    assert gs[name].dtype == torch.float32, name
                    if name in noise:
                        bound = TOL["rtol"] * wt.abs() + TOL["atol"] + noise[name]
                    else:  # a BatchNorm statistic
                        bound = BF16_STATS_SHARE * float(wt.abs().max()) + BF16_STATS_ATOL
                    err = (gs[name] - wt).abs()
                    assert bool((err <= bound).all()), (i, part, name, float(err.max()))
    assert ranks[0]["step"] == want["step"] == len(spec["batches"])
    for name, t in ranks[0]["steps"][-1]["state_dict"].items():
        assert torch.equal(t, ranks[1]["steps"][-1]["state_dict"][name]), name
    return want, widened


@pytest.mark.parametrize("kind", ["rpn", "rcnn"])
def test_bf16_train_steps_match_one_process(tmp_path, kind):
    """Two bf16 train steps (`compute_dtype` "bfloat16", dropout and path
    drop on) at world 2 and in one process on the same global batches of
    2: the RPN on the fixture batches, the RCNN on a synthetic handoff."""
    if kind == "rpn":
        cfg = torch_presets.rpn_unittest()
        batches = [{k: b[k] for k in common.RPN_BATCH_KEYS} for b in _batches()]
    else:
        cfg = torch_presets.rcnn_unittest()
        ds = KittiDataset(cfg.dataset_config, "train")
        ds.seed(0)
        ds.proposal_dir, ds.proposal_iou_dir, ds.rpn_feature_dir = write_handoff(
            ds, str(tmp_path / "handoff"))
        next_batch = common.make_batch_fn(cfg, ds, "rcnn", 2)
        batches = [next_batch(), next_batch()]
    cfg.model_config.compute_dtype = "bfloat16"
    spec = _steps_spec(kind, cfg, batches, seed=7)
    want, widened = _check_bf16_steps(
        spec, lambda spec: _run_ranks(worker.steps_rank, spec, tmp_path / "ranks"),
        18 if kind == "rpn" else 13)
    assert widened[::2] == widened[1::2]  # the two ranks alike
    assert all(n <= cap for n, cap in zip(widened[::2], BF16_WIDENED_MAX[kind])), widened
    if kind == "rcnn":
        assert all(st["metrics"]["rcnn_reg_loss"] > 0 for st in want["steps"])


# ---------------------------------------------------------------------------
# Against the JAX package's mesh step

def test_rpn_train_steps_match_jax_mesh(monkeypatch, tmp_path):
    """Two RPN train steps at world 2 against the JAX package's step on a
    2-device data mesh (`make_data_mesh(2)`, the state replicated, the
    batch sharded) on the same global batches, from the same variables:
    the metrics, every parameter, statistic and EMA entry."""
    direct_knn(monkeypatch)
    jcfg, tcfg = _configs()
    for cfg in (jcfg, tcfg):
        cfg.train_config.optimizer.use_moving_average = True
        cfg.train_config.optimizer.moving_average_decay = 0.9
    batches = [{k: b[k] for k in common.RPN_BATCH_KEYS} for b in _batches()]
    model, args = _jax_rpn("train", jcfg, batches[0])
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 13)
    tx = j_build_optimizer(jcfg.train_config.optimizer, 1, jcfg.train_config.grad_clip_norm)
    mesh = make_data_mesh(WORLD)
    jstate = j_replicate_state(
        JaxTrainState.create(model.apply, as_jax(v["params"]), as_jax(v["batch_stats"]), tx),
        mesh)
    jstep = j_make_step(lambda p: j_rpn.rpn_loss(p, jcfg.model_config))
    rng = jax.random.PRNGKey(100)
    jmetrics = []
    for batch in batches:
        jstate, m, rng = jstep(jstate, j_shard_batch({k: jnp.asarray(x) for k, x in batch.items()},
                                                     mesh), rng)
        jmetrics.append(jax.tree_util.tree_map(np.asarray, m))

    ours, _ = worker.build("rpn", tcfg)
    spec = dict(kind="rpn", cfg=tcfg, state_dict=load_flax_variables(ours, v).state_dict(),
                seed=0, batches=batches)
    ranks = _run_ranks(worker.steps_rank, spec, tmp_path)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                              jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    want_ema = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                         get_ema_params(jstate.opt_state)))
    lr = float(tcfg.train_config.optimizer.initial_learning_rate)
    noise = {n: 2 * 2 * lr for n in want if BN_FOLLOWED_BIAS.search(n)}
    assert len(noise) == 18
    for got in ranks:
        for st, jm in zip(got["steps"], jmetrics):
            assert sorted(st["metrics"]) == sorted(jm)
            for key in jm:
                _close(st["metrics"][key], jm[key], **FWD)
        final = got["steps"][-1]
        for name, w in list(want.items()) + [("ema " + n, w) for n, w in want_ema.items()]:
            g = (final["optimizer"]["ema"][name[4:]] if name.startswith("ema ")
                 else final["state_dict"][name])
            bound = GRAD["atol"] + GRAD["rtol"] * w.abs() + noise.get(name.split(" ")[-1], 0.0)
            assert bool(((g - w).abs() <= bound).all()), (name, float((g - w).abs().max()))
    assert int(jstate.step) == ranks[0]["step"] == 2


# ---------------------------------------------------------------------------
# The CLI

def _adam_update(mu, nu, count, lr):
    """Adam's update after `count` steps from its moments (optimizer.py)."""
    bc1, bc2 = 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count
    return -lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)


def test_cli_two_ranks_train_checkpoint_and_resume(tmp_path, monkeypatch, capfd):
    """`run_training --device cpu --num_devices 2`: max_iterations / 2
    steps, one checkpoint directory and one metrics.jsonl (rank 0's), the
    first step's update at 2 x the learning rate, then a resume at world 2
    from the last checkpoint."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = torch_presets.rpn_unittest()
    cfg.train_config.batch_size = 2
    cfg.train_config.max_iterations = 4
    cfg.train_config.checkpoint_interval = 1
    path = tmp_path / "rpn_unittest.json"
    save_config(cfg, str(path))
    argv = ["--device", "cpu", "--pipeline_config", str(path), "--output_root", str(tmp_path),
            "--num_devices", "2"]
    assert run_training.main(argv) is None
    base = tmp_path / "rpn_unittest"
    ckpt = CheckpointManager(str(base / "checkpoints"))
    assert ckpt.all_steps() == [1, 2]
    assert (base / "rpn_unittest_config.json").is_file()

    def steps_logged():
        with open(base / "logs" / "metrics.jsonl") as f:
            return [json.loads(line)["step"] for line in f]

    assert steps_logged() == [1, 2]

    # The first step's update, from the seed's fresh weights, is Adam's at
    # 2 x the configured rate.
    model, _ = common.build_model(cfg, common.build_dataset(cfg, "train"), "train")
    fresh = init_weights(model, 0).state_dict()
    first = ckpt.restore_raw(1)
    lr = cfg.train_config.optimizer.initial_learning_rate
    moments = first["optimizer"]["state"]
    for name in ("fc0.Dense_0.weight", "seg_logits.Dense_0.bias"):
        moved = first["state_dict"][name] - fresh[name]
        want = _adam_update(moments["mu"][name], moments["nu"][name], 1, 2 * lr)
        _close(moved, want, rtol=1e-4, atol=1e-7)
        assert float(moved.abs().max()) > 1.5 * lr

    assert run_training.main(argv + ["--max_iterations", "6"]) is None
    assert ckpt.all_steps() == [1, 2, 3]
    assert steps_logged() == [1, 2, 3]
    assert capfd.readouterr().out.count("Resumed from step 2") == 1


def test_cli_relaunch_exit_on_every_rank(tmp_path, monkeypatch):
    """The host-RSS cap passed on the ranks: rank 0 checkpoints once, and
    the run exits 75 for a relaunch."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("HFR_MAX_HOST_RSS_MB", "1")
    cfg = torch_presets.rpn_unittest()
    cfg.train_config.batch_size = 2
    path = tmp_path / "rpn_unittest.json"
    save_config(cfg, str(path))
    with pytest.raises(SystemExit) as exc:
        run_training.main(["--device", "cpu", "--pipeline_config", str(path),
                           "--output_root", str(tmp_path), "--num_devices", "2"])
    assert exc.value.code == 75
    assert CheckpointManager(str(tmp_path / "rpn_unittest" / "checkpoints")).all_steps() == [1]


@pytest.mark.parametrize("env,argv,match", [
    # NCCL takes one card a rank: more ranks than cards fail before any starts.
    ({}, ["--num_devices", "2"], "one card a rank"),
    # A run that torchrun started joins its group, of torchrun's size.
    ({"RANK": "0", "WORLD_SIZE": "2"}, ["--num_devices", "4"], "torchrun started 2"),
])
def test_cli_world_size_errors_raise_before_any_rank(tmp_path, monkeypatch, env, argv, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(run_training, "spawn_ranks", None)  # no rank may start
    monkeypatch.setattr(run_training, "initialize_distributed", None)
    with pytest.raises(ValueError, match=match):
        run_training.main(["--pipeline_config", "rpn_multiclass", "--output_root",
                           str(tmp_path), *argv])
