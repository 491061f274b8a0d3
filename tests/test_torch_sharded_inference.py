"""The port's batch-sharded serving (`inference.sharded_forward`,
`parallel.mesh.replicate_module` / `gather_rows`) on the CPU: two gloo
ranks against one process and against the JAX package's fused function.

One run of two ranks serves the whole file (`tests/torch_serve_worker.py`,
a module without jax; a `file://` rendezvous in a temporary directory,
joined within DEADLINE_S): each rank starts from weights of its own, takes
rank 0's by `replicate_module`, meets a batch of 3 that does not split,
then runs every case of CASES (a global batch of 2 or 4 frames,
`rpn_unittest` / `rcnn_unittest`, float32 or bf16, kernel switches off or
on) and returns the gathered dict.

- Every rank's gathered dict equals the one-process forward on the same
  batch bit for bit: on the CPU a frame's arithmetic does not depend on
  the frames beside it (measured: every output bit-equal at one intra-op
  thread), so this holds tighter than the JAX test's bounds
  (`tests/test_parallel_extras.py`: boxes rtol 1e-3 / atol 1e-3, scores
  rtol 1e-3 / atol 1e-4, keep sets exact).
- The float32 batch of 4 against the JAX package's `build_fused_inference`
  with the same weights (`convert.py`), the JAX PointCNN on the
  direct-distance KNN: index outputs exact, boxes rtol 1e-3 / atol 1e-3,
  scores rtol 1e-4 / atol 1e-4 (tests/test_torch_run_inference.py's bounds
  without its text-file rounding).
- `replicate_module` leaves rank 1 bit-equal to rank 0 in every parameter
  and buffer; the batch of 3 raises ValueError on both ranks before any
  collective; the forward's only collective is the gather (three
  `all_gather_into_tensor` calls, one a dtype; no `all_reduce`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.experiments import common
from heterofusionrcnn_torch.inference import random_batch
from heterofusionrcnn_torch.parallel.distributed import spawn_ranks

from tests import torch_serve_worker as worker
from tests.test_torch_layers import as_jax, direct_knn
from tests.test_torch_run_inference import _fixture_copy, _jax_fused

WORLD = 2
DEADLINE_S = 180
BOX_TOL = dict(rtol=1e-3, atol=1e-3)
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = ("final_classes", "final_valid", "num_final")
# name, inputs, compute_dtype, kernel switches
CASES = [("float32_b2", "b2", "float32", False), ("float32_b4", "b4", "float32", False),
         ("float32_switches_b2", "b2", "float32", True),
         ("bfloat16_switches_b4", "b4", "bfloat16", True)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The spec, each rank's results and the JAX fused function's output on
    the float32 batch of 4."""
    tmp = tmp_path_factory.mktemp("sharded")
    root = _fixture_copy(tmp)
    rpn_cfg = common.resolve_config("rpn_unittest", str(root))
    rcnn_cfg = common.resolve_config("rcnn_unittest", str(root))
    dataset = common.build_dataset(rpn_cfg, "test", "two")
    batch = random_batch(rpn_cfg, 4, seed=3)
    inputs = {f"b{b}": {k: batch[j][:b] for k, j in (("pc", "point_cloud"), ("img", "image_input"),
                                                      ("p2", "stereo_calib_p2"))}
              for b in (2, 3, 4)}
    inputs["uneven"] = inputs.pop("b3")
    with pytest.MonkeyPatch.context() as mp:
        direct_knn(mp)
        fused, rpn_v, rcnn_v = _jax_fused(root, batch)
        want_jax = jax.device_get(fused(as_jax(rpn_v), as_jax(rcnn_v),
                                        *(jnp.asarray(batch[k]) for k in
                                          ("point_cloud", "image_input", "stereo_calib_p2"))))
    det = common.build_detector(rpn_cfg, rcnn_cfg, dataset)
    load_flax_variables(det.rpn, rpn_v)
    load_flax_variables(det.rcnn, rcnn_v)
    spec = dict(rpn_cfg=rpn_cfg, rcnn_cfg=rcnn_cfg,
                cluster_sizes=common.cluster_sizes_tuple(dataset),
                bev_z_max=float(dataset.bev_extents[1, 1]),
                state_dict={k: v.clone() for k, v in det.state_dict().items()}, inputs=inputs,
                cases=[dict(name=n, inputs=i, compute_dtype=d, switches=s)
                       for n, i, d, s in CASES])
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    spawn_ranks(worker.serve_rank, WORLD, args=(str(spec_path), str(tmp)), timeout_s=DEADLINE_S,
                rendezvous_dir=str(tmp))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return spec, ranks, want_jax


def _one_process(spec, case):
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        det = worker.detector(spec, case["compute_dtype"], case["switches"])
        x = spec["inputs"][case["inputs"]]
        return det(*(torch.from_numpy(x[k]) for k in ("pc", "img", "p2")))
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_two_ranks_equal_one_process(served, index):
    spec, ranks, _ = served
    case = spec["cases"][index]
    want = _one_process(spec, case)
    b = spec["inputs"][case["inputs"]]["pc"].shape[0]
    assert int(want["num_final"].min()) > 0
    for res in ranks:
        got = res["cases"][index]
        assert got["name"] == case["name"]
        assert got["result"].keys() == want.keys()
        for key, val in want.items():
            assert got["result"][key].shape[0] == b
            assert got["result"][key].dtype == val.dtype, key
            assert torch.equal(got["result"][key], val), (case["name"], key)


def test_two_ranks_equal_jax(served):
    spec, ranks, want = served
    index = [c["name"] for c in spec["cases"]].index("float32_b4")
    assert int(want["num_final"].min()) > 0
    for res in ranks:
        got = {k: v.numpy() for k, v in res["cases"][index]["result"].items()}
        for key in EXACT:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        for key in ("proposals", "final_boxes"):
            np.testing.assert_allclose(got[key], want[key], **BOX_TOL, err_msg=key)
        for key in ("proposal_scores", "final_scores"):
            np.testing.assert_allclose(got[key], want[key], **SCORE_TOL, err_msg=key)


def test_replicate_module_makes_ranks_equal(served):
    spec, ranks, _ = served
    got0, got1 = ranks[0]["replicated"], ranks[1]["replicated"]
    assert got0.keys() == got1.keys() == spec["state_dict"].keys()
    moved = [k for k, v in spec["state_dict"].items() if v.is_floating_point()]
    assert len(moved) > 100  # rank 1 started from other weights and statistics
    for key, val in spec["state_dict"].items():
        assert torch.equal(got0[key], val), key
        assert torch.equal(got1[key], val), key


def test_uneven_batch_raises_on_every_rank(served):
    """Both ranks raise before any collective; neither hangs: both go on to
    the forwards after it, which gather within the deadline."""
    _, ranks, _ = served
    for res in ranks:
        assert res["uneven"]["error"] == "a global batch of 3 does not split over 2 ranks"
        assert not any(res["uneven"]["collectives"].values())
        assert len(res["cases"]) == len(CASES)


def test_the_gather_is_the_only_collective(served):
    spec, ranks, _ = served
    for res in ranks:
        for case in res["cases"]:
            # float32 outputs, int64 classes and counts, bool valid flags
            want = dict(dict.fromkeys(worker.COLLECTIVES, 0), all_gather_into_tensor=3)
            assert case["collectives"] == want, case["name"]
