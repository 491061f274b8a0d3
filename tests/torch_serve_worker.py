"""The ranks of the port's batch-sharded serving tests
(tests/test_torch_sharded_inference.py), importing neither jax nor the JAX
package: each rank is a process started by `spawn`, which imports this
module afresh (tests/torch_dp_worker.py says why these functions live
apart from the test file).

- `replicated_detector`: a rank's `TwoStageDetector` that starts from
  weights of its own and takes rank 0's by `replicate_module`;
- `serve_cases`: a rank's sharded forwards over the cases of a spec;
- `serve_rank`: a rank of a gloo group on the CPU running `serve_cases`,
  its results saved to `<out_dir>/rank<r>.pt`.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List

import torch
import torch.distributed as dist

from heterofusionrcnn_torch.inference import TwoStageDetector, sharded_forward
from heterofusionrcnn_torch.parallel.distributed import initialize_distributed, shutdown_distributed
from heterofusionrcnn_torch.parallel.mesh import rank_and_size, replicate_module

# The collectives a sharded forward could reach; each call is counted.
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "barrier")


def detector(spec: dict, compute_dtype: str = "float32",
             switches: bool = False) -> TwoStageDetector:
    """The spec's detector ({"rpn_cfg", "rcnn_cfg", "cluster_sizes",
    "bev_z_max", "state_dict"}) in `compute_dtype`, with both kernel
    switches `switches`, in eval mode on the CPU."""
    rpn_cfg, rcnn_cfg = copy.deepcopy(spec["rpn_cfg"]), copy.deepcopy(spec["rcnn_cfg"])
    rpn_cfg.model_config.compute_dtype = compute_dtype
    rcnn_cfg.model_config.compute_dtype = compute_dtype
    det = TwoStageDetector(rpn_cfg, rcnn_cfg, spec["cluster_sizes"], conv_kernels=switches,
                           crop_kernel=switches, bev_z_max=spec["bev_z_max"])
    det.load_state_dict(spec["state_dict"])
    return det.eval()


def replicated_detector(spec: dict, group, device: str = "cpu", **kwargs) -> TwoStageDetector:
    """`detector(spec, **kwargs)` on `device`, every floating parameter and
    buffer of a rank other than 0 first moved by its rank (other weights and
    BatchNorm statistics), then rank 0's on every rank (`replicate_module`)."""
    det = detector(spec, **kwargs).to(device)
    rank, _ = rank_and_size(group)
    with torch.no_grad():
        for t in [*det.parameters(), *det.buffers()]:
            if rank and t.is_floating_point():
                t.add_(rank)
    return replicate_module(det, group)


class CountedCollectives:
    """Counts the calls of `COLLECTIVES` while entered."""

    def __init__(self):
        self.calls = {name: 0 for name in COLLECTIVES}
        self._saved = {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = self._saved[name] = getattr(dist, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.calls[_name] += 1
                return _fn(*args, **kwargs)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def serve_cases(spec: dict, group) -> dict:
    """This rank's part of every case of `spec`:

      - "uneven": `sharded_forward` on spec["inputs"]["uneven"] (a batch
        the world size does not divide): the ValueError's message, and the
        collectives it reached;
      - "replicated": this rank's state dict after `replicated_detector`;
      - spec["cases"]: per {"name", "inputs", "compute_dtype", "switches"}
        the gathered dict of `sharded_forward` on the inputs named and the
        collectives of that call.

    Inputs are dicts of numpy arrays (pc, img, p2)."""
    def tensors(name):
        return [torch.from_numpy(spec["inputs"][name][k]) for k in ("pc", "img", "p2")]

    out: Dict[str, object] = {}
    det = replicated_detector(spec, group)
    out["replicated"] = {k: v.clone() for k, v in det.state_dict().items()}
    with CountedCollectives() as counted:
        try:
            sharded_forward(det, *tensors("uneven"), group)
        except ValueError as exc:
            out["uneven"] = {"error": str(exc)}
        else:
            out["uneven"] = {"error": None}
    out["uneven"]["collectives"] = dict(counted.calls)
    forwards: List[dict] = []
    dets = {("float32", False): det}
    for case in spec["cases"]:
        key = (case["compute_dtype"], case["switches"])
        if key not in dets:
            dets[key] = replicated_detector(spec, group, compute_dtype=key[0], switches=key[1])
        det = dets[key]
        with CountedCollectives() as counted:
            result = sharded_forward(det, *tensors(case["inputs"]), group)
        forwards.append(dict(case, result=result, collectives=dict(counted.calls)))
    out["cases"] = forwards
    return out


def serve_rank(rank: int, world_size: int, init_method: str, spec_path: str, out_dir: str) -> None:
    """A rank of a gloo group on the CPU: `serve_cases` of the spec saved
    at `spec_path`, saved to <out_dir>/rank<rank>.pt."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    group = initialize_distributed(rank, world_size, init_method, device="cpu")["group"]
    try:
        torch.save(serve_cases(spec, group), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()
