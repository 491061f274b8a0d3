"""Model export / deployment, the freeze step (PyTorch port of
heterofusionrcnn_tpu/runtime/export.py).

The reference stitches the two stage graphs into one frozen GraphDef; the
JAX package serialises the fused function to StableHLO with both stages'
weights closed over. Here `torch.export` traces the two-stage detector
(`inference.TwoStageDetector`, test mode, eval) into one graph with its
weights inside the artifact, saved with `torch.export.save`. Every
hand-written kernel is a custom op of the namespace `hfr`
(`ops/library.py`): the graph holds `torch.ops.hfr.*` calls, traced through
their fake functions, and each call plans its launch on the card it runs
on. Loading needs the port importable, for that registration; no model
code runs.

    det, (pc, img, p2) = inference.build_two_stage(4, 0, "cuda")
    export_fused_inference(det, pc, img, p2, "fused.pt2")
    out = load_exported("fused.pt2")(pc, img, p2)
"""

from __future__ import annotations

import os

import torch

from heterofusionrcnn_torch.inference import exact_float32


def export_fused_inference(detector: torch.nn.Module, example_pc: torch.Tensor,
                           example_img: torch.Tensor, example_p2: torch.Tensor,
                           out_path: str) -> int:
    """Trace `detector` in eval mode on example inputs of the serving shapes
    (pc (B, P, 4), img (B, H, W, 3), p2 (B, 3, 4), on the detector's
    device) and save the program with its weights to `out_path`.
    Returns the artifact's size in bytes."""
    # Traced with autograd off, so that the forward's own no_grad leaves no
    # grad-mode region in the graph.
    with torch.no_grad():
        program = torch.export.export(detector.eval(), (example_pc, example_img, example_p2),
                                      strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    return os.path.getsize(out_path)


def load_exported(path: str, device: str = "cuda"):
    """Load an artifact of `export_fused_inference`; returns a callable
    (pc, img, p2) -> the detector's output dict. The artifact runs on the
    device it was traced on, which must be `device` ("cuda" unless the
    caller asks for "cpu"); it raises for another."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    import heterofusionrcnn_torch.ops.library  # noqa: F401  (registers torch.ops.hfr.*)

    exact_float32()
    program = torch.export.load(path)
    devices = {t.device.type for t in program.state_dict.values()}
    if devices != {torch.device(device).type}:
        raise ValueError(f"{path} holds weights on {sorted(devices)}, not on {device!r}")
    # Inference only: no autograd records behind the frozen weights (the
    # kernels have no backward).
    return program.module().requires_grad_(False)
