"""Interactive 3D scene viewer on the PyTorch port's data layer
(counterpart of tools/show_predictions_3d.py, with its flags and files).

Per sample, writes ONE offline .html embedding the lidar cloud, GT boxes
(green), RPN proposals (blue, optional) and final predictions (red, with
scores) plus a ~120-line vanilla-JS canvas renderer: drag to orbit, wheel
to zoom, shift-drag to pan — no mayavi / plotly / network needed. A
`--png` mode renders the same scene statically via matplotlib 3D instead
(the HTML export needs no matplotlib; the PNG mode raises ImportError
where it is not installed, as on the card's machine).

    python tools/torch_show_predictions_3d.py --dataset_dir tests/fixtures/kitti \
        --data_split val --predictions_dir outputs/rcnn_multiclass/predictions \
        --step 3000 --out_dir /tmp/vis3d

Frames come through `heterofusionrcnn_torch.datasets.kitti`. Host only.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np

from heterofusionrcnn_torch.configs import DatasetConfig
from heterofusionrcnn_torch.datasets.kitti import labels as label_io
from heterofusionrcnn_torch.datasets.kitti import pointcloud as pc_lib
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.utils.np_box_ops import box_3d_to_corners

_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]

# Keep the reference demo's colour scheme (show_predictions_3d.py:30-34).
_COLORS = {"gt": "#00ff00", "proposal": "#4488ff", "pred": "#ff3333"}

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#101014;color:#ddd;font:12px monospace}}
#hud{{position:fixed;top:8px;left:8px}}</style></head>
<body><canvas id="c"></canvas><div id="hud">{title} &mdash; drag: orbit,
wheel: zoom, shift-drag: pan</div>
<script>
const DATA = {data_json};
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let yaw=-0.9, pitch=0.45, dist=55, cx=0, cy=0, cz=30;
function resize(){{cv.width=innerWidth;cv.height=innerHeight;draw();}}
addEventListener("resize",resize);
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{{if(!drag)return;const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){{cx-=dx*dist*0.001*Math.cos(yaw)-0;cz+=dy*dist*0.001;}}
 else{{yaw+=dx*0.005;pitch=Math.max(-1.4,Math.min(1.4,pitch+dy*0.005));}}
 drag=[e.clientX,e.clientY,drag[2]];draw();}};
cv.onwheel=e=>{{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();}};
function proj(p){{
 // KITTI camera coords: x right, y down, z forward. View: orbit around
 // (cx, cy, cz) at distance dist.
 const x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
 const sy=Math.sin(yaw), cyw=Math.cos(yaw), sp=Math.sin(pitch), cp=Math.cos(pitch);
 const x1=x*cyw - z*sy, z1=x*sy + z*cyw;
 const y2=y*cp - z1*sp, z2=y*sp + z1*cp + dist;
 if(z2<=0.5)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2 + f*x1/z2, cv.height/2 + f*y2/z2, z2];
}}
function draw(){{
 ctx.fillStyle="#101014";ctx.fillRect(0,0,cv.width,cv.height);
 const pts=DATA.points;
 for(let i=0;i<pts.length;i++){{
  const s=proj(pts[i]); if(!s)continue;
  const h=Math.max(0,Math.min(1,(1.8-pts[i][1])/3));
  ctx.fillStyle=`hsl(${{200-140*h}},80%,${{35+35*h}}%)`;
  ctx.fillRect(s[0],s[1],1.6,1.6);
 }}
 for(const box of DATA.boxes){{
  ctx.strokeStyle=box.color;ctx.lineWidth=box.lw||1.4;ctx.beginPath();
  for(const e of DATA.edges){{
   const a=proj(box.corners[e[0]]), b=proj(box.corners[e[1]]);
   if(!a||!b)continue; ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
  }}
  ctx.stroke();
  if(box.label){{
   const t=proj(box.corners[4]);
   if(t){{ctx.fillStyle=box.color;ctx.fillText(box.label,t[0],t[1]-4);}}
  }}
 }}
}}
resize();
</script></body></html>
"""


def _boxes_payload(boxes_3d, color, labels=None, lw=1.4):
    out = []
    for i, b in enumerate(np.asarray(boxes_3d, np.float64)):
        corners = box_3d_to_corners(b[None])[0]
        out.append(
            {
                "corners": np.round(corners, 3).tolist(),
                "color": color,
                "lw": lw,
                "label": labels[i] if labels is not None else None,
            }
        )
    return out


def export_scene_html(
    out_path,
    points,
    gt_boxes=None,
    proposals=None,
    predictions=None,
    pred_scores=None,
    title="scene",
    max_points=60000,
):
    """Write a self-contained interactive HTML 3D scene.

    Args:
      points: (N, >=3) camera-frame points.
      gt_boxes / proposals / predictions: (n, 7) box_3d arrays (optional).
      pred_scores: (n,) scores rendered above each prediction box.
    """
    pts = np.asarray(points)[:, :3]
    if len(pts) > max_points:
        pts = pts[:: -(-len(pts) // max_points)]  # ceil step
    boxes = []
    if gt_boxes is not None and len(gt_boxes):
        boxes += _boxes_payload(gt_boxes, _COLORS["gt"])
    if proposals is not None and len(proposals):
        boxes += _boxes_payload(proposals, _COLORS["proposal"], lw=0.8)
    if predictions is not None and len(predictions):
        labels = (
            [f"{s:.2f}" for s in pred_scores]
            if pred_scores is not None
            else None
        )
        boxes += _boxes_payload(predictions, _COLORS["pred"], labels, lw=1.8)
    data = {
        "points": np.round(pts, 2).tolist(),
        "boxes": boxes,
        "edges": _EDGES,
    }
    with open(out_path, "w") as f:
        f.write(
            _HTML_TEMPLATE.format(title=title, data_json=json.dumps(data))
        )


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError (naming
    matplotlib) where it is not installed, as on the card's machine."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def export_scene_png(out_path, points, gt_boxes=None, predictions=None,
                     max_points=20000, title="scene"):
    """Static matplotlib-3D render of the same scene."""
    plt = _pyplot()

    pts = np.asarray(points)[:, :3]
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points]
    fig = plt.figure(figsize=(12, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.3, c=-pts[:, 1],
               cmap="viridis")
    for arr, color in ((gt_boxes, "lime"), (predictions, "red")):
        if arr is None:
            continue
        for b in np.asarray(arr):
            c = box_3d_to_corners(b[None])[0]
            for a, e in _EDGES:
                ax.plot([c[a, 0], c[e, 0]], [c[a, 2], c[e, 2]],
                        [-c[a, 1], -c[e, 1]], color=color, linewidth=1.0)
    ax.set_title(title)
    ax.set_box_aspect((2, 2, 0.5))
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def _load_predictions(pred_dir, step, split, sample_name):
    """The final rows the RCNN evaluator wrote for the frame (JAX's tool
    reads them from final_predictions_and_scores/<step>, where no
    evaluator writes)."""
    path = os.path.join(pred_dir, "final_predictions_and_scores", split,
                        str(step), sample_name + ".txt")
    if not os.path.exists(path):
        return None
    arr = np.loadtxt(path, ndmin=2)
    return arr if arr.size else None


def _load_proposals(pred_dir, step, split, sample_name):
    path = os.path.join(pred_dir, "proposals_and_scores", split, str(step),
                        sample_name + ".txt")
    if not os.path.exists(path):
        return None
    arr = np.loadtxt(path, ndmin=2)
    return arr if arr.size else None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--data_split", default="val")
    parser.add_argument("--predictions_dir", default=None)
    parser.add_argument("--step", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--max_samples", type=int, default=10)
    parser.add_argument("--score_threshold", type=float, default=0.1)
    parser.add_argument("--show_proposals", action="store_true")
    parser.add_argument("--png", action="store_true",
                        help="static matplotlib renders instead of HTML")
    args = parser.parse_args(argv)

    # The frames of --data_split (JAX's tool shows the config's default
    # split, train, whatever --data_split says).
    cfg = DatasetConfig(dataset_dir=args.dataset_dir, data_split=args.data_split)
    ds = KittiDataset(cfg, "val")
    os.makedirs(args.out_dir, exist_ok=True)

    names = sorted({s.name for s in ds.sample_list})[: args.max_samples]
    for sample_name in names:
        gt = label_io.read_labels(ds.label_dir, int(sample_name))
        gt = label_io.filter_labels(gt, ds.classes)
        gt_boxes = (
            np.stack([label_io.object_label_to_box_3d(o) for o in gt])
            if gt
            else np.zeros((0, 7))
        )
        pc = pc_lib.get_lidar_point_cloud(
            int(sample_name), ds.calib_dir, ds.velo_dir
        )

        preds = scores = props = None
        if args.predictions_dir and args.step:
            arr = _load_predictions(args.predictions_dir, args.step,
                                    args.data_split, sample_name)
            if arr is not None:
                keep = arr[:, 7] >= args.score_threshold
                preds, scores = arr[keep, :7], arr[keep, 7]
            if args.show_proposals:
                parr = _load_proposals(args.predictions_dir, args.step,
                                       args.data_split, sample_name)
                if parr is not None:
                    props = parr[:, :7]

        if args.png:
            out = os.path.join(args.out_dir, sample_name + ".png")
            export_scene_png(out, pc, gt_boxes, preds, title=sample_name)
        else:
            out = os.path.join(args.out_dir, sample_name + ".html")
            export_scene_html(
                out, pc, gt_boxes, props, preds, scores, title=sample_name
            )
        print("wrote", out)


if __name__ == "__main__":
    main()
