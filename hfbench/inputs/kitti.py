"""The benchmark's KITTI inputs: the 13 frames under tests/fixtures/kitti,
read with numpy and the standard library only.

A frozen copy of the port's data layer (`datasets/kitti/`): the velodyne
read and its frustum filter to the camera image, the near/far sampling of
a fixed number of points, the horizontal flip, the PNG decode, the
bilinear resize (cv2's INTER_LINEAR arithmetic) with P2 rescaled, and the
RPN's per-point segmentation and regression labels. It imports nothing of
the port, so a change to the port's loader cannot move these inputs, and
it checks every file it reads against the sha256 in `fixtures.json`.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "kitti", "training")
# Decoded images, by the sha256 of their PNG bytes.
DECODE_CACHE = os.path.join(REPO, ".bench_cache", "decoded_png")
CLASSES = ("Car", "Pedestrian", "Cyclist")
NEAR_DEPTH = 40.0        # the sampler keeps every point at least this far
EXPAND_GT_SIZE = 0.2     # the labels' ignore ring around each GT box
INTENSITY_SHIFT = 0.5    # intensities enter the model in [-0.5, 0.5]

_X_SIGNS = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
_Z_SIGNS = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)
_Y_TOP = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.float32)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COEF_SCALE = 2048


class FixtureMismatch(RuntimeError):
    """A fixture file is missing or differs from its recorded sha256."""


def fixture_files(frame: str) -> Dict[str, str]:
    """The files of one frame, by kind."""
    return {kind: os.path.join(FIXTURE_DIR, kind, frame + ext)
            for kind, ext in (("velodyne", ".bin"), ("image_2", ".png"),
                              ("calib", ".txt"), ("label_2", ".txt"))}


def expected_hashes() -> Dict[str, str]:
    """{relative path: sha256} of every file the loader reads."""
    with open(os.path.join(HERE, "fixtures.json")) as f:
        return json.load(f)["sha256"]


def frame_names() -> List[str]:
    """The frames, in the order `fixtures.json` lists them."""
    with open(os.path.join(HERE, "fixtures.json")) as f:
        return list(json.load(f)["frames"])


def read_checked(path: str, want: Dict[str, str]) -> bytes:
    """The bytes of `path`, refused unless their sha256 is the recorded one."""
    rel = os.path.relpath(path, REPO)
    if rel not in want:
        raise FixtureMismatch(f"{rel} has no recorded sha256")
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FixtureMismatch(f"{rel}: {e}") from e
    got = hashlib.sha256(data).hexdigest()
    if got != want[rel]:
        raise FixtureMismatch(f"{rel}: sha256 {got}, recorded {want[rel]}")
    return data


# ----------------------------------------------------------------- calib

def parse_calib(text: str) -> Dict[str, np.ndarray]:
    rows = [line.split() for line in text.splitlines() if line.split()]
    p2 = np.array([float(v) for v in rows[2][1:]], np.float64).reshape(3, 4)
    r0 = np.array([float(v) for v in rows[4][1:]], np.float64).reshape(3, 3)
    tr = np.array([float(v) for v in rows[5][1:]], np.float64).reshape(3, 4)
    return {"p2": p2, "r0_rect": r0, "tr_velo_to_cam": tr}


def lidar_to_rect(xyz: np.ndarray, calib) -> np.ndarray:
    r0 = np.eye(4)
    r0[:3, :3] = calib["r0_rect"]
    tr = np.eye(4)
    tr[:3, :] = calib["tr_velo_to_cam"]
    homog = np.hstack([xyz, np.ones((xyz.shape[0], 1))])
    return (r0 @ tr @ homog.T).T[:, :3]


def project(points: np.ndarray, p: np.ndarray) -> np.ndarray:
    homog = np.hstack([points, np.ones((points.shape[0], 1))])
    proj = (p @ homog.T).T
    return proj[:, :2] / proj[:, 2:3]


def frustum_points(velo: bytes, calib, im_w: int, im_h: int) -> np.ndarray:
    """Velodyne points in the rectified camera frame, in front of the
    camera and inside the image: (N, 4) [x, y, z, intensity] float32."""
    xyzi = np.frombuffer(velo, np.float32).reshape(-1, 4)
    pts = lidar_to_rect(xyzi[:, :3], calib)
    intensity = xyzi[:, 3]
    front = pts[:, 2] > 0
    pts, intensity = pts[front], intensity[front]
    uv = project(pts, calib["p2"])
    keep = (uv[:, 0] > 0) & (uv[:, 0] < im_w) & (uv[:, 1] > 0) & (uv[:, 1] < im_h)
    return np.hstack([pts[keep], intensity[keep][:, None]]).astype(np.float32)


# ----------------------------------------------------------------- image

def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_sequential(kind: int, line: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB, non-interlaced PNG bytes -> (H, W, 3) uint8."""
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour != 2 or interlace != 0:
        raise ValueError(f"unsupported PNG: depth {depth}, colour {colour}, interlace {interlace}")
    bpp, stride = 3, w * 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data size does not match its header")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(kind, line.tobytes(), prev.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, bpp)


def _linear_coeffs(n_in: int, n_out: int):
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s + 1 >= n_in
    f[high], s[high] = 0, n_in - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return s, np.minimum(s + 1, n_in - 1), w0, w1


def resize_bilinear(image: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 with cv2.resize's INTER_LINEAR
    fixed-point arithmetic."""
    sx0, sx1, a0, a1 = _linear_coeffs(image.shape[1], w)
    sy0, sy1, b0, b1 = _linear_coeffs(image.shape[0], h)
    x = image.astype(np.int64)
    horiz = x[:, sx0] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]
    t0 = ((horiz[sy0] >> 4) * b0[:, None, None]) >> 16
    t1 = ((horiz[sy1] >> 4) * b1[:, None, None]) >> 16
    return np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- labels

def parse_labels(text: str):
    """(boxes (m, 7) [x, y, z, l, w, h, ry] float32, classes (m,) int32,
    1-based) of the objects of `CLASSES`."""
    boxes, classes = [], []
    for line in text.splitlines():
        p = line.split()
        if not p or p[0] not in CLASSES:
            continue
        h, w, l = float(p[8]), float(p[9]), float(p[10])
        boxes.append([float(p[11]), float(p[12]), float(p[13]), l, w, h, float(p[14])])
        classes.append(CLASSES.index(p[0]) + 1)
    return np.asarray(boxes, np.float32).reshape(-1, 7), np.asarray(classes, np.int32)


def box_corners(box: np.ndarray) -> np.ndarray:
    box = np.asarray(box, np.float32)
    l, w, h, ry = box[3], box[4], box[5], box[6]
    x_c = 0.5 * l * _X_SIGNS
    z_c = 0.5 * w * _Z_SIGNS
    y_c = h * _Y_TOP
    c, s = np.cos(ry), np.sin(ry)
    corners = np.stack([x_c * c + z_c * s, y_c, -x_c * s + z_c * c], axis=-1)
    return corners + box[0:3]


def points_in_box(points: np.ndarray, box: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    corners = box_corners(box)
    p2 = corners[1]
    d = points - p2

    def interval(axis):
        proj = d @ axis
        return (proj >= -eps) & (proj <= float(axis @ axis) + eps)

    return interval(corners[0] - p2) & interval(corners[2] - p2) & interval(corners[5] - p2)


def rpn_labels(pts: np.ndarray, boxes: np.ndarray, classes: np.ndarray):
    """Per point: the class of the GT box it lies in (0 background, -1 in
    the expanded ring around a box) and that box."""
    n = pts.shape[0]
    cls = np.zeros(n, np.int32)
    reg = np.zeros((n, 7), np.float32)
    extended = boxes.copy()
    extended[:, 3:6] += EXPAND_GT_SIZE * 2
    extended[:, 1] += EXPAND_GT_SIZE
    for k in range(boxes.shape[0]):
        fg = points_in_box(pts, boxes[k])
        cls[fg] = classes[k]
        reg[fg] = boxes[k]
        cls[np.logical_xor(fg, points_in_box(pts, extended[k]))] = -1
    return cls.astype(np.float32), reg


# ----------------------------------------------------------------- frames

def decoded_png(data: bytes) -> np.ndarray:
    """`decode_png`, kept by the PNG's sha256 under `DECODE_CACHE` in the
    checkout so that only a checkout's first run decodes."""
    path = os.path.join(DECODE_CACHE, hashlib.sha256(data).hexdigest() + ".npy")
    if os.path.exists(path):
        return np.load(path)
    image = decode_png(data)
    os.makedirs(DECODE_CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, image)
    os.replace(tmp, path)
    return image


def load_frames(names=None) -> Dict[str, dict]:
    """Every frame's decoded files, each checked against its sha256 first:
    {name: {"points", "image", "p2", "boxes", "classes"}}."""
    want = expected_hashes()
    frames = {}
    for name in names or frame_names():
        files = fixture_files(name)
        raw = {kind: read_checked(path, want) for kind, path in files.items()}
        calib = parse_calib(raw["calib"].decode())
        image = decoded_png(raw["image_2"])
        boxes, classes = parse_labels(raw["label_2"].decode())
        frames[name] = {
            "points": frustum_points(raw["velodyne"], calib, image.shape[1], image.shape[0]),
            "image": image, "p2": calib["p2"], "boxes": boxes, "classes": classes,
        }
    return frames


def depth_stratified_sample(points: np.ndarray, num_points: int, rng: np.random.Generator):
    """`num_points` rows: every far (z >= 40 m) point and the rest drawn
    from the near ones without replacement; a small cloud is oversampled."""
    n = len(points)
    if num_points < n:
        near = points[:, 2] < NEAR_DEPTH
        far_idx, near_idx = np.flatnonzero(~near), np.flatnonzero(near)
        need = num_points - len(far_idx)
        if need <= 0:
            choice = rng.choice(far_idx, num_points, replace=False)
        else:
            choice = np.concatenate([rng.choice(near_idx, need, replace=False), far_idx])
        rng.shuffle(choice)
    else:
        choice = np.arange(n, dtype=np.int64)
        if num_points > n:
            extra = rng.choice(choice, num_points - n, replace=num_points > 2 * n)
            choice = np.concatenate([choice, extra])
        rng.shuffle(choice)
    return points[choice]


def make_sample(frame: dict, rng: np.random.Generator, num_points: int, img_w: int,
                img_h: int, flip: bool, labels: bool,
                resized_cache: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """One model input of `frame`: its sampled points (intensity shifted),
    the image flipped if `flip` and resized to (img_h, img_w), P2 to
    match; with `labels` the per-point labels and the GT boxes.
    `resized_cache` keeps each (frame, flip)'s resized image for reuse."""
    pc = depth_stratified_sample(frame["points"], num_points, rng).copy()
    pc[:, 3] -= INTENSITY_SHIFT
    image, p2, boxes = frame["image"], frame["p2"].copy(), frame["boxes"].copy()
    if flip:
        image = np.fliplr(image)
        pc[:, 0] = -pc[:, 0]
        p2[0, 2] = frame["image"].shape[1] - p2[0, 2]
        p2[0, 3] = -p2[0, 3]
        above = boxes[:, 6] >= 0
        boxes[above, 6] = np.pi - boxes[above, 6]
        boxes[~above, 6] = -np.pi - boxes[~above, 6]
        boxes[:, 0] = -boxes[:, 0]
    key = (id(frame), flip, img_w, img_h)
    if resized_cache is not None and key in resized_cache:
        resized = resized_cache[key]
    else:
        resized = resize_bilinear(np.ascontiguousarray(image), img_w, img_h).astype(np.float32)
        if resized_cache is not None:
            resized_cache[key] = resized
    p2[0, :] *= img_w / image.shape[1]
    p2[1, :] *= img_h / image.shape[0]
    out = {"point_cloud": pc.astype(np.float32), "image_input": resized,
           "stereo_calib_p2": p2.astype(np.float32)}
    if labels:
        seg, reg = rpn_labels(pc[:, :3], boxes, frame["classes"])
        out.update(label_seg=seg, label_reg=reg, label_boxes=boxes)
    return out
