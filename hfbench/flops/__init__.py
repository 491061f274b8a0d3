"""Operations and bytes of the model's dense products, counted from the
configuration alone, so that the count stays the same whatever kernel or
library computes them.

One multiply-add counts 2 operations. Counted: convolutions and
transposed convolutions, the XConv's lifts, X-transform, X @ in and its
composed separable product, the PointNet++ shared MLPs, every Dense and
head. Not counted: KNN, FPS, NMS, ball query, three-NN, gathers, BatchNorm,
activations, the bilinear image crop; their time shows in the `_ms`
metrics.

`xconv_calls` and `xconv_call_cost` follow `chip_smoke.py`'s `xconv_row`
(the fused XConv's per-query operations and its bytes: points, queries,
indices, features, weights and the output, each read or written once), so
the XConv roofline here is the one the kernel table reports.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 on the tensor cores
# The float32-grade products run as three TF32 products (3xTF32).
TF32_PRODUCTS = 3
# The peak each compute dtype is held to (mfu): float32's products run as
# 3xTF32 on the tensor cores, so a third of TF32's rate; bf16's dense rate.
PEAK_FLOPS_PER_S = {"float32": TF32_FLOPS_PER_S / TF32_PRODUCTS, "bfloat16": 989e12}


@dataclass(frozen=True)
class XConvCall:
    """One XConv (or XDConv) call: b sets of n candidate points with cp
    feature channels, p queries, k neighbours, cf lifted channels,
    cin = cf + cp, d outputs; `with_x` the X-transform; `global_c` the
    width of the global branch on the queries (0: none)."""

    b: int
    n: int
    p: int
    k: int
    cf: int
    cp: int
    d: int
    with_x: bool
    global_c: int = 0

    @property
    def cin(self) -> int:
        return self.cf + self.cp


def xconv_calls(pcfg, in_channels: int, b: int, n: int) -> List[XConvCall]:
    """The XConv calls of a PointCNN config on b sets of n points with
    `in_channels` input features, in the order the forward makes them
    (the channel arithmetic of `models/extractors/pointcnn.py`)."""
    xconvs, xdconvs = pcfg.xconv_layers, pcfg.xdconv_layers
    calls, out_ch, pts = [], [in_channels], [n]
    for i, lp in enumerate(xconvs):
        if i == 0:
            cf = lp.C // 2 if in_channels == 0 else lp.C // 4
        else:
            cf = xconvs[i - 1].C // 4
        p = pts[-1] if lp.P == -1 else lp.P
        glob = lp.C // 4 if pcfg.with_global and i == len(xconvs) - 1 else 0
        calls.append(XConvCall(b, pts[-1], p, lp.K, cf, out_ch[-1], lp.C,
                               pcfg.with_X_transformation, glob))
        pts.append(p)
        out_ch.append(lp.C + glob)
    for i, lp in enumerate(xdconvs):
        c_fts = out_ch[lp.pts_layer_idx + 1] if i == 0 else out_ch[-1]
        c = xconvs[lp.qrs_layer_idx].C
        cf = xconvs[lp.pts_layer_idx].C // 4
        calls.append(XConvCall(b, pts[lp.pts_layer_idx + 1], pts[lp.qrs_layer_idx + 1], lp.K,
                               cf, c_fts, c, pcfg.with_X_transformation))
        out_ch.append(c)
    return calls


def xconv_per_query_flops(c: XConvCall) -> int:
    """Lift-1 (3 -> cf) and lift-2 (cf -> cf) per neighbour, X @ in and the
    composed separable product (k cin -> d), and with the X-transform its
    three layers: 2 k (3 cf + cf^2 + k cin + cin d) + 10 k^3
    (chip_smoke.py `xconv_row`, `per_q`)."""
    k, cf, cin, d = c.k, c.cf, c.cin, c.d
    per_q = k * (2 * 3 * cf + 2 * cf * cf + 2 * k * cin + 2 * cin * d)
    if c.with_x:
        per_q += 2 * 3 * k * k * k + 2 * 2 * k * k * k
    return per_q


def xconv_weight_elems(c: XConvCall) -> int:
    """Elements of the folded weights the fused op reads: the two lifts
    with their affines, Wc (k, cin, d) and its affine, and the X-transform's
    three layers with theirs (`ops/xconv.py` `XConvWeights`)."""
    k, cf, cin, d = c.k, c.cf, c.cin, c.d
    n = 3 * cf + 2 * cf + cf * cf + 2 * cf + k * cin * d + 2 * d
    if c.with_x:
        n += 3 * k * k * k + 2 * k * k + 2 * (k * k * k + 2 * k * k)
    return n


def xconv_call_cost(c: XConvCall):
    """(operations, bytes) of one fused XConv call, as the kernel table
    counts them: the operations of its products, and points, features,
    queries, int32 indices, the output and the weights once each."""
    flops = float(c.b * c.p * xconv_per_query_flops(c))
    nbytes = 4 * (c.b * c.n * (3 + c.cp) + c.b * c.p * (3 + c.k + c.d)) + 4 * xconv_weight_elems(c)
    return flops, nbytes


def xconv_bound_s(calls: List[XConvCall]) -> float:
    """Least time of the fused XConv calls on one H100: per call the larger
    of its bytes over HBM's rate and 3x its operations over TF32's peak
    (3xTF32), summed (chip_smoke.py `add_bound`)."""
    total = 0.0
    for c in calls:
        flops, nbytes = xconv_call_cost(c)
        total += max(nbytes / HBM_BYTES_PER_S, TF32_PRODUCTS * flops / TF32_FLOPS_PER_S)
    return total


def dense(rows: int, cin: int, cout: int) -> float:
    """A Dense of cin -> cout over `rows` rows."""
    return 2.0 * rows * cin * cout


def conv3x3(h: int, w: int, cin: int, cout: int, b: int) -> float:
    """A 3x3 convolution over b maps of h x w outputs (a stride-2
    transposed one counts its h x w inputs: each feeds 9 outputs)."""
    return 2.0 * b * h * w * cin * cout * 9


def pointcnn_flops(pcfg, in_channels: int, b: int, n: int) -> float:
    """The PointCNN's dense products: every XConv (lifts, X-transform,
    X @ in, the separable product, the global branch), each XDConv's fuse
    Dense, and the fc layers."""
    calls = xconv_calls(pcfg, in_channels, b, n)
    total = 0.0
    for c in calls:
        total += c.b * c.p * xconv_per_query_flops(c)
        if c.global_c:
            total += dense(c.b * c.p, 3, c.global_c) + dense(c.b * c.p, c.global_c, c.global_c)
    n_x = len(pcfg.xconv_layers)
    out_ch = [in_channels] + [c.d + c.global_c for c in calls[:n_x]]
    for i, lp in enumerate(pcfg.xdconv_layers):
        c = calls[n_x + i]
        total += dense(c.b * c.p, c.d + out_ch[lp.qrs_layer_idx + 1], c.d)
    width = calls[-1].d + calls[-1].global_c
    rows = calls[-1].b * calls[-1].p
    for fc in pcfg.fc_layers:
        total += dense(rows, width, fc.C)
        width = fc.C
    return total


def pointcnn_out(pcfg, in_channels: int, n: int):
    """(points, channels) of a PointCNN's output."""
    calls = xconv_calls(pcfg, in_channels, 1, n)
    width = pcfg.fc_layers[-1].C if pcfg.fc_layers else calls[-1].d + calls[-1].global_c
    return calls[-1].p, width


def pointnet_flops(ncfg, in_channels: int, b: int, n: int) -> float:
    """PointNet++: each SA level's shared MLP over its npoint x nsample
    grouped rows (3 + C inputs), each FP level's over the dense level's
    points, the fc layers."""
    total, chans, pts = 0.0, [in_channels], [n]
    for sa in ncfg.sa_modules:
        if sa.use_msg:
            raise NotImplementedError("multi-scale grouping is not counted")
        width = 3 + chans[-1]
        for f in sa.mlp:
            total += dense(b * sa.npoint * sa.nsample, width, f)
            width = f
        chans.append(sa.mlp[-1])
        pts.append(sa.npoint)
    c = chans[-1]
    levels = len(ncfg.sa_modules)
    for i, fp in enumerate(ncfg.fp_modules):
        level = levels - 1 - i
        width = c + chans[level]
        for f in fp.mlp:
            total += dense(b * pts[level], width, f)
            width = f
        c = fp.mlp[-1]
    out_pts = pts[levels - len(ncfg.fp_modules)]
    for fc in ncfg.fc_layers:
        total += dense(b * out_pts, c, fc.C)
        c = fc.C
    return total


def pointnet_out(ncfg, in_channels: int, n: int):
    """(points, channels) of a PointNet++'s output."""
    pts = [n] + [sa.npoint for sa in ncfg.sa_modules]
    c = ncfg.fp_modules[-1].mlp[-1] if ncfg.fp_modules else ncfg.sa_modules[-1].mlp[-1]
    if ncfg.fc_layers:
        c = ncfg.fc_layers[-1].C
    return pts[len(ncfg.sa_modules) - len(ncfg.fp_modules)], c


def vgg_pyr_flops(vcfg, b: int, h: int, w: int) -> float:
    """The VGG pyramid on b images of h x w (after `downsample`): four conv
    blocks with ceil-mode 2x2 pools between them, three transposed convs
    and three fusion convs back up."""
    if vcfg.downsample > 1:
        h, w = h // vcfg.downsample, w // vcfg.downsample
    sizes = [(h, w)]
    for _ in range(3):
        sizes.append((math.ceil(sizes[-1][0] / 2), math.ceil(sizes[-1][1] / 2)))
    total, cin = 0.0, 3
    blocks = [vcfg.vgg_conv1, vcfg.vgg_conv2, vcfg.vgg_conv3, vcfg.vgg_conv4]
    for (repeats, filters), (hh, ww) in zip(blocks, sizes):
        for _ in range(repeats):
            total += conv3x3(hh, ww, cin, filters, b)
            cin = filters
    c1, c2, c3, c4 = (blk[1] for blk in blocks)
    total += conv3x3(*sizes[3], c4, c3, b) + conv3x3(*sizes[2], c3 + c3, c2, b)
    total += conv3x3(*sizes[2], c2, c2, b) + conv3x3(*sizes[1], c2 + c2, c1, b)
    total += conv3x3(*sizes[1], c1, c1, b) + conv3x3(*sizes[0], c1 + c1, c1, b)
    return total


def rpn_head_out_dim(rpn_cfg, k: int) -> int:
    """The bin head's width: (2 nbx + 2 nbz + 2 nbt + 4) K."""
    nbx = int(2 * rpn_cfg[0][0] / rpn_cfg[1][0])
    return (nbx * 2 + nbx * 2 + rpn_cfg[2] * 2 + 4) * k


def rpn_flops(mc, b: int, num_classes: int) -> float:
    """The RPN's dense products on b frames: the point extractor, the VGG
    pyramid, the segmentation head, the fc layers and the bin head."""
    lc, ic, rc = mc.layers_config, mc.input_config, mc.rpn_config
    n = ic.pc_sample_pts
    cin = 1 if rc.rpn_use_intensity_feature else 0
    if lc.pc_extractor_type == "pointcnn":
        total = pointcnn_flops(lc.pc_pointcnn, cin, b, n)
        p_out, c_pc = pointcnn_out(lc.pc_pointcnn, cin, n)
    else:
        total = pointnet_flops(lc.pc_pointnet, cin, b, n)
        p_out, c_pc = pointnet_out(lc.pc_pointnet, cin, n)
    total += vgg_pyr_flops(lc.img_vgg_pyr, b, ic.img_dims_h, ic.img_dims_w)
    rows = b * p_out
    total += dense(rows, c_pc, num_classes + 1)
    c = c_pc + lc.img_vgg_pyr.vgg_conv1[1] if rc.rpn_fusion_method == "concat" else c_pc
    for fc in lc.rpn_fc_layers:
        total += dense(rows, c, fc.C)
        c = fc.C
    head = rpn_head_out_dim((rc.rpn_xz_search_range, rc.rpn_xz_bin_len, rc.rpn_theta_bin_num),
                            num_classes)
    return total + dense(rows, c, head)


def rcnn_flops(mc, rpn_mc, b: int, num_classes: int) -> float:
    """The RCNN's dense products on b frames of `rpn_test_post_nms_size`
    proposals (the VGG pass is stage 1's when `rcnn_use_rpn_img_feature_map`):
    the crop MLP, the stage-2 PointCNN, the cls and reg fc stacks and heads."""
    lc, rc = mc.layers_config, mc.rcnn_config
    nb = b * rpn_mc.rpn_config.rpn_test_post_nms_size
    r = rc.rcnn_proposal_roi_crop_size
    total = 0.0
    if not rc.rcnn_use_rpn_img_feature_map:
        total += vgg_pyr_flops(lc.img_vgg_pyr, b, mc.input_config.img_dims_h,
                               mc.input_config.img_dims_w)
    c = 6 if rc.rcnn_use_intensity_feature else 5
    for fc in lc.rcnn_mlp_layers:
        total += dense(nb * r, c, fc.C)
        c = fc.C
    in_ch = _rcnn_in_channels(mc, rpn_mc)
    total += pointcnn_flops(lc.rcnn_pc_pointcnn, in_ch, nb, r)
    p_out, c_out = pointcnn_out(lc.rcnn_pc_pointcnn, in_ch, r)
    c_img = lc.img_vgg_pyr.vgg_conv1[1]
    r1 = rc.rcnn_proposal_roi_img_crop_size
    if rc.rcnn_fusion_method == "mean_concat":
        c_fuse = c_out + c_img
    else:
        c_fuse = p_out * c_out + r1 * r1 * c_img
    for _ in ("cls", "reg"):
        c = c_fuse
        for fc in lc.rcnn_fc_layers:
            total += dense(nb, c, fc.C)
            c = fc.C
    head = rpn_head_out_dim((rc.rcnn_xz_search_range, rc.rcnn_xz_bin_len, rc.rcnn_theta_bin_num),
                            num_classes)
    return total + dense(nb, c, num_classes + 1) + dense(nb, c, head)


def _rcnn_in_channels(mc, rpn_mc) -> int:
    """The stage-2 PointCNN's input features: stage 1's per-point features
    and gathered image features, and the crop MLP's output."""
    rpn_lc, rpn_cfg = rpn_mc.layers_config, rpn_mc.rpn_config
    n = rpn_mc.input_config.pc_sample_pts
    cin = 1 if rpn_cfg.rpn_use_intensity_feature else 0
    if rpn_lc.pc_extractor_type == "pointcnn":
        c_pc1 = pointcnn_out(rpn_lc.pc_pointcnn, cin, n)[1]
    else:
        c_pc1 = pointnet_out(rpn_lc.pc_pointnet, cin, n)[1]
    c = 6 if mc.rcnn_config.rcnn_use_intensity_feature else 5
    for fc in mc.layers_config.rcnn_mlp_layers:
        c = fc.C
    return c_pc1 + rpn_lc.img_vgg_pyr.vgg_conv1[1] + c


def rcnn_xconv_calls(mc, rpn_mc, b: int):
    """The stage-2 PointCNN's XConv calls on b frames' proposals."""
    nb = b * rpn_mc.rpn_config.rpn_test_post_nms_size
    return xconv_calls(mc.layers_config.rcnn_pc_pointcnn, _rcnn_in_channels(mc, rpn_mc), nb,
                       mc.rcnn_config.rcnn_proposal_roi_crop_size)


def iteration_flops(model: str, cfgs, batch: int, num_classes: int, train: bool) -> float:
    """The dense operations of one iteration of a cell: a forward of the
    `model` ("two_stage" or "rpn") on `batch` frames; a train step counts
    forward and backward as 3x the forward's products."""
    rpn_mc = cfgs["rpn"].model_config
    total = rpn_flops(rpn_mc, batch, num_classes)
    if model == "two_stage":
        total += rcnn_flops(cfgs["rcnn"].model_config, rpn_mc, batch, num_classes)
    return 3.0 * total if train else total


def iteration_xconv_calls(model: str, cfgs, batch: int) -> List[XConvCall]:
    """The fused XConv calls of one forward of `model` on `batch` frames."""
    rpn_mc = cfgs["rpn"].model_config
    lc = rpn_mc.layers_config
    calls = []
    if lc.pc_extractor_type == "pointcnn":
        cin = 1 if rpn_mc.rpn_config.rpn_use_intensity_feature else 0
        calls += xconv_calls(lc.pc_pointcnn, cin, batch, rpn_mc.input_config.pc_sample_pts)
    if model == "two_stage":
        calls += rcnn_xconv_calls(cfgs["rcnn"].model_config, rpn_mc, batch)
    return calls
