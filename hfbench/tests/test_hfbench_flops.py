"""`hfbench/flops` against hand counts at the port's unittest widths, and
the full-width XConv bound against the kernel table's (PERF.md: 9.6101 ms
for a batch-4 two-stage forward)."""

from __future__ import annotations

import os

import hfbench_cells
from hfbench import flops, harness


def small_configs():
    return harness.reference_configs(harness.load_json(
        os.path.join(hfbench_cells.TESTS, "configs", "pointcnn_unittest.json")))


def test_first_xconv_by_hand():
    """rpn_unittest's xconv_1: 2048 queries of 2048 points, K 8, C 32, one
    intensity channel: cf = 32 / 4 = 8, cin = 9. A query: k (2 * 3 cf +
    2 cf^2 + 2 k cin + 2 cin d) + 10 k^3 = 8 (48 + 128 + 144 + 576) + 5120."""
    pcfg = small_configs()["rpn"].model_config.layers_config.pc_pointcnn
    c = flops.xconv_calls(pcfg, 1, 1, 2048)[0]
    assert (c.n, c.p, c.k, c.cf, c.cp, c.d) == (2048, 2048, 8, 8, 1, 32)
    assert flops.xconv_call_cost(c)[0] == 2048 * (8 * (48 + 128 + 144 + 576) + 5120)
    weights = 3 * 8 + 2 * 8 + 8 * 8 + 2 * 8 + 8 * 9 * 32 + 2 * 32 + 5 * 8 ** 3 + 6 * 8 ** 2
    assert flops.xconv_call_cost(c)[1] == 4 * (2048 * 4 + 2048 * (3 + 8 + 32)) + 4 * weights


def test_xconv_shapes_by_hand():
    """Queries, candidates and input channels of each of rpn_unittest's
    XConv calls: P -1/512/128/32, then XDConvs (3->2), (2->1), (1->0), (0->0)."""
    pcfg = small_configs()["rpn"].model_config.layers_config.pc_pointcnn
    shapes = [(c.n, c.p, c.cf, c.cp, c.d, c.global_c) for c in flops.xconv_calls(pcfg, 1, 1, 2048)]
    assert shapes == [
        (2048, 2048, 8, 1, 32, 0), (2048, 512, 8, 32, 32, 0), (512, 128, 8, 32, 64, 0),
        (128, 32, 16, 64, 64, 16),
        (32, 128, 16, 80, 64, 0), (128, 512, 16, 64, 32, 0),
        (512, 2048, 8, 32, 32, 0), (2048, 2048, 8, 32, 32, 0),
    ]


def test_vgg_by_hand():
    """rpn_unittest's VGG pyramid on one 120 x 384 image: blocks of one conv
    (8, 16, 32, 64 filters) at 120x384, 60x192, 30x96, 15x48, three
    transposed convs and three fusion convs back up."""
    v = small_configs()["rpn"].model_config.layers_config.img_vgg_pyr
    terms = [(120, 384, 3, 8), (60, 192, 8, 16), (30, 96, 16, 32), (15, 48, 32, 64),
             (15, 48, 64, 32), (30, 96, 64, 16), (30, 96, 16, 16), (60, 192, 32, 8),
             (60, 192, 8, 8), (120, 384, 16, 8)]
    assert flops.vgg_pyr_flops(v, 1, 120, 384) == sum(2 * h * w * i * o * 9 for h, w, i, o in terms)


def test_pointnet_by_hand():
    """The PointNet++ unittest config: SA levels 512/128/32/8 centres of 8
    samples, then four FP levels and two fc layers, on 2048 points."""
    cfg = harness.reference_configs(harness.load_json(
        os.path.join(hfbench_cells.TESTS, "configs", "pointnet_unittest.json")))["rpn"]
    n = cfg.model_config.layers_config.pc_pointnet
    sa = (512 * 8 * (4 * 8 + 8 * 8 + 8 * 16) + 128 * 8 * (19 * 16 + 16 * 16 + 16 * 32)
          + 32 * 8 * (35 * 32 + 32 * 32 + 32 * 64) + 8 * 8 * (67 * 32 + 32 * 32 + 32 * 64))
    fp = (32 * (128 * 32 + 32 * 32) + 128 * (64 * 32 + 32 * 32) + 512 * (48 * 32 + 32 * 16)
          + 2048 * (17 * 16 + 16 * 16 + 16 * 16))
    fc = 2048 * (16 * 32 + 32 * 32)
    assert flops.pointnet_flops(n, 1, 1, 2048) == 2 * (sa + fp + fc)


def test_full_width_xconv_bound_is_the_kernel_tables():
    cfg = harness.reference_configs(harness.load_json(
        os.path.join(harness.HERE, "configs", "pointcnn_multiclass_f32.json")))
    calls = flops.iteration_xconv_calls("two_stage", cfg, 4)
    assert len(calls) == 15
    assert abs(flops.xconv_bound_s(calls) * 1e3 - 9.6101) < 1e-4
