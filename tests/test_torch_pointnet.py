"""The port's PointNet++ pieces against the JAX package on the CPU: the ball
query and `_first_k_true`, the expanded-distance KNN (k > 16), `three_nn`
and `three_interpolate`, `sort_neighbor_indices` ("l2" and every
"c<permutation>"), and the `SAModule` (ball query, and KNN at k = 32),
`SAModuleMSG`, `FPModule` and `PointNet` modules in eval and train mode.

Inputs come from numpy seeds. The ball query's points lie on a grid of
1/64: every squared distance is a multiple of 1/4096 and exact in float32
on both sides, and each radius^2 lies halfway between two such multiples,
so no pair is nearer than 1.2e-4 to the radius^2 (asserted): rounding of
another summation order cannot move a point across the ball's edge. Ties
of the grid's exact distances go to the lower index on both sides
(`jax.lax.top_k`'s order). Flax variables are drawn from a seed and carried
across by `heterofusionrcnn_torch.convert`.

Tolerances: indices and counts exact; distances and interpolated features
1e-5; module outputs within rtol 1e-4 plus 1e-4 x the output's largest
magnitude, BatchNorm statistics rtol / atol 1e-4; the gradient of the sum
of squares of a module's output within 1e-4 x each tensor's largest
element, 1e-3 x for the whole PointNet in train mode. The outputs' bound
is a share of their scale because training BatchNorms over a few dozen
rows amplify rounding level by level: in the three-level PointNet in train
mode JAX's own float32 output lies up to 2.6e-5 of its largest magnitude
(about 12) from a float64 run of the port (the port's up to 8.8e-6). The
whole PointNet's train-mode gradients resolve more coarsely still: with
the values moved by rounding, a max over the neighbours now and then picks
another of two near-equal neighbours, and the gradient follows the pick.
Against a float64 run of the port at seeds 11-13, JAX's float32 gradients
lie up to 4.3e-4 of a tensor's largest element away, the port's up to
2.6e-4 (`python -m tests.test_torch_pointnet` prints these).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.configs import config as jax_config
from heterofusionrcnn_tpu.models.extractors import pointnet as j_pointnet
from heterofusionrcnn_tpu.ops import grouping as j_grouping
from heterofusionrcnn_tpu.ops import interpolate as j_interpolate

from heterofusionrcnn_torch.configs import config as torch_config
from heterofusionrcnn_torch.convert import flax_to_state_dict, load_flax_variables
from heterofusionrcnn_torch.models.extractors import pointnet as t_pointnet
from heterofusionrcnn_torch.ops import grouping, interpolate

from tests.test_torch_layers import as_jax, random_variables

GRID = 64  # grid points' coordinates are multiples of 1 / GRID
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_SHARE = 1e-4
GRAD_SHARE_TRAINED_STACK = 1e-3  # the whole PointNet in train mode (docstring)


def grid_points(rng, shape, span=2.0):
    """float32 points on the 1/GRID grid in [0, span)^3."""
    return (rng.integers(0, int(span * GRID), shape) / GRID).astype(np.float32)


def grid_radius(m: int) -> float:
    """A radius whose square lies halfway between the grid's squared
    distances m / GRID^2 and (m + 1) / GRID^2."""
    return float(np.sqrt((m + 0.5) / GRID ** 2))


def assert_radius_margin(xyz, new_xyz, radius):
    d = ((new_xyz[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)
    assert np.abs(d - radius * radius).min() >= 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nsample,m", [(8, 300), (32, 2500)])
def test_query_ball_point(nsample, m):
    rng = np.random.default_rng(nsample)
    xyz = grid_points(rng, (2, 300, 3))
    new_xyz = np.concatenate([xyz[:, :40], grid_points(rng, (2, 24, 3))], axis=1)
    radius = grid_radius(m)
    assert_radius_margin(xyz, new_xyz, radius)
    want_idx, want_cnt = j_grouping.query_ball_point(radius, nsample, jnp.asarray(xyz),
                                                     jnp.asarray(new_xyz))
    got_idx, got_cnt = grouping.query_ball_point(radius, nsample, torch.from_numpy(xyz),
                                                 torch.from_numpy(new_xyz))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    cnt = np.asarray(want_cnt)
    assert (cnt == nsample).any() and (cnt < nsample).any()  # full and padded balls
    # Chunking the query axis gives the same result.
    old = grouping._TABLE_CHUNK_ELEMS
    grouping._TABLE_CHUNK_ELEMS = 2 * 300 * 7
    try:
        idx, c = grouping.query_ball_point(radius, nsample, torch.from_numpy(xyz),
                                           torch.from_numpy(new_xyz))
    finally:
        grouping._TABLE_CHUNK_ELEMS = old
    assert torch.equal(idx, got_idx) and torch.equal(c, got_cnt)


def test_first_k_true():
    rng = np.random.default_rng(1)
    mask = rng.random((5, 40)) < 0.2
    mask[1] = False                      # an all-False row gives 0s
    mask[2] = False
    mask[2, [7, 30]] = True              # a short row repeats its first hit
    mask[3] = True                       # more hits than k
    want = j_grouping._first_k_true(jnp.asarray(mask), 6)
    got = grouping._first_k_true(torch.from_numpy(mask), 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][1].tolist() == [0] * 6 and got[0][2].tolist() == [7, 30, 7, 7, 7, 7]


@pytest.mark.parametrize("k", [17, 32])
def test_knn_point_beyond_the_kernel(k):
    """k > 16: the JAX package's expanded-distance top-k on every backend,
    where the port's `knn_point` raised before."""
    rng = np.random.default_rng(k)
    xyz = grid_points(rng, (2, 200, 3))
    new_xyz = xyz[:, :50]
    want_d, want_i = j_grouping.knn_point(k, jnp.asarray(xyz), jnp.asarray(new_xyz))
    got_d, got_i = grouping.knn_point(k, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert got_i.dtype == torch.int32


def test_three_nn_and_interpolate():
    rng = np.random.default_rng(5)
    unknown = rng.standard_normal((2, 300, 3)).astype(np.float32)
    known = rng.standard_normal((2, 70, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 70, 6)).astype(np.float32)
    want_d, want_i = j_interpolate.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    got_d, got_i = interpolate.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    w = rng.random((2, 300, 3)).astype(np.float32)
    want = j_interpolate.three_interpolate(jnp.asarray(feats), want_i, jnp.asarray(w))
    got = interpolate.three_interpolate(torch.from_numpy(feats), got_i, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = j_interpolate.three_interpolate_inverse_distance(
        jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats))
    got = interpolate.three_interpolate_inverse_distance(
        torch.from_numpy(unknown), torch.from_numpy(known), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["l2", "cxyz", "cxzy", "cyxz", "cyzx", "czxy", "czyx"])
def test_sort_neighbor_indices(method):
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((2, 120, 3)).astype(np.float32)
    _, idx = grouping.knn_point(12, torch.from_numpy(pts), torch.from_numpy(pts[:, :40]))
    want = jax.jit(j_grouping.sort_neighbor_indices, static_argnums=2)(
        jnp.asarray(pts), jnp.asarray(idx.numpy()), method)
    got = grouping.sort_neighbor_indices(torch.from_numpy(pts), idx, method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and not torch.equal(got, idx)
    with pytest.raises(ValueError):
        grouping.sort_neighbor_indices(torch.from_numpy(pts), idx, "cxxy")


def _pointnet_configs():
    """A three-level PointNet (ball SA, MSG SA, ball SA) with
    three FP levels and one fc layer (dropout 0), for both packages."""
    out = []
    for lib in (jax_config, torch_config):
        out.append(lib.PointNetConfig(
            sa_modules=[
                lib.SAModuleConfig(npoint=128, radius=grid_radius(1000), nsample=16, mlp=[8, 16]),
                lib.SAModuleConfig(npoint=64, use_msg=True, radii=[grid_radius(2000),
                                                                    grid_radius(5000)],
                                   nsamples=[4, 8], mlps=[[16], [16, 24]]),
                lib.SAModuleConfig(npoint=32, radius=grid_radius(8000), nsample=16, mlp=[24, 32]),
            ],
            fp_modules=[lib.FPModuleConfig([24]), lib.FPModuleConfig([16]),
                        lib.FPModuleConfig([16, 16])],
            fc_layers=[lib.FCLayer(16, 0.0)],
        ))
    return out


def _module_case(name, rng):
    """(JAX module, port module, numpy inputs) of one case."""
    xyz = grid_points(rng, (2, 256, 3))
    fts = rng.standard_normal((2, 256, 4)).astype(np.float32)
    if name == "sa_ball":
        radius = grid_radius(1500)
        return (j_pointnet.SAModule(npoint=64, radius=radius, nsample=16, mlp=(8, 16)),
                t_pointnet.SAModule(4, 64, radius, 16, [8, 16]), (xyz, fts))
    if name == "sa_knn32":
        return (j_pointnet.SAModule(npoint=64, radius=1.0, nsample=32, mlp=(8, 16), use_knn=True),
                t_pointnet.SAModule(4, 64, 1.0, 32, [8, 16], use_knn=True), (xyz, fts))
    if name == "sa_msg":
        radii, ns, mlps = (grid_radius(800), grid_radius(3000)), (8, 16), ((8,), (8, 12))
        return (j_pointnet.SAModuleMSG(npoint=64, radii=radii, nsamples=ns, mlps=mlps),
                t_pointnet.SAModuleMSG(0, 64, radii, ns, mlps), (xyz, None))
    if name == "fp":
        coarse = rng.standard_normal((2, 64, 3)).astype(np.float32)
        f2 = rng.standard_normal((2, 64, 8)).astype(np.float32)
        xyz = rng.standard_normal((2, 256, 3)).astype(np.float32)
        return (j_pointnet.FPModule(mlp=(12, 8)), t_pointnet.FPModule(12, [12, 8]),
                (xyz, coarse, fts, f2))
    jcfg, tcfg = _pointnet_configs()  # one feature channel, as the RPN's intensity
    return j_pointnet.PointNet(config=jcfg), t_pointnet.PointNet(tcfg, 1), (xyz, fts[..., :1])


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["sa_ball", "sa_knn32", "sa_msg", "fp", "pointnet"])
def test_module(name, training):
    rng = np.random.default_rng(11)
    jmod, tmod, args = _module_case(name, rng)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    radii = {"sa_ball": [getattr(tmod, "radius", 0)], "sa_msg": getattr(tmod, "radii", []),
             "pointnet": [grid_radius(m) for m in (1000, 2000, 5000, 8000)]}.get(name, [])
    for r in radii:
        # The FPS centres (and the levels' points) are points of the cloud.
        assert_radius_margin(args[0], args[0], r)
    v = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), *jargs, False), 5)

    def f(params):
        out, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, *jargs,
                              training, mutable=["batch_stats"])
        feats = out[-1] if isinstance(out, tuple) else out
        return jnp.sum(feats * feats), (out, upd["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(as_jax(v["params"]))
    load_flax_variables(tmod, v).train(training)
    got = tmod(*(None if a is None else torch.from_numpy(a) for a in args))
    feats = got[-1] if isinstance(got, tuple) else got
    (feats * feats).sum().backward()
    if isinstance(got, tuple):
        np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(want[0]))
        want = want[-1]
    assert feats.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    want_grads = flax_to_state_dict(grads)
    assert sorted(n for n, _ in tmod.named_parameters()) == sorted(want_grads)
    share = GRAD_SHARE_TRAINED_STACK if (training and name == "pointnet") else GRAD_SHARE
    for n, p in tmod.named_parameters():
        w = want_grads[n]
        bound = share * float(w.abs().max())
        assert float((p.grad - w).abs().max()) <= bound, (n, float((p.grad - w).abs().max()), bound)
    if training:
        sd, want_sd = tmod.state_dict(), flax_to_state_dict({}, stats)
        assert want_sd
        for n, w in want_sd.items():
            np.testing.assert_allclose(sd[n].numpy(), w.numpy(), err_msg=n, **TOL)


def float64_departures(seeds=(11, 12, 13)):
    """The whole PointNet in train mode at each seed: the largest departure
    of JAX's and of the port's float32 output (a share of its largest
    magnitude) and gradients (a share of each tensor's largest element)
    from a float64 run of the port."""
    import copy

    from heterofusionrcnn_torch.ops import grouping as t_grouping

    def stable_smallest_k(d, k):  # the int64 key holds float32 bits only
        s, i = torch.sort(d, dim=-1, stable=True)
        return s[..., :k], i[..., :k].to(torch.int32)

    t_grouping.smallest_k = stable_smallest_k
    for seed in seeds:
        jmod, tmod, args = _module_case("pointnet", np.random.default_rng(seed))
        jargs = [jnp.asarray(a) for a in args]
        v = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), *jargs, False), 5)

        def f(params):
            out, _ = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, *jargs,
                                True, mutable=["batch_stats"])
            return jnp.sum(out[1] * out[1]), out[1]

        (_, jout), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(as_jax(v["params"]))
        runs = {}
        for dt in (torch.float32, torch.float64):
            m = load_flax_variables(copy.deepcopy(tmod), v).train(True).to(dt)
            out = m(*(torch.from_numpy(a).to(dt) for a in args))[1]
            (out * out).sum().backward()
            runs[dt] = (out.detach().double(), {n: p.grad.double() for n, p in m.named_parameters()})
        ref_out, ref = runs[torch.float64]

        def grad_share(g):
            return max(float((g[n] - ref[n]).abs().max() / ref[n].abs().max()) for n in ref)

        scale = float(ref_out.abs().max())
        jax_grads = {n: t.double() for n, t in flax_to_state_dict(jgrads).items()}
        print(f"seed {seed}: output JAX {float((torch.from_numpy(np.asarray(jout)).double() - ref_out).abs().max()) / scale:.3g}"
              f" port {float((runs[torch.float32][0] - ref_out).abs().max()) / scale:.3g};"
              f" gradients JAX {grad_share(jax_grads):.3g} port {grad_share(runs[torch.float32][1]):.3g}")


if __name__ == "__main__":
    float64_departures()
