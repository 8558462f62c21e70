"""The port's fused early stages vs the JAX package's, on the CPU at small
sizes.

On the CPU the port's ``run_stem``, ``run_block`` and ``fused_mbconv`` run
their plain PyTorch versions; the JAX side runs the Pallas kernels
themselves in interpret mode (``run_stage(..., interpret=True)``,
``pltpu.force_tpu_interpret_mode()`` around ``fused_mbconv``), compiled with
``xla_allow_excess_precision=False`` so that XLA's CPU compiler rounds bf16
where the kernels say so. Inputs, weights and BatchNorm statistics are made
with numpy from a seed and handed to both. What is compared, and how closely:

- plans (``plan_fused_stages``) and folded weights (``fold_block_weights``,
  ``fold_stem_weights``, ``fold_mbconv_params``; the JAX side's grouped and
  padded arrays un-grouped, the padding checked to be zero): **equal**;
- block, chain, stem and prototype outputs against the Pallas kernels:
  within ``STEPS`` bf16 steps of the value, ``|a − b| ≤ STEPS · 2⁻⁷ ·
  max(|b|, 1)`` — the rounding points are the same, the sums run in another
  order, so now and then a bf16 rounding of ``e``, ``d·se`` or the output
  falls the other way;
- the same outputs against the unfused flax block in float32 at the JAX
  tests' own ``atol=0.02, rtol=0.05`` (0.03 for the chain).

Every interpret-mode result is fetched (``jax.device_get``) before anything
else is dispatched.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepfake_vit_tpu.models import efficientnet as jeff
from deepfake_vit_tpu.models.fused_backbone import FusedBackboneRunner as JRunner
from deepfake_vit_tpu.models.fused_backbone import plan_fused_stages as j_plan
from deepfake_vit_tpu.ops.pallas import fused_stages as jfs
from deepfake_vit_tpu.ops.pallas.fused_mbconv import fold_mbconv_params as j_fold_mbconv
from deepfake_vit_tpu.ops.pallas.fused_mbconv import fused_mbconv as j_fused_mbconv
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables, to_numpy_tree
from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone, MBConvBlock
from deepfake_vit_tpu_torch.models.fused_backbone import FusedBackboneRunner, plan_fused_stages
from deepfake_vit_tpu_torch.ops import fused_mbconv as tmb
from deepfake_vit_tpu_torch.ops import fused_stages as tfs

torch.set_num_threads(1)

STEPS = 2  # bf16 steps between the port's plain versions and the Pallas kernels

BLOCK_SHAPES = [  # kernel, stride, cin, cout, expand, h_in
    (3, 1, 16, 16, 6, 16),    # residual, k3
    (3, 2, 16, 24, 6, 32),    # stride 2, k3
    (5, 1, 24, 24, 6, 16),    # k5 taps
    (5, 2, 24, 40, 6, 32),    # stride 2, k5
    (3, 1, 32, 16, 1, 16),    # no expansion
]
BLOCK_IDS = ["k3s1-residual", "k3s2", "k5s1", "k5s2", "no-expand"]


def _args(kernel, stride, cin, cout, expand):
    return dict(kernel=kernel, stride=stride, expand_ratio=expand, in_filters=cin,
                out_filters=cout, se_ratio=0.25)


def _jit_rounding(fn, *args):
    """Run ``fn`` jitted with ``xla_allow_excess_precision=False`` and fetch
    the result (see tests/test_torch_int8.py)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return jax.device_get(compiled(*args))


def _random_stats(stats, rng):
    """BatchNorm statistics away from the identity: mean N(0, 0.2), var in [0.5, 1.1)."""
    def leaf(path, x):
        v = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return jnp.asarray(np.abs(v) + 0.5 if path[-1].key == "var" else v)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _flax_block(args, h, seed):
    """A flax MBConvBlock with seeded weights and randomized statistics, and
    the port's block carrying the same variables."""
    rng = np.random.default_rng(seed)
    blk = jeff.MBConvBlock(**args)
    v = jax.jit(blk.init)(jax.random.PRNGKey(seed),
                          jnp.zeros((1, h, h, args["in_filters"]), jnp.float32))
    v = {"params": v["params"], "batch_stats": _random_stats(v["batch_stats"], rng)}
    tblk = load_flax_variables(MBConvBlock(**args), to_numpy_tree(v)).eval()
    return blk, v, tblk


def _b0_backbone(seed):
    """Flax b0 backbone variables (seeded, randomized statistics) and the
    port's backbone carrying them."""
    rng = np.random.default_rng(seed)
    jbb = jeff.EfficientNetBackbone(variant="b0")
    v = jax.jit(jbb.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    v = {"params": v["params"], "batch_stats": _random_stats(v["batch_stats"], rng)}
    return v, load_flax_variables(EfficientNetBackbone("b0"), to_numpy_tree(v)).eval()


@pytest.fixture(scope="module")
def b0_backbone():
    return _b0_backbone(7)


def _pad_lanes(x_nhwc):
    """NHWC float → the JAX kernels' lane-padded NCHW bf16."""
    x = jnp.transpose(jnp.asarray(x_nhwc), (0, 3, 1, 2))
    return jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, jfs.LANES - x.shape[-1]))).astype(jnp.bfloat16)


def _from_padded(out, w_valid):
    """(B, C, h, 128) bf16 → NHWC float32 numpy."""
    return np.transpose(np.asarray(out[..., :w_valid].astype(np.float32)), (0, 2, 3, 1))


def _f32(t):
    return np.asarray(t).astype(np.float32)


def _ungroup(weights, bp):
    """The JAX side's grouped, padded block weights in the port's flat
    shapes; asserts that everything beyond ``cexp`` is zero."""
    w_exp, b_exp, taps, b_dw, w_se1, b_se1, w_se2, b_se2, w_proj, b_proj = map(_f32, weights)
    G, grp = bp.n_groups, bp.group

    def cut(a, axis):
        keep, pad = np.split(a, [bp.cexp], axis=axis)
        assert not pad.any(), "padding beyond cexp is not zero"
        return keep

    return [
        cut(w_exp.reshape(G * grp, bp.cin), 0),
        cut(b_exp.reshape(-1), 0),
        cut(taps.transpose(1, 0, 2).reshape(bp.kernel ** 2, G * grp), 1),
        cut(b_dw.reshape(-1), 0),
        cut(w_se1.transpose(1, 0, 2).reshape(bp.cse, G * grp), 1),
        b_se1.reshape(-1),
        cut(w_se2, 0),
        cut(b_se2.reshape(-1), 0),
        cut(w_proj.transpose(1, 0, 2).reshape(bp.cout, G * grp), 1),
        b_proj.reshape(-1),
    ]


def _assert_steps(got, ref, steps=STEPS):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    excess = np.abs(got - ref) - steps * 2.0 ** -7 * np.maximum(np.abs(ref), 1.0)
    assert excess.max() <= 0, (f"{(excess > 0).sum()} of {ref.size} beyond {steps} bf16 steps, "
                               f"worst |diff| {np.abs(got - ref).max()}")


# ---------------------------------------------------------------------------
# Plans and folded weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,size,min_h", [("b0", 64, 8), ("b4", 192, 14), ("b4", 224, 14)])
def test_plans_match_jax(variant, size, min_h):
    plans, tail = plan_fused_stages(variant, size, min_h)
    jplans, jtail = j_plan(variant, size, min_h)
    assert tail == jtail and len(plans) == len(jplans)
    for (p, idxs), (jp, jidxs) in zip(plans, jplans):
        assert idxs == jidxs
        assert (p.h_in, p.h_out, p.stem, p.c_stem) == (jp.h_in, jp.h_out, jp.stem, jp.c_stem)
        for b, jb in zip(p.blocks, jp.blocks):
            for f in ("kernel", "stride", "cin", "cexp", "cse", "cout", "has_expand", "residual"):
                assert getattr(b, f) == getattr(jb, f), f
    if (variant, size) == ("b4", 192):
        assert tail == 10 and [i for _, idx in plans for i in idx] == list(range(10))
    if (variant, size) == ("b4", 224):
        assert tail == 22 and plans[-1][0].h_out == 14


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=BLOCK_IDS)
def test_folded_block_weights_equal_jax(shape):
    kernel, stride, cin, cout, expand, h = shape
    args = _args(kernel, stride, cin, cout, expand)
    _, v, tblk = _flax_block(args, h, seed=kernel + stride + cin)
    jbp = jfs.block_plan_from_args(args)
    want = _ungroup(jfs.fold_block_weights(v["params"], v["batch_stats"], jbp), jbp)
    got = tfs.fold_block_weights(tblk, tfs.block_plan_from_args(args))
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * 7 + [torch.bfloat16,
                                                                             torch.float32]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.float().numpy(), w, err_msg=f"weight {i}")


def test_folded_stem_and_prototype_weights_equal_jax(b0_backbone):
    v, bb = b0_backbone
    jw, jb = jfs.fold_stem_weights(v["params"], v["batch_stats"])
    w, b = tfs.fold_stem_weights(bb)
    assert w.dtype == torch.bfloat16 and w.shape == (32, 27)
    np.testing.assert_array_equal(w.float().numpy(), _f32(jw))
    np.testing.assert_array_equal(b.numpy(), _f32(jb).reshape(-1))

    for idx, expand in ((0, 1), (1, 6)):  # block 0 has no expand conv
        want = j_fold_mbconv(v["params"][f"block_{idx}"], v["batch_stats"][f"block_{idx}"],
                                      expand)
        got = tmb.fold_mbconv_params(getattr(bb, f"block_{idx}"), expand)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), _f32(want[k]), err_msg=f"block {idx} {k}")
    assert tmb.fold_bn is not None  # re-exported from models/quant.py


# ---------------------------------------------------------------------------
# Blocks, chain and stem against the Pallas kernels and the flax modules
# ---------------------------------------------------------------------------


def _jax_stage(plan, xin, weights):
    return _jit_rounding(lambda x, *w: jfs.run_stage(plan, x, list(w), interpret=True),
                         xin, *weights)


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=BLOCK_IDS)
def test_single_block_matches_pallas_and_flax(shape):
    kernel, stride, cin, cout, expand, h = shape
    args = _args(kernel, stride, cin, cout, expand)
    blk, v, tblk = _flax_block(args, h, seed=kernel * 7 + stride)
    x = np.random.default_rng(h + cin).normal(0, 1, (2, h, h, cin)).astype(np.float32)

    jbp = jfs.block_plan_from_args(args)
    plan = jfs.StagePlan(blocks=(jbp,), h_in=h)
    xin = _pad_lanes(x)
    if stride == 2:
        xin = jfs.space_to_depth_phases(xin, w_valid=h)
    pallas = _from_padded(_jax_stage(plan, xin, jfs.fold_block_weights(
        v["params"], v["batch_stats"], jbp)), plan.h_out)
    flax_ref = np.asarray(blk.apply(v, jnp.asarray(x)))

    bp = tfs.block_plan_from_args(args)
    before = tfs.run_block.launches
    got = tfs.run_stage(tfs.StagePlan(blocks=(bp,), h_in=h), torch.from_numpy(x).to(torch.bfloat16),
                        tfs.fold_block_weights(tblk, bp))
    assert tfs.run_block.launches == before  # the CPU runs the plain version: no launch
    assert got.dtype == torch.bfloat16 and got.shape == (2, h // stride, h // stride, cout)
    got = got.float().numpy()
    _assert_steps(got, pallas)
    np.testing.assert_allclose(got, flax_ref, atol=0.02, rtol=0.05)
    # The port's own unfused module, float32, as a third view of the same block.
    with torch.no_grad():
        own = tblk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, own, atol=0.02, rtol=0.05)


def test_three_block_chain_matches_pallas_and_flax():
    """A stride-2 entry and two stride-1 residual blocks, chained."""
    h = 32
    argses = [_args(3, 2, 16, 24, 6), _args(3, 1, 24, 24, 6), _args(3, 1, 24, 24, 6)]
    made = [_flax_block(a, h if i == 0 else h // 2, seed=20 + i) for i, a in enumerate(argses)]
    x = np.random.default_rng(5).normal(0, 1, (2, h, h, 16)).astype(np.float32)

    flax_ref = jnp.asarray(x)
    for blk, v, _ in made:
        flax_ref = blk.apply(v, flax_ref)
    jbps = tuple(jfs.block_plan_from_args(a) for a in argses)
    jw = []
    for jbp, (_, v, _) in zip(jbps, made):
        jw += jfs.fold_block_weights(v["params"], v["batch_stats"], jbp)
    xin = jfs.space_to_depth_phases(_pad_lanes(x), w_valid=h)
    pallas = _from_padded(_jax_stage(jfs.StagePlan(blocks=jbps, h_in=h), xin, jw), h // 2)

    bps = tuple(tfs.block_plan_from_args(a) for a in argses)
    tw = []
    for bp, (_, _, tblk) in zip(bps, made):
        tw += tfs.fold_block_weights(tblk, bp)
    got = tfs.run_stage(tfs.StagePlan(blocks=bps, h_in=h), torch.from_numpy(x).to(torch.bfloat16),
                        tw).float().numpy()
    # Three blocks deep: a one-step difference of block 1 is an input
    # difference of blocks 2 and 3, so the limit is per block.
    _assert_steps(got, pallas, steps=3 * STEPS)
    np.testing.assert_allclose(got, np.asarray(flax_ref), atol=0.03, rtol=0.05)


def test_stem_and_first_block_match_pallas_and_flax(b0_backbone):
    """The stem and block 0 (no expand conv) at b0 widths on 32² images."""
    h, stem_c = 32, 32
    v, bb = b0_backbone
    imgs = np.random.default_rng(11).normal(0, 0.5, (2, h, h, 3)).astype(np.float32)

    y = nn.Conv(stem_c, (3, 3), strides=(2, 2), padding="SAME", use_bias=False).apply(
        {"params": {"kernel": v["params"]["stem_conv"]["kernel"]}}, jnp.asarray(imgs))
    bn, st = v["params"]["stem_bn"], v["batch_stats"]["stem_bn"]
    y = jax.nn.silu((y - st["mean"]) / jnp.sqrt(st["var"] + jeff._BN_EPS) * bn["scale"] + bn["bias"])
    args0 = dict(jeff.block_args("b0")[0])
    flax_ref = np.asarray(jeff.MBConvBlock(**args0).apply(
        {"params": v["params"]["block_0"], "batch_stats": v["batch_stats"]["block_0"]}, y))

    jbp = jfs.block_plan_from_args(args0)
    jplan = jfs.StagePlan(blocks=(jbp,), h_in=h, stem=True, c_stem=stem_c)
    jw = jfs.fold_stem_weights(v["params"], v["batch_stats"]) + jfs.fold_block_weights(
        v["params"]["block_0"], v["batch_stats"]["block_0"], jbp)
    stem_only = jfs.StagePlan(blocks=(), h_in=h, stem=True, c_stem=stem_c)
    xin = jfs.space_to_depth_stem(jnp.asarray(imgs))
    pallas_stem = _from_padded(_jax_stage(stem_only, xin, jw[:2]), h // 2)
    pallas = _from_padded(_jax_stage(jplan, xin, jw), h // 2)

    bp = tfs.block_plan_from_args(args0)
    tw = tfs.fold_stem_weights(bb) + tfs.fold_block_weights(bb.block_0, bp)
    x16 = torch.from_numpy(imgs).to(torch.bfloat16)
    stem = tfs.run_stem(x16, tw[:2])
    assert stem.shape == (2, h // 2, h // 2, stem_c) and stem.dtype == torch.bfloat16
    _assert_steps(stem.float().numpy(), pallas_stem, steps=1)
    np.testing.assert_allclose(stem.float().numpy(), np.asarray(y), atol=0.02, rtol=0.05)
    got = tfs.run_stage(tfs.StagePlan(blocks=(bp,), h_in=h, stem=True, c_stem=stem_c), x16,
                        tw).float().numpy()
    _assert_steps(got, pallas)
    np.testing.assert_allclose(got, flax_ref, atol=0.02, rtol=0.05)


@pytest.mark.parametrize("cin,cout,exp,H", [(32, 32, 6, 28), (24, 24, 1, 28)],
                         ids=["expand-residual", "no-expand"])
def test_prototype_matches_pallas_and_flax(cin, cout, exp, H):
    args = _args(3, 1, cin, cout, exp)
    blk, v, tblk = _flax_block(args, H, seed=cin + exp)
    x = np.random.default_rng(cin).normal(0, 1, (2, H, H, cin)).astype(np.float32)
    flax_ref = np.asarray(blk.apply(v, jnp.asarray(x)))
    folded = j_fold_mbconv(v["params"], v["batch_stats"], exp)
    with pltpu.force_tpu_interpret_mode():
        compiled = j_fused_mbconv.lower(jnp.asarray(x), folded, H, H, exp).compile(
            compiler_options={"xla_allow_excess_precision": False})
        pallas = jax.device_get(compiled(jnp.asarray(x), folded)).astype(np.float32)

    tfolded = tmb.fold_mbconv_params(tblk, exp)
    got = tmb.fused_mbconv(torch.from_numpy(x), tfolded, exp)
    assert got.dtype == torch.bfloat16 and got.shape == (2, H, H, cout)
    assert torch.equal(got, tmb.fused_mbconv_plain(torch.from_numpy(x), tfolded, exp))
    got = got.float().numpy()
    _assert_steps(got, pallas)
    err = np.abs(got - flax_ref)
    assert err.max() < 0.05 * max(np.abs(flax_ref).mean(), 1.0) and err.mean() < 0.01
    # The two designs round at different points: they are close, not equal.
    bp = tfs.block_plan_from_args(args)
    stage = tfs.run_block(bp, torch.from_numpy(x).to(torch.bfloat16),
                          tfs.fold_block_weights(tblk, bp)).float().numpy()
    np.testing.assert_allclose(got, stage, atol=0.02, rtol=0.05)


def test_runner_matches_jax_runner_b0():
    """The whole b0 runner at 64² (stem + blocks 0-5, ``min_fused_h=8``)
    against the JAX runner in interpret mode, compiled as one graph (about
    17 s on one CPU core)."""
    v, bb = _b0_backbone(13)
    imgs = np.random.default_rng(13).normal(0, 0.5, (2, 64, 64, 3)).astype(np.float32)
    jrunner = JRunner("b0", v["params"], v["batch_stats"], image_size=64, min_fused_h=8)
    ref = _jit_rounding(lambda x: jrunner(x, interpret=True), jnp.asarray(imgs, jnp.bfloat16))
    runner = FusedBackboneRunner(bb, image_size=64, min_fused_h=8)
    assert runner.tail_start == jrunner.tail_start
    got = runner(torch.from_numpy(imgs)).float().numpy()
    _assert_steps(got, np.asarray(ref, np.float32), steps=runner.n_blocks * STEPS)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def test_fused_wrappers_validate_and_count_only_launches():
    args = _args(3, 1, 16, 16, 6)
    _, _, tblk = _flax_block(args, 8, seed=1)
    bp = tfs.block_plan_from_args(args)
    w = tfs.fold_block_weights(tblk, bp)
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16)
    counts = (tfs.run_stem.launches, tfs.run_block.launches, tmb.fused_mbconv.launches)

    with pytest.raises(TypeError):
        tfs.run_block(bp, x.float(), w)
    with pytest.raises(ValueError, match="NHWC"):
        tfs.run_block(bp, x[..., :8], w)
    with pytest.raises(ValueError, match="w_proj"):
        tfs.run_block(bp, x, w[:8] + [w[8].float(), w[9]])
    with pytest.raises(ValueError, match="weight tensors"):
        tfs.run_block(bp, x, w[:9])
    odd = tfs.BlockPlan(**{**bp.__dict__, "stride": 2, "residual": False})
    with pytest.raises(ValueError, match="even"):
        tfs.run_block(odd, torch.zeros((1, 7, 7, 16), dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="k3/k5"):
        tfs.run_block(tfs.BlockPlan(**{**bp.__dict__, "kernel": 7}), x,
                      w[:2] + [torch.zeros(49, 96)] + w[3:])
    wide = tfs.BlockPlan(kernel=3, stride=1, cin=16, cexp=96, cse=4, cout=200, has_expand=True,
                         residual=False)
    with pytest.raises(ValueError, match="exceeds"):
        tfs.run_block(wide, x, w[:8] + [torch.zeros(200, 96, dtype=torch.bfloat16),
                                        torch.zeros(200)])
    with pytest.raises(ValueError, match="w_exp"):
        tfs.run_block(bp, x, [w[0].to("meta")] + w[1:])  # weights on another device

    sw = [torch.zeros((32, 27), dtype=torch.bfloat16), torch.zeros(32)]
    img = torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tfs.run_stem(img.float(), sw)
    with pytest.raises(ValueError, match="even"):
        tfs.run_stem(img[:, :7], sw)
    with pytest.raises(ValueError):
        tfs.run_stem(img, [sw[0].float(), sw[1]])

    folded = tmb.fold_mbconv_params(tblk, 6)
    with pytest.raises(TypeError):
        tmb.fused_mbconv(x.to(torch.int8), folded, 6)
    with pytest.raises(ValueError, match="3×3"):
        tmb.fused_mbconv(x, {**folded, "w_dw": torch.zeros(5, 5, 96)}, 6)
    with pytest.raises(ValueError, match="lack"):
        tmb.fused_mbconv(x, {k: t for k, t in folded.items() if k != "b_se2"}, 6)

    # CPU tensors run the plain versions: outputs come back, nothing is counted.
    assert tfs.run_block(bp, x, w).shape == (1, 8, 8, 16)
    assert tfs.run_stem(img, sw).shape == (1, 4, 4, 32)
    assert tmb.fused_mbconv(x, folded, 6).shape == (1, 8, 8, 16)
    assert counts == (tfs.run_stem.launches, tfs.run_block.launches, tmb.fused_mbconv.launches)
    assert tfs.block_smem_bytes(tfs.block_plan_from_args(_args(5, 1, 160, 160, 6))) < 232448
    with pytest.raises(ValueError, match="block 23"):  # b6 at 224²: cout 200 at 14²
        FusedBackboneRunner(EfficientNetBackbone("b6"), image_size=224)
