"""The port's train-mode model and train step vs the JAX package's, on a
small b0 (64² faces, head [16]) with the same seeded weights and batch,
in float32 on the CPU.

Dropout rates are 0 and drop-connect is off on both sides (JAX's
``_drop_connect`` is patched to the identity here, in the test; the
package is untouched), so the two runs are deterministic and comparable:

- the train-mode forward: logits and features within 1e-4 of their
  largest value, the moved running statistics within 1e-5;
- one step's gradients against ``jax.value_and_grad`` of JAX
  ``_forward_loss``: per leaf max |Δ| ≤ 1e-3 · max(max |g_leaf|,
  1e-3 · max |g|). The floor is for the leaves whose gradient is zero
  analytically — the bias of a BatchNorm whose output reaches the next
  train-mode BatchNorm through a linear map, which subtracts the batch
  mean again — where both packages hold float noise of about 1e-8 of the
  largest gradient. ``grad_norm`` within 1e-4 relative.
- whole steps: three SGD-Nesterov steps, three AdamW steps with clipping,
  and an accumulation-2 step, each against JAX ``make_train_step``:
  parameters within 1e-4 of their leaf's scale (at least 1), running
  statistics within 1e-4. Under AdamW the analytically-zero leaves above
  move by Adam's normalized noise, up to lr a step in either package in
  either direction; they are held to 2 · steps · lr instead.

In bf16 (the configuration's ``use_amp``), the port against the JAX
package's bf16, each compiled with ``xla_allow_excess_precision=False``
so that XLA rounds where the TPU does:

- an MBConv block's train-mode forward and backward alone (a seeded
  input and output probe; blocks 0, 1, 2 and 15): output, input gradient
  and parameter gradients within 0.0125 of the reference's L2 norm
  (measured 0.0089-0.0102). The same
  block with every convolution's output and gradient rounded to 6
  significant bits, a quarter of bf16's precision, is over the limit
  (0.0141-0.0179), which the test asserts.
- one whole step: loss within 0.1 relative (measured 0.043), grad_norm
  within 0.25 (0.10), 1 − the gradients' cosine within 0.35 (0.158). At
  the seeded init a bf16 rounding anywhere moves the whole gradient this
  far (JAX's bf16 step against its float32 step: 0.018, 0.073, 0.11), so
  these limits catch gross faults only; the blocks hold the precision.

Then the port alone: ``remat=True`` gives the step ``remat=False``
gives, the running statistics included; dropout and drop-connect keep
1 − rate, scale by 1/(1 − rate), and drop-connect draws one mask a
sample; a step after a checkpoint round trip is the step without one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepfake_vit_tpu.models.efficientnet as jeff
from deepfake_vit_tpu.models.feature_extractor import DeepfakeDetectionModel as JModel
from deepfake_vit_tpu.training import create_optimizer as jcreate_optimizer
from deepfake_vit_tpu.training import make_criterion as jmake_criterion
from deepfake_vit_tpu.training.train_state import TrainState as JState
from deepfake_vit_tpu.training.train_state import _forward_loss as j_forward_loss
from deepfake_vit_tpu.training.train_state import make_train_step as jmake_train_step
from deepfake_vit_tpu_torch.models.bridge import export_flax_variables, load_flax_variables
from deepfake_vit_tpu_torch.models.feature_extractor import DeepfakeDetectionModel
from deepfake_vit_tpu_torch.models.layers import Conv, drop_connect, dropout, init_weights
from deepfake_vit_tpu_torch.training import TrainState, create_optimizer, make_criterion
from deepfake_vit_tpu_torch.training import make_train_step
from deepfake_vit_tpu_torch.training.train_state import _forward_loss
from deepfake_vit_tpu_torch.training.trainer import Trainer
from deepfake_vit_tpu_torch.utils.io_utils import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

B, S, HEAD = 8, 64, (16,)
LOSS = {"type": "CombinedLoss"}
CLASS_WEIGHTS = np.array([0.8, 1.3], np.float32)
SGD = {"type": "SGD", "lr": 1e-2, "momentum": 0.9, "nesterov": True}
ADAMW = {"type": "AdamW", "lr": 1e-4, "weight_decay": 1e-4}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(0, 1, (B, S, S, 3)).astype(np.float32),
             "label": np.array([0, 1, 1, 0, 1, 1, 0, 0], np.int32),
             "landmarks": rng.uniform(8, 56, (B, 5, 2)).astype(np.float32)}
    jm = JModel(variant="b0", classifier_hidden_dims=HEAD, dropout_rate=0.0,
                feature_dropout_rate=0.0)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                         jnp.asarray(batch["image"]), jnp.asarray(batch["landmarks"]))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    return jm, v, batch


@pytest.fixture
def no_jax_drop_connect(monkeypatch):
    monkeypatch.setattr(jeff, "_drop_connect", lambda x, rate, deterministic, rng: x)


def _port_model(variables):
    m = DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=HEAD, dropout_rate=0.0,
                               feature_dropout_rate=0.0)
    m = load_flax_variables(m, variables)
    m.feature_extractor.backbone.drop_connect_rate = 0.0
    return m


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(kp): np.asarray(x, np.float64)
            for kp, x in jax.tree_util.tree_leaves_with_path(tree)}


def _grads_tree(module):
    shadow = copy.deepcopy(module)
    with torch.no_grad():
        for p, q in zip(module.parameters(), shadow.parameters()):
            q.copy_(p.grad)
    return export_flax_variables(shadow)["params"]


def test_train_forward_and_gradients_match(setup, no_jax_drop_connect):
    jm, v, batch = setup
    jcrit = jmake_criterion(LOSS, jnp.asarray(CLASS_WEIGHTS))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    @jax.jit
    def reference(params):
        grad_fn = jax.value_and_grad(
            lambda p: j_forward_loss(jm, jcrit, p, v["batch_stats"], jb, jax.random.PRNGKey(2),
                                     True), has_aux=True)
        (loss, (stats, metrics)), grads = grad_fn(params)
        (logits, feats), _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                      jb["image"], jb["landmarks"], train=True,
                                      return_features=True, rngs={"dropout": jax.random.PRNGKey(2)},
                                      mutable=["batch_stats"])
        return loss, stats, metrics, grads, logits, feats

    jloss, jstats, jmetrics, jgrads, jlogits, jfeats = jax.tree_util.tree_map(
        np.asarray, reference(v["params"]))

    model = _port_model(v).train()
    crit = make_criterion(LOSS, torch.from_numpy(CLASS_WEIGHTS))
    tb = _tbatch(batch)
    logits, feats = model(tb["image"], tb["landmarks"])
    for port, ref in ((logits, jlogits), (feats, jfeats)):
        err = np.abs(port.detach().numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, err
    model = _port_model(v).train()
    loss, metrics = _forward_loss(model, crit, tb, torch.Generator(), True)
    loss.backward()
    for k in jmetrics:
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 1e-5 * max(1.0, abs(float(jmetrics[k]))), k

    stats, ref_stats = _flat(export_flax_variables(model)["batch_stats"]), _flat(jstats)
    assert set(stats) == set(ref_stats)
    assert max(np.abs(stats[k] - ref_stats[k]).max() for k in stats) <= 1e-5

    grads, ref_grads = _flat(_grads_tree(model)), _flat(jgrads)
    assert set(grads) == set(ref_grads)
    gmax = max(np.abs(g).max() for g in ref_grads.values())
    worst = max((np.abs(grads[k] - ref_grads[k]).max()
                 / max(np.abs(ref_grads[k]).max(), 1e-3 * gmax), k) for k in ref_grads)
    assert worst[0] <= 1e-3, worst
    norm = lambda t: np.sqrt(sum((g ** 2).sum() for g in t.values()))  # noqa: E731
    assert abs(norm(grads) - norm(ref_grads)) <= 1e-4 * norm(ref_grads)


def _j_steps(jm, v, batch, opt_cfg, clip, n, accumulation=1):
    tx = jcreate_optimizer(opt_cfg, gradient_clip=clip)
    state = JState.create(v["params"], v["batch_stats"], jax.jit(tx.init)(v["params"]))
    step = jmake_train_step(jm, jmake_criterion(LOSS, jnp.asarray(CLASS_WEIGHTS)), tx,
                            accumulation_steps=accumulation, donate=False)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    metrics = []
    for _ in range(n):
        state, m = step(state, jb, jax.random.PRNGKey(5))
        metrics.append(jax.tree_util.tree_map(float, m))
    return state, metrics


def _t_steps(v, batch, opt_cfg, clip, n, accumulation=1, remat=False):
    model = _port_model(v)
    opt = create_optimizer(model.parameters(), opt_cfg, gradient_clip=clip)
    step = make_train_step(model, make_criterion(LOSS, torch.from_numpy(CLASS_WEIGHTS)), opt,
                           accumulation_steps=accumulation, remat=remat)
    state = TrainState()
    metrics = [{k: float(x) for k, x in step(state, batch, 5).items()} for _ in range(n)]
    assert state.step == n
    return model, opt, metrics


@pytest.mark.parametrize("name,opt_cfg,clip,n,accumulation", [
    ("sgd", SGD, None, 3, 1), ("adamw", ADAMW, 1.0, 3, 1), ("sgd_accum2", SGD, None, 1, 2)])
def test_whole_steps_match(setup, no_jax_drop_connect, name, opt_cfg, clip, n, accumulation):
    jm, v, batch = setup
    jstate, jmetrics = _j_steps(jm, v, batch, opt_cfg, clip, n, accumulation)
    model, _, metrics = _t_steps(v, batch, opt_cfg, clip, n, accumulation)
    for jm_, m in zip(jmetrics, metrics):
        assert abs(m["loss"] - jm_["loss"]) <= 1e-4 * abs(jm_["loss"])
        assert abs(m["grad_norm"] - jm_["grad_norm"]) <= 1e-4 * jm_["grad_norm"]
    got = export_flax_variables(model)
    params, ref = _flat(got["params"]), _flat(jax.device_get(jstate.params))
    # Leaves with an analytically zero gradient (see the module docstring).
    zero_grad = set()
    if opt_cfg["type"] != "SGD":
        g = _flat(_grads_tree(model))
        gmax = max(np.abs(x).max() for x in g.values())
        zero_grad = {k for k, x in g.items() if np.abs(x).max() < 1e-5 * gmax}
    for k in ref:
        err = np.abs(params[k] - ref[k]).max()
        if k in zero_grad:
            assert err <= 2 * n * opt_cfg["lr"], (k, err)
        else:
            assert err <= 1e-4 * max(np.abs(ref[k]).max(), 1.0), (k, err)
    stats, ref_stats = _flat(got["batch_stats"]), _flat(jax.device_get(jstate.batch_stats))
    assert max(np.abs(stats[k] - ref_stats[k]).max() for k in ref_stats) <= 1e-4


def _jit_rounding(fn, *args):
    """``fn`` jitted with ``xla_allow_excess_precision=False``: by default
    XLA's CPU compiler keeps bf16 intermediates in float32."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return jax.device_get(compiled(*args))


def _coarse_convs(model, bits):
    """Every convolution's output and its gradient rounded to ``bits``
    significant bits (bf16 keeps 8): a control below bf16's precision."""
    drop = 24 - bits

    def coarse(x):
        i = x.float().view(torch.int32)
        return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32).to(x.dtype)

    class Coarse(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return coarse(x)

        @staticmethod
        def backward(ctx, g):
            return coarse(g)

    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(lambda module, inputs, out: Coarse.apply(out))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _sorted_leaves(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for _, x in sorted(
        jax.tree_util.tree_leaves_with_path(tree), key=lambda t: jax.tree_util.keystr(t[0]))])


@pytest.mark.parametrize("idx", [0, 1, 2, 15])  # no expansion, stride 2, residual, the last
def test_bf16_block_matches_jax_bf16_block(setup, idx):
    _, v, _ = setup
    args = jeff.block_args("b0")[idx]
    size = S // 2 // int(np.prod([a["stride"] for a in jeff.block_args("b0")[:idx]]))
    rng = np.random.default_rng(idx)
    x = rng.normal(0, 1, (B, size, size, args["in_filters"])).astype(np.float32)
    out = size // args["stride"]
    probe = rng.normal(0, 1, (B, out, out, args["out_filters"])).astype(np.float32)
    params = v["params"]["feature_extractor"]["backbone"][f"block_{idx}"]
    stats = v["batch_stats"]["feature_extractor"]["backbone"][f"block_{idx}"]
    block = jeff.MBConvBlock(**args, dtype=jnp.bfloat16)

    def f(p, xb):
        y, _ = block.apply({"params": p, "batch_stats": stats}, xb, train=True,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * probe), y

    (_, jy), (jgp, jgx) = _jit_rounding(jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
                                        params, jnp.asarray(x, jnp.bfloat16))
    ref = (np.asarray(jy, np.float32), np.asarray(jgx, np.float32), _sorted_leaves(jgp))

    def port(bits=None):
        m = load_flax_variables(DeepfakeDetectionModel(
            variant="b0", classifier_hidden_dims=HEAD, dtype=torch.bfloat16), v)
        if bits:
            _coarse_convs(m, bits)
        blk = getattr(m.feature_extractor.backbone, f"block_{idx}").train()
        blk.drop_rate = 0.0
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16).requires_grad_()
        y = blk(xt)
        (y.float() * torch.from_numpy(probe).permute(0, 3, 1, 2)).sum().backward()
        nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()  # noqa: E731
        return nhwc(y), nhwc(xt.grad), _sorted_leaves(_grads_tree(blk))

    err = max(_rel_l2(a, b) for a, b in zip(port(), ref))
    assert err <= 0.0125, err
    coarse = max(_rel_l2(a, b) for a, b in zip(port(6), ref))
    assert coarse > 0.0125, coarse  # the limit sees a precision below bf16's


def test_bf16_step_matches_jax_bf16_step(setup, no_jax_drop_connect):
    _, v, batch = setup
    jm = JModel(variant="b0", classifier_hidden_dims=HEAD, dropout_rate=0.0,
                feature_dropout_rate=0.0, dtype=jnp.bfloat16)
    jcrit = jmake_criterion(LOSS, jnp.asarray(CLASS_WEIGHTS))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def reference(params):
        (loss, _), grads = jax.value_and_grad(
            lambda p: j_forward_loss(jm, jcrit, p, v["batch_stats"], jb, jax.random.PRNGKey(2),
                                     True), has_aux=True)(params)
        return loss, grads

    jloss, jgrads = _jit_rounding(reference, v["params"])
    model = load_flax_variables(DeepfakeDetectionModel(
        variant="b0", classifier_hidden_dims=HEAD, dropout_rate=0.0, feature_dropout_rate=0.0,
        dtype=torch.bfloat16), v).train()
    model.feature_extractor.backbone.drop_connect_rate = 0.0
    loss, _ = _forward_loss(model, make_criterion(LOSS, torch.from_numpy(CLASS_WEIGHTS)),
                            _tbatch(batch), torch.Generator(), True)
    loss.backward()
    grads, ref = _flat(_grads_tree(model)), _flat(jgrads)
    g1 = np.concatenate([grads[k].ravel() for k in ref])
    g0 = np.concatenate([g.ravel() for g in ref.values()])
    assert abs(loss.item() - float(jloss)) <= 0.1 * abs(float(jloss))
    assert abs(np.linalg.norm(g1) - np.linalg.norm(g0)) <= 0.25 * np.linalg.norm(g0)
    assert 1.0 - g1 @ g0 / (np.linalg.norm(g1) * np.linalg.norm(g0)) <= 0.35


def test_remat_gives_the_same_step(setup):
    _, v, batch = setup
    cfg = dict(opt_cfg=ADAMW, clip=1.0, n=2, accumulation=2)
    plain, _, m_plain = _t_steps(v, batch, **cfg)
    remat, _, m_remat = _t_steps(v, batch, **cfg, remat=True)
    # Dropout and drop-connect on: the rerun must redraw the same masks.
    for model in (plain, remat):
        assert model.training
    a, b = export_flax_variables(plain), export_flax_variables(remat)
    for tree in ("params", "batch_stats"):
        fa, fb = _flat(a[tree]), _flat(b[tree])
        for k in fa:
            np.testing.assert_allclose(fb[k], fa[k], rtol=0, atol=1e-6, err_msg=k)
    assert m_plain == pytest.approx(m_remat, rel=1e-6)


def test_remat_with_dropout_redraws_the_same_masks(setup):
    _, v, batch = setup
    outs = []
    for remat in (False, True):
        model = DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=HEAD,
                                       dropout_rate=0.5, feature_dropout_rate=0.3)
        model = load_flax_variables(model, v)  # drop-connect at its 0.2 default
        opt = create_optimizer(model.parameters(), SGD)
        step = make_train_step(model, make_criterion(LOSS), opt, remat=remat)
        m = step(TrainState(), batch, 11)
        outs.append((float(m["loss"]), export_flax_variables(model)))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for tree in ("params", "batch_stats"):
        fa, fb = _flat(outs[0][1][tree]), _flat(outs[1][1][tree])
        for k in fa:
            np.testing.assert_allclose(fb[k], fa[k], rtol=0, atol=1e-6, err_msg=k)


def test_dropout_and_drop_connect_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(400, 500)
    y = dropout(x, 0.4, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.6) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.6))
    assert torch.equal(dropout(x, 0.0, g), x)
    z = drop_connect(torch.ones(4000, 3, 2, 2), 0.25, g)
    per_sample = z.reshape(4000, -1)
    assert torch.all(per_sample.amin(1) == per_sample.amax(1))  # one draw a sample
    assert abs((per_sample[:, 0] != 0).float().mean().item() - 0.75) < 0.03
    assert torch.allclose(per_sample[per_sample[:, 0] != 0], torch.tensor(1 / 0.75))
    # Same generator state, same masks; eval mode is the identity.
    a = dropout(x, 0.4, torch.Generator().manual_seed(3))
    b = dropout(x, 0.4, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    model = init_weights(DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=HEAD), 0)
    model.eval()
    img = torch.randn(2, 32, 32, 3, generator=g)
    with torch.no_grad():
        logits = model(img)[0]
        assert torch.isfinite(logits).all() and torch.equal(model(img)[0], logits)
        # The backbone's pooled output: dropout in train mode only.
        backbone = model.feature_extractor.backbone
        pooled = backbone(img, return_maps=False)
        assert torch.equal(pooled, backbone(img).mean(dim=(2, 3)))
        backbone.train()
        dropped = backbone(img, return_maps=False, generator=torch.Generator().manual_seed(1))
        kept = dropped != 0
        assert 0 < kept.float().mean() < 1  # rate 0.4
        backbone.eval()


def test_resumed_step_is_the_same_step(setup, tmp_path):
    _, v, batch = setup
    crit = make_criterion(LOSS)

    def trainer(model):
        opt = create_optimizer(model.parameters(), ADAMW, gradient_clip=1.0)
        return Trainer(model, opt, crit, [batch], [batch], seed=7,
                       config={"save_dir": str(tmp_path), "print_freq": 100})

    a = trainer(load_flax_variables(DeepfakeDetectionModel(
        variant="b0", classifier_hidden_dims=HEAD, dropout_rate=0.3), v))
    for _ in range(2):
        a.train_step(a.state, batch, a.seed)
    path = save_checkpoint(a.checkpoint_state(0), tmp_path)
    b = trainer(DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=HEAD,
                                       dropout_rate=0.3))
    assert b.resume_from_checkpoint(path) == 1
    assert b.state.step == 2
    ma = a.train_step(a.state, batch, a.seed)
    mb = b.train_step(b.state, batch, b.seed)
    assert float(ma["loss"]) == float(mb["loss"])
    fa, fb = _flat(export_flax_variables(a.model)), _flat(export_flax_variables(b.model))
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert load_checkpoint(path)["step"] == 2
