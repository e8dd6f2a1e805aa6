"""The port's attack classes (``byzpy_tpu_torch.attacks``), the wire's
pre-decode inflation and ``parallel.ps.adaptive_attack_rows`` against the
JAX package's, on the CPU, same numpy inputs.

Tolerances, stated per test: sign flip, empire (at a round's node counts,
d a multiple of 8 or not), mimic and inf bit for bit; little within f32
rounding (rtol 1e-6, atol 3e-6, a few ulps of rows of scale 3: XLA
contracts its last multiply-add and the squared deviations into FMAs of
its own order); the label-flip
gradient within rtol 1e-5, atol 1e-6 (f32 products summed in another
order); the adaptive submissions and the inflation ratios bit for bit
(numpy f32 arithmetic in both); the gaussian draw by seed determinism,
fresh draws and moments (PyTorch cannot reproduce ``jax.random``'s
bits); the PS rounds within rtol 1e-4, atol 1e-5 (``tests/test_torch_ps.py``'s
tolerance).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import byzpy_tpu.aggregators as JAgg
import byzpy_tpu.attacks as JA
from byzpy_tpu.engine.actor import wire as jwire
from byzpy_tpu.engine.graph.operator import OpContext as JOpContext
from byzpy_tpu.models import data as jdata
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.parallel import ps as jps
from byzpy_tpu.serving.staleness import StalenessPolicy as JStaleness
import byzpy_tpu_torch.aggregators as PAgg
import byzpy_tpu_torch.attacks as PA
from byzpy_tpu_torch.engine.actor import wire as pwire
from byzpy_tpu_torch.engine.graph import OpContext
from byzpy_tpu_torch.models import from_flax, ordered_like, synthetic_classification
from byzpy_tpu_torch.models import nets
from byzpy_tpu_torch.ops import attack_ops
from byzpy_tpu_torch.parallel import PSStepConfig, adaptive_attack_rows, build_ps_train_step
from byzpy_tpu_torch.serving import StalenessPolicy

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_bundle(jbundle, module):
    bundle = nets.make_bundle(module, device=CPU)
    bundle.params = ordered_like(from_flax(_np_tree(jbundle.params), device=CPU), bundle.params)
    return bundle


def _honest(h, d, seed):
    return np.random.default_rng(seed).normal(size=(h, d)).astype(np.float32) * np.float32(3.0)


SHAPES = [(6, 421), (7, 64), (5, 1000), (13, 333), (30, 2048)]


# ---------------------------------------------------------------------------
# static attacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,d", SHAPES)
@pytest.mark.parametrize("scale", [-1.0, -1.1, 2.5])
def test_empire_bitwise(h, d, scale):
    x = _honest(h, d, seed=h * d)
    ours = PA.EmpireAttack(scale=scale, device=CPU).apply(honest_grads=[torch.from_numpy(r) for r in x])
    ref = np.asarray(JA.EmpireAttack(scale=scale).apply(honest_grads=[jnp.asarray(r) for r in x]))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("h,d", SHAPES)
@pytest.mark.parametrize("f,N", [(2, None), (3, None), (1, 40)])
def test_little_within_f32(h, d, f, N):
    x = _honest(h, d, seed=h + d)
    ours = PA.LittleAttack(f, N, device=CPU).apply(honest_grads=[torch.from_numpy(r) for r in x])
    ref = np.asarray(JA.LittleAttack(f, N).apply(honest_grads=[jnp.asarray(r) for r in x]))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=3e-6)


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"b": r.normal(size=(5,)).astype(np.float32),
            "w": {"k": r.normal(size=(3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("scale", [-1.0, -3.5, 0.25])
def test_sign_flip_bitwise_over_a_tree(scale):
    g = _tree(0)
    ours = PA.SignFlipAttack(scale=scale, device=CPU).apply(base_grad=g)
    ref = JA.SignFlipAttack(scale=scale).apply(base_grad=jax.tree_util.tree_map(jnp.asarray, g))
    np.testing.assert_array_equal(ours["b"].numpy(), np.asarray(ref["b"]))
    np.testing.assert_array_equal(ours["w"]["k"].numpy(), np.asarray(ref["w"]["k"]))
    with pytest.raises(ValueError, match="SignFlipAttack requires base_grad"):
        PA.SignFlipAttack(device=CPU).apply()


@pytest.mark.parametrize("epsilon", [0, 2, 4])
def test_mimic_bitwise_and_a_copy(epsilon):
    hs = [_tree(s) for s in range(5)]
    ours = PA.MimicAttack(epsilon=epsilon, device=CPU).apply(honest_grads=hs)
    ref = JA.MimicAttack(epsilon=epsilon).apply(
        honest_grads=[jax.tree_util.tree_map(jnp.asarray, h) for h in hs])
    np.testing.assert_array_equal(ours["w"]["k"].numpy(), np.asarray(ref["w"]["k"]))
    ours["b"][0] = 99.0
    assert hs[epsilon]["b"][0] != 99.0


def test_mimic_inf_and_constructor_errors_match():
    hs = [np.ones(4, np.float32)] * 3
    for epsilon, grads in ((3, hs), (0, [])):
        with pytest.raises(ValueError) as ours:
            PA.MimicAttack(epsilon=epsilon, device=CPU).apply(honest_grads=grads)
        with pytest.raises(ValueError) as ref:
            JA.MimicAttack(epsilon=epsilon).apply(honest_grads=grads)
        assert str(ours.value) == str(ref.value)
    x = _honest(4, 37, seed=3)
    inf = PA.InfAttack(device=CPU).apply(honest_grads=[torch.from_numpy(r) for r in x])
    ref = np.asarray(JA.InfAttack().apply(honest_grads=[jnp.asarray(r) for r in x]))
    np.testing.assert_array_equal(inf.numpy(), ref)
    assert np.isposinf(inf.numpy()).all() and inf.dtype == torch.float32
    for cls, args in ((PA.MimicAttack, dict(epsilon=-1)), (PA.LittleAttack, dict(f=-1)),
                      (PA.GaussianAttack, dict(sigma=-1.0))):
        jcls = getattr(JA, cls.__name__)
        with pytest.raises(ValueError) as ours:
            cls(**args, device=CPU)
        with pytest.raises(ValueError) as ref_err:
            jcls(**args)
        assert str(ours.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="N must be >= f"):
        PA.LittleAttack(5, 3, device=CPU).apply(honest_grads=list(torch.from_numpy(x)))
    for cls in (PA.EmpireAttack, PA.LittleAttack, PA.InfAttack, PA.GaussianAttack):
        args = (1,) if cls is PA.LittleAttack else ()
        with pytest.raises(ValueError, match=f"{cls.__name__} requires honest_grads"):
            cls(*args, device=CPU).apply(honest_grads=[])


def test_gaussian_seeded_fresh_and_moments():
    hs = [torch.zeros(20_000)] * 3
    a, b = PA.GaussianAttack(mu=1.0, sigma=2.0, seed=5, device=CPU), \
        PA.GaussianAttack(mu=1.0, sigma=2.0, seed=5, device=CPU)
    first, second = a.apply(honest_grads=hs), a.apply(honest_grads=hs)
    assert not torch.equal(first, second)  # each apply draws fresh noise
    assert torch.equal(first, b.apply(honest_grads=hs))  # the same seed replays
    assert torch.equal(second, b.apply(honest_grads=hs))
    for draw in (first, second):
        assert abs(float(draw.mean()) - 1.0) < 0.05 and abs(float(draw.std()) - 2.0) < 0.05
    g = torch.Generator().manual_seed(5)
    c = PA.GaussianAttack(mu=1.0, sigma=2.0, generator=g, device=CPU)
    assert torch.equal(c.apply(honest_grads=hs), first) and c.generator is g
    assert PA.GaussianAttack(seed=6, device=CPU).apply(honest_grads=hs).dtype == torch.float32


@pytest.mark.parametrize("flip", ["num_classes", "mapping"])
def test_label_flip_matches_jax(flip):
    jb = jnets.mnist_mlp(seed=1)
    bundle = _port_bundle(jb, nets.MLP())
    jx, jy = jdata.synthetic_classification(n_samples=32, seed=3)
    x, y = synthetic_classification(n_samples=32, seed=3, device=CPU)
    kw = {"num_classes": 10} if flip == "num_classes" else {"mapping": [3, 4, 5, 6, 7, 8, 9, 0, 1, 2]}
    ours = PA.LabelFlipAttack(**kw, device=CPU).apply(model=bundle, x=x, y=y)
    ref = from_flax(_np_tree(JA.LabelFlipAttack(**kw).apply(model=jb, x=jx, y=jy)), device=CPU)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    honest = torch.func.grad(bundle.loss_fn)(bundle.params, x, y)
    assert not torch.allclose(ours["dense_0.weight"], honest["dense_0.weight"])
    # the op itself, and its error
    direct = attack_ops.label_flip_grad(torch.func.grad(bundle.loss_fn), bundle.params, x, y, **kw)
    for k in ours:
        assert torch.equal(direct[k], ours[k])
    with pytest.raises(ValueError, match="requires num_classes or mapping"):
        attack_ops.label_flip_grad(None, None, x, y)
    with pytest.raises(ValueError, match="LabelFlipAttack requires num_classes or mapping"):
        PA.LabelFlipAttack(device=CPU)
    with pytest.raises(ValueError, match="requires model, x, and y"):
        PA.LabelFlipAttack(num_classes=10, device=CPU).apply(model=bundle, x=x)


def test_compute_collects_flagged_inputs_as_the_jax_base():
    x = _honest(4, 16, seed=1)
    hs = [torch.from_numpy(r) for r in x]
    out = PA.EmpireAttack(device=CPU).compute({"honest_grads": hs}, context=OpContext("atk"))
    ref = JA.EmpireAttack().compute({"honest_grads": [jnp.asarray(r) for r in x]},
                                    context=JOpContext("atk"))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for atk, missing in ((PA.EmpireAttack(device=CPU), "honest_grads"),
                         (PA.SignFlipAttack(device=CPU), "base_grad"),
                         (PA.LabelFlipAttack(num_classes=3, device=CPU), "model")):
        with pytest.raises(KeyError, match=missing):
            atk.compute({}, context=OpContext("atk"))
    assert not PA.EmpireAttack(device=CPU).is_adaptive and PA.InfluenceAscentAttack(4, device=CPU).is_adaptive
    for name in ("Attack", "SignFlipAttack", "InfluenceAscentAttack"):
        cls_p, cls_j = getattr(PA, name), getattr(JA, name)
        for flag in ("uses_base_grad", "uses_model_batch", "uses_honest_grads", "is_adaptive", "name"):
            assert getattr(cls_p, flag) == getattr(cls_j, flag), (name, flag)


def test_attacks_exports_and_default_device(monkeypatch):
    assert PA.__all__ == JA.__all__ and len(PA.__all__) == 14
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (PA.EmpireAttack, PA.InfAttack, lambda: PA.LittleAttack(1),
                 lambda: PA.KrumEvasionAttack(4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ---------------------------------------------------------------------------
# adaptive attacks: one observation sequence through both packages
# ---------------------------------------------------------------------------

DIM = 300


def _observations(rounds=9, seed=0, dim=DIM):
    rng = np.random.default_rng(seed)
    return [(r, rng.normal(size=dim).astype(np.float32) * np.float32(1 + r % 3),
             {"b": bool(r % 2)}, {"b": "accepted" if r % 3 else "rejected_rate"})
            for r in range(rounds)]


ADAPTIVE = {
    "influence_ascent": lambda M, **kw: M.InfluenceAscentAttack(DIM, seed=7, client_id="b", **kw),
    "influence_ascent_direction": lambda M, **kw: M.InfluenceAscentAttack(
        DIM, direction=np.linspace(-1, 2, DIM), scale0=0.3, grow=2.0, shrink=0.25, seed=1,
        client_id="b", **kw),
    "krum_evasion": lambda M, **kw: M.KrumEvasionAttack(DIM, seed=7, client_id="b", **kw),
    "staleness_abuse": lambda M, **kw: M.StalenessAbuseAttack(
        DIM, staleness=(StalenessPolicy if M is PA else JStaleness)(kind="exponential", cutoff=3),
        seed=7, client_id="b", **kw),
    "staleness_abuse_poly": lambda M, **kw: M.StalenessAbuseAttack(
        DIM, staleness=(StalenessPolicy if M is PA else JStaleness)(kind="polynomial", alpha=1.5,
                                                                    cutoff=2),
        scale=2.0, backoff_rounds=2, seed=3, client_id="b", **kw),
    "residual_shaping_s4": lambda M, **kw: M.ResidualShapingAttack(DIM, mode="s4", seed=7,
                                                                   client_id="b", **kw),
    "residual_shaping_int8": lambda M, **kw: M.ResidualShapingAttack(
        DIM, mode="int8", block=64, kappa=3.0, seed=7, client_id="b", **kw),
}


@pytest.mark.parametrize("name", sorted(ADAPTIVE))
def test_adaptive_replays_bitwise_across_packages(name):
    ours, ref = ADAPTIVE[name](PA, device=CPU), ADAPTIVE[name](JA)
    for r, agg, acc, ver in _observations():
        sub = ours.apply()
        assert isinstance(sub, torch.Tensor) and sub.dtype == torch.float32
        np.testing.assert_array_equal(sub.numpy(), np.asarray(ref.apply()))
        if hasattr(ref, "wire_inflation"):
            assert ours.wire_inflation == ref.wire_inflation
            np.testing.assert_array_equal(ours.residual, ref.residual)
        if hasattr(ref, "next_round_stamp"):
            assert ours.next_round_stamp(r) == ref.next_round_stamp(r)
            assert ours.should_submit() == ref.should_submit()
            assert ours.inflation == ref.inflation and ours.delta == ref.delta
        # the port observes a tensor, the JAX package a numpy array
        ours.observe_round(PA.PublicRoundState(r, torch.from_numpy(agg), acc, ver, server_round=r))
        ref.observe_round(JA.PublicRoundState(r, agg, acc, ver, server_round=r))
    assert ours.submissions == ref.submissions and len(ours.observations) == 9


def test_adaptive_constructor_errors_match():
    cases = [
        (lambda M: M.InfluenceAscentAttack(0), "dim must be"),
        (lambda M: M.InfluenceAscentAttack(4, grow=0.5), "need 0 < shrink"),
        (lambda M: M.KrumEvasionAttack(4, shrink=1.5), "need 0 < shrink"),
        (lambda M: M.InfluenceAscentAttack(4, direction=np.zeros(4)), "non-zero"),
        (lambda M: M.KrumEvasionAttack(4, direction=np.ones(3)), "direction has 3"),
        (lambda M: M.ResidualShapingAttack(4, mode="fp8"), "mode must be one of"),
        (lambda M: M.ResidualShapingAttack(4, kappa=0.5), "kappa must be >= 1"),
        (lambda M: M.ResidualShapingAttack(4, block=0), "block must be positive"),
    ]
    for make, msg in cases:
        with pytest.raises(ValueError) as ours:
            make(_with_cpu(PA))
        with pytest.raises(ValueError) as ref:
            make(JA)
        assert str(ours.value) == str(ref.value) and msg in str(ours.value)
    with pytest.raises(TypeError, match="StalenessPolicy"):
        PA.StalenessAbuseAttack(4, staleness=JStaleness(), device=CPU)


class _with_cpu:
    """The attacks module with ``device="cpu"`` bound into each class."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        cls = getattr(self.module, name)
        return lambda *a, **kw: cls(*a, device=CPU, **kw)


# ---------------------------------------------------------------------------
# the wire's pre-decode inflation
# ---------------------------------------------------------------------------


def _frames(mode, seed):
    """(codes, scales, block, n): one frame of random codes of ``mode``,
    with its hostile patterns (s4 nibble 0, fp8 non-finite bytes), an
    all-zero block and a short last block."""
    rng = np.random.default_rng(seed)
    block, n = 32, 32 * 5 + 7
    nb = -(-n // block)
    if mode == "int8":
        codes = rng.integers(-60, 61, size=n).astype(np.int8)
        codes[block:2 * block] = 0
    elif mode == "s4":
        codes = rng.integers(0, 256, size=nb * block // 2).astype(np.uint8)
        codes[: block // 2] = 0x88  # an all-zero block (both nibbles 8)
        codes[block // 2] = 0x80  # a hostile nibble 0 (-8)
    else:
        f8 = ml_dtypes.float8_e4m3fn if mode == "fp8" else ml_dtypes.float8_e5m2
        codes = (rng.normal(size=n) * 20).astype(f8).view(np.uint8)
        codes[3] = 0x7F  # non-finite in both formats
        codes[block:2 * block] = 0
    scales = rng.random(nb).astype(np.float32) + np.float32(0.5)
    return codes, scales, block, n


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["int8", "s4", "fp8", "fp8_e5m2"])
def test_frame_inflation_matches_jax(mode, seed):
    codes, scales, block, n = _frames(mode, seed)
    ref = jwire.frame_inflation(jwire.QuantizedWireArray(mode, codes, scales, block, (n,), "float32"))
    ours = pwire.frame_inflation(pwire.QuantizedWireArray(
        mode, torch.from_numpy(codes.copy()), torch.from_numpy(scales), block, (n,), "float32"))
    assert ours == ref and ours >= 1.0
    zero = np.zeros_like(codes) if mode != "s4" else np.full_like(codes, 0x88)
    assert pwire.frame_inflation(pwire.QuantizedWireArray(
        mode, torch.from_numpy(zero), torch.from_numpy(scales), block, (n,), "float32")) == 1.0
    assert pwire._WIRE_QMAX == jwire._WIRE_QMAX
    assert pwire.BLOCKWISE_WIRE_MODES == jwire.BLOCKWISE_WIRE_MODES
    assert pwire.frame_inflation(pwire.QuantizedWireArray(
        "bf16", torch.zeros(4, dtype=torch.int16), None, block, (4,), "float32")) is None


# ---------------------------------------------------------------------------
# adaptive_attack_rows and the PS round
# ---------------------------------------------------------------------------


def test_adaptive_attack_rows_matches_jax_and_errors():
    x = _honest(5, 40, seed=9)
    ours = adaptive_attack_rows(PA.EmpireAttack(device=CPU), 3, honest=torch.from_numpy(x))
    ref = jps.adaptive_attack_rows(JA.EmpireAttack(), 3, honest=jnp.asarray(x))
    assert tuple(ours.shape) == (3, 40)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    a, b = PA.KrumEvasionAttack(40, device=CPU), JA.KrumEvasionAttack(40)
    np.testing.assert_array_equal(adaptive_attack_rows(a, 2).numpy(),
                                  np.asarray(jps.adaptive_attack_rows(b, 2)))
    for n_byz in (0, -1):
        with pytest.raises(ValueError) as e_ours:
            adaptive_attack_rows(a, n_byz)
        with pytest.raises(ValueError) as e_ref:
            jps.adaptive_attack_rows(b, n_byz)
        assert str(e_ours.value) == str(e_ref.value)
    with pytest.raises(ValueError) as e_ours:
        adaptive_attack_rows(PA.LittleAttack(1, device=CPU), 2)
    with pytest.raises(ValueError) as e_ref:
        jps.adaptive_attack_rows(JA.LittleAttack(1), 2)
    assert str(e_ours.value) == str(e_ref.value) == "little needs the honest matrix"


# (port aggregator, JAX aggregator, attack name) of the slice's PS rounds
PS_CONFIGS = {
    "mda_empire": (lambda: PAgg.MinimumDiameterAveraging(2, device=CPU),
                   lambda: JAgg.MinimumDiameterAveraging(2), "empire"),
    "smea_little": (lambda: PAgg.SMEA(2, device=CPU), lambda: JAgg.SMEA(2), "little"),
    "smea_inf": (lambda: PAgg.SMEA(2, device=CPU), lambda: JAgg.SMEA(2), "inf"),
    "trimmed_influence": (lambda: PAgg.CoordinateWiseTrimmedMean(2, device=CPU),
                          lambda: JAgg.CoordinateWiseTrimmedMean(2), "influence"),
}


def _make_attack(M, kind, d, **kw):
    if kind == "empire":
        return M.EmpireAttack(scale=-1.1, **kw)
    if kind == "little":
        return M.LittleAttack(2, **kw)
    if kind == "inf":
        return M.InfAttack(**kw)
    return M.InfluenceAscentAttack(d, scale0=0.01, **kw)


@pytest.mark.parametrize("config", sorted(PS_CONFIGS))
def test_ps_rounds_with_attack_classes_match_jax(config):
    """2 PS steps of the MLP (n=6 nodes, 2 byzantine rows from an attack
    class through adaptive_attack_rows, batch 8) with MDA, SMEA or the
    trimmed mean: parameters within rtol 1e-4, atol 1e-5 of the JAX round
    (run eagerly: MDA's search is host code) after every step; the
    adaptive attack observes each package's own aggregate."""
    n, n_byz, batch, steps = 6, 2, 8, 2
    make_ours, make_ref, kind = PS_CONFIGS[config]
    jb = jnets.mnist_mlp(seed=0)
    bundle = _port_bundle(jb, nets.MLP())
    d = sum(int(v.numel()) for v in bundle.params.values())
    jx, jy = jdata.synthetic_classification(n_samples=steps * n * batch, seed=3)
    x, y = synthetic_classification(n_samples=steps * n * batch, seed=3, device=CPU)
    atk, jatk = _make_attack(PA, kind, d, device=CPU), _make_attack(JA, kind, d)
    agg, jagg = make_ours(), make_ref()
    seen = {}

    def ours_agg(m):
        seen["ours"] = agg._aggregate_matrix(m)
        return seen["ours"]

    def ref_agg(m):
        seen["ref"] = jagg._aggregate_matrix(m)
        return seen["ref"]

    cfg = PSStepConfig(n_nodes=n, n_byzantine=n_byz)
    step, opt = build_ps_train_step(
        bundle, ours_agg, cfg, attack=lambda h, g: adaptive_attack_rows(atk, n_byz, honest=h))
    jstep, jopt = jps.build_ps_train_step(
        jb, ref_agg, jps.PSStepConfig(n_nodes=n, n_byzantine=n_byz),
        attack=lambda h, key: jps.adaptive_attack_rows(jatk, n_byz, honest=h))
    params, jparams = bundle.params, jb.params
    for s in range(steps):
        sl = slice(s * n * batch, (s + 1) * n * batch)
        params, opt, _ = step(params, opt, x[sl].reshape(n, batch, 28, 28, 1), y[sl].reshape(n, batch))
        jparams, jopt, _ = jstep(jparams, jopt, jx[sl].reshape(n, batch, 28, 28, 1),
                                 jy[sl].reshape(n, batch), jax.random.PRNGKey(0))
        assert bool(torch.isfinite(seen["ours"]).all())
        atk.observe_round(PA.PublicRoundState(s, seen["ours"]))
        jatk.observe_round(JA.PublicRoundState(s, np.asarray(seen["ref"])))
        ref = from_flax(_np_tree(jparams), device=CPU)
        for k, v in params.items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {s} {k}")
    if kind == "inf":
        assert agg.last_selection.tolist() == list(range(n - n_byz))
