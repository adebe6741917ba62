"""AMP O2 (`auto_cast(level="O2")`, `decorate`), `GradScaler` and the
named recompute policies: the PyTorch port against the JAX package on
CPU, at gpt_tiny with the reference's weights loaded into the port.

Tolerances, each with its reason:

* O2 dtypes: equal after every module and at every op's cast point;
* O2 losses over 3 TrainSteps: one bf16 ulp (the loss is rounded to
  bf16 by the reference's O2 divide; the two frameworks' f32 sums may
  straddle a rounding boundary);
* O2 gradients of the first step: 3e-2 of each gradient's max-abs, as
  test_torch_train's O1 bound (1-ulp bf16 roundings compound through the
  backward);
* bf16 parameters after 3 AdamW steps, held through their change from
  the start: where the reference's update rounds away (a LayerNorm
  weight near 1, whose bf16 step is 8 lr), the port's parameter is
  bit-equal to it; elsewhere the port's change is within 0.25 of the
  reference's in L2 (measured at most 0.14; a skipped update gives 1,
  a flipped sign 2). Adam normalises each update to about lr, so a
  gradient element whose sign differs between the frameworks' roundings
  moves by up to 2·lr: the key bias, whose exact gradient is zero
  (softmax cancels a per-query constant), is such noise throughout and
  is held only to that 2·lr a step;
* GradScaler: the same skips, counters and scale; parameters to 1e-6;
* recompute policies: gradients equal to the run without recompute,
  within 1e-6 of each gradient's max-abs (the same ops on the same
  inputs, recomputed).
"""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.distributed.fleet import recompute as trc
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt_tiny)

pytestmark = pytest.mark.torch_port

VOCAB = 2048
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(getattr(x, "_value", x), jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ids(seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int64)


def _pair(seed=40, decorate=True, **cfg):
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**cfg))
    arrays = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, arrays)
    if decorate:
        assert jamp.decorate(jm, level="O2") is jm
        assert tamp.decorate(tm, level="O2") is tm
    return jm, tm


def _o2(mod):
    return mod.auto_cast(level="O2", dtype="bfloat16")


def _jax_loss(m, ids):
    with _o2(jamp):
        return m.fused_head_loss(ids, block_size=16)


def _torch_loss(m, ids):
    with _o2(tamp):
        return m.fused_head_loss(ids, block_size=16)


def _bf16_ulp(x):
    """The bf16 spacing at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


# ------------------------------------------------------------------ dtypes

# the reference's op names at the port's cast points ("recompute" is the
# reference's remat op, which the port has no op for; its slices and
# reshapes inside the blocks leave bf16 as bf16)
_OP_NAMES = {"scaled_dot_product_attention": "flash_attention"}
_SKIP = {"recompute", "reshape", "squeeze", "transpose"}


def _float_dtypes(vals):
    return tuple(str(getattr(v, "dtype", "")).split(".")[-1] for v in vals
                 if v is not None and "float" in str(getattr(v, "dtype", "")))


@pytest.mark.parametrize("recompute", [False, True])
def test_o2_dtype_after_every_module_and_op_matches_reference(
        recompute, monkeypatch):
    """Decorated gpt_tiny, fused head loss under O2: each module's output
    dtype, and the dtypes each op casts its float inputs to (the
    reference's tape `apply`, the port's `cast_inputs_for`), in order,
    are the reference's; the loss is bf16 on both sides."""
    jm, tm = _pair(seed=41, recompute=recompute)
    ids = _ids(1)
    jmods, tmods = {}, {}

    def note(seen, name, out):      # the first call's output; keeps it
        seen.setdefault(name, str(out.dtype).split(".")[-1])

    for name, layer in jm.named_sublayers():
        layer.register_forward_post_hook(
            lambda l, i, o, name=name: note(jmods, name, o))
    for name, mod in tm.named_modules():
        if name:
            mod.register_forward_hook(
                lambda m, i, o, name=name: note(tmods, name, o))

    jops, tops = [], []
    jcast, tcast = jamp.cast_inputs_for, tamp.cast_inputs_for

    def jlog(name, vals):
        out = jcast(name, vals)
        jops.append((_OP_NAMES.get(name, name), _float_dtypes(out)))
        return out

    def tlog(name, vals):
        out = tcast(name, vals)
        tops.append((name, _float_dtypes(out)))
        return out

    monkeypatch.setattr(jamp, "cast_inputs_for", jlog)
    monkeypatch.setattr(tamp, "cast_inputs_for", tlog)
    jl = _jax_loss(jm, paddle.to_tensor(ids))
    tl = _torch_loss(tm, torch.from_numpy(ids))
    assert str(jl.dtype) == "bfloat16" and tl.dtype == torch.bfloat16
    assert set(jmods) == set(tmods) and len(tmods) > 15
    assert tmods == jmods
    assert {tmods[n] for n in tmods if ".ln" in n or n.endswith("ln_f")} \
        == {"float32"}
    # the reference casts at every op; its slices inside the blocks
    # (the fused qkv split) keep bf16 bf16 and the labels' slice has no
    # float input — the head's slice of the hidden states is the one that
    # moves a dtype, and the port casts there
    jops = [op for op in jops if op[0] not in _SKIP]
    last = max(i for i, op in enumerate(jops) if op[0] == "slice" and op[1])
    jops = [op for i, op in enumerate(jops)
            if op[0] != "slice" or i == last]
    assert tops == jops
    names = [n for n, _ in tops]
    assert {"add", "slice", "divide", "fused_linear_cross_entropy",
            "flash_attention", "gelu"} <= set(names)
    assert dict(tops)["layer_norm"] == ("float32",) * 3
    assert dict(tops)["divide"] == ("bfloat16",)


def test_o2_without_decorate_and_o1_unchanged():
    """auto_cast O2 on f32 parameters casts at the ops (the loss and the
    matmuls go bf16, layer norm stays f32); the same model under O1
    keeps its f32 loss."""
    _, tm = _pair(seed=42, decorate=False)
    ids = torch.from_numpy(_ids(2))
    assert _torch_loss(tm, ids).dtype == torch.bfloat16
    with tamp.auto_cast(level="O1"):
        assert tm.fused_head_loss(ids, block_size=16).dtype == torch.float32
    assert tm.gpt.wte.weight.dtype == torch.float32
    m, o = tamp.decorate([tm], optimizers=["opt"])
    assert m == [tm] and o == ["opt"]
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="bfloat16"):
        tamp.decorate(tm, dtype="float16")


# --------------------------------------------------------- O2 train step

def _jax_value_and_grads(jm, loss_of):
    """The reference's loss and gradients as its compiled TrainStep takes
    them (`jax.value_and_grad` over the parameter values)."""
    params = list(jm.named_parameters())

    def pure(vals):
        held = [p._value for _, p in params]
        for (_, p), v in zip(params, vals):
            p._value = v
        try:
            return loss_of()._value
        finally:
            for (_, p), v in zip(params, held):
                p._value = v

    loss, grads = jax.value_and_grad(pure)([p._value for _, p in params])
    return loss, {n: g for (n, _), g in zip(params, grads)}


def test_o2_first_step_gradients_match_reference():
    jm, tm = _pair(seed=43, recompute=True)
    ids = _ids(3)
    jl, jgrads = _jax_value_and_grads(
        jm, lambda: _jax_loss(jm, paddle.to_tensor(ids)))
    tl = _torch_loss(tm, torch.from_numpy(ids))
    assert abs(float(tl.detach()) - float(jl)) <= _bf16_ulp(float(jl))
    tl.backward()
    for n, p in tm.named_parameters():
        assert p.grad.dtype == torch.bfloat16, n
        assert str(jgrads[n].dtype) == "bfloat16", n
        err = _rel(p.grad, jgrads[n])
        assert err <= 3e-2, f"{n}: rel err {err:.2e}"


def test_o2_train_step_matches_reference_over_three_steps():
    """bench_gpt1p3b's recipe at gpt_tiny: decorate O2, AdamW, the fused
    head under auto_cast O2, per-layer recompute, TrainStep."""
    jm, tm = _pair(seed=40, recompute=True)
    start = {n: _f32(p) for n, p in tm.named_parameters()}
    js = paddle.jit.TrainStep(jm, _jax_loss, paddle.optimizer.AdamW(
        LR, parameters=jm.parameters()))
    ts = TrainStep(tm, _torch_loss, AdamW(LR, parameters=tm.parameters()))
    rng = np.random.default_rng(0)
    steps = 3
    for _ in range(steps):
        ids = rng.integers(0, VOCAB, (2, 16)).astype(np.int64)
        jl = float(js(paddle.to_tensor(ids)).numpy().astype(np.float32))
        tl = ts(torch.from_numpy(ids))
        assert tl.dtype == torch.bfloat16
        assert abs(float(tl) - jl) <= _bf16_ulp(jl)
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        state = ts.optimizer._states[id(p)]
        assert state["moment1"].dtype == torch.float32
        got = _f32(p).ravel() - start[n].ravel()
        want = _f32(jparams[n]._value).ravel() - start[n].ravel()
        if not want.any():
            assert not got.any(), n
            continue
        if n.endswith("qkv.bias"):
            key = slice(got.size // 3, 2 * got.size // 3)
            assert np.abs(got[key] - want[key]).max() <= 2 * LR * steps, n
            got, want = np.delete(got, key), np.delete(want, key)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 0.25, f"{n}: change off by {err:.3f} in L2"


# -------------------------------------------------------------- GradScaler

def _linear_pair(seed=7):
    from paddle_tpu_torch.nn import Linear

    paddle.seed(seed)
    jnet = paddle.nn.Linear(4, 4)
    tnet = Linear(4, 4)
    with torch.no_grad():
        tnet.weight.copy_(torch.from_numpy(np.array(jnet.weight.numpy())))
        tnet.bias.copy_(torch.from_numpy(np.array(jnet.bias.numpy())))
    return jnet, tnet


def test_grad_scaler_matches_reference():
    jnet, tnet = _linear_pair()
    jopt = paddle.optimizer.SGD(0.1, parameters=jnet.parameters())
    topt = SGD(0.1, parameters=tnet.parameters())
    kw = dict(init_loss_scaling=128.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    js, ts = paddle.amp.GradScaler(**kw), tamp.GradScaler(**kw)
    x = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    scales = []

    def round_(poison):
        jopt.clear_grad()
        topt.clear_grad()
        k = np.inf if poison else 1.0
        jloss = (jnet(paddle.to_tensor(x)) * k).sum()
        tloss = (tnet(torch.from_numpy(x)) * k).sum()
        jsc, tsc = js.scale(jloss), ts.scale(tloss)
        if not poison:
            want = float(jsc.numpy())
            assert abs(float(tsc.detach()) - want) <= 1e-5 * abs(want)
        jsc.backward()
        tsc.backward()
        js.step(jopt)
        ts.step(topt)
        js.update()
        ts.update()
        scales.append((js._scale, ts._scale))
        assert ts.state_dict() == js.state_dict()

    round_(False)
    w1 = tnet.weight.detach().clone()
    round_(True)              # a planted inf: the step is skipped
    assert torch.equal(tnet.weight.detach(), w1)
    assert ts._bad_steps == 1
    round_(True)              # second bad step: the scale halves
    round_(False)
    round_(False)             # incr_every_n_steps good steps: doubles
    assert [s for s, _ in scales] == [t for _, t in scales] == [
        128.0, 128.0, 64.0, 64.0, 128.0]
    assert _rel(tnet.weight, jnet.weight._value) <= 1e-6
    assert _rel(tnet.bias, jnet.bias._value) <= 1e-6
    sc = ts.get_loss_scaling()
    assert sc.dtype == torch.float32 and sc.ndim == 0 and float(sc) == 128.0


def test_grad_scaler_unscale_once_state_dict_and_minimize():
    jnet, tnet = _linear_pair(8)
    topt = SGD(0.0, parameters=tnet.parameters())
    ts = tamp.GradScaler(init_loss_scaling=64.0)
    ts.scale(tnet(torch.ones(2, 4)).sum()).backward()
    ts.unscale_(topt)
    g = tnet.weight.grad.clone()
    with pytest.raises(RuntimeError, match="already been called"):
        ts.unscale_(topt)
    ts.step(topt)             # must not unscale again
    ts.update()
    assert torch.equal(tnet.weight.grad, g)
    ts.unscale_(topt)         # a fresh round after update()
    other = tamp.GradScaler()
    other.load_state_dict(ts.state_dict())
    assert other._scale == 64.0 and other.state_dict() == ts.state_dict()
    other.set_init_loss_scaling(8.0)
    assert float(other.get_loss_scaling()) == 8.0
    off = tamp.GradScaler(enable=False)
    assert not off.is_enable()
    loss = tnet(torch.ones(2, 4)).sum()
    assert off.scale(loss) is loss
    ms = tamp.GradScaler(init_loss_scaling=4.0)
    topt.clear_grad()
    ms.minimize(topt, ms.scale(tnet(torch.ones(2, 4)).sum()))
    assert ms._good_steps == 1
    # the same unscaled gradient as the reference's scaler
    jopt = paddle.optimizer.SGD(0.0, parameters=jnet.parameters())
    js = paddle.amp.GradScaler(init_loss_scaling=4.0)
    js.scale(jnet(paddle.ones([2, 4])).sum()).backward()
    js.unscale_(jopt)
    assert _rel(tnet.weight.grad, jnet.weight.grad._value) <= 1e-6


# ---------------------------------------------------- recompute policies

POLICIES = [False, True, "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable",
            trc.checkpoint_policy("dots_saveable")]
POLICY_IDS = ["off", "true", "nothing", "dots", "dots_no_batch",
              "everything", "callable"]


def _crit_loss(m, x):
    return GPTPretrainingCriterion()(m(x), x)


@pytest.mark.parametrize("where", ["train_step", "per_layer"])
@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
def test_remat_policy_gives_equal_gradients(policy, where):
    ids = torch.from_numpy(_ids(4))
    cfg = dict(recompute=policy) if where == "per_layer" else {}
    runs = []
    for rc in (False, policy):
        m = GPTForCausalLM(gpt_tiny(**(cfg if rc is policy else {})),
                           device="cpu", seed=6)
        step = TrainStep(m, _crit_loss, AdamW(LR, parameters=m.parameters()),
                         remat=rc if where == "train_step" else False)
        loss = step(ids)
        runs.append((float(loss), {n: p.grad.clone()
                                   for n, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for n in g0:
        assert _rel(g1[n], g0[n]) <= 1e-6, n


def test_remat_loss_matches_reference_under_a_policy():
    """The reference's TrainStep(remat='dots_saveable') against the
    port's, over 3 f32 steps (test_jit_amp's remat parity, across the
    packages)."""
    jm, tm = _pair(seed=44, decorate=False)
    from paddle_tpu.text.models import GPTPretrainingCriterion as JCrit

    js = paddle.jit.TrainStep(
        jm, lambda m, x: JCrit()(m(x), x),
        paddle.optimizer.AdamW(LR, parameters=jm.parameters()),
        remat="dots_saveable")
    ts = TrainStep(tm, _crit_loss, AdamW(LR, parameters=tm.parameters()),
                   remat="dots_saveable")
    ids = _ids(5)
    for _ in range(3):
        jl = float(js(paddle.to_tensor(ids)).numpy())
        tl = float(ts(torch.from_numpy(ids)))
        assert abs(tl - jl) <= 1e-5 * abs(jl)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket] += 1
        return func(*args, **(kwargs or {}))


_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm)


def _dot_counts(remat):
    m = GPTForCausalLM(gpt_tiny(), device="cpu", seed=6)
    ids = torch.from_numpy(_ids(4))
    fwd, bwd = _Count(), _Count()
    with fwd:
        loss = trc.recompute(lambda x: _crit_loss(m, x), ids,
                             policy=remat) if remat else _crit_loss(m, ids)
    with bwd:
        loss.backward()
    return ({k: fwd.n[k] for k in _DOTS}, {k: bwd.n[k] for k in _DOTS})


def test_dots_saveable_backward_reruns_no_matmul():
    """Counted below autograd: with no recompute the backward runs B
    matmuls (its own); keep-nothing reruns the forward's F as well;
    dots_saveable serves them from what the forward kept, as does
    dots_with_no_batch_dims_saveable for mm but not bmm."""
    f0, b0 = _dot_counts(False)
    assert f0[torch.ops.aten.mm] > 0
    _, b_true = _dot_counts(True)
    _, b_dots = _dot_counts("dots_saveable")
    _, b_nobatch = _dot_counts("dots_with_no_batch_dims_saveable")
    for op in _DOTS:
        assert b_true[op] == b0[op] + f0[op], op
        assert b_dots[op] == b0[op], op
    for op in (torch.ops.aten.mm, torch.ops.aten.addmm):
        assert b_nobatch[op] == b0[op], op
    assert b_nobatch[torch.ops.aten.bmm] == \
        b0[torch.ops.aten.bmm] + f0[torch.ops.aten.bmm]


@pytest.mark.parametrize("policy", [True, "dots_saveable"])
def test_sac_recompute_replays_dropout_masks(policy):
    """Dropout 0.2 under a policy: the recompute draws the forward's
    masks, so gradients equal the run without recompute."""
    grads = []
    for rc in (False, policy):
        tm = GPTForCausalLM(gpt_tiny(dropout=0.2, recompute=rc),
                            device="cpu", seed=5)
        ids = torch.from_numpy(_ids(3))
        with trng.generator_scope(torch.Generator().manual_seed(9)):
            _crit_loss(tm, ids).backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_recompute_sequential_and_policy_names():
    layers = torch.nn.Sequential(*[torch.nn.Linear(8, 8) for _ in range(4)])
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    layers(x).sum().backward()
    want = [p.grad.clone() for p in layers.parameters()]
    layers.zero_grad()
    out = trc.recompute_sequential({"segments": 2}, layers, x)
    torch.testing.assert_close(out, layers(x))
    out.sum().backward()
    for p, w in zip(layers.parameters(), want):
        torch.testing.assert_close(p.grad, w)
    assert trc.checkpoint_policy(None) is None
    assert trc.checkpoint_policy(True) is None
    assert trc.checkpoint_policy("nothing_saveable") is None
    assert trc.checkpoint_policy("everything_saveable") is \
        trc.everything_saveable
    fn = trc.checkpoint_policy("dots_saveable")
    assert trc.checkpoint_policy(fn) is fn
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        trc.checkpoint_policy("dots")
