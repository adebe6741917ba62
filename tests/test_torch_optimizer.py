"""Optimizers, LR schedules, regularizers and gradient clipping: the
PyTorch port against the JAX package on CPU.

The same numpy parameters and gradients (made from a seed) go through
both packages. The port follows the reference's compiled update
(`apply_gradients_tree`, what `TrainStep` runs) for the per-optimizer
trajectories, and its eager `step()` for what only the eager path reads
(param groups, `optimize_attr`, per-parameter regularizers, `need_clip`,
schedules driven step by step, the cross-package resume). Tolerances,
each with its reason:

* f32 trajectories: 1e-6 of each tensor's max-abs — the same f32 ops,
  up to summation order in the norms (Lamb, Lars, clipping) and lr·coeff
  products rounded once in f64 (port) or twice in f32 (reference);
* bf16 parameters: one bf16 ulp — the update is the same f32 math
  rounded once to bf16; XLA may keep an f32 intermediate that torch
  rounds;
* schedules: equal, bit for bit (plain Python floats on both sides);
* the cross-package resume over a real loss: the parameters within 1e-5
  max-abs of the reference's 6-step run — f32 gradients from the two
  frameworks' backward passes differ in summation order, and Adam turns
  such noise on small gradients into parameter steps (lr 1e-4 here);
  the same bound, for the same reason, for TrainStep with two groups
  and a clip against the reference's TrainStep (per-group clipping
  lands at least 7e-4 away).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.regularizer import L1Decay as JL1, L2Decay as JL2
from paddle_tpu.tensor_core import Parameter as JParam, Tensor as JTensor
from paddle_tpu_torch import L1Decay, L2Decay
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (load_jax_optimizer_state,
                                      load_jax_state_dict)
from paddle_tpu_torch.optimizer import lr as tlr

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(4, 6), (6,), (3, 2, 5)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _bf16_ulps(got, want):
    """Largest distance in bf16 steps between two bf16-valued arrays."""
    def ordered(x):
        i = _f32(x).view(np.int32) >> 16
        return np.where(i < 0, -(i & 0x7FFF), i).astype(np.int64)
    return int(np.abs(ordered(got) - ordered(want)).max())


def _assert_match(got, want, dtype, label):
    if dtype == "float32":
        assert _rel(got, want) <= 1e-6, (label, _rel(got, want))
    else:
        assert _bf16_ulps(got, want) <= 1, (label, _bf16_ulps(got, want))


# (name, kwargs, decay kwargs): the "with weight decay" arm adds the
# decay kwargs; Lamb and Lars carry their own decay terms
OPTIMIZERS = [
    ("SGD", dict(learning_rate=0.1), dict(weight_decay=0.01)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9),
     dict(weight_decay=0.01)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9, use_nesterov=True),
     dict(weight_decay=0.01)),
    ("Adam", dict(learning_rate=0.01), dict(weight_decay=0.01)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.0),
     dict(weight_decay=0.05)),
    ("Adamax", dict(learning_rate=0.01), dict(weight_decay=0.01)),
    ("Adagrad", dict(learning_rate=0.05, initial_accumulator_value=0.1),
     dict(weight_decay=0.01)),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9), dict(weight_decay=0.01)),
    ("RMSProp", dict(learning_rate=0.01, rho=0.9), dict(weight_decay=0.01)),
    ("RMSProp", dict(learning_rate=0.01, rho=0.9, momentum=0.9,
                     centered=True), dict(weight_decay=0.01)),
    ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.0),
     dict(lamb_weight_decay=0.01)),
    ("LarsMomentum", dict(learning_rate=0.1, lars_weight_decay=0.0),
     dict(lars_weight_decay=0.0005)),
]


def _opt_id(case):
    name, kw, _ = case
    extra = [k for k in ("use_nesterov", "centered") if kw.get(k)]
    return "-".join([name] + extra)


def _params(rng):
    # the (6,) parameter starts at zero: Lamb's and Lars's zero-norm
    # branches
    return [rng.standard_normal(s).astype(np.float32) * (i != 1)
            for i, s in enumerate(SHAPES)]


@pytest.mark.parametrize("decay", [False, True], ids=["no_decay", "decay"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", OPTIMIZERS, ids=_opt_id)
def test_optimizer_trajectory_matches_reference(case, dtype, decay):
    name, kw, decay_kw = case
    kw = dict(kw, **(decay_kw if decay else {}))
    rng = np.random.default_rng(11)
    params = _params(rng)
    jopt = getattr(paddle.optimizer, name)(
        parameters=[paddle.create_parameter([1], "float32")], **kw)
    jp = [jnp.asarray(p).astype(getattr(jnp, dtype)) for p in params]
    states = jopt.init_states_tree(jp)
    tp = [torch.from_numpy(p).to(getattr(torch, dtype)).requires_grad_()
          for p in params]
    opt = getattr(topt, name)(parameters=tp, **kw)
    lr = kw["learning_rate"]
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        jp, states = jopt.apply_gradients_tree(
            jp, [jnp.asarray(g).astype(getattr(jnp, dtype)) for g in grads],
            states, np.float32(lr))
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step()
    for i, (p, ref) in enumerate(zip(tp, jp)):
        assert p.dtype == getattr(torch, dtype)
        _assert_match(p, ref, dtype, f"param {i}")
    # accumulators: f32 for bf16 parameters, equal to the reference's
    for i, p in enumerate(tp):
        for k, acc in opt._states[id(p)].items():
            want = states[i][k]
            assert acc.dtype == torch.float32, k
            assert _rel(acc, want) <= (1e-6 if dtype == "float32"
                                       else 1e-5), (i, k)


# ------------------------------------------------- eager-path features

def _pairs(rng, n=3):
    """(reference Parameter, port Parameter) pairs on the same values."""
    out = []
    for s in SHAPES[:n]:
        a = rng.standard_normal(s).astype(np.float32)
        out.append((JParam(jnp.asarray(a)), torch.nn.Parameter(
            torch.from_numpy(a.copy()))))
    return out


def _run_eager(pairs, jopt, opt, rng, steps=5, on_step=None):
    for _ in range(steps):
        for jp, tp in pairs:
            g = rng.standard_normal(tuple(tp.shape)).astype(np.float32)
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g.copy())
        jopt.step()
        opt.step()
        if on_step is not None:
            on_step()
    for i, (jp, tp) in enumerate(pairs):
        assert _rel(tp, jp._value) <= 1e-6, i


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_param_groups_optimize_attr_regularizer_and_clip(name):
    """Two groups (a group lr, a group weight decay), a per-parameter lr
    scale, L2Decay and L1Decay regularizers (both folded in as coupled
    L2, as the reference does), a parameter with need_clip False, and a
    global-norm clip applied per group."""
    rng = np.random.default_rng(12)
    pairs = _pairs(rng)
    (ja, ta), (jb, tb), (jc, tc) = pairs
    ja.optimize_attr = {"learning_rate": 0.5}
    ta.optimize_attr = {"learning_rate": 0.5}
    jb.regularizer, tb.regularizer = JL2(0.02), L2Decay(0.02)
    jc.regularizer, tc.regularizer = JL1(0.03), L1Decay(0.03)
    jc.need_clip = tc.need_clip = False
    jopt = getattr(paddle.optimizer, name)(
        learning_rate=0.01, weight_decay=0.01,
        grad_clip=jnn.ClipGradByGlobalNorm(0.5),
        parameters=[{"params": [ja, jb], "learning_rate": 0.05},
                    {"params": [jc], "weight_decay": 0.1}])
    opt = getattr(topt, name)(
        learning_rate=0.01, weight_decay=0.01,
        grad_clip=tnn.ClipGradByGlobalNorm(0.5),
        parameters=[{"params": [ta, tb], "learning_rate": 0.05},
                    {"params": [tc], "weight_decay": 0.1}])
    _run_eager(pairs, jopt, opt, rng)


def test_scheduler_learning_rate_drives_the_eager_step():
    rng = np.random.default_rng(13)
    pairs = _pairs(rng)
    jsched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.1, 10), 2, 0.0,
                              0.1)
    tsched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.1, 10), 2, 0.0,
                              0.1)
    jopt = paddle.optimizer.Momentum(jsched, 0.9,
                                     parameters=[j for j, _ in pairs])
    opt = topt.Momentum(tsched, 0.9, parameters=[t for _, t in pairs])
    lrs = []

    def on_step():
        assert opt.get_lr() == jopt.get_lr()
        lrs.append(opt.get_lr())
        jsched.step()
        tsched.step()

    _run_eager(pairs, jopt, opt, rng, on_step=on_step)
    assert lrs[0] == 0.0 and lrs[1] == 0.05 and lrs[-1] < 0.1
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)
    plain = topt.SGD(0.1, parameters=[pairs[0][1]])
    plain.set_lr(0.25)
    assert plain.get_lr() == 0.25


def _mlp_groups(m, group_lr):
    ps = list(m.parameters())
    return [{"params": ps[:2], "learning_rate": group_lr},
            {"params": ps[2:]}]


@pytest.mark.parametrize("name", ["SGD", "Adam"])
def test_train_step_clips_over_all_groups_as_the_reference(name):
    """TrainStep with two param groups and a global-norm clip, against
    the reference's TrainStep over 3 steps: the clip's norm spans both
    groups, as in the reference's compiled update, where the eager
    `step()` clips each group on its own (held here to differ). A
    callable group learning rate is refused, as the reference's
    compiled step refuses it."""
    from paddle_tpu_torch.jit import TrainStep

    paddle.seed(5)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Linear(8, 3))
    tm, em = (tnn.Sequential(tnn.Linear(4, 8), tnn.Linear(8, 3))
              for _ in range(2))
    arrays = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    load_jax_state_dict(tm, arrays)
    load_jax_state_dict(em, arrays)

    def loss_fn(m, x, y):
        return ((m(x) - y) ** 2).mean()

    def make(mod, m, group_lr=0.05):
        return getattr(mod, name)(
            learning_rate=0.01, grad_clip=(jnn if mod is
                                           paddle.optimizer else tnn
                                           ).ClipGradByGlobalNorm(0.1),
            parameters=_mlp_groups(m, group_lr))

    js = paddle.jit.TrainStep(jm, loss_fn, make(paddle.optimizer, jm))
    ts = TrainStep(tm, loss_fn, make(topt, tm))
    eager = make(topt, em)
    rng = np.random.default_rng(14)
    for _ in range(3):
        x = rng.standard_normal((5, 4)).astype(np.float32)
        y = rng.standard_normal((5, 3)).astype(np.float32)
        jl = float(js(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
        tl = float(ts(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(tl - jl) <= 1e-6 * abs(jl)
        eager.clear_grad()
        loss_fn(em, torch.from_numpy(x), torch.from_numpy(y)).backward()
        eager.step()
    jparams = dict(jm.named_parameters())
    for (n, p), (_, e) in zip(tm.named_parameters(), em.named_parameters()):
        assert _rel(p, jparams[n]._value) <= 1e-5, n
        # per-group clipping is another trajectory, far outside the bound
        assert _rel(e, jparams[n]._value) > 1e-4, n
    lam = TrainStep(em, loss_fn, make(topt, em, group_lr=lambda: 0.05))
    with pytest.raises(NotImplementedError, match="callable"):
        lam(torch.from_numpy(x), torch.from_numpy(y))


def test_minimize_and_clear_gradients():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(0.5, parameters=[p])
    assert opt.minimize((p * torch.tensor([1.0, 2.0, 3.0])).sum()) == \
        ([], [])
    torch.testing.assert_close(p.detach(), torch.tensor([0.5, 0.0, -0.5]))
    opt.clear_gradients()
    assert p.grad is None


def test_names_dedup_and_exclusions_see_optimizer_keys():
    a, b, c = (torch.nn.Parameter(torch.ones(2)) for _ in range(3))
    opt = topt.SGD(0.1, parameters=[("w", a), ("w", b), c])
    assert [n for n, _ in opt._params] == ["w", "w.dedup1", "param_2"]
    seen = []

    def exclude(p):
        seen.append(p.name)
        return p.name.endswith("bias")

    model = torch.nn.Linear(3, 2)
    lamb = topt.Lamb(0.1, lamb_weight_decay=0.5,
                     parameters=model.named_parameters(),
                     exclude_from_weight_decay_fn=exclude)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    bias = model.bias.detach().clone()
    lamb.step()
    assert seen == ["weight", "bias"]
    # zero gradient and the decay excluded: the bias stays
    torch.testing.assert_close(model.bias.detach(), bias)
    lars = topt.LarsMomentum(0.1, parameters=model.named_parameters(),
                             exclude_from_weight_decay=["bias"])
    lars.step()
    torch.testing.assert_close(model.bias.detach(), bias)


def test_state_dict_round_trip_and_reference_keys():
    rng = np.random.default_rng(14)
    pairs = _pairs(rng, n=2)
    jsched = jlr.StepDecay(0.01, step_size=2)
    tsched = tlr.StepDecay(0.01, step_size=2)
    jopt = paddle.optimizer.Adam(jsched, parameters=[j for j, _ in pairs])
    opt = topt.Adam(tsched, parameters=[
        (j.name, t) for j, t in pairs])        # the reference's names
    _run_eager(pairs, jopt, opt, rng, steps=2,
               on_step=lambda: (jsched.step(), tsched.step()))
    jsd, sd = jopt.state_dict(), opt.state_dict()
    assert set(sd) == set(jsd)
    assert sd["@step"] == jsd["@step"] == 2
    assert sd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for k, v in jsd.items():
        if isinstance(v, JTensor):
            assert _rel(sd[k], v._value) <= 1e-6, k
    # into a fresh optimizer (and a fresh scheduler) over the same params
    opt2 = topt.Adam(tlr.StepDecay(0.5, step_size=7), parameters=[
        (j.name, t) for j, t in pairs])
    opt2.set_state_dict(sd)
    assert opt2._step_count == 2 and opt2.get_lr() == opt.get_lr()
    for _, t in pairs:
        for k, v in opt._states[id(t)].items():
            assert torch.equal(opt2._states[id(t)][k], v), k
    # numpy arrays load too (a reference export)
    opt3 = topt.Adam(0.01, parameters=[(j.name, t) for j, t in pairs])
    opt3.set_dict({k: np.asarray(v._value) for k, v in jsd.items()
                   if isinstance(v, JTensor)})
    for _, t in pairs:
        for k, v in opt._states[id(t)].items():
            assert _rel(opt3._states[id(t)][k], v) <= 1e-6, k


def test_resume_from_reference_optimizer_state():
    """3 reference steps, then weights, accumulators, step count and
    schedule carried into the port, then 3 port steps: equal to 6
    reference steps."""
    from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.text.models.gpt import GPTConfig as JaxConfig
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = dict(vocab_size=256, hidden_size=32, num_layers=1, num_heads=2,
               max_seq_len=16)
    paddle.seed(3)
    jm = JaxGPT(JaxConfig(**cfg))
    jsched = jlr.CosineAnnealingDecay(1e-4, T_max=10)
    jopt = paddle.optimizer.AdamW(jsched, parameters=jm.parameters(),
                                  weight_decay=0.1)
    rng = np.random.default_rng(15)
    batches = [rng.integers(0, 256, (2, 16)).astype(np.int64)
               for _ in range(6)]

    def ref_step(ids):
        loss = jm.fused_head_loss(paddle.to_tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()

    for ids in batches[:3]:
        ref_step(ids)
    weights = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    state = {k: (np.array(v.numpy()) if isinstance(v, JTensor) else v)
             for k, v in jopt.state_dict().items()}
    names = [p.name for p in jm.state_dict().values()]
    for ids in batches[3:]:
        ref_step(ids)

    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_jax_state_dict(tm, weights)
    tsched = tlr.CosineAnnealingDecay(1e-4, T_max=10)
    opt = topt.AdamW(tsched, parameters=tm.named_parameters(),
                     weight_decay=0.1)
    load_jax_optimizer_state(opt, tm, state, names)
    assert opt._step_count == 3 and tsched.last_epoch == 3
    for ids in batches[3:]:
        loss = tm.fused_head_loss(torch.from_numpy(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        tsched.step()
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        err = np.abs(_f32(p) - np.asarray(jparams[n].numpy())).max()
        assert err <= 1e-5, (n, err)
        m1 = opt._states[id(p)]["moment1"]
        want = np.asarray(jopt._states[jparams[n].name]["moment1"])
        assert np.abs(_f32(m1) - want).max() <= 1e-5 * max(
            np.abs(want).max(), 1e-3), n


# ---------------------------------------------------------------- clipping

CLIPS = [("ClipGradByValue", (0.3,)), ("ClipGradByValue", (0.5, -0.2)),
         ("ClipGradByNorm", (0.7,)), ("ClipGradByGlobalNorm", (1.5,)),
         ("ClipGradByGlobalNorm", (100.0,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls,args", CLIPS,
                         ids=[f"{c}{a}" for c, a in CLIPS])
def test_clip_classes_match_reference(cls, args, dtype):
    rng = np.random.default_rng(16)
    jpairs, tpairs = [], []
    for i, s in enumerate(SHAPES):
        g = rng.standard_normal(s).astype(np.float32)
        jp = JParam(jnp.zeros(s, jnp.float32))
        tp = torch.nn.Parameter(torch.zeros(s))
        jp.need_clip = tp.need_clip = i != 1
        jpairs.append((jp, JTensor(jnp.asarray(g).astype(
            getattr(jnp, dtype)))))
        tpairs.append((tp, torch.from_numpy(g).to(getattr(torch, dtype))))
    jpairs.append((JParam(jnp.zeros([2])), None))
    tpairs.append((torch.nn.Parameter(torch.zeros(2)), None))
    jout = getattr(jnn, cls)(*args)(jpairs)
    tout = getattr(tnn, cls)(*args)(tpairs)
    assert tout[-1][1] is None
    for i, ((_, jg), (_, tg)) in enumerate(zip(jout[:-1], tout[:-1])):
        assert tg.dtype == getattr(torch, dtype)
        _assert_match(tg, jg._value, dtype, i)
    assert torch.equal(tout[1][1], tpairs[1][1])     # need_clip False


@pytest.mark.parametrize("norm_type", [2.0, 3.0, float("inf")])
def test_clip_grad_functions_match_reference(norm_type):
    rng = np.random.default_rng(17)
    jps, tps = [], []
    for s in SHAPES:
        g = rng.standard_normal(s).astype(np.float32)
        jp, tp = JParam(jnp.zeros(s)), torch.nn.Parameter(torch.zeros(s))
        jp.grad = JTensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g.copy())
        jps.append(jp)
        tps.append(tp)
    jt = jclip.clip_grad_norm_(jps, 1.0, norm_type=norm_type)
    tt = tnn.clip_grad_norm_(tps, 1.0, norm_type=norm_type)
    assert _rel(tt, jt._value) <= 1e-6
    for jp, tp in zip(jps, tps):
        assert _rel(tp.grad, jp.grad._value) <= 1e-6
    jclip.clip_grad_value_(jps, 0.05)
    tnn.clip_grad_value_(tps, 0.05)
    for jp, tp in zip(jps, tps):
        assert _rel(tp.grad, jp.grad._value) <= 1e-6
    assert float(tnn.clip_grad_norm_([torch.nn.Parameter(torch.ones(2))],
                                     1.0)) == 0.0


# --------------------------------------------------------------- schedules

SCHEDULES = [
    ("NoamDecay", dict(d_model=64, warmup_steps=5)),
    ("PiecewiseDecay", dict(boundaries=[3, 9], values=[0.1, 0.03, 0.001])),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.2)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=7,
                             power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=7, cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=5, start_lr=0.0,
                          end_lr=0.1)),
    ("LinearWarmup", dict(learning_rate="sched", warmup_steps=4,
                          start_lr=0.01, end_lr=0.2)),
    ("ExponentialDecay", dict(learning_rate=0.3, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.3, milestones=[4, 11, 20])),
    ("StepDecay", dict(learning_rate=0.3, step_size=4, gamma=0.5)),
    ("LambdaDecay", dict(learning_rate=0.3,
                         lr_lambda=lambda e: 0.95 ** e)),
    ("ReduceOnPlateau", dict(learning_rate=1.0, patience=2, factor=0.5,
                             cooldown=1)),
    ("ReduceOnPlateau", dict(learning_rate=1.0, mode="max",
                             threshold_mode="abs", patience=1)),
    ("CosineAnnealingDecay", dict(learning_rate=0.2, T_max=13,
                                  eta_min=0.01)),
    ("MultiplicativeDecay", dict(learning_rate=0.3,
                                 lr_lambda=lambda e: 0.9)),
    ("OneCycleLR", dict(max_learning_rate=0.5, total_steps=30)),
    ("OneCycleLR", dict(max_learning_rate=0.5, total_steps=30,
                        anneal_strategy="linear", phase_pct=0.4)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=4, step_size_down=6)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=3, mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=3, mode="exp_range", exp_gamma=0.9)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=5, scale_fn=lambda c: 1.0 / c)),
]


def _make_sched(mod, name, kw):
    kw = dict(kw)
    if kw.get("learning_rate") == "sched":
        kw["learning_rate"] = mod.ExponentialDecay(0.2, 0.8)
    return getattr(mod, name)(**kw)


def _metric(i):
    # plateaus and improvements, for ReduceOnPlateau
    return [1.0, 0.9, 0.9, 0.9, 0.9, 0.5, 0.5, 0.5, 0.5, 0.49][i % 10]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedule_values_and_state_dict_equal_reference(name, kw):
    assert set(tlr.__all__) == set(jlr.__all__)
    j, t = _make_sched(jlr, name, kw), _make_sched(tlr, name, kw)
    plateau = name == "ReduceOnPlateau"
    jv, tv = [], []
    for i in range(30):
        jv.append(j())
        tv.append(t())
        if plateau:
            j.step(_metric(i))
            # the port also takes a 0-d tensor
            t.step(torch.tensor(_metric(i), dtype=torch.float64)
                   if i % 2 else _metric(i))
        else:
            j.step()
            t.step()
        if i == 14:      # a state_dict round trip half way
            t2 = _make_sched(tlr, name, kw)
            t2.set_state_dict(t.state_dict())
            assert t2.state_dict() == t.state_dict()
    assert tv == jv                       # bit for bit
    assert all(isinstance(v, float) or v == 0 for v in tv)
    assert t.state_dict() == j.state_dict()
    assert t.state_keys() == j.state_keys()
    # a fresh pair loaded from those states, then an explicit epoch
    t3, j3 = _make_sched(tlr, name, kw), _make_sched(jlr, name, kw)
    t3.set_dict(t.state_dict())
    j3.set_dict(j.state_dict())
    if not plateau:
        t3.step(epoch=40)
        j3.step(epoch=40)
    assert t3() == j3()


def test_lambda_decay_state_dict_drops_the_lambda():
    t = tlr.LambdaDecay(0.1, lambda e: 0.5)
    assert "lr_lambda" not in t.state_dict()
    assert math.isclose(t(), 0.05)
