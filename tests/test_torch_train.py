"""The training slice: the PyTorch port against the JAX package on CPU.

gpt_tiny with shared weights (the JAX model's state_dict loaded into the
port), the losses, AdamW and TrainStep. Inputs are made from a seed with
numpy and cast to float32 / int explicitly (the test conftest turns x64
on). Tolerances, each with its reason:

* f32 losses and gradients: 1e-5 relative to each tensor's max-abs —
  the frameworks sum matmuls and reductions in different orders;
* the 5-step f32 AdamW trajectory: losses 1e-5 relative, parameters
  1e-4 max-abs — Adam normalises each update to ~lr (1e-3), so where a
  gradient element is small its summation-order noise is magnified
  into the step: 1e-4 is 2 % of the 5-step budget of 5·lr;
* O1 bf16, op by op (teacher-forced): one bf16 ulp, 1e-2 of each
  tensor's max-abs, with the dtype equal at every module boundary;
  end to end, every gradient within 3e-2 of its max-abs — the 1-ulp
  rounding differences compound through the backward.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.nn import functional as JF
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models import GPTPretrainingCriterion as JaxCrit
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt_tiny)

pytestmark = pytest.mark.torch_port

VOCAB = 2048


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _rel_err(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _pair(seed=40, **cfg):
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**cfg))
    arrays = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, arrays)
    return jm, tm


def _ids(seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int64)


def _jax_loss(jm, ids, fused):
    t = paddle.to_tensor(ids)
    return jm.fused_head_loss(t) if fused else JaxCrit()(jm(t), t)


def _torch_loss(tm, ids, fused):
    t = torch.from_numpy(ids)
    return tm.fused_head_loss(t) if fused else \
        GPTPretrainingCriterion()(tm(t), t)


# ------------------------------------------------------------------ slice

@pytest.mark.parametrize("fused,tied,recompute", [
    (False, True, False), (True, True, False), (False, False, False),
    (True, False, False), (False, True, True)],
    ids=["criterion", "fused_head", "untied", "untied-fused_head",
         "recompute"])
def test_gpt_tiny_loss_and_every_grad_match(fused, tied, recompute):
    jm, tm = _pair(tie_embeddings=tied, recompute=recompute)
    ids = _ids()
    jl = _jax_loss(jm, ids, fused)
    jl.backward()
    tl = _torch_loss(tm, ids, fused)
    tl.backward()
    assert _rel_err(tl, float(jl.numpy())) <= 1e-5
    jgrads = dict(jm.named_parameters())
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(jgrads) and len(names) > 10
    for n, p in tm.named_parameters():
        err = _rel_err(p.grad, jgrads[n].grad.numpy())
        assert err <= 1e-5, f"{n}: rel err {err:.2e}"


def test_train_step_5_step_adamw_trajectory_f32():
    jm, tm = _pair(seed=41)
    ids = _ids(1)
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.01)
    jstep = paddle.jit.TrainStep(
        jm, lambda m, x: JaxCrit()(m(x), x), jopt)
    tstep = TrainStep(tm, lambda m, x: GPTPretrainingCriterion()(m(x), x),
                      topt)
    jlosses = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(5)]
    tlosses = [tstep(torch.from_numpy(ids)).item() for _ in range(5)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    assert topt._step_count == 5 and tstep.num_batch_signatures == 1
    tparams = export_state_dict(tm)
    d = tm.config.hidden_size
    for n, v in jm.state_dict().items():
        got, want = tparams[n], v.numpy()
        if n.endswith("qkv.bias"):
            # the key bias's gradient is 0 in exact arithmetic (softmax
            # is shift-invariant per row): both packages hold rounding
            # noise there, which Adam turns into ±lr steps of either
            # sign — held to 5 steps of lr, the rest of the bias as usual
            assert np.abs(got[d:2 * d] - want[d:2 * d]).max() <= 5 * 2e-3
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(
                want, np.s_[d:2 * d])
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=n)


def _jax_value_and_grads(jm, loss_of):
    """The reference's loss and parameter gradients as its compiled
    `TrainStep` takes them (`jax.value_and_grad` over the parameter
    values; jit/__init__.py `pure_loss`): its eager tape cannot run
    backward through an O1 graph."""
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
    return float(loss), {n: g for (n, _), g in zip(params, grads)}


def _o1(mod):
    return mod.auto_cast(level="O1", dtype="bfloat16")


def _check_o1_loss_and_every_grad(fused):
    """The main path's precision (bf16 O1) end to end: the loss and every
    parameter gradient against the reference's. Both sides round to bf16
    at the same op boundaries, but each rounding lands on either
    neighbour as the two frameworks' f32 sums differ, and those 1-ulp
    differences compound through the backward: 3e-2 of each gradient's
    max-abs, about the size of O1's own departure from f32, so this
    cannot tell one cast point from another. At this random init the
    loss sits near ln V whatever the layers compute, so its 1e-4 says
    little too; `test_o1_cast_points_match_reference_op_by_op` holds
    each op to one rounding and each module boundary to its dtype."""
    jm, tm = _pair(seed=42)
    ids = _ids(2)
    with _o1(jamp):
        jl, jgrads = _jax_value_and_grads(
            jm, lambda: _jax_loss(jm, ids, fused))
    with _o1(tamp):
        tl = _torch_loss(tm, ids, fused)
    assert tl.dtype == torch.float32
    assert abs(tl.item() - jl) <= 1e-4 * abs(jl)
    tl.backward()   # O1 keeps f32 parameters and f32 gradients
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32
        err = _rel_err(p.grad, jgrads[n])
        assert err <= 3e-2, f"{n}: rel err {err:.2e}"


def test_o1_bf16_loss_within_bf16_tolerance():
    _check_o1_loss_and_every_grad(fused=False)


def test_o1_bf16_fused_head_loss_and_every_grad_match():
    _check_o1_loss_and_every_grad(fused=True)


def _as_np(t):
    """(float32 values, dtype name) of a reference or port tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy(), str(t.dtype).split(".")[-1]
    a = np.asarray(t.numpy())
    return a.astype(np.float32), a.dtype.name


def test_o1_cast_points_match_reference_op_by_op(monkeypatch):
    """Teacher-forced O1 forward: every module of the port gets the
    reference's input for that module and its output is replaced by the
    reference's, so each op runs on identical inputs on both sides. Each
    module's output, and each module's input as the port computed it
    (the functional ops between modules: attention, gelu, the residual
    adds), must have the reference's dtype and values: bf16 within
    1e-2 of the tensor's max-abs (one bf16 ulp is at most 2^-7 of a
    value, where the two f32 accumulations round to different
    neighbours), f32 within 1e-5. The loss on the reference's logits
    must agree to 1e-5 (f32 math on identical bf16 logits). The
    reference runs its flash Pallas kernel (interpret mode), the kernel
    of its main path, so the attention comparison is like for like."""
    from paddle_tpu.nn.functional import attention as jattn
    from paddle_tpu.ops.pallas_kernels import flash_attention as jfa

    monkeypatch.setattr(jattn, "_pallas_eligible", lambda q, k: True)
    monkeypatch.setattr(jfa, "flash_attention_bshd", functools.partial(
        jfa.flash_attention_bshd, interpret=True))
    jm, tm = _pair(seed=44)
    ids = _ids(5)

    trace, handles = {}, []
    for name, layer in jm.named_sublayers():
        def pre(layer, inputs, name=name):       # one entry per call
            trace.setdefault(name, []).append({"in": _as_np(inputs[0])})

        def post(layer, inputs, outputs, name=name):
            trace[name][-1]["out"] = _as_np(outputs)

        handles += [layer.register_forward_pre_hook(pre),
                    layer.register_forward_post_hook(post)]
    with _o1(jamp):
        jlogits = jm(paddle.to_tensor(ids))
        jloss = float(JaxCrit()(jlogits, paddle.to_tensor(ids)).numpy())
    for h in handles:
        h.remove()

    checked = []

    def check(what, got, want):
        (g, gdt), (w, wdt) = _as_np(got), want
        if wdt.startswith("int"):
            np.testing.assert_array_equal(g, w, err_msg=what)
            return
        assert gdt == wdt, f"{what}: dtype {gdt}, reference {wdt}"
        tol = 1e-2 if wdt == "bfloat16" else 1e-5
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"{what}: rel err {err:.2e} > {tol:.0e}"
        checked.append((what, wdt))

    def forced(want):
        a, dt = want
        return torch.from_numpy(a).to(getattr(torch, dt))

    calls = dict.fromkeys(trace, 0)
    for name, mod in tm.named_modules():
        if name not in trace:
            continue

        def tpre(mod, args, name=name):
            want = trace[name][calls[name]]["in"]
            check(f"{name} input", args[0], want)
            return (forced(want),) + tuple(args[1:])

        def tpost(mod, args, out, name=name):
            want = trace[name][calls[name]]["out"]
            calls[name] += 1
            check(f"{name} output", out, want)
            return forced(want)

        mod.register_forward_pre_hook(tpre)
        mod.register_forward_hook(tpost)
    with _o1(tamp):
        tlogits = tm(torch.from_numpy(ids))
        check("logits", tlogits, _as_np(jlogits))
        tloss = GPTPretrainingCriterion()(forced(_as_np(jlogits)),
                                          torch.from_numpy(ids))
    assert tloss.dtype == torch.float32
    assert abs(tloss.item() - jloss) <= 1e-5 * abs(jloss)
    assert calls == {n: len(t) for n, t in trace.items()}
    # every linear and layer norm was held, in its O1 dtype: bf16 out of
    # the matmuls and attention, f32 out of the norms and residual adds
    params = {n.rsplit(".", 1)[0] for n, _ in tm.named_parameters()}
    outs = dict((w[:-len(" output")], dt) for w, dt in checked
                if w.endswith(" output"))
    assert params <= set(outs)
    assert {outs[n] for n in params if ".ln" in n} == {"float32"}
    assert {outs[n] for n in params if n.endswith(("qkv", "fc1"))} == {
        "bfloat16"}
    assert dict(checked)["gpt.layers.0.proj input"] == "bfloat16"


def test_recompute_replays_dropout_masks():
    """Dropout > 0: the recomputed forward draws the same keep masks as
    the forward it replaces, so gradients equal the keep-everything
    run's under the same generator."""
    grads = []
    for rc in (False, True):
        tm = GPTForCausalLM(gpt_tiny(dropout=0.2, recompute=rc),
                            device="cpu", seed=5)
        ids = torch.from_numpy(_ids(3))
        with trng.generator_scope(torch.Generator().manual_seed(9)):
            GPTPretrainingCriterion()(tm(ids), ids).backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_step_remat_and_donation():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=6)
    ref = GPTForCausalLM(gpt_tiny(), device="cpu", seed=6)
    ids = torch.from_numpy(_ids(4))

    def loss_fn(m, x):
        return GPTPretrainingCriterion()(m(x), x)

    a = TrainStep(tm, loss_fn, AdamW(1e-3, parameters=tm.parameters()),
                  remat=True, donate_params=False)
    b = TrainStep(ref, loss_fn, AdamW(1e-3, parameters=ref.parameters()))
    held = tm.gpt.wte.weight.detach()        # the pre-step storage
    before = held.clone()
    la, lb = a(ids), b(ids)
    torch.testing.assert_close(la, lb, rtol=1e-6, atol=0)
    for p, q in zip(tm.parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7)
    assert torch.equal(held, before)          # not donated: left as it was
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        TrainStep(tm, loss_fn, a.optimizer, remat="dots_saveable")


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_loss_and_grad_match(reduction, weighted, dtype):
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 5, 37)).astype(np.float32)
    labels = rng.integers(0, 37, (3, 5)).astype(np.int64)
    labels[0, 1] = labels[2, 4] = -100                  # ignore_index
    weight = rng.uniform(0.5, 2.0, 37).astype(np.float32)
    cot = rng.standard_normal((3, 5)).astype(np.float32)

    jx = paddle.to_tensor(jnp.asarray(logits).astype(getattr(jnp, dtype)),
                          stop_gradient=False)
    jloss = JF.cross_entropy(
        jx, paddle.to_tensor(labels), reduction=reduction,
        weight=paddle.to_tensor(weight) if weighted else None)
    (jloss * paddle.to_tensor(cot) if reduction == "none"
     else jloss).sum().backward()

    tx = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tloss = TF.cross_entropy(
        tx, torch.from_numpy(labels), reduction=reduction,
        weight=torch.from_numpy(weight) if weighted else None)
    (tloss * torch.from_numpy(cot) if reduction == "none"
     else tloss).sum().backward()

    # the loss is f32 math on identical inputs on both sides: 1e-5 in
    # either dtype; a bf16 gradient may round to the other neighbour
    # (one ulp, at most 2^-7 of a value): 8e-3 of its max-abs
    assert tloss.dtype == torch.float32
    assert _rel_err(tloss, jloss.numpy()) <= 1e-5
    assert tx.grad.dtype == tx.dtype
    assert _rel_err(tx.grad, np.asarray(
        jnp.asarray(jx.grad.numpy(), jnp.float32))) <= (
        1e-5 if dtype == "float32" else 8e-3)


@pytest.mark.parametrize("transpose_weight", [False, True])
def test_fused_linear_cross_entropy_loss_and_grads_match(transpose_weight):
    rng = np.random.default_rng(9)
    n_tok, d, vocab = 2 * 11, 16, 53     # 22 rows, blocks of 8: padded
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    w = rng.standard_normal((vocab, d) if transpose_weight
                            else (d, vocab)).astype(np.float32) * 0.3
    labels = rng.integers(0, vocab, (2, 11)).astype(np.int64)
    labels[1, 3] = -100
    b = rng.standard_normal(vocab).astype(np.float32)
    jx, jw, jb = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b))
    jloss = JF.fused_linear_cross_entropy(
        jx, jw, paddle.to_tensor(labels), bias=jb,
        transpose_weight=transpose_weight, block_size=8)
    jloss.backward()
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    tloss = TF.fused_linear_cross_entropy(
        tx, tw, torch.from_numpy(labels), bias=tb,
        transpose_weight=transpose_weight, block_size=8)
    tloss.backward()
    assert n_tok % 8 != 0
    assert _rel_err(tloss, jloss.numpy()) <= 1e-5
    for name, t, j in (("x", tx, jx), ("w", tw, jw), ("bias", tb, jb)):
        assert _rel_err(t.grad, j.grad.numpy()) <= 1e-5, name


@pytest.mark.parametrize("kw", [dict(soft_label=True),
                                dict(use_softmax=False), dict(axis=0)])
def test_unported_cross_entropy_forms_raise_naming_roadmap_row(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        TF.cross_entropy(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                         **kw)


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_updates_match_apply_gradients_tree(dtype):
    rng = np.random.default_rng(10)
    shapes = [(4, 6), (6,), (3, 2, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    lr, wd = 1e-2, 0.05
    jopt = paddle.optimizer.AdamW(lr, parameters=[paddle.create_parameter(
        [1], "float32")], weight_decay=wd)
    jp = [jnp.asarray(p).astype(getattr(jnp, dtype)) for p in params]
    states = jopt.init_states_tree(jp)
    tp = [torch.from_numpy(p).to(getattr(torch, dtype)).requires_grad_()
          for p in params]
    topt = AdamW(lr, parameters=tp, weight_decay=wd)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, states = jopt.apply_gradients_tree(
            jp, [jnp.asarray(g).astype(getattr(jnp, dtype)) for g in grads],
            states, np.float32(lr))
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g).to(p.dtype)
        topt.step()
    for p, ref in zip(tp, jp):
        assert p.dtype == getattr(torch, dtype)
        got = p.detach().float().numpy()
        want = np.asarray(jnp.asarray(ref, jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:   # one bf16 rounding of the same f32 update: equal bits
            np.testing.assert_array_equal(got, want)
    m1 = topt._states[id(tp[0])]["moment1"]
    assert m1.dtype == torch.float32      # f32 accumulators for bf16


def test_adamw_apply_decay_param_fun_takes_state_dict_names():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=7)
    seen = []

    def decay(name):
        seen.append(name)
        return "bias" not in name and "ln" not in name

    opt = AdamW(1e-3, parameters=tm.named_parameters(), weight_decay=0.5,
                apply_decay_param_fun=decay)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)    # zero grad: only decay moves p
    opt.step()
    assert set(seen) == set(before)
    for n, p in tm.named_parameters():
        if decay(n):
            torch.testing.assert_close(p, before[n] * (1 - 1e-3 * 0.5))
        else:
            assert torch.equal(p, before[n])


def test_optimizer_unported_options_raise():
    p = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        AdamW(1e-3, parameters=p, grad_clip=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        AdamW(lambda: 1e-3, parameters=p)
    for kw in (dict(multi_precision=True), dict(lazy_mode=True),
               dict(name="opt")):     # not taken: never silently ignored
        with pytest.raises(TypeError):
            AdamW(1e-3, parameters=p, **kw)


# --------------------------------------------------------------- amp & rest

def test_amp_lists_and_cast_points_match_reference():
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST
    x = torch.ones(2, 3)
    with tamp.auto_cast():
        assert TF.linear(x, torch.ones(3, 4)).dtype == torch.bfloat16
        assert TF.layer_norm(x.bfloat16(), (3,)).dtype == torch.float32
        assert TF.gelu(x).dtype == torch.float32          # follows
        assert "cross_entropy" not in tamp.black_list()
    with tamp.auto_cast(custom_black_list={"linear"}):
        assert TF.linear(x, torch.ones(3, 4)).dtype == torch.float32
    assert not tamp.state().enabled
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        with tamp.auto_cast(level="O2"):
            pass
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tamp.decorate(None)


def test_model_flops_matches_reference():
    from paddle_tpu.observability.steptrace import model_flops as jflops
    from paddle_tpu_torch.observability.steptrace import model_flops
    from paddle_tpu_torch.text.models.gpt import gpt_1p3b, gpt_small

    for cfg in (gpt_small(), gpt_1p3b(), {"hidden_size": 64,
                                          "num_layers": 2,
                                          "vocab_size": 100}):
        assert model_flops(cfg, 16, 1024) == jflops(cfg, 16, 1024)


def test_untied_head_loads_and_exports_key_for_key():
    jm, tm = _pair(seed=43, tie_embeddings=False)
    arrays = export_state_dict(tm)
    ref = {k: v.numpy() for k, v in jm.state_dict().items()}
    assert "lm_head.weight" in arrays and set(arrays) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(arrays[k], ref[k])
    arrays["lm_head.weight"][0, 0] += 1.0      # a copy, never a view
    assert tm.lm_head.weight[0, 0].item() == pytest.approx(
        float(ref["lm_head.weight"][0, 0]))


def test_rng_streams_are_reproducible_from_the_seed():
    trng.seed(123)
    a = [torch.rand(3, generator=trng.next_generator()) for _ in range(2)]
    trng.seed(123)
    b = [torch.rand(3, generator=trng.next_generator()) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


def test_cuda_only_entry_points_raise_without_gpu(monkeypatch):
    from paddle_tpu_torch.ops.cuda_kernels import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else True)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
