"""BERT / ERNIE (paddle_tpu_torch/text/models/bert.py) against the JAX
package's on the CPU, at bert_tiny, with the reference model's weights
carried across by `convert.load_jax_state_dict`. Every tensor is held
by its largest difference over its own max-abs, within 1e-5 unless a
case says otherwise:

- `BertModel`: the sequence and pooled outputs;
- `BertForPretraining`: the MLM and NSP logits with no mask, a 2-D
  keep-mask (the dense path) and 1-D lengths (the flash kernels'
  kv_lens, their plain versions here) with a 0-length row;
- the masked prefix against the unpadded sequence (the reference's own
  check, tests/test_text_models.py), for both mask forms;
- `BertPretrainingCriterion` and `fused_mlm_loss`, with their gradients;
- `BertForSequenceClassification`;
- three f32 AdamW steps under `jit.TrainStep` at bench_bert's lr 1e-4:
  the losses 1e-5 relative, and each parameter's change over the steps
  against the reference's change, 1e-5 relative in norm past one f32
  spacing a step, leaving out the elements whose reference gradient is
  zero to rounding (`GRAD_ZERO`): AdamW normalizes each gradient, so the frameworks'
  summation noise there (the key bias: analytically 0) becomes a step
  of up to lr in either direction;
- a float 1-D mask raising the reference's ValueError;
- at mp 2 (gloo processes, tests/torch_hybrid_worker.py `bert_mp`):
  the MLM / NSP logits and the loss against the serial model, 1e-4, as
  the reference's test_tp_matches_serial holds its own.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text import models as JM
from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text import models as TM

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then (small ops slow down tenfold); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
B, S = 3, 16
# an element whose reference gradient is below this share of its leaf's
# max-abs gradient holds rounding noise (the key bias's is analytically
# 0: softmax ignores a per-query shift), which AdamW's normalization
# turns into a step of up to lr in either direction
GRAD_ZERO = 1e-6


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    jmesh.reset_mesh()
    yield
    tmesh.reset_mesh()


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy())


def _pair(name, **kw):
    paddle.seed(0)
    jm = getattr(JM, name)(JM.bert_tiny(), **kw)
    w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tm = getattr(TM, name)(TM.bert_tiny(), device="cpu", **kw)
    load_jax_state_dict(tm, w)
    return jm, tm, w


def _batch(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (b, s))
    tt = rng.integers(0, 2, (b, s))
    labels = np.full((b, s), -100, np.int64)
    pick = rng.random((b, s)) < 0.3
    pick[:, 0] = True
    labels[pick] = ids[pick]
    nsp = rng.integers(0, 2, (b,))
    return ids, tt, labels, nsp


def _masks(kind, b=B, s=S):
    lens = np.array([s, 9, 0][:b])
    if kind == "none":
        return None
    if kind == "lengths":
        return lens
    return (np.arange(s)[None, :] < lens[:, None]).astype(np.int64)


def _both(x):
    return (None, None) if x is None else (paddle.to_tensor(x),
                                           torch.from_numpy(x))


def test_state_dict_carries_across_key_for_key():
    _, tm, w = _pair("BertForPretraining")
    back = export_state_dict(tm)
    assert set(back) == set(w)
    for k, v in w.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


def test_bert_model_sequence_and_pooled_outputs():
    jm, tm, _ = _pair("BertModel")
    ids, tt, _, _ = _batch()
    with jax.default_matmul_precision("highest"):
        js, jp = jm(paddle.to_tensor(ids), paddle.to_tensor(tt))
    ts, tp = tm(torch.from_numpy(ids), torch.from_numpy(tt))
    assert _rel(_np(ts), _np(js)) < TOL
    assert _rel(_np(tp), _np(jp)) < TOL
    assert TM.ErnieModel is TM.BertModel and \
        TM.ErnieForPretraining is TM.BertForPretraining


@pytest.mark.parametrize("mask", ["none", "keep2d", "lengths"])
def test_pretraining_logits_under_every_mask_form(mask):
    jm, tm, _ = _pair("BertForPretraining")
    ids, tt, _, _ = _batch(1)
    jmask, tmask = _both(_masks(mask))
    with jax.default_matmul_precision("highest"):
        jl, jn = jm(paddle.to_tensor(ids), paddle.to_tensor(tt), jmask)
    tl, tn = tm(torch.from_numpy(ids), torch.from_numpy(tt), tmask)
    assert _rel(_np(tl), _np(jl)) < TOL
    assert _rel(_np(tn), _np(jn)) < TOL


@pytest.mark.parametrize("mask", ["keep2d", "lengths"])
def test_masked_prefix_matches_the_unpadded_sequence(mask):
    """The reference's own check: a prefix with a garbage tail masked
    out gives the unpadded sequence's outputs on the prefix."""
    jm, tm, _ = _pair("BertModel")
    rng = np.random.default_rng(2)
    real = rng.integers(1, 1024, (1, 16))
    padded = np.concatenate([real, rng.integers(1, 1024, (1, 8))], axis=1)
    if mask == "keep2d":
        m = np.concatenate([np.ones((1, 16)), np.zeros((1, 8))],
                           axis=1).astype(np.int64)
    else:
        m = np.array([16])
    short, _ = tm(torch.from_numpy(real))
    masked, _ = tm(torch.from_numpy(padded), attention_mask=torch.from_numpy(m))
    assert _rel(_np(masked)[:, :16], _np(short)) < TOL
    with jax.default_matmul_precision("highest"):
        jmasked, _ = jm(paddle.to_tensor(padded),
                        attention_mask=paddle.to_tensor(m))
    assert _rel(_np(masked)[:, :16], _np(jmasked)[:, :16]) < TOL


def _losses_and_grads(model, ids, tt, labels, nsp, fused, ref):
    if ref:
        crit = JM.BertPretrainingCriterion()
        args = [paddle.to_tensor(a) for a in (ids, tt, labels, nsp)]
        with jax.default_matmul_precision("highest"):
            if fused:
                loss = model.fused_mlm_loss(args[0], args[2], args[1],
                                            nsp_labels=args[3])
            else:
                ml, nl = model(args[0], args[1])
                loss = crit(ml, args[2], nl, args[3])
            loss.backward()
        return float(loss.numpy()), {k: _np(p.grad) for k, p in
                                     model.named_parameters()}
    crit = TM.BertPretrainingCriterion()
    args = [torch.from_numpy(a) for a in (ids, tt, labels, nsp)]
    if fused:
        loss = model.fused_mlm_loss(args[0], args[2], args[1],
                                    nsp_labels=args[3])
    else:
        ml, nl = model(args[0], args[1])
        loss = crit(ml, args[2], nl, args[3])
    loss.backward()
    return float(loss), {k: _np(p.grad) for k, p in model.named_parameters()}


@pytest.mark.parametrize("fused", [False, True])
def test_pretraining_loss_and_gradients(fused):
    """`BertPretrainingCriterion` over forward()'s logits, and
    `fused_mlm_loss`, with NSP: the loss and every gradient."""
    jm, tm, _ = _pair("BertForPretraining")
    batch = _batch(3)
    jl, jg = _losses_and_grads(jm, *batch, fused=fused, ref=True)
    tl, tg = _losses_and_grads(tm, *batch, fused=fused, ref=False)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert set(tg) == set(jg)
    for k in tg:
        assert _rel(tg[k], jg[k]) < TOL, k


def test_sequence_classification():
    jm, tm, _ = _pair("BertForSequenceClassification", num_classes=3)
    ids, tt, _, _ = _batch(4)
    m = _masks("keep2d")
    with jax.default_matmul_precision("highest"):
        jo = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                paddle.to_tensor(m))
    to = tm(torch.from_numpy(ids), torch.from_numpy(tt), torch.from_numpy(m))
    assert to.shape == (B, 3) and _rel(_np(to), _np(jo)) < TOL


def test_three_adamw_train_steps_match_reference():
    """Each leaf's change over the three steps against the reference's,
    in norm, 1e-5 relative, on the elements whose reference gradient at
    the first step is not zero to rounding (see GRAD_ZERO); an element
    may differ by the f32 spacing of its value once a step (three),
    since each side rounds its parameter after every update (a weight
    near 3 has a spacing of 1e-3 of its change)."""
    jm, tm, w0 = _pair("BertForPretraining")
    ids, tt, labels, nsp = _batch(5)
    _, g0 = _losses_and_grads(_pair("BertForPretraining")[0], ids, tt,
                              labels, nsp, fused=False, ref=True)

    def jloss(m, a, t, l, n):
        ml, nl = m(a, t)
        return JM.BertPretrainingCriterion()(ml, l, nl, n)

    def tloss(m, a, t, l, n):
        ml, nl = m(a, t)
        return TM.BertPretrainingCriterion()(ml, l, nl, n)

    jstep = paddle.jit.TrainStep(
        jm, jloss, paddle.optimizer.AdamW(1e-4, parameters=jm.parameters()))
    tstep = TrainStep(tm, tloss, AdamW(1e-4, parameters=tm.parameters()))
    jargs = [paddle.to_tensor(a) for a in (ids, tt, labels, nsp)]
    targs = [torch.from_numpy(a) for a in (ids, tt, labels, nsp)]
    with jax.default_matmul_precision("highest"):
        jl = [float(jstep(*jargs).numpy()) for _ in range(3)]
    tl = [float(tstep(*targs)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert jl[2] < jl[0]
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    got = export_state_dict(tm)
    assert set(got) == set(want) == set(w0) == set(g0)
    for k, v in got.items():
        g = np.abs(g0[k])
        kept = g >= GRAD_ZERO * g.max()
        d_ref = (want[k].astype(np.float64) - w0[k])[kept]
        d_got = (v.astype(np.float64) - w0[k])[kept]
        ulps = 3 * np.spacing(np.maximum(np.abs(want[k]), np.abs(w0[k])))
        off = np.maximum(np.abs(d_got - d_ref) - ulps[kept], 0.0)
        assert np.linalg.norm(off) <= TOL * np.linalg.norm(d_ref), k


def test_float_lengths_mask_raises_the_reference_message():
    jm, tm, _ = _pair("BertModel")
    ids = np.ones((2, 8), np.int64)
    with pytest.raises(ValueError) as jerr:
        jm(paddle.to_tensor(ids),
           attention_mask=paddle.to_tensor(np.array([8.0, 4.0])))
    with pytest.raises(ValueError) as terr:
        tm(torch.from_numpy(ids),
           attention_mask=torch.tensor([8.0, 4.0]))
    assert "LENGTHS" in str(terr.value)
    assert str(terr.value).split(";")[0] == str(jerr.value).split(";")[0]


def test_fused_loss_refuses_mp_and_models_default_to_cuda(monkeypatch):
    _, tm, _ = _pair("BertForPretraining")
    tmesh.init_mesh(mp=2, world_size=2)
    ids = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="FULL vocab"):
        tm.fused_mlm_loss(ids, ids)
    tmesh.reset_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TM.BertModel, TM.BertForPretraining,
                 TM.BertForSequenceClassification):
        with pytest.raises(RuntimeError, match="no"):
            make(TM.bert_tiny())


def test_configs_match_the_reference():
    for name in ("bert_tiny", "bert_base", "ernie_3_base"):
        a, b = vars(getattr(JM, name)()), vars(getattr(TM, name)())
        assert a == b, name


def test_bert_at_mp2_matches_the_serial_model(tmp_path):
    """gloo ranks at mp 2, each holding its shard of the reference's
    weights (`convert.cut_bert_state`): the MLM logits (this rank's
    vocab columns), the NSP logits and the criterion's loss, with a 2-D
    keep-mask and with 1-D lengths, against the serial port model,
    1e-4."""
    from test_torch_mp_layers import launch_worker

    _, tm, w = _pair("BertForPretraining")
    ids, tt, labels, nsp = _batch(6, b=2)
    np.savez(tmp_path / "bert_weights.npz", **w)
    np.savez(tmp_path / "bert_inputs.npz", ids=ids, tt=tt, labels=labels,
             nsp=nsp)
    launch_worker("bert_mp", tmp_path, 2, timeout=240)
    crit = TM.BertPretrainingCriterion()
    for kind in worker.BERT_MASKS:
        m = _masks(kind, b=2)
        tmask = None if m is None else torch.from_numpy(m)
        with torch.no_grad():
            ml, nl = tm(torch.from_numpy(ids), torch.from_numpy(tt), tmask)
            loss = float(crit(ml, torch.from_numpy(labels), nl,
                              torch.from_numpy(nsp)))
        for r in range(2):
            got = dict(np.load(tmp_path / f"bert_mp_r{r}.npz"))
            meta = json.load(open(tmp_path / f"bert_mp_r{r}.json"))
            v = ml.shape[-1] // 2
            assert _rel(got[f"{kind}/mlm"],
                        _np(ml)[..., r * v:(r + 1) * v]) < 1e-4
            assert _rel(got[f"{kind}/nsp"], _np(nl)) < 1e-4
            np.testing.assert_allclose(meta[f"{kind}/loss"], loss,
                                       rtol=1e-4)
