"""The port's Transformer layers (paddle_tpu_torch/nn/layer/transformer.py)
against the JAX package's on the CPU, from the reference's weights
carried key for key and the same numpy inputs from
`np.random.default_rng(seed)`: `Transformer` at 2 + 2 layers, d 32, 4
heads, post- and pre-norm, with and without masks (outputs and every
gradient, through `paddle_tpu.grad` and the port's `grad`); every cache
form of `MultiHeadAttention` and of the layers and stacks; the cache's
dtype under bf16 O1; an incremental decode against the full forward;
and a beam search through `dynamic_decode` over the cached decoder.

Tolerances: 1e-6 of each tensor's max-abs in float32 (1e-5 where a
whole 2 + 2 stack and its gradients are compared: each layer norm and
softmax adds its f32 rounding), 1e-12 in float64; token ids exact.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state_dict

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


D, H, FF = 32, 4, 64


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy(), np.float32)


def _carry(j, t):
    load_jax_state_dict(t, {k: np.asarray(v.numpy())
                            for k, v in j.state_dict().items()})
    return j, t


def _model(cls, *args, **kw):
    return _carry(getattr(jnn, cls)(*args, **kw),
                  getattr(tnn, cls)(*args, **kw))


def _x(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _both(a, grad=False):
    return (paddle.to_tensor(a, stop_gradient=not grad),
            torch.tensor(a, requires_grad=grad))


# ---- the whole model ----

@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("masks", [False, True])
def test_transformer_matches_the_reference(masks, normalize_before):
    j, t = _model("Transformer", D, H, 2, 2, FF, dropout=0.0,
                  normalize_before=normalize_before)
    src, tgt = _x(0, 2, 5, D), _x(1, 2, 6 if masks else 5, D)
    (js, ts), (jt, tt) = _both(src, True), _both(tgt, True)
    kw_j, kw_t = {}, {}
    if masks:
        keep = np.ones((2, 1, 1, 5), bool)
        keep[1, ..., 3:] = False                     # padded source
        mem = np.where(keep, 0.0, -1e9).astype(np.float32)
        tm_j = j.generate_square_subsequent_mask(6)
        tm_t = t.generate_square_subsequent_mask(6)
        assert tm_t.dtype == torch.float32
        np.testing.assert_array_equal(tm_t.numpy(), np.asarray(tm_j.numpy()))
        kw_j = dict(src_mask=paddle.to_tensor(keep), tgt_mask=tm_j,
                    memory_mask=paddle.to_tensor(mem))
        kw_t = dict(src_mask=torch.from_numpy(keep), tgt_mask=tm_t,
                    memory_mask=torch.from_numpy(mem))
    with jax.default_matmul_precision("highest"):
        jo = j(js, jt, **kw_j)
    to = t(ts, tt, **kw_t)
    assert _rel(_np(to), _np(jo)) < 1e-5
    probe = _x(9, *to.shape)
    jp = [js, jt] + [p for _, p in j.named_parameters()]
    tp = [ts, tt] + [p for _, p in t.named_parameters()]
    with jax.default_matmul_precision("highest"):
        jg = paddle.grad((jo * paddle.to_tensor(probe)).sum(), jp)
    tg = tpaddle.grad((to * torch.from_numpy(probe)).sum(), tp)
    names = ["src", "tgt"] + [n for n, _ in t.named_parameters()]
    for name, a, b in zip(names, tg, jg):
        if name.endswith("k_proj.bias"):
            # exactly 0: softmax is shift-invariant per row
            assert np.abs(_np(a)).max() < 1e-5 and np.abs(_np(b)).max() < 1e-5
            continue
        assert _rel(_np(a), _np(b)) < 1e-5, name


def test_transformer_float64_matches_the_reference():
    j, t = _model("Transformer", D, H, 2, 2, FF, dropout=0.0)
    j.astype("float64")
    t.astype("float64")
    src, tgt = _x(0, 2, 5, D, dtype=np.float64), _x(1, 2, 4, D,
                                                    dtype=np.float64)
    jo = j(paddle.to_tensor(src), paddle.to_tensor(tgt),
           tgt_mask=j.generate_square_subsequent_mask(4))
    to = t(torch.from_numpy(src), torch.from_numpy(tgt),
           tgt_mask=t.generate_square_subsequent_mask(4))
    assert to.dtype == torch.float64
    assert _rel(to.detach().numpy(), np.asarray(jo.numpy())) < 1e-12


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_sdpa_off_the_cpu_takes_the_kernel_wrapper_and_raises(monkeypatch,
                                                              dtype):
    """On the CPU a float64 query takes the dense path (the float64 test
    above). Off the CPU there is no dtype condition, as in the
    reference's `_pallas_eligible`: a query the kernels do not take
    reaches the flash wrapper and raises there, never the dense path.
    The `meta` device stands in for the card: only the device check is
    lifted, so the wrapper's own dtype check is what raises."""
    from paddle_tpu_torch.nn.functional import attention as tatt
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as tfa
    monkeypatch.setattr(tfa, "_device_check", lambda q: None)

    def no_dense(*a, **kw):
        raise AssertionError("the dense path ran off the CPU")
    monkeypatch.setattr(tatt, "dense_attention_bshd", no_dense)
    q = torch.empty((2, 16, 2, 8), dtype=dtype, device="meta")
    with pytest.raises(TypeError, match="not in"):
        tnn.functional.scaled_dot_product_attention(q, q, q)
    if dtype == torch.float64:
        c = torch.from_numpy(_x(0, 2, 16, 2, 8, dtype=np.float64))
        monkeypatch.undo()
        out = tnn.functional.scaled_dot_product_attention(c, c, c)
        assert out.dtype == torch.float64 and out.shape == c.shape


def test_stacks_deep_copy_one_layer():
    layer = tnn.TransformerEncoderLayer(D, H, FF)
    enc = tnn.TransformerEncoder(layer, 3)
    assert enc.layers[0] is layer and enc.layers[1] is not layer
    for n, p in enc.layers[2].named_parameters():
        assert torch.equal(p, dict(layer.named_parameters())[n])
        assert p.data_ptr() != dict(layer.named_parameters())[n].data_ptr()


# ---- the caches ----

def test_multi_head_attention_caches_match_the_reference():
    j, t = _model("MultiHeadAttention", D, H)
    mem = _x(2, 2, 7, D)
    jm, tm = _both(mem)
    # static: the projected memory
    jsc = j.gen_cache(jm, jm, type=jnn.MultiHeadAttention.StaticCache)
    tsc = t.gen_cache(tm, tm, type=tnn.MultiHeadAttention.StaticCache)
    assert isinstance(tsc, tnn.MultiHeadAttention.StaticCache)
    for a, b in zip(tsc, jsc):
        assert _rel(_np(a), _np(b)) < 1e-6
    q = _x(3, 2, 3, D)
    jq, tq = _both(q)
    out_t = t(tq, tm, tm, cache=tsc)
    assert isinstance(out_t, torch.Tensor)
    assert _rel(_np(out_t), _np(j(jq, jm, jm, cache=jsc))) < 1e-6
    # incremental: float32 [batch, 0, heads, head_dim], one step at a time
    jc = j.gen_cache(jq)
    tc = t.gen_cache(tq)
    assert tuple(tc.k.shape) == (2, 0, H, D // H) == tuple(jc.k.shape)
    assert tc.k.dtype == torch.float32
    for step in range(3):
        jo, jc = j(jq[:, step:step + 1], cache=jc)
        to, tc = t(tq[:, step:step + 1], cache=tc)
        assert isinstance(tc, tnn.MultiHeadAttention.Cache)
        assert _rel(_np(to), _np(jo)) < 1e-6
        assert _rel(_np(tc.k), _np(jc.k)) < 1e-6
        assert _rel(_np(tc.v), _np(jc.v)) < 1e-6
    assert tc.k.shape[1] == 3


def test_layer_and_stack_caches_match_the_reference():
    src, mem = _x(4, 2, 4, D), _x(5, 2, 6, D)
    (js, ts), (jm, tm) = _both(src), _both(mem)
    # encoder layer and stack: incremental self-attention caches
    j, t = _model("TransformerEncoderLayer", D, H, FF, dropout=0.0)
    jo, jc = j(js, cache=j.gen_cache(js))
    to, tc = t(ts, cache=t.gen_cache(ts))
    assert _rel(_np(to), _np(jo)) < 1e-6
    assert _rel(_np(tc.k), _np(jc.k)) < 1e-6
    j2 = jnn.TransformerEncoder(j, 2, jnn.LayerNorm(D))
    t2 = tnn.TransformerEncoder(t, 2, tnn.LayerNorm(D))
    _carry(j2, t2)
    jo, jcs = j2(js, cache=j2.gen_cache(js))
    to, tcs = t2(ts, cache=t2.gen_cache(ts))
    assert len(tcs) == 2 and _rel(_np(to), _np(jo)) < 1e-6
    for a, b in zip(tcs, jcs):
        assert _rel(_np(a.v), _np(b.v)) < 1e-6
    # decoder layer: (incremental, static) per layer
    j, t = _model("TransformerDecoderLayer", D, H, FF, dropout=0.0)
    jo, (ji, jst) = j(js, jm, cache=j.gen_cache(jm))
    to, (ti, tst) = t(ts, tm, cache=t.gen_cache(tm))
    assert isinstance(tst, tnn.MultiHeadAttention.StaticCache)
    assert _rel(_np(to), _np(jo)) < 1e-6
    assert _rel(_np(ti.k), _np(ji.k)) < 1e-6
    assert _rel(_np(tst.v), _np(jst.v)) < 1e-6
    # decoder stack, and gen_cache's do_zip layout
    j2 = jnn.TransformerDecoder(j, 2)
    t2 = tnn.TransformerDecoder(t, 2)
    _carry(j2, t2)
    jz, tz = j2.gen_cache(jm, do_zip=True), t2.gen_cache(tm, do_zip=True)
    assert len(tz) == len(jz) == 2 and len(tz[0]) == 2
    for a, b in zip(tz[1], jz[1]):
        assert isinstance(a, tnn.MultiHeadAttention.StaticCache)
        assert _rel(_np(a.k), _np(b.k)) < 1e-6
    jo, jcs = j2(js, jm, cache=j2.gen_cache(jm))
    to, tcs = t2(ts, tm, cache=t2.gen_cache(tm))
    assert _rel(_np(to), _np(jo)) < 1e-6
    for (a, _), (b, _) in zip(tcs, jcs):
        assert _rel(_np(a.k), _np(b.k)) < 1e-6


def test_cache_dtype_under_bf16_o1_follows_the_reference():
    """gen_cache makes the incremental cache float32 whatever the model's
    dtype, and appending a bf16 step promotes it: under O1 the cache is
    float32 in both packages, the output bf16."""
    j, t = _model("MultiHeadAttention", D, H)
    q = _x(6, 2, 1, D)
    jq, tq = _both(q)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jo, jc = j(jq, cache=j.gen_cache(jq))
        jo, jc = j(jq, cache=jc)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        to, tc = t(tq, cache=t.gen_cache(tq))
        to, tc = t(tq, cache=tc)
    assert str(jc.k.dtype) == "float32" and tc.k.dtype == torch.float32
    assert str(jo.dtype) == "bfloat16" and to.dtype == torch.bfloat16
    assert _rel(_np(tc.k), _np(jc.k)) < 1e-2
    assert _rel(_np(to), _np(jo)) < 2e-2
    # a bf16 model (no autocast): the float32 cache promotes attention
    # to float32, as jnp promotes it
    t.astype("bfloat16")
    o, c = t(tq.bfloat16(), cache=t.gen_cache(tq))
    assert c.k.dtype == torch.float32 and o.dtype == torch.float32


def test_incremental_decode_equals_the_full_forward():
    j, t = _model("Transformer", D, H, 2, 2, FF, dropout=0.0)
    src, tgt = _x(7, 2, 5, D), _x(8, 2, 6, D)
    (js, ts), (jt, tt) = _both(src), _both(tgt)
    full = {}
    steps = {}
    for name, m, s, g, mask in (
            ("j", j, js, jt, j.generate_square_subsequent_mask(6)),
            ("t", t, ts, tt, t.generate_square_subsequent_mask(6))):
        mem = m.encoder(s)
        full[name] = _np(m.decoder(g, mem, tgt_mask=mask))
        cache = m.decoder.gen_cache(mem)
        outs = []
        for i in range(6):
            o, cache = m.decoder(g[:, i:i + 1], mem, cache=cache)
            outs.append(_np(o))
        steps[name] = np.concatenate(outs, 1)
    assert _rel(steps["t"], full["t"]) < 1e-5
    assert _rel(steps["t"], steps["j"]) < 1e-6
    assert _rel(full["t"], full["j"]) < 1e-6


# ---- beam search over the cached decoder ----

def _beam(pkg, nn_mod, model, emb, proj, pos, src, beam, end, steps):
    """dynamic_decode over a cell that carries the decoder's incremental
    caches; the static caches and the memory tiled by
    tile_beam_merge_with_batch. The cell's first state is a [batch, 1]
    placeholder and it makes the empty caches at step 0: the reference's
    `initialize` cannot tile a cache of length 0 (its reshape by -1)."""
    tile = nn_mod.BeamSearchDecoder.tile_beam_merge_with_batch
    mem = model.encoder(src)
    static = [nn_mod.MultiHeadAttention.StaticCache(tile(c[1].k, beam),
                                                    tile(c[1].v, beam))
              for c in model.decoder.gen_cache(mem)]
    mem_t = tile(mem, beam)

    def cell(x, incr):
        if not isinstance(incr, list):
            incr = [layer.self_attn.gen_cache(mem_t)
                    for layer in model.decoder.layers]
        t = incr[0].k.shape[1]
        x = x + pos[t]
        out, new = model.decoder(
            x.unsqueeze(1) if pkg is tpaddle else paddle.unsqueeze(x, 1),
            mem_t, cache=[(c, s) for c, s in zip(incr, static)])
        return out[:, 0], [c for c, _ in new]

    dec = nn_mod.BeamSearchDecoder(
        cell, start_token=0, end_token=end, beam_size=beam,
        embedding_fn=lambda ids: nn_mod.functional.embedding(ids, emb),
        output_fn=lambda h: pkg.matmul(h, proj))
    start = (torch.zeros(src.shape[0], 1) if pkg is tpaddle
             else paddle.zeros([src.shape[0], 1]))
    ids, _ = nn_mod.dynamic_decode(dec, inits=start, max_step_num=steps)
    return np.asarray(ids.numpy())


@pytest.mark.parametrize("beam,end", [(3, 1), (4, 5)])
def test_beam_search_over_the_cached_decoder_matches_the_reference(beam,
                                                                    end):
    V = 13
    j, t = _model("Transformer", D, H, 2, 2, FF, dropout=0.0)
    rs = np.random.default_rng(beam)
    emb = rs.standard_normal((V, D)).astype(np.float32)
    proj = (rs.standard_normal((D, V)) * 2.0).astype(np.float32)
    pos = (rs.standard_normal((12, D)) * 0.1).astype(np.float32)
    src = _x(10 + beam, 2, 5, D)
    with torch.no_grad():
        got = _beam(tpaddle, tnn, t, torch.from_numpy(emb),
                    torch.from_numpy(proj), torch.from_numpy(pos),
                    torch.from_numpy(src), beam, end, 8)
    want = _beam(paddle, jnn, j, paddle.to_tensor(emb),
                 paddle.to_tensor(proj), paddle.to_tensor(pos),
                 paddle.to_tensor(src), beam, end, 8)
    assert got.shape == want.shape and got.shape[0] == 2
    np.testing.assert_array_equal(got, want)


def test_engine_attention_takes_the_caches_as_the_layer_does():
    """The auto-parallel Engine's realized attention (`_attention_fwd`,
    here at world 1: every collective the identity) with each cache form
    equals the layer's own forward."""
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.distributed import mesh as tmesh

    tmesh.reset_mesh()
    t = tnn.MultiHeadAttention(D, H)
    q, mem = torch.from_numpy(_x(11, 2, 3, D)), torch.from_numpy(
        _x(12, 2, 5, D))
    want_c = t.gen_cache(q)
    got_c = t.gen_cache(q)
    for step in range(3):
        want, want_c = t(q[:, step:step + 1], cache=want_c)
        got, got_c = ap._attention_fwd(t, q[:, step:step + 1], cache=got_c,
                                       heads=H)
        assert _rel(_np(got), _np(want)) < 1e-6
        assert _rel(_np(got_c.k), _np(want_c.k)) < 1e-6
    static = t.gen_cache(mem, mem, type=tnn.MultiHeadAttention.StaticCache)
    got = ap._attention_fwd(t, q, mem, mem, cache=static, heads=H)
    assert isinstance(got, torch.Tensor)
    assert _rel(_np(got), _np(t(q, mem, mem, cache=static))) < 1e-6
