"""Speculative decoding — draft-model propose, one-step ragged verify
(counterpart of paddle_tpu/inference/speculative.py).

A proposer offers up to k tokens per live sequence; the model scores all
k+1 positions of every slot in ONE ragged step
(`GPTForCausalLM._paged_verify_fused`) and accepts the longest prefix of
proposals equal to its own picks — the argmax, or the keyed draw of
`sample_tokens`, which depends only on (seed, stream, position) — so the
output is token-identical to the non-speculative engine whatever the
proposals. On the card the step's attention runs the query-blocked
kernel K2. Two proposers drive it: prompt lookup
(`structured/ngram.NgramSpeculator`, host proposals) and a draft model
(`SpeculativeDecoder`, `LLMEngineConfig(draft_model=...)`).

The draft model (same GPT family, tied vocabulary) keeps its own paged KV
pools, mirroring the engine's: the same page ids and page tables, its own
[N, P, h', d'] buffers in the engine's kv dtype (scale planes beside int8
/ int4 pools), so one page allocation covers both and a page costs big +
draft bytes. A window is [draft catch-up ticks, when a request's draft
pool lags by more than one row] + the draft's propose window (k+1
iterations of `_paged_decode_fused` in propose mode, one CUDA graph per
greedy-or-sampled choice on the card) + the target's verify. The
proposals never leave the device: they are gathered from the propose
window's emits and handed to the verify as a tensor, and come back to the
host with the verify's emits, the window's one sync. The draft's picks
use the engine's key, so a sampled draft draws the target's Gumbel noise
and agrees with it more often than an argmax would.

Structured decoding: the verify masks each of its k+1 picks per slot by
the grammar state its drafts lead to (`_paged_verify_fused`'s gstate0 /
gtrans / gmask, from `LLMEngine._grammar_args`); the draft's propose
window stays unmasked, as in the reference — a grammar-illegal proposal
fails the exact match and ends the accepted prefix. The host advances
each constrained request's DFA state over the emitted tokens.

Rollback is positional: rejected rows' KV, in both pools, stays past the
accepted frontier, masked by kv_len and overwritten by position when the
real tokens arrive. A request's valid draft prefix is
`_Request.draft_prefilled`; the propose window replays a lag of one row
itself (its iteration 0), so only admission and preemption cost catch-up
ticks. The reference's brownout cap (`spec_k_cap`), `release_pools` and
metrics registry belong to the overload plane (ROADMAP A10).
"""
import time as _time

import numpy as np
import torch

from ..quantization import runtime as _qrt
from .llm_engine import PoolExhausted, _FusedStep, _PagedStep

__all__ = ["SpeculativeDecoder"]


class _VerifyStep:
    """The engine's verify step — the eager counterpart of the JAX
    package's compiled `_CompiledVerifyStep` (speculative.py:139). The
    pools and scale planes are updated IN PLACE (where JAX donated them
    to the executable). Every index array of the window goes into ONE
    host buffer and makes ONE copy to the device, as the engine's single
    tick does; the emitted tokens come back in one copy, the window's
    one sync."""

    def __init__(self, model, k, page_size):
        self.model = model
        self.k = int(k)
        self.page_size = int(page_size)

    def __call__(self, rows, drafts, page_tables, kv, kv_scales=None,
                 key=None, grammar=None):
        """rows: the host numpy inputs (tok0, pos0, width, rem, fin0, eos,
        temps, top_ps, streams), [S] each (`_Speculator._verify_rows`);
        page_tables [S, MP] int; key, the engine's device key (None when
        every row is greedy); grammar, `LLMEngine._grammar_args`' (gstate0
        [S] int32, the arena's device tables or None): with tables the
        picks are masked. drafts [S, k]: a host int array, or an int32
        tensor on the model's device (a draft model's proposals), which
        then comes back with the emits in the same copy. Returns emits
        [k+1, S] as a numpy int32 array (-1 = nothing emitted), and with
        device drafts (emits, drafts [S, k] numpy)."""
        tok0, pos0, width, rem, fin0, eos, temps, top_ps, streams = rows
        gst, tables = grammar if grammar is not None else (None, None)
        S, k = tok0.shape[0], self.k
        MP = page_tables.shape[1]
        on_device = isinstance(drafts, torch.Tensor)
        buf = np.zeros((10 * S + S * k + S * MP,), np.int32)
        vec = buf[:10 * S].reshape(10, S)
        for row, x in enumerate((tok0, pos0, width, rem, fin0, eos,
                                 streams)):
            vec[row] = x
        f = vec[7:9].view(np.float32)
        f[0] = temps
        f[1] = top_ps
        if gst is not None:
            vec[9] = gst
        if not on_device:
            buf[10 * S:10 * S + S * k] = np.asarray(drafts).reshape(-1)
        buf[10 * S + S * k:] = np.asarray(page_tables).reshape(-1)
        dev = torch.from_numpy(buf).to(self.model.device)
        (tok0_d, pos0_d, width_d, rem_d, fin_d, eos_d,
         streams_d) = dev[:7 * S].view(7, S)
        temps_d, tops_d = dev[7 * S:9 * S].view(torch.float32).view(2, S)
        drafts_d = (drafts if on_device
                    else dev[10 * S:10 * S + S * k].view(S, k))
        pt_d = dev[10 * S + S * k:].view(S, MP)
        mask = ({} if tables is None else
                dict(gstate0=dev[9 * S:10 * S], gtrans=tables[0],
                     gmask=tables[1]))
        with torch.inference_mode():
            emits, _, _ = self.model._paged_verify_fused(
                k, self.page_size, tok0_d, pos0_d, drafts_d, width_d,
                rem_d, fin_d != 0, eos_d, temps_d, pt_d, kv, kv_scales,
                top_ps=tops_d, streams=streams_d, key=key, **mask)
            if not on_device:
                return emits.cpu().numpy()
            both = torch.cat([emits, drafts_d.t().to(emits.dtype)])
            both = both.cpu().numpy()                  # the one sync
        return both[:k + 1], both[k + 1:].T


class _Speculator:
    """What both proposers share around the verify step: the admission
    headroom, the page reservation of a window, the verify's per-row
    inputs, and the accounting of its emits. `stats_key` names the
    proposer's counters (`<key>_windows`, `_proposed`, `_accepted`)."""

    stats_key = None

    def __init__(self, engine, spec_k):
        self.engine = engine
        self.k = int(spec_k)
        if self.k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.k}")
        self._verify_fn = _VerifyStep(engine.model, self.k, engine.page_size)
        self._stats = engine.stats
        for what in ("windows", "proposed", "accepted"):
            self._stats.setdefault(f"{self.stats_key}_{what}", 0)

    def window_headroom(self):
        """Pages admission leaves free for the next verify window: one
        per live frontier slot, so a burst of admissions cannot drain the
        pool to where every window collapses to width 0."""
        return sum(
            1 for r in self.engine._slots
            if r is not None and r.n_prefilled == len(r.tokens) - 1)

    def _reserve(self, frontier, want):
        """Reserve the pages of positions pos0..pos0+width of each frontier
        row, width = min(want[slot], the row's budget); pool pressure
        narrows a row's width, down to 0 (a plain decode row of the
        verify). Returns {slot: width}, or None when even a frontier
        token's page cannot be covered (the engine then runs a single
        tick, which owns preemption)."""
        eng = self.engine
        ps = eng.page_size
        width = {}
        for slot, req in frontier:
            w = min(want[slot], req.target - len(req.tokens))
            last = req.n_prefilled + w
            try:
                while last // ps >= len(req.pages):
                    page = eng.pool.alloc()
                    eng._page_tables[slot, len(req.pages)] = page
                    req.pages.append(page)
            except PoolExhausted:
                covered = len(req.pages) * ps - 1 - req.n_prefilled
                if covered < 0:
                    return None   # frontier write itself has no page
                w = min(w, covered)
            width[slot] = w
        return width

    def _verify_rows(self, frontier, width):
        """The verify's per-row host inputs, [S] each (empty slots dead):
        (tok0, pos0, width, rem, fin0, eos, temps, top_ps, streams)."""
        S = self.engine.num_slots
        tok0, pos0, wid, rem = (np.zeros((S,), np.int32) for _ in range(4))
        fin = np.ones((S,), bool)
        eos = np.full((S,), -1, np.int32)
        temps = np.zeros((S,), np.float32)
        tops = np.ones((S,), np.float32)
        streams = np.zeros((S,), np.int32)
        for slot, req in frontier:
            tok0[slot] = req.tokens[-1]
            pos0[slot] = req.n_prefilled
            wid[slot] = width[slot]
            rem[slot] = req.target - len(req.tokens)
            fin[slot] = False
            if req.eos is not None:
                eos[slot] = int(req.eos)
            temps[slot] = req.temperature
            tops[slot] = req.top_p
            streams[slot] = req.sample_stream
        return tok0, pos0, wid, rem, fin, eos, temps, tops, streams

    def _accept(self, frontier, emits, drafts, width, t0):
        """Append each row's emitted tokens (emits [k+1, S], -1 = none),
        finish rows that emit their eos or spend their budget, and count
        the window: an emitted pick equals the draft at its position iff
        that draft was accepted, so the accepted count is exact. `t0`:
        the host clock when the window started. Returns the requests
        finished."""
        eng, k = self.engine, self.k
        eng.sched.note_boundary(_time.perf_counter() - t0)
        self._stats["steps"] += 1
        self._stats[f"{self.stats_key}_windows"] += 1
        finished = []
        now = _time.perf_counter()
        total = proposed = accepted = 0
        for slot, req in frontier:
            first = req.num_generated == 0
            emitted, done = 0, False
            for j in range(k + 1):
                t = int(emits[j, slot])
                if t < 0:
                    break
                req.tokens.append(t)
                if req.grammar is not None:
                    # the verify's DFA advance, replayed on the host
                    req.gstate = req.grammar.advance(req.gstate, t)
                if j < k and t == int(drafts[slot, j]):
                    accepted += 1
                emitted += 1
                if ((req.eos is not None and t == req.eos)
                        or len(req.tokens) >= req.target):
                    done = True
            req.n_prefilled += emitted
            total += emitted
            proposed += width[slot]
            self._stats["generated"] += emitted
            eng.sched.note_tokens(req.tenant, emitted)
            if first and emitted > 0:
                req.t_first_token = now
                eng.sched.note_first_token(req, now - req.t_submit)
            if done:
                eng._finish(slot, req)
                finished.append(req)
        self._stats["tokens_in"] += total
        self._stats[f"{self.stats_key}_proposed"] += proposed
        self._stats[f"{self.stats_key}_accepted"] += accepted
        eng.sched.note_spec_window(proposed, accepted)
        return finished


class _ProposeStep(_FusedStep):
    """The draft model's propose window — the counterpart of the JAX
    package's `_CompiledProposeStep` (speculative.py:95):
    `_paged_decode_fused` in propose mode at k+1 iterations, lag and
    frontier carried in the static buffer beside the other per-row
    inputs. On the card one CUDA graph per greedy-or-sampled choice,
    captured and replayed by `_FusedStep`'s machinery: warm-up and
    capture on the step's own private stream (so its K1 workspace is
    its own and kept by the graph), the collector held off during the
    capture, launch counts taken back and added again at every replay.
    On a CPU model the window runs eagerly."""

    def __init__(self, draft, spec_k, page_size, num_slots, pages_per_seq,
                 key):
        super().__init__(draft, int(spec_k) + 1, page_size, num_slots,
                         pages_per_seq, key, propose=True)
        self.spec_k = int(spec_k)

    def drafts(self, emits):
        """Each row's proposals after its lag replay, gathered on the
        device from the window's emits [k+1, S]: drafts[s, j] =
        emits[lag_s + j, s], j < k (the reference's speculative.py:450).
        The lag row is read from the static buffer the replay read, in
        stream order: no host sync. A row that picked its eos emits -1
        after it, and past its width; those proposals become token 0, a
        valid embedding index for the verify (the verify can emit nothing
        past an eos: it is kept and ends the request, or a rejection
        before it ends the window; `try_window` masks the host copy past
        each width before counting acceptances). Returns [S, k] int32."""
        S = self.S
        lag = self._static[6 * S:7 * S].long()
        idx = lag[None, :] + torch.arange(self.spec_k, device=lag.device)[
            :, None]
        return emits.gather(0, idx).clamp_min(0).t().contiguous()


class SpeculativeDecoder(_Speculator):
    """The engine's draft-model speculation: the draft pools and the
    window orchestration (module docstring). Owned by `LLMEngine` when
    `LLMEngineConfig(draft_model=...)` is set; `try_window(frontier)` is
    the sibling of `_try_step_fused`."""

    mode = "draft"
    stats_key = "spec"

    def __init__(self, engine, draft_model, spec_k):
        draft_model.eval()
        big_cfg = engine.model.config
        dcfg = draft_model.config
        if dcfg.vocab_size != big_cfg.vocab_size:
            raise ValueError(
                f"draft_model vocab_size {dcfg.vocab_size} != target "
                f"{big_cfg.vocab_size}: speculative decoding needs a "
                "tied tokenizer (proposals are target token ids)")
        if dcfg.max_seq_len < engine.max_model_len:
            raise ValueError(
                f"draft_model max_seq_len {dcfg.max_seq_len} < engine "
                f"max_model_len {engine.max_model_len}: the draft must "
                "reach every position it proposes at")
        if draft_model.device != engine.device:
            raise ValueError(
                f"draft_model is on {draft_model.device}, the engine's "
                f"model on {engine.device}")
        super().__init__(engine, spec_k)
        self.draft = draft_model
        ps = engine.page_size
        num_pages = engine.pool.num_pages
        nh = dcfg.num_heads
        hd = dcfg.hidden_size // nh
        # the draft pools mirror the engine pool's geometry (same page
        # ids and tables), their own buffers in the engine's kv dtype
        draft_dt, self._quantized = _qrt.resolve_kv_dtype(engine.kv_dtype,
                                                          draft_model.dtype)
        if self._quantized == 4 and hd % 2:
            raise ValueError(
                f"kv_dtype='int4': draft head_dim {hd} is odd — nibble "
                "packing pairs head_dim elements")
        hd_store = hd // 2 if self._quantized == 4 else hd
        dev = engine.device
        layers = 2 * dcfg.num_layers
        self._kv = [torch.zeros((num_pages, ps, nh, hd_store),
                                dtype=draft_dt, device=dev)
                    for _ in range(layers)]
        self._kv_scales = [
            torch.zeros(_qrt.kv_scale_shape(num_pages, ps, nh),
                        dtype=torch.float32, device=dev)
            for _ in range(layers if self._quantized else 0)]
        # three steps: the draft's catch-up tick (its own flat budget,
        # wide enough that a post-admission replay clears in few ticks),
        # the draft's propose window, the target's verify
        self._draft_T = max(engine.token_budget, engine.num_slots)
        self._prefill_fn = _PagedStep(draft_model)
        self._propose_fn = _ProposeStep(draft_model, self.k, ps,
                                        engine.num_slots, engine.pages_per_seq,
                                        engine._key)

    # ---- pool accounting ----

    def pool_bytes(self):
        """Draft-pool resident bytes, scale planes included (a page
        costs big + draft bytes)."""
        return int(sum(p.numel() * p.element_size()
                       for p in self._kv + self._kv_scales))

    def reset_pools(self):
        """abort_all path: zero the draft pools and scale planes IN PLACE
        — the propose graph holds their addresses, so a fresh allocation
        would leave it writing into freed memory (the engine's own pools
        follow the same rule)."""
        with torch.inference_mode():
            for p in self._kv + self._kv_scales:
                p.zero_()

    # ---- draft catch-up ----

    def _catch_up(self, rows):
        """Replay the tokens the draft pools are missing, down to a lag of
        at most one row per request, through the draft's single tick
        (`_PagedStep`), chunked to its flat budget: the prompt after
        admission, the replay after preemption. The last lagging row is
        left to the propose window, which writes it at its iteration 0."""
        eng = self.engine
        ps, T = eng.page_size, self._draft_T
        S, MP = eng.num_slots, eng.pages_per_seq
        while True:
            todo = [(slot, req) for slot, req in rows
                    if req.draft_prefilled < req.n_prefilled - 1]
            if not todo:
                return
            # tok, pos, sid, widx, klen [T] | sample_idx [1] | tables: one
            # copy to the device; rows past i are padding (trash row 0)
            buf = np.zeros((5 * T + 1 + S * MP,), np.int32)
            tok, pos, sid, widx, klen = buf[:5 * T].reshape(5, T)
            buf[5 * T + 1:] = eng._page_tables.reshape(-1)
            i = 0
            took = {}
            for slot, req in todo:
                take = min(req.n_prefilled - 1 - req.draft_prefilled, T - i)
                for d in range(take):
                    p = req.draft_prefilled + d
                    tok[i] = req.tokens[p]
                    pos[i] = p
                    sid[i] = slot
                    widx[i] = req.pages[p // ps] * ps + p % ps
                    klen[i] = p + 1
                    i += 1
                took[slot] = take
                if i == T:
                    break
            dev = torch.from_numpy(buf).to(eng.device)
            tok_d, pos_d, sid_d, widx_d, klen_d = dev[:5 * T].view(5, T)
            self._prefill_fn(tok_d, pos_d, sid_d, widx_d,
                             dev[5 * T + 1:].view(S, MP), klen_d,
                             dev[5 * T:5 * T + 1], self._kv,
                             self._kv_scales or None)
            for slot, req in todo:
                req.draft_prefilled += took.get(slot, 0)

    # ---- the speculative window ----

    def try_window(self, frontier):
        """One speculative window over the frontier rows (each at its
        sampling frontier), or None when even a frontier token's page
        cannot be covered. Pages for positions pos0..pos0+width are
        reserved up front, for both pools at once (they share page ids).
        Returns the requests finished."""
        eng = self.engine
        width = self._reserve(frontier, {
            slot: 0 if req.spec_off else self.k for slot, req in frontier})
        if width is None:
            return None
        try:
            self._catch_up(frontier)
        except Exception as e:
            eng.abort_all(e)
            raise
        rows = self._verify_rows(frontier, width)
        prop = self._propose_fn
        (tok_p, pos_p, rem_p, fin_p, eos_p, streams_p, lag, front, temps_p,
         tops_p, pt_p) = prop.host_views()
        # the propose window's rows: the verify's, each started one row
        # early when its draft lags by one (after the catch-up it lags by
        # at most one: iteration 0 replays it from the token before the
        # frontier); width-0 and empty rows are finished
        tok0, pos0, _, _, _, eos, temps, tops, streams = rows
        pos_p[:], front[:], eos_p[:] = pos0, tok0, eos
        temps_p[:], tops_p[:], streams_p[:] = temps, tops, streams
        tok_p[:], rem_p[:], lag[:], fin_p[:] = 0, 0, 0, 1
        pt_p[:] = eng._page_tables
        for slot, req in frontier:
            if width[slot] >= 1:
                lag[slot] = req.n_prefilled - req.draft_prefilled
                tok_p[slot] = req.tokens[-1 - lag[slot]]
                rem_p[slot] = width[slot] + lag[slot]
                fin_p[slot] = 0

        sampled = any(r.temperature > 0 for _, r in frontier)
        grammar = eng._grammar_args(frontier)
        t0 = _time.perf_counter()
        try:
            # the proposals stay on the device into the verify; the
            # verify's emits (and the drafts with them) are the one sync
            drafts = prop.drafts(prop.launch(self._kv, self._kv_scales
                                             or None, sampled))
            emits, drafts_h = self._verify_fn(
                rows, drafts, eng._page_tables, eng._kv,
                eng._kv_scales or None, key=eng._key if sampled else None,
                grammar=grammar)
        except Exception as e:
            eng.abort_all(e)
            raise
        # the verify read token 0 where the window proposed nothing (past
        # a row's width, as the reference's -1 there): a bonus pick of
        # token 0 at j = width < k is not an accepted proposal
        for slot, _ in frontier:
            drafts_h[slot, width[slot]:] = -1
        # the propose window wrote draft rows pos0..pos0+width-1; they are
        # right up to the accepted prefix, which ends where the emits do
        for slot, req in frontier:
            if width[slot] >= 1:
                n = req.n_prefilled + int((emits[:, slot] >= 0).sum())
                req.draft_prefilled = min(int(pos0[slot]) + width[slot], n)
        return self._accept(frontier, emits, drafts_h, width, t0)
