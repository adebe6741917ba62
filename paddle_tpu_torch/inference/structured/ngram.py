"""Draft-model-free speculation: n-gram / prompt-lookup proposals
(counterpart of paddle_tpu/inference/structured/ngram.py).

When the last n tokens of a sequence also occur earlier in its prompt +
generated text, the tokens that followed that earlier occurrence are a
strong guess for what follows now. `NgramSpeculator` mines exactly that
— longest-suffix match (n from `max_match` down to 1) against the
request's own token history, the most recent occurrence wins, the k
tokens after it are the proposal — and feeds it to the engine's ragged
verify step (`inference/speculative._VerifyStep`). Selected with
``LLMEngineConfig(spec_mode="ngram")``: no second model, no draft pool,
no catch-up ticks; a window is [host proposal scan] + 1 verify step.
Slots with no match run verify-only (width 0: a plain decode row inside
the same step).

Losslessness: acceptance is exact match against the model's own pick
(greedy, or the keyed draw of `sample_tokens`), so the output is
token-identical to the non-speculative engine whatever the proposals;
bad proposals cost width, never correctness.

Duck-typed to the surface the engine drives (`try_window` /
`window_headroom` / `release_pools` / `reset_pools` / `pool_bytes` /
`.k`), reporting 0 pool bytes. The reference's brownout cap
(`spec_k_cap`) and metrics registry are not ported: no cap applies.
"""
import time as _time

import numpy as np

from ..llm_engine import PoolExhausted
from ..speculative import _VerifyStep

__all__ = ["NgramSpeculator"]


class NgramSpeculator:
    mode = "ngram"

    def __init__(self, engine, spec_k, max_match=3, scan_window=512):
        self.engine = engine
        self.k = int(spec_k)
        if self.k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.k}")
        self.max_match = int(max_match)
        self.scan_window = int(scan_window)
        self._verify_fn = _VerifyStep(engine.model, self.k,
                                      engine.page_size)
        self._stats = engine.stats
        for key in ("ngram_windows", "ngram_proposed", "ngram_accepted"):
            self._stats.setdefault(key, 0)

    # ---- the engine's speculator surface ----

    def pool_bytes(self):
        return 0

    def window_headroom(self):
        """One free page per live frontier slot, so the next verify
        window's k-token reservation does not collapse to width 0."""
        return sum(
            1 for r in self.engine._slots
            if r is not None and r.n_prefilled == len(r.tokens) - 1)

    def reset_pools(self):
        pass                      # no draft pool to re-zero

    def release_pools(self):
        pass                      # nothing resident

    # ---- proposal mining ----

    def _propose(self, req):
        """Longest-suffix prompt lookup over the request's own tokens:
        match the last n tokens (n = max_match..1) against an earlier
        occurrence (most recent wins, within the trailing `scan_window`
        positions) and propose the <= k tokens that followed it. Empty
        list = no match = verify-only row."""
        toks = req.tokens
        n_max = min(self.max_match, len(toks) - 1)
        for n in range(n_max, 0, -1):
            tail = toks[-n:]
            hi = len(toks) - n - 1   # latest start with a continuation
            lo = max(0, hi - self.scan_window)
            for j in range(hi, lo - 1, -1):
                if toks[j:j + n] == tail:
                    cont = toks[j + n:j + n + self.k]
                    if cont:
                        return cont
        return []

    # ---- the speculative window ----

    def try_window(self, frontier):
        """One n-gram speculative window over the frontier rows (each at
        its sampling frontier), or None when even a frontier token's page
        cannot be covered (the engine then runs a single tick). Pages for
        the frontier token and its proposals are reserved before the
        step; a dry pool narrows the row's width to what its pages
        cover. Returns the requests finished."""
        eng = self.engine
        ps = eng.page_size
        k = self.k
        S = eng.num_slots

        proposals = {}
        width = {}
        for slot, req in frontier:
            props = [] if req.spec_off else self._propose(req)
            w = min(len(props), k, req.target - len(req.tokens))
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
            proposals[slot] = props[:w]

        tok0 = np.zeros((S,), np.int32)
        pos0 = np.zeros((S,), np.int32)
        drafts = np.zeros((S, k), np.int32)
        wid = np.zeros((S,), np.int32)
        rem = np.zeros((S,), np.int32)
        fin_v = np.ones((S,), bool)
        eos = np.full((S,), -1, np.int32)
        temps = np.zeros((S,), np.float32)
        tops = np.ones((S,), np.float32)
        streams = np.zeros((S,), np.int32)
        gen_before = {}
        for slot, req in frontier:
            tok0[slot] = req.tokens[-1]
            pos0[slot] = req.n_prefilled
            wid[slot] = width[slot]
            drafts[slot, :len(proposals[slot])] = proposals[slot]
            rem[slot] = req.target - len(req.tokens)
            fin_v[slot] = False
            if req.eos is not None:
                eos[slot] = int(req.eos)
            temps[slot] = req.temperature
            tops[slot] = req.top_p
            streams[slot] = req.sample_stream
            gen_before[slot] = req.num_generated

        t0 = _time.perf_counter()
        try:
            sampled = any(r.temperature > 0 for _, r in frontier)
            emits = self._verify_fn(tok0, pos0, drafts, wid, rem, fin_v,
                                    eos, temps, tops, streams,
                                    eng._page_tables, eng._kv,
                                    eng._kv_scales or None,
                                    key=eng._key if sampled else None)
        except Exception as e:
            eng.abort_all(e)
            raise
        eng.sched.note_boundary(_time.perf_counter() - t0)

        self._stats["steps"] += 1
        self._stats["ngram_windows"] += 1

        finished = []
        now = _time.perf_counter()
        total = proposed = accepted = 0
        for slot, req in frontier:
            emitted, done, from_draft = 0, False, 0
            for j in range(k + 1):
                t = int(emits[j, slot])
                if t < 0:
                    break
                req.tokens.append(t)
                if j < k and t == int(drafts[slot, j]):
                    from_draft += 1
                emitted += 1
                if ((req.eos is not None and t == req.eos)
                        or len(req.tokens) >= req.target):
                    done = True
            req.n_prefilled += emitted
            total += emitted
            proposed += width[slot]
            accepted += from_draft
            self._stats["generated"] += emitted
            eng.sched.note_tokens(req.tenant, emitted)
            if gen_before[slot] == 0 and emitted > 0:
                req.t_first_token = now
                eng.sched.note_first_token(req, now - req.t_submit)
            if done:
                eng._finish(slot, req)
                finished.append(req)
        self._stats["tokens_in"] += total
        self._stats["ngram_proposed"] += proposed
        self._stats["ngram_accepted"] += accepted
        eng.sched.note_spec_window(proposed, accepted)
        return finished
