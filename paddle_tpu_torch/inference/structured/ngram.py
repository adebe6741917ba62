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
(greedy, or the keyed draw of `sample_tokens`, masked by the request's
grammar when it has one), so the output is token-identical to the
non-speculative engine whatever the proposals; bad proposals cost width,
never correctness.

The engine drives it through the surface it shares with the draft-model
`SpeculativeDecoder` (`inference/speculative._Speculator`: `try_window`,
`window_headroom`, `reset_pools`, `release_pools`, `pool_bytes`, `.k`),
reporting 0 pool bytes. The brownout cap (`spec_k_cap`) narrows the
proposals, and the `pt_ngram_spec_*` counters live in the port's
registry.
"""
import time as _time

import numpy as np

from ...observability import metrics as _obs
from ..speculative import _Speculator

__all__ = ["NgramSpeculator"]

_NGRAM_WINDOWS = _obs.counter(
    "pt_ngram_spec_windows_total",
    "n-gram speculative windows dispatched (one verify step each)")
_NGRAM_PROPOSED = _obs.counter(
    "pt_ngram_spec_proposed_total",
    "prompt-lookup tokens proposed to the verify step (window widths "
    "summed; match-less slots propose 0 and run verify-only)")
_NGRAM_ACCEPTED = _obs.counter(
    "pt_ngram_spec_accepted_total",
    "accepted prompt-lookup tokens that entered the output")
_NGRAM_ACC_RATE = _obs.gauge(
    "pt_ngram_spec_acceptance_rate",
    "accepted / proposed for the n-gram proposer, process-cumulative")


class NgramSpeculator(_Speculator):
    mode = "ngram"
    stats_key = "ngram"
    counters = (_NGRAM_WINDOWS, _NGRAM_PROPOSED, _NGRAM_ACCEPTED,
                _NGRAM_ACC_RATE)

    def __init__(self, engine, spec_k, max_match=3, scan_window=512):
        super().__init__(engine, spec_k)
        self.max_match = int(max_match)
        self.scan_window = int(scan_window)

    # ---- the engine's speculator surface ----

    def pool_bytes(self):
        return 0

    def reset_pools(self):
        pass                      # no draft pool to re-zero

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
        k_eff = self._k_eff()
        proposals = {slot: [] if req.spec_off or not k_eff
                     else self._propose(req)[:k_eff]
                     for slot, req in frontier}
        width = self._reserve(frontier, {slot: len(p)
                                         for slot, p in proposals.items()})
        if width is None:
            return None
        drafts = np.zeros((eng.num_slots, self.k), np.int32)
        for slot, props in proposals.items():
            drafts[slot, :width[slot]] = props[:width[slot]]
        grammar = eng._grammar_args(frontier)
        t0 = _time.perf_counter()
        try:
            sampled = any(r.temperature > 0 for _, r in frontier)
            emits = self._verify_fn(self._verify_rows(frontier, width),
                                    drafts, eng._page_tables, eng._kv,
                                    eng._kv_scales or None,
                                    key=eng._key if sampled else None,
                                    grammar=grammar)
        except Exception as e:
            eng.abort_all(e)
            raise
        return self._accept(frontier, emits, drafts, width, t0)
