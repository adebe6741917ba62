"""Grammar arena: fixed device tables for masking inside the decode windows
(counterpart of paddle_tpu/inference/structured/arena.py).

A captured CUDA graph holds the addresses it reads, so the fused and
verify windows cannot take per-grammar tables. The engine keeps ONE
arena for its lifetime:

* ``trans`` int32 ``[G, vocab]`` — arena-ABSOLUTE next state for token
  ``t`` in arena state ``g``;
* ``mask``  ``[G, ceil(vocab/32)]`` per-state allowed-token bitsets,
  uint32 on the host (byte-equal to the reference's) and the same bits
  as int32 on the device (`text.models.gpt.grammar_allowed` expands them
  with int32 shifts: torch has few uint32 kernels on CUDA).

Row 0 is the MASK-IDENTITY row: every token allowed, self-transition.
Unconstrained slots carry arena state 0, whose mask row is all ones (a
value-level no-op on the logits); the engine runs the windows without
any mask op when no row of a window has a grammar (its choice of graph).

Compiled grammars load at base offsets >= 1 with their local next states
rebased to arena-absolute; disallowed transitions clamp to 0, which is
safe because masking (fused) and exact-match acceptance (verify) mean a
disallowed token's transition is never consumed. ``G`` is fixed for the
engine's lifetime (`LLMEngineConfig(grammar_states=...)`); a grammar that
cannot fit even after compacting away unreferenced entries raises
``GrammarError``.

`device_tables()` allocates the device pair once and, when the host
arena changed (`load`, `_compact`), copies the changed rows into it in
place, on the current stream: it never rebinds them, so a graph captured
earlier reads the new values (the reference's "value swap, never a
recompile").
"""
import threading

import numpy as np
import torch

from ...core.place import resolve_device
from .compiler import GrammarError, _STRUCT_REJECTS, _STRUCT_STATES

__all__ = ["GrammarArena", "GrammarCache"]


class GrammarCache:
    """Hash-keyed ``(pattern, eos_id) -> CompiledGrammar`` compile cache
    plus its compile / hit / reject counters, lock-guarded:
    ``LLMServer.submit`` compiles grammars on the caller's thread while
    ``add_request`` may compile on the engine thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache = {}
        self.compiles = 0
        self.cache_hits = 0
        self.rejects = 0

    def lookup(self, key):
        """The cached grammar for ``key`` (counting the hit), or None."""
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self.cache_hits += 1
            return hit

    def insert(self, key, grammar):
        """Publish a freshly compiled grammar; first writer wins (a racing
        duplicate compile is wasted work, not corruption)."""
        with self._lock:
            self.compiles += 1
            return self._cache.setdefault(key, grammar)

    def reject(self):
        with self._lock:
            self.rejects += 1

    def snapshot(self):
        with self._lock:
            return {"compiles": self.compiles,
                    "cache_hits": self.cache_hits,
                    "rejects": self.rejects}


class GrammarArena:
    """The host tables (numpy, the reference's layout) and their device
    pair on `device` (default CUDA; module docstring)."""

    def __init__(self, vocab, n_states, device=None):
        self.vocab = int(vocab)
        self.n_states = max(1, int(n_states))
        self.words = (self.vocab + 31) // 32
        self.device = resolve_device(device)
        self.trans = np.zeros((self.n_states, self.vocab), np.int32)
        self.mask = np.zeros((self.n_states, self.words), np.uint32)
        # identity row: all tokens allowed (surplus bits past vocab in
        # the last word are set too — they index nothing), stay in 0
        self.mask[0, :] = np.uint32(0xFFFFFFFF)
        self._next = 1
        self._loaded = {}            # hash -> (base, CompiledGrammar)
        self._dirty = (0, self.n_states)   # host rows the device lacks
        self._dev = None             # (trans [G, vocab], mask [G, W] int32)
        self.refreshes = 0           # device_tables() calls that copied

    @property
    def capacity(self):
        """States available to a single grammar (row 0 is reserved)."""
        return self.n_states - 1

    @property
    def states_used(self):
        return self._next

    def base_of(self, grammar):
        """Arena base offset of a loaded grammar (by object or hash)."""
        h = grammar if isinstance(grammar, str) else grammar.hash
        return self._loaded[h][0]

    def load(self, grammar, live=None):
        """Ensure `grammar` is resident; return its base offset. When the
        arena is full, compact away grammars outside `live` (hashes still
        referenced by queued or running requests) and retry; still over
        budget → GrammarError."""
        ent = self._loaded.get(grammar.hash)
        if ent is not None:
            return ent[0]
        need = grammar.n_states
        if self._next + need > self.n_states:
            self._compact(set(live or ()))
        if self._next + need > self.n_states:
            _STRUCT_REJECTS.inc()
            raise GrammarError(
                f"grammar=: arena full ({self._next}/{self.n_states} "
                f"states used, grammar needs {need}); raise "
                "LLMEngineConfig(grammar_states=...) or retire live "
                "constrained requests")
        base = self._next
        self._write(base, grammar)
        self._loaded[grammar.hash] = (base, grammar)
        self._next = base + need
        self._mark(base, self._next)
        _STRUCT_STATES.set(float(self._next))
        return base

    def _mark(self, lo, hi):
        if self._dirty is None:
            self._dirty = (lo, hi)
        else:
            self._dirty = (min(lo, self._dirty[0]), max(hi, self._dirty[1]))

    def _write(self, base, grammar):
        n = grammar.n_states
        t = grammar.trans.astype(np.int64)
        allowed = t >= 0
        # rebase local next states to arena-absolute; clamp disallowed to
        # 0 (never consumed — the mask / acceptance gate runs first)
        self.trans[base:base + n] = np.where(
            allowed, t + base, 0).astype(np.int32)
        words = np.zeros((n, self.words), np.uint32)
        q_idx, t_idx = np.nonzero(allowed)
        np.bitwise_or.at(
            words, (q_idx, t_idx // 32),
            (np.uint32(1) << (t_idx % 32).astype(np.uint32)))
        self.mask[base:base + n] = words

    def _compact(self, keep):
        """Rebuild the arena keeping only grammars in `keep` — the rebase
        invalidates dropped grammars' offsets, which is fine because
        nothing references them."""
        survivors = [g for h, (_, g) in sorted(self._loaded.items(),
                                               key=lambda kv: kv[1][0])
                     if h in keep]
        self.trans[1:] = 0
        self.mask[1:] = 0
        self._loaded = {}
        self._next = 1
        for g in survivors:
            base = self._next
            self._write(base, g)
            self._loaded[g.hash] = (base, g)
            self._next = base + g.n_states
        self._mark(1, self.n_states)
        _STRUCT_STATES.set(float(self._next))

    def device_tables(self):
        """The (trans, mask) device pair the windows read: int32 [G, vocab]
        and int32 [G, W]. Allocated at the first call; afterwards the rows
        the host arena changed are copied in place, so the pair keeps its
        addresses for the engine's lifetime."""
        if self._dev is None:
            self._dev = (
                torch.empty((self.n_states, self.vocab), dtype=torch.int32,
                            device=self.device),
                torch.empty((self.n_states, self.words), dtype=torch.int32,
                            device=self.device))
        if self._dirty is not None:
            lo, hi = self._dirty
            trans, mask = self._dev
            trans[lo:hi].copy_(torch.from_numpy(self.trans[lo:hi]))
            mask[lo:hi].copy_(torch.from_numpy(
                self.mask[lo:hi].view(np.int32)))
            self._dirty = None
            self.refreshes += 1
        return self._dev
