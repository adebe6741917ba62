"""Speculative decoding — the one-step ragged verify (counterpart of
paddle_tpu/inference/speculative.py, the verify half).

A proposer (here the n-gram speculator, inference/structured/ngram.py)
offers up to k tokens per live sequence; the model scores all k+1
positions of every slot in ONE ragged step
(`GPTForCausalLM._paged_verify_fused`) and accepts the longest prefix of
proposals equal to its own picks — the argmax, or the keyed draw of
`sample_tokens`, which depends only on (seed, stream, position) — so the
output is token-identical to the non-speculative engine whatever the
proposals.
On the card the step's attention runs the query-blocked kernel K2.

Rollback is positional: rejected proposals' KV rows stay in the pool
past the accepted frontier, masked by kv_len and overwritten by position
when the real tokens arrive.

The draft-model proposer (`SpeculativeDecoder`, its propose step over
the fused k-tick decode and its mirrored draft pool) is ROADMAP A7.
"""
import numpy as np
import torch

__all__ = []


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

    def __call__(self, tok0, pos0, drafts, width, rem, fin0, eos, temps,
                 top_ps, streams, page_tables, kv, kv_scales=None, key=None):
        """Host numpy inputs: tok0 / pos0 / width / rem / eos / streams [S]
        int, fin0 [S] bool, drafts [S, k] int, temps / top_ps [S] float,
        page_tables [S, MP] int; key, the engine's device key (None when
        every row is greedy). Returns emits [k+1, S] as a numpy int32
        array (-1 = nothing emitted)."""
        S, k = tok0.shape[0], self.k
        MP = page_tables.shape[1]
        buf = np.empty((9 * S + S * k + S * MP,), np.int32)
        vec = buf[:9 * S].reshape(9, S)
        for row, x in enumerate((tok0, pos0, width, rem, fin0, eos)):
            vec[row] = x
        vec[6] = streams
        f = vec[7:9].view(np.float32)
        f[0] = temps
        f[1] = top_ps
        buf[9 * S:9 * S + S * k] = np.asarray(drafts).reshape(-1)
        buf[9 * S + S * k:] = np.asarray(page_tables).reshape(-1)
        dev = torch.from_numpy(buf).to(self.model.device)
        (tok0_d, pos0_d, width_d, rem_d, fin_d, eos_d,
         streams_d) = dev[:7 * S].view(7, S)
        temps_d, tops_d = dev[7 * S:9 * S].view(torch.float32).view(2, S)
        drafts_d = dev[9 * S:9 * S + S * k].view(S, k)
        pt_d = dev[9 * S + S * k:].view(S, MP)
        with torch.inference_mode():
            emits, _, _ = self.model._paged_verify_fused(
                k, self.page_size, tok0_d, pos0_d, drafts_d, width_d,
                rem_d, fin_d != 0, eos_d, temps_d, pt_d, kv, kv_scales,
                top_ps=tops_d, streams=streams_d, key=key)
            return emits.cpu().numpy()
