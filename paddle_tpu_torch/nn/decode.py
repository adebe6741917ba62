"""Beam-search decoding (counterpart of paddle_tpu/nn/decode.py):
`Decoder`, `BeamSearchDecoder` and `dynamic_decode`.

The loop is host-driven: each step calls the cell eagerly and keeps the
beam bookkeeping in torch ops beside it, and the stopping test reads one
bool to the host per step, as in the reference. The cell is any callable
(inputs, states) -> (outputs, next_states), its states any nest of
tuples, lists and dicts of tensors. (`GPTForCausalLM.generate` is the
static-cache alternative for plain generation.)
"""
import torch

from .functional import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(torch.as_tensor(tree))


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return torch.as_tensor(tree)


class Decoder:
    """The decode contract: initialize() -> (inputs, states, finished);
    step() -> (outputs, states, inputs, finished); finalize()
    optional."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a step cell (the reference's
    `BeamSearchDecoder`). cell: (inputs, states) -> (outputs,
    next_states); the logits are output_fn(outputs) (or the outputs);
    tokens enter the cell through embedding_fn (or as int64 ids)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[batch, ...] -> [batch * beam, ...], each sample repeated."""
        return torch.as_tensor(x).repeat_interleave(beam_size, dim=0)

    def _merge(self, v):
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def _split(self, v):
        return v.reshape((-1, self.beam_size) + tuple(v.shape[1:]))

    def initialize(self, initial_cell_states):
        states = _tree_map(
            lambda t: t.repeat_interleave(self.beam_size, dim=0),
            initial_cell_states)
        batch = _first_leaf(states).shape[0] // self.beam_size
        dev = _first_leaf(states).device
        # beam 0 live, the rest dead at the start, so step 0 picks
        # distinct tokens
        log_probs = torch.tensor(
            [0.0] + [-1e9] * (self.beam_size - 1), dtype=torch.float32,
            device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        inputs = torch.full((batch * self.beam_size,), self.start_token,
                            dtype=torch.int64, device=dev)
        if self.embedding_fn is not None:
            inputs = self.embedding_fn(inputs)
        return inputs, (states, log_probs, finished), finished

    def step(self, time, inputs, states, **kwargs):
        cell_states, log_probs, finished = states
        outputs, next_cell = self.cell(inputs, cell_states)
        logits = self.output_fn(outputs) if self.output_fn else outputs
        lv = torch.as_tensor(logits).float()
        vocab = lv.shape[-1]
        batch = lv.shape[0] // self.beam_size
        step_lp = torch.log_softmax(lv, dim=-1).reshape(
            batch, self.beam_size, vocab)
        # a finished beam emits only end_token, at no cost
        noend = torch.full((vocab,), -1e9, dtype=torch.float32,
                           device=lv.device)
        noend[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], noend, step_lp)
        flat = (log_probs[..., None] + step_lp).reshape(
            batch, self.beam_size * vocab)
        # lax.top_k: the largest first, the lower index first among ties
        order = torch.sort(flat, dim=-1, descending=True, stable=True)
        top_scores = order.values[:, :self.beam_size]
        top_idx = order.indices[:, :self.beam_size]
        parent = top_idx // vocab
        token = top_idx % vocab
        binc = torch.arange(batch, device=lv.device)[:, None]
        next_finished = finished[binc, parent] | (token == self.end_token)
        next_cell = _tree_map(
            lambda t: self._merge(self._split(t)[binc, parent]), next_cell)
        next_inputs = token.reshape(-1)
        if self.embedding_fn is not None:
            next_inputs = self.embedding_fn(next_inputs)
        return ((top_scores, token, parent),
                (next_cell, top_scores, next_finished), next_inputs,
                next_finished)

    def finalize(self, outputs, final_states, sequence_lengths):
        _scores, predicted_ids, parent_ids = outputs
        return gather_tree(predicted_ids, parent_ids), final_states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run `decoder.step` until every sequence finishes or max_step_num
    (the reference's `dynamic_decode`). Returns (final, final_states)
    and, with return_length, the lengths [batch, beam]; final is
    [batch, time, beam] unless output_time_major."""
    inputs, states, finished = decoder.initialize(inits)
    fin = finished
    seq_len = torch.zeros(fin.shape, dtype=torch.int64, device=fin.device)
    scores_acc, ids_acc, parents_acc = [], [], []
    time = 0
    with torch.no_grad():
        while max_step_num is None or time < max_step_num:
            (scores, token, parent), states, inputs, finished = \
                decoder.step(time, inputs, states, **kwargs)
            scores_acc.append(scores)
            ids_acc.append(token)
            parents_acc.append(parent)
            seq_len = seq_len + (~fin).to(torch.int64)
            fin = finished
            time += 1
            if bool(fin.all()):
                break
        outputs = (torch.stack(scores_acc), torch.stack(ids_acc),
                   torch.stack(parents_acc))
        try:
            final, final_states = decoder.finalize(outputs, states, seq_len)
        except NotImplementedError:
            final, final_states = outputs[1], states
    if not output_time_major and torch.is_tensor(final):
        final = final.movedim(0, 1)
    rets = (final, final_states)
    if return_length:
        rets = rets + (seq_len,)
    return rets
