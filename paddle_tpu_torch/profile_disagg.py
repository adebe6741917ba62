"""Disaggregated prefill → decode across two processes: one rank
prefills, the other decodes from the KV pages streamed to it.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
        --log_dir=LOG paddle_tpu_torch/profile_disagg.py \\
        --model gpt_small --kv bfloat16,int8 --out DIR [--device cpu]

Both ranks build the same model from SEED (identical weights) and the
same prompts from PROMPT_SEED. For each pool kind of `--kv`:

* **Rank 0, the prefill tier**, submits every prompt at once to a
  prefill-only `LLMEngine` (`add_request(prefill_only=True)`) and, as
  each request reaches its frontier, streams its payload to rank 1
  with `kv_transfer.send_kv_payload(dst=1)` over the xproc socket
  transport.
* **Rank 1, the decode tier**, first serves the same prompts on a
  local single engine (the reference: all submitted at once), then
  receives the payloads on a thread (`recv_kv_payload(0)`) and admits
  each into a decode engine at its frontier (`import_kv_pages`) as it
  arrives, stepping the engine in between.

K1's launches on each rank come from the paged-attention wrapper's
counts, set to 0 just before a round and read just after (they move on
the card only). Each rank writes DIR/disagg_out_<rank>.json: per pool,
the tokens, pages, trace ids, per-request legs (wall clocks, which align
across the two processes of one host as the request traces' stamps do)
and the launches; rank 0 also `send_retries` (transport resends). The
last act is `xproc.barrier()`: neither rank exits before both finished.

`--device` defaults to cuda (each rank takes `cuda:{local_rank %
device_count}`: both ranks share one card); `--device cpu` runs the
plain versions.
"""
import os
import sys

if __package__ in (None, ""):
    # run as a script: import the package from the checkout, not from
    # the package directory the interpreter put first on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import queue  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch.distributed import xproc  # noqa: E402
from paddle_tpu_torch.inference import LLMEngine, LLMEngineConfig  # noqa: E402
from paddle_tpu_torch.inference.fleet_serving import kv_transfer  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,  # noqa: E402
                                              gpt_small, gpt_tiny)

# per model: config, weight dtype, prompt lengths, new tokens, engine
MODELS = {
    "gpt_small": dict(config=gpt_small, dtype="bfloat16",
                      prompt_lens=(16, 40, 100, 200, 350, 500, 700, 900),
                      new_tokens=32,
                      engine=dict(num_slots=8, page_size=16,
                                  token_budget=256, max_model_len=1024)),
    "gpt_tiny": dict(config=gpt_tiny, dtype="float32",
                     prompt_lens=(7, 16, 17, 33, 48),
                     new_tokens=8,
                     engine=dict(num_slots=4, page_size=16, token_budget=32,
                                 max_model_len=96)),
}
RECV_TIMEOUT_MS = 300_000
SEED = 1234             # the weights, identical on both ranks
PROMPT_SEED = 4321


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODELS), default="gpt_small")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--kv", default="bfloat16,int8",
                   help="pool kinds, comma-separated")
    p.add_argument("--out", required=True, help="output directory")
    return p.parse_args(argv)


def prompts_of(spec, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in spec["prompt_lens"]]


def _drain(eng):
    while eng.has_work():
        eng.step()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _counts():
    """K1 / K2 launches since the last reset, and those on the
    tensor-core route."""
    return {"launches": dict(pa.launches),
            "tc_launches": dict(pa.tc_launches)}


def _start_round(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_mb(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 1e6


def _ms(phases, a, b):
    return (phases[b] - phases[a]) * 1e3


def prefill_tier(model, cfg, prompts, device):
    """Rank 0: every prompt at once on a prefill-only engine; each
    payload streamed to rank 1 as its request reaches the frontier."""
    eng = LLMEngine(model, cfg)
    warm = eng.add_request(prompts[0][:8], prefill_only=True)
    _drain(eng)
    warm.future.result(timeout=0)
    _sync(device)
    _start_round(device)
    xproc.barrier()                 # rank 1 listens from here on
    pa.reset_launches()
    reqs = [eng.add_request(p, prefill_only=True) for p in prompts]
    sent = {}               # prompt index -> its row, in sending order
    payloads = []
    while len(sent) < len(reqs):
        if eng.has_work():
            eng.step()
        for i, r in enumerate(reqs):
            if i in sent or not r.future.done():
                continue
            payload = r.future.result(timeout=0)
            t_send0 = time.time()
            t0 = time.perf_counter()
            kv_transfer.send_kv_payload(payload, dst=1,
                                        timeout_ms=RECV_TIMEOUT_MS)
            send_ms = (time.perf_counter() - t0) * 1e3
            payloads.append(payload)
            ph = payload.trace["phases"]
            sent[i] = dict(prompt=i, trace_id=payload.trace["trace_id"],
                           pages=payload.num_pages,
                           n_prefilled=payload.n_prefilled,
                           prefill_ms=_ms(ph, "queued", "prefill_end"),
                           gather_ms=_ms(ph, "prefill_end", "kv_export"),
                           send_ms=send_ms, t_send0=t_send0)
    _sync(device)
    counts = _counts()
    peak = _peak_mb(device)
    streamed = list(sent.values())
    # the frame's size and its pack time, apart from the timed stream
    for row, payload in zip(streamed, payloads):
        t0 = time.perf_counter()
        raw = kv_transfer.pack_kv_payload(payload)
        row["pack_ms"] = (time.perf_counter() - t0) * 1e3
        row["frame_bytes"] = len(raw)
    eng.close()
    return dict(streamed=streamed,
                sent_pages=sum(r["pages"] for r in streamed),
                trace_ids=[r["trace_id"] for r in streamed],
                peak_mb=peak, **counts)


def _receiver(n, box):
    """Rank 1's receiving thread: n payloads from rank 0, in order."""
    try:
        for _ in range(n):
            payload = kv_transfer.recv_kv_payload(
                0, timeout_ms=RECV_TIMEOUT_MS)
            box.put((payload, time.time()))
    except Exception as e:          # handed to the decode loop, raised
        box.put((e, None))


def decode_tier(model, cfg, prompts, new_tokens, device):
    """Rank 1: the local single-engine reference, then the decode
    engine fed by the stream."""
    ref = LLMEngine(model, cfg)
    warm = ref.add_request(prompts[0][:8], max_new_tokens=2)
    _drain(ref)
    warm.future.result(timeout=0)
    _sync(device)
    _start_round(device)
    pa.reset_launches()
    t0 = time.perf_counter()
    refs = [ref.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    _drain(ref)
    _sync(device)
    local_s = time.perf_counter() - t0
    local = dict(_counts(), seconds=local_s,
                 ttft_ms=[_ms(r.trace.phases, "queued", "first_token")
                          for r in refs],
                 peak_mb=_peak_mb(device))
    ref_tokens = [r.future.result(timeout=0) for r in refs]
    ref.close()
    del ref

    dec = LLMEngine(model, cfg)
    warm = dec.add_request(prompts[0][:8], max_new_tokens=2)
    _drain(dec)
    warm.future.result(timeout=0)
    _sync(device)
    _start_round(device)
    xproc._socket_transport()       # the endpoint is published ...
    box = queue.Queue()
    thread = threading.Thread(target=_receiver, args=(len(prompts), box),
                              daemon=True)
    thread.start()
    xproc.barrier()                 # ... before rank 0 starts
    pa.reset_launches()
    by_tokens = {p.tobytes(): i for i, p in enumerate(prompts)}
    got, t_first = [], None

    def admit(item):
        payload, t_arrived = item
        if isinstance(payload, Exception):
            raise payload
        i = by_tokens[payload.tokens.tobytes()]
        req = dec.import_kv_pages(payload, max_new_tokens=new_tokens)
        got.append((i, payload, req, t_arrived))

    while len(got) < len(prompts) or dec.has_work():
        while True:
            try:
                admit(box.get_nowait())
            except queue.Empty:
                break
        if dec.has_work():
            if t_first is None:
                t_first = time.perf_counter()
            dec.step()
        elif len(got) < len(prompts):
            admit(box.get(timeout=RECV_TIMEOUT_MS / 1e3))
    _sync(device)
    decode_s = time.perf_counter() - t_first
    counts = _counts()
    peak = _peak_mb(device)
    thread.join(timeout=60)
    rows = []
    for i, payload, req, t_arrived in got:
        toks = req.future.result(timeout=0)[len(prompts[i]):]
        local_toks = ref_tokens[i][len(prompts[i]):]
        ph = req.trace.phases
        raw = kv_transfer.pack_kv_payload(payload)
        t0 = time.perf_counter()
        kv_transfer.unpack_kv_payload(raw)
        unpack_ms = (time.perf_counter() - t0) * 1e3
        n = min(len(toks), len(local_toks))
        diff = np.flatnonzero(toks[:n] != local_toks[:n])
        rows.append(dict(
            prompt=i, trace_id=payload.trace["trace_id"],
            pages=payload.num_pages,
            transfer_stamped="kv_transfer" in payload.trace["phases"],
            t_arrived=t_arrived, unpack_ms=unpack_ms,
            import_ms=_ms(ph, "kv_transfer", "kv_import"),
            ttft_ms=_ms(ph, "queued", "first_token"),
            tokens=[int(t) for t in toks],
            local_tokens=[int(t) for t in local_toks],
            equal=bool(np.array_equal(toks, local_toks)),
            first_diff=int(diff[0]) if diff.size else None))
    generated = sum(len(r["tokens"]) for r in rows)
    out = dict(received=rows,
               recv_trace_ids=[r["trace_id"] for r in rows],
               kv_pages_imported=dec.stats.get("kv_pages_imported", 0),
               decode_seconds=decode_s,
               decode_tok_s=generated / decode_s,
               local=dict(local, tok_s=sum(
                   len(t) - len(p) for t, p in zip(ref_tokens, prompts))
                   / local_s),
               peak_mb=peak, **counts)
    dec.close()
    return out


def main(argv=None):
    args = parse_args(argv)
    dist.init_parallel_env(device=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != 2:
        raise SystemExit(f"profile_disagg runs as 2 ranks, not {world}")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    spec = MODELS[args.model]
    config = spec["config"]()
    model = GPTForCausalLM(config, device=device, dtype=spec["dtype"],
                           seed=SEED)
    model.eval()
    prompts = prompts_of(spec, config.vocab_size, PROMPT_SEED)
    out = dict(rank=rank, model=args.model, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
               prompt_lens=list(spec["prompt_lens"]),
               new_tokens=spec["new_tokens"], pools={})
    t0 = time.perf_counter()
    for kv in args.kv.split(","):
        cfg = LLMEngineConfig(kv_dtype=kv, **spec["engine"])
        if rank == 0:
            out["pools"][kv] = prefill_tier(model, cfg, prompts, device)
        else:
            out["pools"][kv] = decode_tier(model, cfg, prompts,
                                           spec["new_tokens"], device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    if rank == 0:
        out["send_retries"] = xproc.stats["send_retries"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"disagg_out_{rank}.json"), "w") as f:
        json.dump(out, f)
    xproc.barrier()       # neither rank exits before both finished


if __name__ == "__main__":
    main()
