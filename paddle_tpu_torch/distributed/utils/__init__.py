"""distributed.utils (counterpart of paddle_tpu/distributed/utils): the
eager MoE dispatch API and the small launch and log helpers.

`global_scatter` / `global_gather` keep the reference's semantics: in
one process each is the identity on rows already sorted by destination,
with the dispatch counts validated (its ValueError messages); across
processes they raise, pointing to the capacity-bucketed all-to-all of
`distributed.moe` (`MoELayer`, `moe_a2a_dispatch_combine`), as the
reference does.
"""
import logging
import socket

import numpy as np
import torch

__all__ = ["global_scatter", "global_gather", "get_logger",
           "get_host_name_ip", "find_free_ports"]


def _counts(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t).reshape(-1).astype(np.int64)


def _multiprocess(group):
    from .. import xproc

    return xproc.is_multiprocess()


def _rows(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """MoE dispatch: the rows of `x` [n_tokens, d] in send order, rank
    major and expert minor (`local_count[i]` rows go to expert i % E of
    rank i // E; the rows come sorted by destination, as the reference
    op requires). One process: the rows themselves, the counts
    validated."""
    if _multiprocess(group):
        raise NotImplementedError(
            "multi-process global_scatter: the ragged all-to-all is not "
            "ported — use paddle_tpu_torch.distributed.moe.MoELayer "
            "(capacity-bucketed all_to_all dispatch)")
    xv = _rows(x)
    lc = _counts(local_count)
    gc = _counts(global_count)
    if int(lc.sum()) != int(xv.shape[0]):
        raise ValueError(
            f"local_count sums to {int(lc.sum())} but x has "
            f"{int(xv.shape[0])} rows")
    if int(gc.sum()) != int(lc.sum()):
        raise ValueError(
            f"global_count sums to {int(gc.sum())} != local_count sum "
            f"{int(lc.sum())} — inconsistent dispatch metadata "
            "(single-process world sends exactly what it receives)")
    return xv.clone()


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """The inverse of `global_scatter`: the expert outputs back to their
    source ranks. One process: the rows themselves, validated."""
    if _multiprocess(group):
        raise NotImplementedError(
            "multi-process global_gather: use "
            "paddle_tpu_torch.distributed.moe.MoELayer (capacity-bucketed "
            "all_to_all combine)")
    xv = _rows(x)
    gc = _counts(global_count)
    if int(gc.sum()) != int(xv.shape[0]):
        raise ValueError(
            f"global_count sums to {int(gc.sum())} but x has "
            f"{int(xv.shape[0])} rows")
    return xv.clone()


def get_logger(log_level, name="root"):
    """A logger at `log_level` with one stream handler."""
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    return logger


def get_host_name_ip():
    """(host name, its address), or None when it does not resolve."""
    try:
        host = socket.gethostname()
        return host, socket.gethostbyname(socket.getfqdn(host))
    except OSError:
        return None


def find_free_ports(num):
    """A set of `num` free local TCP ports (bound to port 0 and
    released)."""
    ports = set()
    socks = []
    try:
        while len(ports) < num:
            s = socket.socket()
            s.bind(("", 0))
            socks.append(s)
            ports.add(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports
