"""distributed.communication.stream — the stream variants of the
collectives (counterpart of
paddle_tpu/distributed/communication/stream.py).

The reference's `sync_op` / `use_calc_stream` pick the CUDA stream an op
runs on and whether the call blocks. The port's collectives cross
processes through host copies over gloo and complete on return, so these
wrappers accept and ignore `use_calc_stream` and pass `sync_op` through.
Signatures keep the reference's positional parameter order.
"""
from .. import collective as _c
from ..collective import ReduceOp  # noqa: F401

__all__ = ["all_reduce", "all_gather", "broadcast", "reduce", "scatter",
           "alltoall", "alltoall_single", "reduce_scatter", "send",
           "recv"]


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_list, tensor, group=group, sync_op=sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _c.broadcast(tensor, src=src, group=group, sync_op=sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst=dst, op=op, group=group, sync_op=sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            use_calc_stream=False):
    return _c.scatter(tensor, tensor_list, src=src, group=group,
                      sync_op=sync_op)


def alltoall(out_tensor_list, in_tensor_list=None, group=None,
             sync_op=True, use_calc_stream=False):
    # stream.alltoall takes (out, in); collective.alltoall takes (in, out)
    return _c.alltoall(in_tensor_list, out_tensor_list, group=group,
                       sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor=None, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _c.alltoall_single(in_tensor, out_tensor,
                              in_split_sizes=in_split_sizes,
                              out_split_sizes=out_split_sizes,
                              group=group, sync_op=sync_op)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_list, op=op, group=group,
                             sync_op=sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src=src, group=group, sync_op=sync_op)
