from .group import (Group, ReduceOp, axis_group,  # noqa: F401
                    get_world_group, new_group)
from .ops import (P2POp, all_gather, all_gather_object, all_reduce,  # noqa: F401
                  all_to_all, alltoall, alltoall_single, barrier,
                  batch_isend_irecv, broadcast, irecv, isend, recv, reduce,
                  reduce_scatter, scatter, send, wait)


class stream:
    """The stream variants (the reference's
    ``communication/__init__.py:10-21``): the same calls; ``sync_op`` is
    accepted and completion is ``wait()``."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    all_to_all = staticmethod(alltoall)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    reduce_scatter = staticmethod(reduce_scatter)
    scatter = staticmethod(scatter)
    send = staticmethod(send)
    recv = staticmethod(recv)
