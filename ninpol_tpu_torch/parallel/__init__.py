"""Multi-device interpolation (one process, several torch devices)."""
from .sharding import (Mesh, PartitionedRows, Replicated, local, make_mesh,
                       schedule, split_nodes, to_device)

__all__ = ["Mesh", "PartitionedRows", "Replicated", "local", "make_mesh",
           "schedule", "sharded_gls", "split_nodes", "to_device"]


def __getattr__(name):
    # sharded_gls lives in _methods/gls.py, which imports this package:
    # re-exported on first use so that neither import waits on the other
    if name == "sharded_gls":
        from .._methods.gls import sharded_gls
        return sharded_gls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
