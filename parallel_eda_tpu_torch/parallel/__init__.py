"""Multi-device routing over a (net, node) mesh (the JAX package's
parallel/): see shard.py."""

from .shard import (NET, NODE, Mesh, ShardedRouter, make_mesh,
                    make_multislice_mesh, shard_graph)

__all__ = ["NET", "NODE", "Mesh", "ShardedRouter", "make_mesh",
           "make_multislice_mesh", "shard_graph"]
