"""The process bootstrap of the distributed transports (``compat``)."""
from repro_torch.runtime.compat import (NodeMesh, axis_size, host_mesh,
                                        init_node_group, make_mesh,
                                        node_mesh, spawn_nodes)

__all__ = ["NodeMesh", "axis_size", "host_mesh", "init_node_group",
           "make_mesh", "node_mesh", "spawn_nodes"]
