"""Whole-map solvers over a device mesh: the point-major global BA and the
essential graph sharded over `mesh.Mesh` shards, in one process or over a
`torch.distributed` process group (`multihost`)."""
