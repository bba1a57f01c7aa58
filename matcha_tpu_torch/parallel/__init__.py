"""Multi-process training on ``torch.distributed``: the mesh and its
placement rules (``mesh``), the shard-major stream layout (``stream``) and
joining a run (``distributed``)."""
