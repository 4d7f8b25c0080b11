"""The generative stack's scale-out: the (data, model) mesh over
``torch.distributed``, its collectives, and the sharding rules of the
generators' parameters (:mod:`repro_torch.distributed.sharding`)."""

from repro_torch.distributed.sharding import (Mesh, MeshContext,
                                              current_mesh, gen_param_specs,
                                              layer_shards, local_block,
                                              spmd)

__all__ = ["Mesh", "MeshContext", "current_mesh", "gen_param_specs",
           "layer_shards", "local_block", "spmd"]
