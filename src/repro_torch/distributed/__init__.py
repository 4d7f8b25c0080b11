"""Scale-out: the (data, model) mesh over ``torch.distributed``, its
collectives, and the sharding rules of both halves of the repo, the
generators' and the LM's (:mod:`repro_torch.distributed.sharding`)."""

from repro_torch.distributed.sharding import (Mesh, MeshContext,
                                              batch_specs, cache_specs,
                                              current, current_mesh, gather,
                                              gen_param_specs, layer_shards,
                                              live_mesh, local_block,
                                              mesh_context, param_specs,
                                              place, spmd)

__all__ = ["Mesh", "MeshContext", "batch_specs", "cache_specs", "current",
           "current_mesh", "gather", "gen_param_specs", "layer_shards",
           "live_mesh", "local_block", "mesh_context", "param_specs",
           "place", "spmd"]
