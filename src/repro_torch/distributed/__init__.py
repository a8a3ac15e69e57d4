"""Distributed pieces of the port: the mesh topology (``topology``), the
collectives of the expert-parallel MoE bodies (``collectives``), the
fleet's cloud expert sharding (``sharding.fleet_expert_shards`` /
``shard_expert_stacks``), the training loop's fault pieces and the loss."""
