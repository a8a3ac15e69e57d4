"""Distributed pieces of the port (so far the fleet's cloud expert
sharding, ``sharding.fleet_expert_shards`` / ``shard_expert_stacks``)."""
