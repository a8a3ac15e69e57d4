"""Routing and expert compute of the port: HL-GGN gating, the single-shard
MoE layer and expert-mask validation."""
