"""Distributed pieces of the port: the mesh topology (``topology``), the
differentiable collectives (``collectives``), the partition rules and
blocks of training on a mesh and the fleet's cloud expert sharding
(``sharding``), the training loop's fault pieces and elastic topology
(``fault``) and the vocabulary-sharded loss (``loss``)."""
