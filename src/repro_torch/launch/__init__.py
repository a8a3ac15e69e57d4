"""Step builders (the train step on one device) and the meshes of ranks
(``mesh``: ``make_topology``, ``spawn_ranks``)."""
