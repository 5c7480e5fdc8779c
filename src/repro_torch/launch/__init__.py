"""Launch layer of the port: the LM train, prefill and serve steps
(``steps``), the training driver (``train``), the abstract inputs of every
(arch × shape) (``specs``), the meshes (``mesh``: the FL engine's cohort
mesh and the production (data, model) mesh on a process group), the
sharding rules (``sharding``: parameter, batch and cache specs as DTensor
placements, per-card bytes, and the bank's placement and remesh slot
algebra), one card's blocks of a step's state made on that card alone
(``local``: the per-card init), the dry run's per-card memory, FLOP and
collective plan (``dryrun``, with ``utils.hlo`` and ``utils.spmd``) and the
collective profile (``profile``)."""
