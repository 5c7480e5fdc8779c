"""Launch layer of the port: the LM train, prefill and serve steps
(``steps``), the training driver (``train``), the abstract inputs of every
(arch × shape) (``specs``), the meshes (``mesh``: the FL engine's cohort
mesh and the production (data, model) mesh on a process group), the
sharding rules (``sharding``: parameter, batch and cache specs as DTensor
placements, per-card bytes, and the bank's placement and remesh slot
algebra) and the dry run's per-card memory and FLOP plan (``dryrun``, with
``utils.hlo``). Multi-card execution and the collective-traffic profiler
(the reference's ``profile.py``) are not ported yet."""
