"""Launch layer of the port: the LM train, prefill and serve steps
(``steps``), the single-device training driver (``train``), and the FL
engine's cohort mesh (``mesh``) with the bank's placement and remesh slot
algebra (``sharding``). The production mesh, the parameter, batch and
cache specs, dry-run and profiling tools are a later port slice."""
