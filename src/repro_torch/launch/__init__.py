"""Launch layer of the port: the LM train, prefill and serve steps
(``steps``) and the single-device training driver (``train``). The mesh,
sharding, dry-run and profiling tools are a later port slice."""
