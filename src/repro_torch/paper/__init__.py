"""The paper's experiment drivers on the port: Tables 3-5, Figures 10 and
12-14 and the dry run's roofline table, one module each, with the names,
``run(...)`` signatures and rows of the JAX package's ``benchmarks/``
scripts. Each ``run`` adds a keyword-only ``device`` (default: the card,
which raises on a host without CUDA). ``python -m repro_torch.paper.run``
runs them all.

The populations are synthetic stand-ins for the paper's datasets
(``common.SCENARIOS``): the tables show the direction of each claim on
them, not the paper's figures.
"""
