"""Parallel execution (port of the JAX package's ``parallel`` package): the
device mesh over process groups (``mesh``), trial-parallel training
(``trial_parallel``) and multi-process execution (``multihost``)."""
