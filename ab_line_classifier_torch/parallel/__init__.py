"""Trial-parallel training on one device (port of the JAX package's
``parallel`` package, without its device mesh)."""
