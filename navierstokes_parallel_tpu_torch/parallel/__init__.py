"""The sharded backend: a process mesh, halo exchange, the deep-halo SOR
inner and the sharded solver (counterpart of the JAX package's
``parallel/``)."""
