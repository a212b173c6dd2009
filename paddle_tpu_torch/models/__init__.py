"""Model builders, copied from the JAX package's ``models/`` so both
packages emit the same programs."""
