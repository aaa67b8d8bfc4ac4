"""Host-side data helpers of the port: numpy copies of the JAX package's."""
