"""Image writers and conversion of JAX-package state to the port's."""
