"""Problem definitions and their validation data (counterpart of the JAX
package's ``models/``)."""
