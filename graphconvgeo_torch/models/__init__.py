"""The Highway-GCN model and parameter conversion from the JAX package."""
