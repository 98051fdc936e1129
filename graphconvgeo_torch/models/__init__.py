"""The Highway-GCN and GAT models, the Highway-GCN's sampled forward, and parameter conversion from the JAX package."""
