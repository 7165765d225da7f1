"""GNN layers, the paper's sequential GAT and the JAX param converter."""
