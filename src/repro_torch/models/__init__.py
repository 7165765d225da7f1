"""Model families of the port (the GNN family in this slice)."""
