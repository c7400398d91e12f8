"""Development tools of the port (they need the CUDA card)."""
