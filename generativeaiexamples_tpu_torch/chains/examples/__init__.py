"""Chain-server examples."""
