"""Model definitions of the port (llama-2 family) and their configs."""
