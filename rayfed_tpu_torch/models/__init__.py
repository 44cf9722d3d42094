"""Model families of the port (so far the Llama serving path)."""
