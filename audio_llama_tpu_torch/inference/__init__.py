"""Generation for the port."""
