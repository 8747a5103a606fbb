"""Host training loop of the port."""
