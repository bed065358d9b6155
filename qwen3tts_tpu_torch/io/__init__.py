"""Weight seams into the port."""
