"""Tools of the port: timing harnesses for the card and the checkpoint fixture."""
