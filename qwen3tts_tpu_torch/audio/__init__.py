"""Audio I/O and the log-mel front end of the port."""
