"""Host-side runtime helpers of the port."""
