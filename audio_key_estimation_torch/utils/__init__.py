"""Host-side constants of the port."""
