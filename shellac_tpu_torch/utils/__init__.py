"""Host-side utilities of the port (supervisor failure hooks)."""
