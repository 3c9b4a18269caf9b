"""Host utilities of the port (archives)."""
