"""The port's HTTP serving seam: server, auth and routes."""
