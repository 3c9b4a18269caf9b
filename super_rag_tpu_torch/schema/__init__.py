"""Request and result models of the port's serving seam."""
