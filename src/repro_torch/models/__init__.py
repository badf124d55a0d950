"""Model stack of the port: layers, attention, dense transformer."""
