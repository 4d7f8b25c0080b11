"""Entry points of the port: the generative server."""
