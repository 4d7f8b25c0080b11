"""Entry points of the port: the generative server and trainer, and the
LM server."""
