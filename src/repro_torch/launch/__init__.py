"""Entry points: the decode step builder and the serving driver."""
