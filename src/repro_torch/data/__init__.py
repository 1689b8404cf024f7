"""The synthetic data stream and its threefry PRNG."""
