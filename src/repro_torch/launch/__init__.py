"""Entry points: the step builders, the serving driver and the training
driver."""
