"""The training supervisor: restarts after a host failure."""
