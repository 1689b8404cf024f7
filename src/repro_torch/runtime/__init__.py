"""Fault tolerance (heartbeats, elastic re-planning, stragglers, the
training supervisor) and deterministic chaos injection."""
