"""Architecture registry and shape suites (the port of ``repro.configs``)."""
