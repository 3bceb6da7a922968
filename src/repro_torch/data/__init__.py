"""Port of ``repro.data`` (see the modules)."""
