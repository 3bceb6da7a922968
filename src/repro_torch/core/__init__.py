"""Port of ``repro.core`` (see the modules)."""
