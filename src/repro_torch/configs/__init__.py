"""Port of ``repro.configs`` (see the modules)."""
