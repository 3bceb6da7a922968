"""Port of ``repro.models`` (see the modules)."""
