"""The problems a configuration names, one file each (see the harness)."""
