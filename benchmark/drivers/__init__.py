"""The drivers of the program's paths, one file each (see the harness)."""
